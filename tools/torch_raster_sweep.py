"""Time the port's rasterizer kernel beside its first port on one NVIDIA GPU.

    python3 tools/torch_raster_sweep.py FIRST_PORT_RASTERIZE_CU

``FIRST_PORT_RASTERIZE_CU`` is the source of the first port of the kernel (a
per-pixel 64-bit ``atomicMax`` into a key buffer, then a resolve pass); the
commit before the redesign has it as
``head_detector_tpu_torch/csrc/rasterize.cu`` (``git show <commit>:<path>``).

Both kernels are timed in turns, twice over, within one run on one card,
which is the only way two of them can be compared, with the outputs and the
scratch allocated once:

* at PNCC shapes (4 seeded heads, V=5023, F=6814, 640x640, the meshes of
  ``chip_smoke.py``), on one of those heads, on a head scaled to twice the
  canvas, and with no triangles (the cost of the launches and of writing the
  empty canvases);
* by replaying a CUDA graph of launches (the device's time alone) and by a
  loop of launches from Python (what a caller that never waits would see).

The committed kernel's two entry points are also checked against the plain
torch versions in every case; the first port's time includes clearing its key
buffer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from head_detector_tpu_torch import cuda_build  # noqa: E402
from head_detector_tpu_torch.flame import FlameModel  # noqa: E402
from head_detector_tpu_torch.ops import rasterize as r  # noqa: E402
from head_detector_tpu_torch.pncc import PNCCProcessor  # noqa: E402

SIZE = chip_smoke.IMAGE_SIZE


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_raster_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(chip_smoke.nvidia_smi())
    proc = PNCCProcessor(device=dev)
    tris = torch.as_tensor(proc.triangles, device=dev)
    colors = torch.as_tensor(proc.colors, dtype=torch.float32, device=dev)
    verts = chip_smoke.pncc_heads(FlameModel.from_assets(device=dev), 4, SIZE)
    n, nv, _ = verts.shape
    cases = {
        "PNCC shapes": (verts, tris),
        "one head": (verts[:1].contiguous(), tris),
        "head filling the canvas": (chip_smoke.filling_head(verts, SIZE, SIZE), tris),
        "no triangles": (verts, tris[:0].contiguous()),
    }
    canvas = torch.empty((n, SIZE, SIZE, 3), dtype=torch.float32, device=dev)
    hit = torch.empty((n, SIZE, SIZE), dtype=torch.bool, device=dev)
    rgb = torch.empty((SIZE, SIZE, 3), dtype=torch.uint8, device=dev)
    keys = torch.empty((n, SIZE, SIZE), dtype=torch.int64, device=dev)

    out = os.path.join(tempfile.mkdtemp(prefix="raster_sweep_"), "first_port.so")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", out, sys.argv[1]],
                   check=True)
    first_port = ctypes.CDLL(out)
    first_port.hdt_rasterize_zbuffer.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]

    def report(turn, kernel, case, name, fn):
        loop = chip_smoke.time_ms(fn)
        print(f"turn {turn} [{kernel}] {case}: {name} graph {chip_smoke.graph_ms(fn)[0]:.4f} ms, "
              f"loop {loop[0]:.4f} ({loop[1]:.4f}-{loop[2]:.4f})", flush=True)

    for turn in range(2):
        for case, (v, t) in cases.items():
            heads = v.shape[0]
            scratch = r.alloc_scratch(v, t)

            def zbuffer():
                r.launch_rasterize_zbuffer(v, t, colors, scratch, canvas[:heads], hit[:heads])

            def pncc():
                r.launch_pncc_render(v, t, colors, scratch, rgb)

            def old():
                keys[:heads].zero_()
                err = first_port.hdt_rasterize_zbuffer(
                    v.data_ptr(), t.data_ptr(), colors.data_ptr(), keys.data_ptr(),
                    canvas.data_ptr(), hit.data_ptr(), heads, nv, t.shape[0], SIZE, SIZE, 0,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            zbuffer()
            pncc()
            want = r.rasterize_zbuffer_plain(v, t, colors, SIZE, SIZE)
            if not (torch.equal(canvas[:heads], want[0]) and torch.equal(hit[:heads], want[1])
                    and torch.equal(rgb, r.pncc_render_plain(v, t, colors, SIZE, SIZE))):
                print(f"the committed kernel disagrees with plain: {case}", file=sys.stderr)
                return 1
            report(turn, "committed", case, "rasterize_zbuffer", zbuffer)
            report(turn, "committed", case, "pncc_render", pncc)
            report(turn, "first port", case, "rasterize_zbuffer", old)
    return 0


if __name__ == "__main__":
    sys.exit(main())
