"""Z-buffered triangle rasterizer: plain torch versions, the Hopper kernel's
two wrappers, and the host ``rasterize`` composite.

Counterpart of ``head_detector_tpu/ops/rasterize.py`` (the XLA golden) and
``head_detector_tpu/ops/rasterize_pallas.py`` (the TPU kernel).  Contract,
shared by both versions here:

* barycentric weights by the C++ ``get_point_weight`` formula, with the
  relative degenerate guard ``deno <= 1e-6 * dot00 * dot11``;
* pixel bbox ``ceil(min)..floor(max)`` clamped to the canvas, strict
  ``w > 0`` inside test, depth must exceed -1e8;
* the winner is the lexicographic max of (depth, -triangle index), so on a
  depth tie the lowest index wins;
* color = sum(w_i * c_i) of the winner; ``reverse`` flips the output rows.

The plain version reduces a per-pixel 64-bit key ``(ordered depth bits << 32)
| (0xFFFFFFFF - triangle)`` by max; the kernel keeps each pixel's best
``(depth, triangle)`` inside the block that owns the pixel's tile (in a
register, compared lexicographically, and as the same key in shared memory),
which is the same order.  Both run the same float32 operations in the same
order on the winner.  Meshes may be batched, ``[N, V, 3]`` with one z-buffer per mesh
and shared triangles and colors.

Two functions, each with a plain version (CPU tensors) and a CUDA kernel
(``csrc/rasterize.cu``, CUDA tensors) and no fallback from one to the other:

* ``rasterize_zbuffer`` -> float colors and a hit mask per mesh;
* ``pncc_render`` -> one uint8 canvas with the meshes composited in order by
  the PNCC rule (``head_detector_tpu/pncc.py``): at a hit pixel
  ``c8 = uint8(255.0 * color)``, which replaces what earlier meshes left
  there unless ``c8`` sums to 0.  The product is taken in float32 and the
  cast truncates, exactly as ``composite`` below does with ``alpha = 1``.

A steady-state call of either CUDA wrapper does not wait for the device: the
index range of a triangle table is read back once per tensor.
"""

from __future__ import annotations

import ctypes
import threading
import weakref

import numpy as np
import torch

from head_detector_tpu_torch.device import resolve_device

NEG_DEPTH = -1e8
_EMPTY = torch.iinfo(torch.int64).min  # key of a pixel no triangle covers
_LOW_MASK = 0xFFFFFFFF
# bound on (triangle, pixel) candidates held at once by the plain version
_CANDIDATES_PER_CHUNK = 1 << 22
MAX_CANVAS = 32767  # the kernel packs pixel boxes as int16


def _triangle_setup(tv: torch.Tensor):
    """Per-triangle terms of the weight formula; ``tv`` is [..., 3, 3]."""
    p0, p1, p2 = tv[..., 0, :2], tv[..., 1, :2], tv[..., 2, :2]
    v0 = p2 - p0
    v1 = p1 - p0
    v0x, v0y, v1x, v1y = v0[..., 0], v0[..., 1], v1[..., 0], v1[..., 1]
    dot00 = v0x * v0x + v0y * v0y
    dot01 = v0x * v1x + v0y * v1y
    dot11 = v1x * v1x + v1y * v1y
    deno = dot00 * dot11 - dot01 * dot01
    degenerate = deno <= 1e-6 * dot00 * dot11
    inver = torch.where(
        degenerate, torch.zeros_like(deno), 1.0 / torch.where(degenerate, 1.0, deno)
    )
    return {
        "p0x": p0[..., 0], "p0y": p0[..., 1],
        "v0x": v0x, "v0y": v0y, "v1x": v1x, "v1y": v1y,
        "dot00": dot00, "dot01": dot01, "dot11": dot11,
        "inver": inver, "degenerate": degenerate,
    }


def _point_weights(s, px: torch.Tensor, py: torch.Tensor):
    """(w0, w1, w2) at pixels (px, py) for per-pixel triangle terms ``s``."""
    v2x = px - s["p0x"]
    v2y = py - s["p0y"]
    dot02 = s["v0x"] * v2x + s["v0y"] * v2y
    dot12 = s["v1x"] * v2x + s["v1y"] * v2y
    u = (s["dot11"] * dot02 - s["dot01"] * dot12) * s["inver"]
    v = (s["dot00"] * dot12 - s["dot01"] * dot02) * s["inver"]
    return 1.0 - u - v, v, u


def _depth_key(depth: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Signed int64 key ordered like (depth, -tri): the unsigned key of the
    CUDA kernel minus 2**63."""
    bits = (depth + 0.0).view(torch.int32)  # + 0.0 maps -0 to +0
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return ordered * (1 << 32) + (_LOW_MASK - tri.to(torch.int64))


def rasterize_zbuffer_plain(
    vertices: torch.Tensor,  # [N, V, 3] float32 (x, y, depth) in pixels
    triangles: torch.Tensor,  # [F, 3] int
    colors: torch.Tensor,  # [V, 3] float32
    height: int,
    width: int,
    reverse: bool = False,
):
    """Plain torch version: returns (color [N, H, W, 3], hit [N, H, W])."""
    n = vertices.shape[0]
    nf = triangles.shape[0]
    dev = vertices.device
    hw = height * width
    keys = torch.full((n * hw,), _EMPTY, dtype=torch.int64, device=dev)
    tri = triangles.to(device=dev, dtype=torch.int64)
    tv = vertices.to(torch.float32)[:, tri]  # [N, F, 3, 3]
    setup = {k: v.reshape(-1) for k, v in _triangle_setup(tv).items()}  # [N*F]

    if n * nf:
        xs, ys = tv[..., 0], tv[..., 1]
        x0 = torch.ceil(xs.amin(-1)).clamp(min=0.0).reshape(-1)
        x1 = torch.floor(xs.amax(-1)).clamp(max=width - 1.0).reshape(-1)
        y0 = torch.ceil(ys.amin(-1)).clamp(min=0.0).reshape(-1)
        y1 = torch.floor(ys.amax(-1)).clamp(max=height - 1.0).reshape(-1)
        live = ((x0 <= x1) & (y0 <= y1) & ~setup["degenerate"]).nonzero()[:, 0]
        x0, y0 = x0[live].to(torch.int64), y0[live].to(torch.int64)
        bw = x1[live].to(torch.int64) - x0 + 1
        counts = bw * (y1[live].to(torch.int64) - y0 + 1)
        cum = counts.cumsum(0)
        start = 0
        while start < live.numel():
            base = int(cum[start - 1]) if start else 0
            end = int(torch.searchsorted(cum, base + _CANDIDATES_PER_CHUNK, right=True))
            end = max(end, start + 1)
            c = counts[start:end]
            owner = torch.repeat_interleave(torch.arange(end - start, device=dev), c)
            offs = torch.arange(owner.numel(), device=dev) - (cum[start:end] - c - base)[owner]
            owner = owner + start
            px = x0[owner] + offs % bw[owner]
            py = y0[owner] + offs // bw[owner]
            pair = live[owner]  # head * F + triangle
            s = {k: v[pair] for k, v in setup.items()}
            w0, w1, w2 = _point_weights(s, px.to(torch.float32), py.to(torch.float32))
            corners = tv.reshape(-1, 3, 3)[pair, :, 2]
            depth = w0 * corners[:, 0] + w1 * corners[:, 1] + w2 * corners[:, 2]
            ok = (w0 > 0) & (w1 > 0) & (w2 > 0) & (depth > NEG_DEPTH)
            head = pair // nf
            pix = head * hw + py * width + px
            keys.scatter_reduce_(
                0, pix[ok], _depth_key(depth[ok], (pair % nf)[ok]), reduce="amax"
            )
            start = end

    keys = keys.reshape(n, height, width)
    if reverse:
        keys = keys.flip(1)
    hit = keys != _EMPTY
    canvas = torch.zeros((n, height, width, 3), dtype=torch.float32, device=dev)
    head, row, col = hit.nonzero(as_tuple=True)
    win = _LOW_MASK - (keys[head, row, col] & _LOW_MASK)
    src_row = (height - 1 - row) if reverse else row
    s = {k: v[head * nf + win] for k, v in setup.items()}
    w0, w1, w2 = _point_weights(s, col.to(torch.float32), src_row.to(torch.float32))
    corner = tri[win]  # [P, 3]
    cols = colors.to(device=dev, dtype=torch.float32)
    canvas[head, row, col] = (
        w0[:, None] * cols[corner[:, 0]]
        + w1[:, None] * cols[corner[:, 1]]
        + w2[:, None] * cols[corner[:, 2]]
    )
    return canvas, hit


def _check_cuda_inputs(vertices, triangles, colors, height, width):
    dev = vertices.device
    if dev.type != "cuda":
        raise ValueError(f"vertices must be a CUDA tensor, got {dev}")
    for name, t, dtype in (
        ("vertices", vertices, torch.float32),
        ("triangles", triangles, torch.int32),
        ("colors", colors, torch.float32),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, vertices on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vertices.dim() != 3 or vertices.shape[2] != 3:
        raise ValueError(f"vertices must be [N, V, 3], got {tuple(vertices.shape)}")
    if triangles.dim() != 2 or triangles.shape[1] != 3:
        raise ValueError(f"triangles must be [F, 3], got {tuple(triangles.shape)}")
    if tuple(colors.shape) != (vertices.shape[1], 3):
        raise ValueError(
            f"colors must be [{vertices.shape[1]}, 3], got {tuple(colors.shape)}"
        )
    if height <= 0 or width <= 0:
        raise ValueError(f"canvas must be non-empty, got {height}x{width}")
    if vertices.shape[0] * height * width >= 2**31 or triangles.shape[0] >= 2**31:
        raise ValueError("canvas or mesh too large for 32-bit indexing")
    if max(height, width) > MAX_CANVAS:
        raise ValueError(f"canvas sides must be <= {MAX_CANVAS}, got {height}x{width}")
    if vertices.shape[0] > 65535:
        raise ValueError("at most 65535 meshes per call")
    if triangles.numel():
        lo, hi = _index_range(triangles)
        if lo < 0 or hi >= vertices.shape[1]:
            raise ValueError(
                f"triangle indices must lie in [0, {vertices.shape[1]}), "
                f"got [{lo}, {hi}]"
            )


# launch counts are bumped from loader threads too (the training dataset
# renders in a thread pool), and ``+=`` on an attribute is not atomic
_COUNT_LOCK = threading.Lock()

# id(table) -> (weak reference, version counter, lowest, highest index): the
# range of a table that is alive and unchanged since it was read
_CHECKED_TABLES: dict = {}


def _index_range(triangles: torch.Tensor):
    """(lowest, highest) index of a non-empty triangle table.  Reading it is a
    device-to-host synchronisation, so it is done once per tensor: a later
    call with the same tensor object, not written to since, costs nothing."""
    key = id(triangles)
    entry = _CHECKED_TABLES.get(key)
    if entry is not None and entry[0]() is triangles and entry[1] == triangles._version:
        return entry[2], entry[3]
    lo, hi = torch.stack(torch.aminmax(triangles)).tolist()
    ref = weakref.ref(triangles, lambda _, key=key: _CHECKED_TABLES.pop(key, None))
    _CHECKED_TABLES[key] = (ref, triangles._version, lo, hi)
    return lo, hi


def _library():
    from head_detector_tpu_torch import cuda_build

    lib = cuda_build.load("rasterize")
    if lib.hdt_rasterize_zbuffer.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.hdt_raster_scratch_bytes.argtypes = [i32, i32]
        lib.hdt_raster_scratch_bytes.restype = ctypes.c_longlong
        lib.hdt_pncc_render.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
        lib.hdt_pncc_render.restype = i32
        lib.hdt_rasterize_zbuffer.restype = i32
        lib.hdt_rasterize_zbuffer.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    return lib


def alloc_scratch(vertices: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
    """The kernels' scratch for these meshes (triangle records and boxes);
    its contents need not survive a call."""
    size = _library().hdt_raster_scratch_bytes(vertices.shape[0], triangles.shape[0])
    return torch.empty(size, dtype=torch.uint8, device=vertices.device)


def launch_rasterize_zbuffer(vertices, triangles, colors, scratch, canvas, hit,
                             reverse: bool = False) -> None:
    """Launch the kernel on checked inputs and preallocated ``scratch``
    (``alloc_scratch``), ``canvas`` [N, H, W, 3] float32 and ``hit``
    [N, H, W] bool; nothing is launched for N = 0."""
    n, nv, _ = vertices.shape
    _, height, width = hit.shape
    err = _library().hdt_rasterize_zbuffer(
        vertices.data_ptr(), triangles.data_ptr(), colors.data_ptr(),
        scratch.data_ptr(), canvas.data_ptr(), hit.data_ptr(),
        n, nv, triangles.shape[0], height, width, int(bool(reverse)),
        torch.cuda.current_stream(vertices.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rasterize kernel launch failed: cudaError {err}")
    if n:
        with _COUNT_LOCK:
            rasterize_zbuffer_cuda.launches += 1


def rasterize_zbuffer_cuda(
    vertices: torch.Tensor,  # [N, V, 3] float32, CUDA
    triangles: torch.Tensor,  # [F, 3] int32
    colors: torch.Tensor,  # [V, 3] float32
    height: int,
    width: int,
    reverse: bool = False,
):
    """Hopper kernel (``csrc/rasterize.cu``); same returns as the plain
    version.  Counts its launches in ``rasterize_zbuffer_cuda.launches``."""
    _check_cuda_inputs(vertices, triangles, colors, height, width)
    n = vertices.shape[0]
    dev = vertices.device
    canvas = torch.empty((n, height, width, 3), dtype=torch.float32, device=dev)
    hit = torch.empty((n, height, width), dtype=torch.bool, device=dev)
    launch_rasterize_zbuffer(vertices, triangles, colors,
                             alloc_scratch(vertices, triangles), canvas, hit, reverse)
    return canvas, hit


rasterize_zbuffer_cuda.launches = 0


def launch_pncc_render(vertices, triangles, colors, scratch, canvas) -> None:
    """Launch the PNCC entry point on checked inputs and preallocated
    ``scratch`` and ``canvas`` [H, W, 3] uint8."""
    n, nv, _ = vertices.shape
    height, width, _ = canvas.shape
    err = _library().hdt_pncc_render(
        vertices.data_ptr(), triangles.data_ptr(), colors.data_ptr(),
        scratch.data_ptr(), canvas.data_ptr(),
        n, nv, triangles.shape[0], height, width,
        torch.cuda.current_stream(vertices.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"PNCC render kernel launch failed: cudaError {err}")
    with _COUNT_LOCK:
        pncc_render_cuda.launches += 1


def pncc_render_cuda(
    vertices: torch.Tensor,  # [N, V, 3] float32, CUDA
    triangles: torch.Tensor,  # [F, 3] int32
    colors: torch.Tensor,  # [V, 3] float32
    height: int,
    width: int,
) -> torch.Tensor:
    """Hopper kernel (``csrc/rasterize.cu``, ``hdt_pncc_render``): the meshes
    composited in order into one uint8 [H, W, 3] canvas on the card.  Counts
    its launches in ``pncc_render_cuda.launches``; no meshes give zeros
    without a launch."""
    _check_cuda_inputs(vertices, triangles, colors, height, width)
    dev = vertices.device
    if vertices.shape[0] == 0:
        return torch.zeros((height, width, 3), dtype=torch.uint8, device=dev)
    canvas = torch.empty((height, width, 3), dtype=torch.uint8, device=dev)
    launch_pncc_render(vertices, triangles, colors, alloc_scratch(vertices, triangles),
                       canvas)
    return canvas


pncc_render_cuda.launches = 0


def pncc_render_plain(
    vertices: torch.Tensor,  # [N, V, 3] float32
    triangles: torch.Tensor,  # [F, 3] int
    colors: torch.Tensor,  # [V, 3] float32
    height: int,
    width: int,
) -> torch.Tensor:
    """Plain torch version of ``pncc_render``: ``rasterize_zbuffer_plain``,
    then the composite in mesh order."""
    out = torch.zeros((height, width, 3), dtype=torch.uint8, device=vertices.device)
    if vertices.shape[0] == 0:
        return out
    canvas, hit = rasterize_zbuffer_plain(vertices, triangles, colors, height, width)
    for i in range(vertices.shape[0]):
        c8 = (255.0 * canvas[i]).to(torch.int32).to(torch.uint8)  # float32 product, truncated
        replace = hit[i] & (c8.sum(-1, dtype=torch.int32) != 0)
        out[replace] = c8[replace]
    return out


def _on_device(vertices, triangles, colors):
    """Kernel-ready copies (float32 / int32, contiguous, on the vertices'
    device); a tensor that already is comes back as the same object."""
    dev = vertices.device
    return (vertices.to(torch.float32).contiguous(),
            triangles.to(device=dev, dtype=torch.int32).contiguous(),
            colors.to(device=dev, dtype=torch.float32).contiguous())


def pncc_render(
    vertices: torch.Tensor,  # [N, V, 3]
    triangles: torch.Tensor,
    colors: torch.Tensor,
    height: int,
    width: int,
) -> torch.Tensor:
    """PNCC canvas uint8 [H, W, 3] of N meshes composited in order: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if vertices.device.type == "cpu":
        return pncc_render_plain(vertices, triangles, colors, height, width)
    if vertices.device.type == "cuda":
        return pncc_render_cuda(*_on_device(vertices, triangles, colors), height, width)
    raise ValueError(f"no rasterizer for device {vertices.device}")


def rasterize_zbuffer(
    vertices: torch.Tensor,  # [V, 3] or [N, V, 3]
    triangles: torch.Tensor,
    colors: torch.Tensor,
    height: int,
    width: int,
    reverse: bool = False,
):
    """Render -> (color [(N,) H, W, 3] float in [0, 1], hit [(N,) H, W] bool):
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    single = vertices.dim() == 2
    verts = vertices[None] if single else vertices
    if verts.device.type == "cpu":
        canvas, hit = rasterize_zbuffer_plain(
            verts, triangles, colors, height, width, reverse
        )
    elif verts.device.type == "cuda":
        canvas, hit = rasterize_zbuffer_cuda(
            *_on_device(verts, triangles, colors), height, width, reverse
        )
    else:
        raise ValueError(f"no rasterizer for device {verts.device}")
    if single:
        return canvas[0], hit[0]
    return canvas, hit


def composite(bg: np.ndarray, canvas: np.ndarray, hit: np.ndarray,
              alpha: float = 1.0) -> np.ndarray:
    """Blend a rendered canvas onto a uint8 background, exactly as
    ``Sim3DR.rasterize`` does (float64 blend, then a truncating uint8 cast);
    only the hit pixels are computed, the rest is ``bg``."""
    out = bg.copy()
    rows, cols = np.nonzero(hit)
    out[rows, cols, :3] = (
        (1 - alpha) * bg[rows, cols, :3] + alpha * 255.0 * canvas[rows, cols]
    ).astype(np.uint8)
    return out


def rasterize(
    vertices: np.ndarray,
    triangles: np.ndarray,
    colors: np.ndarray,
    bg: np.ndarray = None,
    height: int = None,
    width: int = None,
    channel: int = None,
    reverse: bool = False,
    alpha: float = 1.0,
    device="cuda",
) -> np.ndarray:
    """Drop-in equivalent of ``Sim3DR.rasterize``: renders on ``device`` and
    composites on the host."""
    if bg is not None:
        height, width, channel = bg.shape
    else:
        if height is None or width is None or channel is None:
            raise ValueError("give bg, or height, width and channel")
        bg = np.zeros((height, width, channel), dtype=np.uint8)
    device = resolve_device(device)
    canvas, hit = rasterize_zbuffer(
        torch.as_tensor(np.ascontiguousarray(vertices, np.float32), device=device),
        torch.as_tensor(np.ascontiguousarray(triangles, np.int32), device=device),
        torch.as_tensor(np.ascontiguousarray(colors, np.float32), device=device),
        height=height, width=width, reverse=reverse,
    )
    return composite(bg, canvas.cpu().numpy(), hit.cpu().numpy(), alpha)


def get_normal(vertices: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
    """Per-vertex normals [V, 3]: each triangle's unnormalised normal (the
    cross product of its edges) summed into its three corners, then
    L2-normalised; a vertex no triangle touches keeps a zero normal."""
    vertices = torch.as_tensor(vertices).to(torch.float32)
    triangles = torch.as_tensor(triangles, device=vertices.device).long()
    tv = vertices[triangles]  # [F, 3, 3]
    tn = torch.linalg.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])  # [F, 3]
    normal = torch.zeros_like(vertices)
    for k in range(3):
        normal.index_add_(0, triangles[:, k], tn)
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    return torch.where(norm > 0, normal / torch.where(norm == 0, 1.0, norm), normal)
