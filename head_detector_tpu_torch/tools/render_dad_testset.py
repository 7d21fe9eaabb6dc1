"""Render a DAD-3DHeads-format stand-in test set with the port's rasterizer.

Counterpart of ``tools/render_dad_testset.py``.  The DAD academic test set
is not in the repository, but the full DAD protocol
(``evaluation/evaluate_dad.py``: NME-2D, Z_n, rot/angle error,
Procrustes-aligned chamfer, attribute breakdown) can be exercised on
rendered FLAME-head scenes whose GT follows the ``DadSample`` schema.

Sample ``i`` draws from ``RandomState((seed * 1000003 + i) % 2**31)`` every
number the reference draws, in its order (head count, FLAME shape and
expression, jaw, the three Euler angles of every head, the background, then
per head its size, centre and attributes), so one seed gives the same
samples as the JAX tool.  The heads are decoded (canonical, zero rotation)
and placed on the device, the placement in float64 as the reference's numpy;
all heads are drawn as one mesh in one z-buffer by one ``rasterize_zbuffer``
launch (the Hopper kernel on a CUDA device, the plain version on the CPU).

Frame conventions (as the reference's; the DAD evaluator scores the GT fed
back as a prediction at ~0 error):

* predictions live in image coords (x right, y down, z = model projection
  depth); the DAD world frame relates by the proper rotation diag(1,-1,-1)
  (y up, z toward viewer), the 180-degree pre-rotation the evaluator
  applies to the model-view matrix (``ROT_180``);
* ``model_view_matrix[:3,:3] = diag(1,-1,-1) @ R_gt``;
* ``vertices_3d = (x, -y, -z_model)`` of the absolute projected vertices;
* ``landmarks_68_2d`` are the 68-landmark rows of the absolute projection.

Images are PNG: the GT landmarks are exact projections, and JPEG blocking
would add a noise floor under every metric.

Usage::

    python -m head_detector_tpu_torch.tools.render_dad_testset \\
        --out runs/dad_standin --count 256 --image-size 512 [--max-heads 3] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from head_detector_tpu_torch.device import exact_float32, resolve_device
from head_detector_tpu_torch.evaluation.dad_metrics import get_68_landmark_indices
from head_detector_tpu_torch.flame import FlameModel, flame_vertices
from head_detector_tpu_torch.head_info import FlameParams
from head_detector_tpu_torch.ops.rasterize import rasterize_zbuffer
from head_detector_tpu_torch.tools.render_synthetic_dataset import (
    euler_rotation,
    make_background,
)
from head_detector_tpu_torch.train.dataset import scene_tables

ROT_180 = np.diag([1.0, -1.0, -1.0])


def sample_seed(seed: int, index: int) -> int:
    return (seed * 1000003 + index) % (2**31)


@dataclasses.dataclass
class DadScene:
    """A sample's draws and its heads placed on the device, before the pass."""

    params: np.ndarray  # [max_heads, 413] float32, translation and scale unset
    rots: np.ndarray  # [max_heads, 3, 3] float64
    yaw: np.ndarray  # [max_heads] degrees
    background: np.ndarray  # [s, s, 3] uint8
    attributes: List[dict]  # per drawn head: quality, gender, expression, age
    abs_v: torch.Tensor  # [n, V, 3] float64: image coords, z = projection depth


class DadRenderer:
    """Draws stand-in samples at ``image_size`` on ``device`` (default
    ``cuda``: raises without a card; ``device="cpu"`` runs the plain
    rasterizer)."""

    def __init__(self, image_size: int = 512, max_heads: int = 1, device="cuda",
                 flame_model: Optional[FlameModel] = None):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.max_heads = max_heads
        self.flame = flame_model or FlameModel.from_assets(device=self.device)
        self.faces, self.colors = scene_tables(self.device)
        self.lmk68 = get_68_landmark_indices()

    def place(self, rng: np.random.RandomState) -> DadScene:
        """Every draw of a sample, in the reference's order, and its heads
        decoded and placed on the device."""
        s, pad_n, dev = self.image_size, self.max_heads, self.device
        n = int(rng.choice(np.arange(1, pad_n + 1)))
        params = np.zeros((pad_n, 413), np.float32)
        params[:, :300] = rng.normal(0, 0.3, (pad_n, 300))
        params[:, 300:400] = rng.normal(0, 0.3, (pad_n, 100))
        params[:, 400] = np.abs(rng.normal(0, 0.12, pad_n))
        params[:, 401:403] = rng.normal(0, 0.03, (pad_n, 2))
        rpy_deg = np.stack([
            rng.uniform(-45, 45, pad_n),   # roll
            rng.uniform(-50, 50, pad_n),   # pitch
            rng.uniform(-75, 75, pad_n),   # yaw
        ], 1)
        rots = np.stack([euler_rotation(np.radians(r), np.radians(p), np.radians(y))
                         for r, p, y in rpy_deg])
        params[:, 403:409] = rots[:, :, :2].transpose(0, 2, 1).reshape(pad_n, 6)
        background = make_background(rng, s)
        target, center, attributes = np.zeros(n), np.zeros((n, 2)), []
        for h in range(n):
            target_px = float(np.exp(rng.uniform(np.log(72), np.log(300))))
            target[h] = min(target_px, s * 0.55)
            half = target[h] / 2.0
            center[h] = rng.uniform(half + 4, s - half - 4), rng.uniform(half + 4, s - half - 4)
            attributes.append({
                "quality": str(rng.choice(["good", "mid"])),
                "gender": str(rng.choice(["female", "male"])),
                "expression": str(rng.choice(["none", "smile", "surprise"])),
                "age": str(rng.choice(["20-30", "30-50", "50+"])),
            })

        with exact_float32():
            verts = flame_vertices(
                self.flame, FlameParams.from_3dmm(torch.as_tensor(params[:n], device=dev)),
                zero_rot=True)  # [n, V, 3] canonical
        f64 = dict(dtype=torch.float64, device=dev)
        rv = torch.einsum("nvb,nab->nva", verts.double(), torch.as_tensor(rots[:n], **f64))
        ext_xy = torch.maximum(rv[..., 0].amax(1) - rv[..., 0].amin(1),
                               rv[..., 1].amax(1) - rv[..., 1].amin(1))
        rv = rv * (torch.as_tensor(target, **f64) / (ext_xy * 128.0))[:, None, None]
        mid = (rv.amax(1) + rv.amin(1)) / 2.0
        mid[:, 2] = 0.0
        abs_v = (rv - mid[:, None] + 1.0) / 2.0 * 256.0
        abs_v[..., :2] += torch.as_tensor(center - 128.0, **f64)[:, None]
        return DadScene(params, rots, rpy_deg[:, 2], background, attributes, abs_v)

    def scene_mesh(self, scene: DadScene):
        """(vertices [1, n V, 3] float32 with camera-facing depth, triangles,
        colors): the sample's heads as one mesh, as the pass draws them."""
        n, nv = scene.abs_v.shape[0], self.colors.shape[0]
        raster_v = scene.abs_v.clone()
        raster_v[..., 2] *= -1.0  # the rasterizer wants camera-facing depth
        faces = torch.cat([self.faces + h * nv for h in range(n)]).contiguous()
        return (raster_v.to(torch.float32).reshape(1, n * nv, 3).contiguous(), faces,
                self.colors.repeat(n, 1).contiguous())

    def draw(self, rng: np.random.RandomState):
        """One sample -> (uint8 image [s, s, 3] RGB, [per-head DadSample
        config dicts])."""
        scene = self.place(rng)
        s, n = self.image_size, scene.abs_v.shape[0]
        canvas, hit = rasterize_zbuffer(*self.scene_mesh(scene), height=s, width=s)
        image = torch.where(hit[0][..., None],
                            (canvas[0] * 255.0).clamp(0, 255).to(torch.uint8),
                            torch.as_tensor(scene.background, device=self.device))
        image, abs_v = image.cpu().numpy(), scene.abs_v.cpu().numpy()
        cfgs = []
        for h in range(n):
            v = abs_v[h]
            (x1, y1), (x2, y2) = v[:, :2].min(0), v[:, :2].max(0)
            mv = np.eye(4)
            mv[:3, :3] = ROT_180 @ scene.rots[h]
            cfgs.append({
                "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                "model_view_matrix": mv.tolist(),
                "landmarks_68_2d": v[self.lmk68, :2].tolist(),
                "vertices_3d": (v * np.array([1.0, -1.0, -1.0])).tolist(),
                "attributes": {
                    **scene.attributes[h],
                    "occlusions": "none" if n == 1 else "head",
                    "pose": "frontal" if abs(scene.yaw[h]) < 30 else "profile",
                    "standard light": "yes",
                },
                # extra fields for oracle/conversion tools (ignored by DadSample)
                "_params_dad": scene.params[h].tolist(),
            })
        return image, cfgs


def render_testset(out: str, count: int = 256, image_size: int = 512, seed: int = 99,
                   max_heads: int = 1, device="cuda",
                   flame_model: Optional[FlameModel] = None, log_every: int = 50) -> dict:
    """Samples ``0..count-1`` under ``out`` (``images/NNNNN.png`` and
    ``dataset.json``, one annotated head a sample); returns the count and
    the seconds taken."""
    import cv2

    renderer = DadRenderer(image_size, max_heads, device, flame_model)
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    index = {"standin": []}
    t0 = time.perf_counter()
    for i in range(count):
        image, cfgs = renderer.draw(np.random.RandomState(sample_seed(seed, i)))
        rel = os.path.join("images", f"{i:05d}.png")
        cv2.imwrite(os.path.join(out, rel), cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
        cfg = dict(cfgs[0])  # DAD annotates one head per sample
        cfg["image_path"] = rel
        index["standin"].append(cfg)
        if log_every and (i + 1) % log_every == 0:
            print(f"{i + 1}/{count}", flush=True)
    with open(os.path.join(out, "dataset.json"), "w") as f:
        json.dump(index, f)
    return {"samples": count, "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--count", type=int, default=256)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=99)
    ap.add_argument("--max-heads", type=int, default=1,
                    help=">1 renders distractor heads; only head 0 is "
                         "annotated (exercises the IoU selection path)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    done = render_testset(args.out, args.count, args.image_size, args.seed, args.max_heads,
                          args.device)
    print(f"done: {args.count} samples at {args.out}/dataset.json "
          f"({done['samples'] / max(done['seconds'], 1e-9):.1f} samples/s)")
    return done


if __name__ == "__main__":
    main()
