"""Float32 training gradients on the card and on the CPU against float64.

One train-mode forward + loss + backward (TF32 off) of a training-layout
model on the card in float32, on the CPU in float32 and on the CPU with the
network in float64 (the loss after the heads' float32 outputs is float32
either way), from the same weights and batch: the gradients' relative L2
over the model and per parameter, each pair against the others.  Float32
cannot resolve every parameter's gradient of a deep network to 1e-3: the
float64 run says which side of a card/CPU difference is the float32 error.

The weights are a seeded random init (BatchNorm calibrated), optionally
trained ``--steps`` bfloat16 steps on rendered scenes first; ``--float64-convs``
runs the card's convolutions under the named scopes in float64, to find
where a difference starts.

Usage::

    python -m head_detector_tpu_torch.tools.grad_precision --arch segformer \\
        --size 320 [--steps 8 --lr 3e-4 --max-steps 100] \\
        [--float64-convs heads.head1.pose_stem backbone]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Sequence, Tuple

import torch

# parameters whose exact gradient is 0: biases that only shift a channel
# before a train-mode BatchNorm (QARepVGG branches, the neck's upsample before
# a 1x1 conv and its BatchNorm; SegFormer's last LayerNorm feeds only 1x1
# stems), and SegFormer's key bias (it adds q.b to every logit of a query,
# which the softmax cancels)
EXACT_ZERO = ("branch_3x3_bn.bias", "branch_1x1.bias", "upsample.bias",
              "backbone.norm4.bias", "attn.k.bias")
BATCH = 2  # the batch of the step, as chip_smoke.py's float32 checks take it


def _float64_conv(module, x):
    bias = None if module.bias is None else module.bias.double()
    return module._conv_forward(x.double(), module.weight.double(), bias).to(x.dtype)


def step_gradients(arch, state: Dict[str, torch.Tensor], images, targets, loss_cfg, device,
                   dtype=torch.float32, float64_convs: Sequence[str] = (),
                   on_net=None, loss_dtype=torch.float32) -> Tuple[dict, dict]:
    """(loss components, {parameter: gradient as float64 on the CPU}) of one
    train-mode step of ``arch`` with ``state`` on ``device``, the network in
    ``dtype``, the convolutions under ``float64_convs`` in float64;
    ``on_net(net)`` is called on the built network before the step (to hook
    its modules).  ``targets``: the five ``Targets`` fields, or a
    ``ParamTargets`` (the params wire, decoded in the loss); the FLAME model
    and parameter targets are in ``loss_dtype`` (float64: the loss too)."""
    import numpy as np

    from head_detector_tpu_torch.device import exact_float32
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.models import build_model
    from head_detector_tpu_torch.models.blocks import Conv2d
    from head_detector_tpu_torch.train.loss import Targets
    from head_detector_tpu_torch.train.param_wire import ParamTargets
    from head_detector_tpu_torch.train.trainer import images_to_device, make_loss_fn

    net = build_model(arch, deploy=False).to(device)
    net.load_state_dict(state, strict=True)
    net.to(dtype)
    net.dtype = dtype
    for name, module in net.named_modules():
        if isinstance(module, Conv2d) and any(name.startswith(s) for s in float64_convs):
            module.forward = _float64_conv.__get__(module)
    if on_net is not None:
        on_net(net)
    if isinstance(targets, ParamTargets):
        targets = ParamTargets(*(torch.as_tensor(np.asarray(t)).to(device, loss_dtype)
                                 for t in targets))
    else:
        targets = Targets(*targets).to(device)
    loss_fn = make_loss_fn(net, FlameModel.from_assets(device=device, dtype=loss_dtype), loss_cfg)
    with exact_float32():
        total, comps = loss_fn(images_to_device(images, device).to(dtype), targets)
        total.backward()
    return ({k: float(v.detach()) for k, v in comps.items()},
            {n: p.grad.detach().cpu().double() for n, p in net.named_parameters()})


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-300))


def compare(grads: Dict[str, dict], bar: float = 1e-3, worst: int = 3) -> dict:
    """For every pair of gradient sets (``grads[side]``: parameter ->
    gradient): the relative L2 over the model and the number of parameters
    over ``bar``, the exact-zero ones (:data:`EXACT_ZERO`) left out, whose
    largest |g| against the largest gradient anywhere is reported instead;
    and the ``worst`` parameters of each side against the last one."""
    sides = list(grads)
    ref = grads[sides[-1]]
    zero = [n for n in ref if n.endswith(EXACT_ZERO)]
    rest = [n for n in ref if n not in zero]
    flat = {s: torch.cat([grads[s][n].reshape(-1) for n in rest]) for s in sides}
    largest = max(float(g.abs().max()) for g in ref.values())
    out = {"model_rel_l2": {}, "over": {}, "parameters": len(rest),
           "exact_zero": max([float(grads[s][n].abs().max()) for s in sides for n in zero]
                             or [0.0]) / largest}
    for i, a in enumerate(sides):
        for b in sides[i + 1:]:
            key = f"{a}-{b}"
            out["model_rel_l2"][key] = _rel(flat[a], flat[b])
            out["over"][key] = sum(_rel(grads[a][n], grads[b][n]) > bar for n in rest)
    for s in sides[:-1]:
        out[f"worst_{s}"] = sorted(((_rel(grads[s][n], ref[n]), n) for n in rest),
                                   reverse=True)[:worst]
    return out


def prepare(arch: str, size: int, steps: int, lr: float, max_steps: int, device):
    """(weights on the CPU, images, targets, loss settings) of the check: a
    seeded random init of ``arch`` (BatchNorm calibrated), trained ``steps``
    bfloat16 steps at ``lr`` on rendered scenes on ``device``, and the batch
    of the step."""
    from head_detector_tpu_torch.config import CONFIG_DIR, load_config, run_config_from_dict
    from head_detector_tpu_torch.flame import FlameModel
    from head_detector_tpu_torch.models import build_model, init_model
    from head_detector_tpu_torch.train import trainer as tt
    from head_detector_tpu_torch.train.dataset import SyntheticHeadsDataset, collate_samples

    name = arch if os.path.exists(os.path.join(CONFIG_DIR, f"{arch}.yaml")) else "yolo_heads_m"
    loss_cfg = run_config_from_dict(load_config(os.path.join(CONFIG_DIR, f"{name}.yaml"))).loss
    ds = SyntheticHeadsDataset(image_size=size, length=BATCH * (steps + 1), seed=3,
                               render=True, device=device)
    net = init_model(build_model(arch, deploy=False, dtype=torch.bfloat16).to(device),
                     torch.Generator().manual_seed(0), (size, size))
    if steps:
        cfg = tt.TrainConfig(lr_warmup_steps=0, initial_lr=lr, max_steps=max_steps)
        state = tt.TrainState(net, cfg)
        step = tt.make_train_step(net, FlameModel.from_assets(device=device), loss_cfg, cfg)
        for b in range(1, steps + 1):
            step(state, *collate_samples([ds[b * BATCH + i] for i in range(BATCH)], 30))
    weights = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    images, targets = collate_samples([ds[i] for i in range(BATCH)], 30)
    return weights, images, targets, loss_cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="segformer",
                    help="the loss settings are the arch's config's, else yolo_heads_m's")
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--steps", type=int, default=0, help="bfloat16 steps before the check")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--max-steps", type=int, default=100,
                    help="the cosine schedule's length for those steps (no warmup)")
    ap.add_argument("--float64-convs", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from head_detector_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    weights, images, targets, loss_cfg = prepare(args.arch, args.size, args.steps, args.lr,
                                                 args.max_steps, dev)
    grads, comps = {}, {}
    for side, where, dtype, f64 in (("card", dev, torch.float32, args.float64_convs),
                                    ("cpu", torch.device("cpu"), torch.float32, ()),
                                    ("float64", torch.device("cpu"), torch.float64, ())):
        t0 = time.perf_counter()
        comps[side], grads[side] = step_gradients(args.arch, weights, images, targets, loss_cfg,
                                                  where, dtype, f64)
        print(f"[grad_precision] {side}: {time.perf_counter() - t0:.1f} s, loss "
              f"{comps[side]['loss']:.6f}", flush=True)
    out = compare(grads)
    out["loss_rel"] = max(abs(comps["card"][k] - comps["cpu"][k]) / max(abs(comps["cpu"][k]),
                                                                        1e-12)
                          for k in comps["cpu"] if k.startswith("loss"))
    print(f"[grad_precision] {args.arch} at {args.size} px, batch {BATCH}, {args.steps} "
          f"steps at lr {args.lr:g}, float64 convs {args.float64_convs or 'none'}: {out}")
    return out


if __name__ == "__main__":
    main()
