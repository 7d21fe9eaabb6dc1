"""The port's export surface against the JAX package on the CPU: QARepVGG
fusion, the space-to-depth stem, the deploy model, ``param_count``, the
serialized program, the SuperGradients state dict, the ``.trcd`` TorchScript
and the demo's CLI.

Inputs: yolo_heads_n with the random weights of ``tests/test_torch_mirror.py``
(``_randomize``: small weights, BatchNorm statistics off the init point, the
network where the mirror's bars were set) as a flax tree of float32 numpy
leaves, fed to both packages; images from seeded ``RandomState``s.  Bars: the fused
tree within 1e-6 relative of JAX's; ``s2d_stem_kernel`` bit-equal; the s2d
deploy model within 1e-5 (relative to each output's largest magnitude) of
the dense one; the deploy model at the bars of ``tests/test_torch_model.py``;
the SuperGradients state dict equal, key for key and bit for bit, to the JAX
mirror's ``state_dict()``; the port's ``.trcd`` against the JAX mirror's at
the bars of ``tests/test_torch_mirror.py`` (scores 1e-4, boxes 2e-3 + 1e-4
relative, flame 2e-3 + 1e-3 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu import export as jax_export
from head_detector_tpu.models import param_count as jax_param_count
from head_detector_tpu.models import presets as jax_presets
from head_detector_tpu.torch_mirror import build_torch_mirror, load_flax_variables
from head_detector_tpu.torch_mirror import export_torchscript as jax_export_torchscript
from head_detector_tpu_torch import export, torch_mirror
from head_detector_tpu_torch.detector import random_variables
from head_detector_tpu_torch.models import get_arch, param_count
from head_detector_tpu_torch.tools.convert_torch_checkpoint import convert
from test_model import TINY
from test_torch_mirror import _randomize
from test_torch_options import M_CHECKPOINT, port_arch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "yolo_heads_n"
SIZE = 64


def mirror_variables(arch: str, seed: int = 0) -> dict:
    """A flax tree of the JAX mirror's ``_randomize`` weights."""
    mirror = build_torch_mirror(arch)
    _randomize(mirror, seed)
    tree, _ = convert(mirror.state_dict())
    return tree


@pytest.fixture(scope="module")
def variables():
    return mirror_variables(ARCH)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(5).rand(2, SIZE, SIZE, 3).astype(np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_fuse_qarepvgg_matches_jax(variables):
    got = _flat(export.fuse_qarepvgg(variables, get_arch(ARCH)))
    want = _flat(jax_export.fuse_qarepvgg(variables, jax_presets.get_arch(ARCH)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_s2d_stem_kernel_bit_equal_and_exact():
    """The kernel re-lay equals JAX's bit for bit, and the space-to-depth
    form (the JAX channel order, not pixel_unshuffle's) computes the dense
    3x3/s2 conv."""
    r = np.random.RandomState(0)
    w = r.randn(3, 3, 3, 8).astype(np.float32)
    k = export.s2d_stem_kernel(w)
    np.testing.assert_array_equal(k, jax_export.s2d_stem_kernel(w))

    from head_detector_tpu_torch.models.blocks import BlockCfg, QARepVGGBlock

    x = torch.from_numpy(r.rand(2, 3, 16, 16).astype(np.float32))
    dense = torch.nn.functional.conv2d(x, torch.from_numpy(w.transpose(3, 2, 0, 1)),
                                       stride=2, padding=1)
    block = QARepVGGBlock(3, 8, stride=2, use_act=False, s2d=True, cfg=BlockCfg())
    with torch.no_grad():
        block.rbr_reparam.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        block.rbr_reparam.bias.zero_()
        s2d = block(x)
    np.testing.assert_allclose(s2d.numpy(), dense.numpy(), rtol=1e-6, atol=1e-6)
    unshuffled = torch.nn.functional.pixel_unshuffle(x, 2)
    assert not torch.equal(unshuffled, x.reshape(2, 3, 8, 2, 8, 2).permute(
        0, 3, 5, 1, 2, 4).reshape(2, 12, 8, 8))


def test_s2d_deploy_model_matches_dense(variables, images):
    """The stem's output (where the two forms differ) within 1e-6 and each
    decoded output within 1e-5 of its largest magnitude."""
    dense, _ = export.build_deploy(ARCH, variables, device="cpu")
    s2d, fused = export.build_deploy(ARCH, variables, s2d_stem=True, device="cpu")
    assert fused["params"]["backbone"]["stem"]["conv"]["rbr_reparam"]["kernel"].shape[:3] \
        == (2, 2, 12)
    x = _nchw(images)
    with torch.no_grad():
        stem_d, stem_s = dense.backbone.stem(x), s2d.backbone.stem(x)
        want, _ = dense(x)
        got, _ = s2d(x)
    np.testing.assert_allclose(stem_s.numpy(), stem_d.numpy(), rtol=0,
                               atol=1e-6 * float(stem_d.abs().max()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("serving", [False, True])
def test_build_deploy_matches_jax(variables, images, serving):
    model, fused = export.build_deploy(ARCH, variables, device="cpu",
                                       defer_globalization=serving, skip_flame=serving)
    jmodel, jfused = jax_export.build_deploy(ARCH, variables, dtype=jnp.float32,
                                             defer_globalization=serving, skip_flame=serving)
    assert _flat(fused).keys() == _flat(jax.tree_util.tree_map(np.asarray, jfused)).keys()
    dec_j, _ = jmodel.apply(jfused, jnp.asarray(images), train=False)
    with torch.no_grad():
        dec_t, _ = model(_nchw(images))
    np.testing.assert_allclose(dec_t.scores.numpy(), np.asarray(dec_j.scores),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(dec_t.boxes_xyxy.numpy(), np.asarray(dec_j.boxes_xyxy),
                               atol=0.1)
    if not serving:
        np.testing.assert_allclose(dec_t.flame_params.numpy(),
                                   np.asarray(dec_j.flame_params), rtol=1e-3, atol=5e-3)


def test_param_count_equals_jax(variables):
    fused = export.fuse_qarepvgg(variables, get_arch(ARCH))
    for tree in (variables, fused, fused["params"]):
        assert param_count(tree) == int(jax_param_count(tree))
    assert param_count(fused) < param_count(variables)


def test_export_serialized_round_trip(tmp_path):
    """TINY's deploy model through torch.export and back, at the examples'
    shape: the same outputs as the eager model."""
    tiny = random_variables(port_arch(TINY), SIZE, "cpu")
    model, _ = export.build_deploy(port_arch(TINY), tiny, device="cpu")
    wrapped = torch_mirror.DecodedOutputs(model).eval()
    x = _nchw(np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32))
    path = str(tmp_path / "tiny.pt2")
    export.export_serialized(wrapped, (x,), path)
    restored = export.load_serialized(path)
    with torch.no_grad():
        want = wrapped(x)
        got = restored(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()))


def test_sg_state_dict_equals_jax_mirror_and_round_trips(variables):
    got = torch_mirror.sg_state_dict(variables, ARCH)
    mirror = build_torch_mirror(ARCH)
    load_flax_variables(mirror, variables)
    want = mirror.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k

    tree, notes = convert(got)
    assert not [n for n in notes if n.startswith(("dropped", "UNFOLDED"))]
    back, orig = _flat(tree), _flat(variables)
    assert back.keys() == orig.keys()
    for k, v in orig.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_trcd_matches_jax_mirror_trcd(variables, tmp_path):
    """The port's .trcd (its deploy model traced on the CPU) against the JAX
    mirror's .trcd of the same variables; the trace keeps the batch dynamic
    and equals the eager model."""
    port_path, jax_path = str(tmp_path / "port.trcd"), str(tmp_path / "jax.trcd")
    loaded = torch_mirror.export_torchscript(ARCH, variables, port_path,
                                             image_size=(SIZE, SIZE), device="cpu")
    jax_export_torchscript(ARCH, variables, jax_path, image_size=(SIZE, SIZE))
    reference = torch.jit.load(jax_path)
    x = _nchw(np.random.RandomState(2).rand(2, SIZE, SIZE, 3).astype(np.float32))
    eager = torch_mirror.decoded_outputs(ARCH, variables)
    with torch.no_grad():
        tb, ts, tf = loaded(x)
        jb, js, jf = reference(x)
        eb, es, ef = eager(x)
    assert tb.shape == (2, jb.shape[1], 4) and tf.shape[-1] == 413
    np.testing.assert_allclose(ts.numpy(), js.numpy(), atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), jb.numpy(), atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(tf.numpy(), jf.numpy(), atol=2e-3, rtol=1e-3)
    for got, want in ((tb, eb), (ts, es), (tf, ef)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_demo_cli_writes_every_render(tmp_path, capsys):
    import cv2

    from head_detector_tpu_torch import demo
    from head_detector_tpu_torch.train.dataset import render_scene

    scene = render_scene(11, 0, 640, 3, device="cpu")
    image = str(tmp_path / "scene.png")
    cv2.imwrite(image, cv2.cvtColor(scene, cv2.COLOR_RGB2BGR))
    out = tmp_path / "renders"
    demo.main(["--image", image, "--out-dir", str(out), "--model", "yolo_heads_m",
               "--checkpoint", M_CHECKPOINT, "--device", "cpu"])
    for mode in demo.DRAW_MODES:
        render = cv2.imread(str(out / f"{mode}.jpg"))
        assert render is not None and render.shape == scene.shape, mode
    heads = int(capsys.readouterr().out.split(";")[1].split()[0])
    assert heads > 0
