"""Port model and weights on the CPU: the deploy-fused YoloHeads forward
against flax ``apply``, the msgpack reader against flax's, and the shipped
yolo_heads_m checkpoint through ``state_dict_from_flax``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu.export import build_deploy
from head_detector_tpu.models import build_model as jax_build_model
from head_detector_tpu.models import init_model
from head_detector_tpu_torch import weights
from head_detector_tpu_torch.models import build_model, get_arch

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "checkpoints", "flagship_ema.msgpack")


@pytest.fixture(scope="module")
def n_variables():
    model = jax_build_model("yolo_heads_n")
    variables = init_model(model, jax.random.PRNGKey(0), (64, 64))
    return jax.tree_util.tree_map(np.asarray, variables)


def _port_model(variables, arch, serving=True):
    state, used = weights.state_dict_from_flax(variables, arch)
    assert used == weights.count_leaves(variables)
    net = build_model(arch, defer_globalization=serving, skip_flame=serving)
    net.load_state_dict(state, strict=True)
    return net.eval()


@pytest.mark.parametrize("size,serving", [(64, True), (160, True), (64, False)])
def test_forward_matches_flax(n_variables, size, serving):
    """serving: FLAME towers skipped and globalisation deferred (the
    detector's form); otherwise the dense globalised 413-vector per anchor."""
    arch = get_arch("yolo_heads_n")
    model, fused = build_deploy("yolo_heads_n", n_variables, dtype=jnp.float32,
                                defer_globalization=serving, skip_flame=serving)
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    dec_j, raw_j, feats_j = model.apply(fused, jnp.asarray(x), train=False,
                                        return_feats=True)
    net = _port_model(n_variables, arch, serving)
    with torch.no_grad():
        dec_t, raw_t, feats_t = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                                    return_feats=True)

    for fj, ft in zip(feats_j, feats_t):
        fj = np.asarray(fj)
        ft = ft.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(ft, fj, atol=1e-4 * np.abs(fj).max())
    # float32 sums in another order through ~70 conv layers: logits agree to
    # ~1e-4 relative; a DFL expectation times stride 32 turns that into
    # hundredths of a pixel, far inside the IoU >= 0.99 bar
    np.testing.assert_allclose(dec_t.scores.numpy(), np.asarray(dec_j.scores),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(dec_t.boxes_xyxy.numpy(), np.asarray(dec_j.boxes_xyxy),
                               atol=0.1)
    if serving:
        assert dec_t.flame_params.shape == (2, dec_j.scores.shape[1], 0)
    else:
        # the towers of these random weights see the same float32 reassociation
        np.testing.assert_allclose(dec_t.flame_params.numpy(),
                                   np.asarray(dec_j.flame_params), rtol=1e-3, atol=5e-3)
    np.testing.assert_array_equal(raw_t.anchor_points.numpy(),
                                  np.asarray(raw_j.anchor_points))
    np.testing.assert_array_equal(raw_t.stride_tensor.numpy(),
                                  np.asarray(raw_j.stride_tensor))


def test_reader_matches_flax_and_restores_every_leaf():
    from flax import serialization

    got = weights.load_variables(CKPT)
    with open(CKPT, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_got) == len(flat_want) == 1273
    for (pg, g), (pw, w) in zip(flat_got, flat_want):
        assert pg == pw and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)

    arch = get_arch("yolo_heads_m")
    state, used = weights.state_dict_from_flax(got, arch)
    assert (used, weights.count_leaves(got)) == (1273, 1273)
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.values())
    net = build_model(arch, defer_globalization=True, skip_flame=True)
    net.load_state_dict(state, strict=True)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 128, 128).astype(np.float32))
    with torch.no_grad():
        dec, raw, feats = net.eval()(x, return_feats=True)
    assert dec.boxes_xyxy.shape == (1, 16 * 16 + 8 * 8 + 4 * 4, 4)
    assert torch.isfinite(dec.boxes_xyxy).all() and torch.isfinite(dec.scores).all()
    assert [f.shape[1] for f in feats] == list(net.neck.out_channels)


@pytest.mark.parametrize("compacted", [False, True])
def test_sparse_flame_rows_match_jax(n_variables, compacted):
    from head_detector_tpu.export import fuse_qarepvgg
    from head_detector_tpu.models.presets import get_arch as jax_get_arch
    from head_detector_tpu.ops.sparse_towers import sparse_flame_rows as jax_rows
    from head_detector_tpu_torch.ops.sparse_towers import extract_patches, sparse_flame_rows

    arch = get_arch("yolo_heads_n")
    net = _port_model(n_variables, arch)
    rng = np.random.RandomState(7)
    # neck maps of a 64 px input: strides 8/16/32 -> 8x8, 4x4, 2x2
    feats = [rng.rand(3, ch, s, s).astype(np.float32)
             for ch, s in zip(net.neck.out_channels, (8, 4, 2))]
    # corners and centers of every scale (64 + 16 + 4 anchors)
    idx = np.array([[0, 7, 36, 63, 64, 69, 79, 80, 81, 83],
                    [1, 8, 42, 56, 65, 75, 78, 80, 82, 83],
                    [9, 15, 48, 55, 66, 70, 71, 80, 82, 83]], np.int64)
    bidx = None
    if compacted:
        idx = idx.reshape(1, -1)
        bidx = rng.randint(0, 3, idx.shape)
    want = jax_rows(
        fuse_qarepvgg(n_variables, jax_get_arch("yolo_heads_n")),
        jax_get_arch("yolo_heads_n"),
        [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats],
        jnp.asarray(idx, jnp.int32),
        batch_idx=None if bidx is None else jnp.asarray(bidx, jnp.int32),
    )
    with torch.no_grad():
        got = sparse_flame_rows(
            net.heads, arch, [torch.from_numpy(f) for f in feats], torch.from_numpy(idx),
            batch_idx=None if bidx is None else torch.from_numpy(bidx),
        )
    want = np.asarray(want)
    assert got.shape == want.shape == idx.shape + (413,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    # patches: zero outside the map, the map inside it
    p = extract_patches(torch.from_numpy(feats[0]), torch.tensor([[0, 7]]).expand(3, 2),
                        torch.tensor([[0, 3]]).expand(3, 2), rf=5)
    padded = np.pad(feats[0], ((0, 0), (0, 0), (2, 2), (2, 2)))
    np.testing.assert_array_equal(p[1, 0].numpy(), padded[1, :, 0:5, 0:5])
    np.testing.assert_array_equal(p[2, 1].numpy(), padded[2, :, 7:12, 3:8])
