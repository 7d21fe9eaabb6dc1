"""Port rasterizer: the plain torch version against the JAX golden (XLA) and
the Pallas kernel in interpret mode, on the CPU (the CUDA kernel against the
plain version is in test_torch_cuda.py).

Tolerances are those of tests/test_rasterize_pallas.py: hit agreement
>= 0.999 and |color| difference < 1e-4 on pixels both versions hit; against
the JAX versions, pixels under sliver triangles are exempt from the color
bound (see ``_sliver_pixels``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from head_detector_tpu.ops.rasterize import rasterize_zbuffer as jax_rasterize_zbuffer
from head_detector_tpu.ops.rasterize_pallas import rasterize_zbuffer_pallas
from head_detector_tpu_torch.ops import rasterize as port
from test_rasterize import _random_mesh


def _agree(color_a, hit_a, color_b, hit_b, exempt=None):
    """Hit agreement >= 0.999, |color| < 1e-4 on common hits outside ``exempt``."""
    color_a, hit_a, color_b, hit_b = map(np.asarray, (color_a, hit_a, color_b, hit_b))
    assert (hit_a == hit_b).mean() >= 0.999
    common = hit_a & hit_b
    if exempt is not None:
        common &= ~exempt
    if common.any():
        assert np.abs(color_a - color_b)[common].max() < 1e-4


def _port(vertices, triangles, colors, size, reverse=False):
    c, h = port.rasterize_zbuffer(
        torch.from_numpy(vertices), torch.from_numpy(triangles),
        torch.from_numpy(colors), height=size, width=size, reverse=reverse,
    )
    return c.numpy(), h.numpy()


def _sliver_pixels(vertices, triangles, colors, size):
    """Pixels a sliver triangle covers (sin^2 of its corner angle < 1e-3).
    Its weights carry float32 rounding times 1/sin^2, so two correct float32
    versions that round differently (XLA contracts to FMAs, the port does not)
    differ there by more than 1e-4 while agreeing on coverage; against float64
    truth both err by ~2e-4 at the worst such pixel of these meshes."""
    p = vertices[triangles, :2].astype(np.float64)
    v0, v1 = p[:, 2] - p[:, 0], p[:, 1] - p[:, 0]
    d00, d11 = (v0 * v0).sum(1), (v1 * v1).sum(1)
    d01 = (v0 * v1).sum(1)
    sliver = (d00 * d11 - d01 * d01) < 1e-3 * d00 * d11
    return _port(vertices, triangles[sliver], colors, size)[1]


@pytest.mark.parametrize("seed,size", [(0, 100), (1, 64), (2, 130)])
def test_plain_matches_xla_and_pallas(seed, size):
    rng = np.random.RandomState(seed)
    vertices, triangles, colors = _random_mesh(rng, 40, 200, size)
    args = (jnp.asarray(vertices), jnp.asarray(triangles, jnp.int32), jnp.asarray(colors))
    xla = jax_rasterize_zbuffer(*args, height=size, width=size)
    pal = rasterize_zbuffer_pallas(*args, height=size, width=size, tile=64, chunk=128,
                                   interpret=True)
    got = _port(vertices, triangles, colors, size)
    exempt = _sliver_pixels(vertices, triangles, colors, size)
    assert got[1].any() and exempt.mean() < 0.05
    _agree(*got, *xla, exempt=exempt)
    _agree(*got, *pal, exempt=exempt)


def test_plain_batched_heads_match_single():
    rng = np.random.RandomState(3)
    meshes = [_random_mesh(rng, 40, 120, 80) for _ in range(3)]
    triangles, colors = meshes[0][1], meshes[0][2]
    verts = np.stack([m[0] for m in meshes])
    c, h = port.rasterize_zbuffer(torch.from_numpy(verts), torch.from_numpy(triangles),
                                  torch.from_numpy(colors), height=80, width=80)
    for i in range(3):
        ci, hi = _port(verts[i], triangles, colors, 80)
        np.testing.assert_array_equal(h[i].numpy(), hi)
        np.testing.assert_array_equal(c[i].numpy(), ci)


def test_depth_tie_prefers_first_triangle():
    vertices = np.array(
        [[2, 2, 0.5], [30, 2, 0.5], [2, 30, 0.5], [2, 2, 0.5], [30, 2, 0.5], [2, 30, 0.5]],
        np.float32,
    )
    triangles = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    colors = np.zeros((6, 3), np.float32)
    colors[:3] = [1.0, 0.0, 0.0]
    colors[3:] = [0.0, 1.0, 0.0]
    c, h = _port(vertices, triangles, colors, 32)
    assert h[10, 10] and c[10, 10, 0] == 1.0 and c[10, 10, 1] == 0.0
    # the lower index wins whichever order the triangles come in
    c2, _ = _port(vertices, triangles[::-1].copy(), colors, 32)
    assert c2[10, 10, 1] == 1.0
    out = port.rasterize(vertices, triangles, colors, bg=np.zeros((32, 32, 3), np.uint8),
                         device="cpu")
    assert out[10, 10, 0] == 255 and out[10, 10, 1] == 0


def test_reverse_empty_and_degenerate():
    v = np.array([[2, 2, 0.5], [30, 2, 0.5], [2, 10, 0.5]], np.float32)
    t = np.array([[0, 1, 2]], np.int32)
    c = np.ones((3, 3), np.float32)
    a, ha = _port(v, t, c, 32)
    b, hb = _port(v, t, c, 32, reverse=True)
    np.testing.assert_array_equal(b, a[::-1])
    np.testing.assert_array_equal(hb, ha[::-1])
    assert ha[2:10].any() and not ha[11:].any()
    # empty mesh: nothing hit
    _, h0 = _port(np.zeros((1, 3), np.float32), np.zeros((0, 3), np.int32),
                  np.zeros((1, 3), np.float32), 32)
    assert not h0.any()
    # a degenerate (collinear) triangle and a duplicated vertex cover nothing
    vd = np.array([[1, 1, 0.5], [20, 20, 0.5], [10, 10, 0.5], [5, 25, 0.5]], np.float32)
    td = np.array([[0, 1, 2], [0, 3, 3]], np.int32)
    _, hd = _port(vd, td, np.ones((4, 3), np.float32), 32)
    assert not hd.any()


def test_rasterize_composite_matches_jax(monkeypatch):
    from head_detector_tpu.ops.rasterize import rasterize as jax_rasterize

    monkeypatch.setenv("HDT_RASTERIZER", "xla")
    rng = np.random.RandomState(4)
    vertices, triangles, colors = _random_mesh(rng, 30, 60, 48)
    bg = rng.randint(0, 255, (48, 48, 3), dtype=np.uint8)
    want = jax_rasterize(vertices, triangles, colors, bg=bg.copy(), alpha=0.6)
    got = port.rasterize(vertices, triangles, colors, bg=bg.copy(), alpha=0.6,
                         device="cpu")
    assert (np.abs(got.astype(int) - want.astype(int)).max(-1) > 1).mean() <= 0.001


def _host_composite(verts, triangles, colors, height, width):
    """The PNCC composite on the host, head by head as the reference does it:
    ``composite`` with alpha = 1, then ``mask = current.sum(2) != 0``."""
    canvas, hit = port.rasterize_zbuffer(
        torch.from_numpy(verts), torch.from_numpy(triangles), torch.from_numpy(colors),
        height=height, width=width)
    canvas, hit = canvas.numpy(), hit.numpy()
    image = np.zeros((height, width, 3), np.uint8)
    for i in range(len(verts)):
        current = port.composite(image, canvas[i], hit[i])
        mask = current.sum(2) != 0
        image[mask] = current[mask]
    return image, canvas, hit


@pytest.mark.parametrize("case", ["overlapping_heads", "zero_uint8_color", "no_heads",
                                  "non_square"])
def test_pncc_render_plain_matches_host_composite(case):
    rng = np.random.RandomState(5)
    height, width = (72, 110) if case == "non_square" else (96, 96)
    meshes = [_random_mesh(rng, 40, 150, min(height, width)) for _ in range(3)]
    triangles, colors = meshes[0][1], meshes[0][2]
    verts = np.stack([m[0] for m in meshes])
    if case == "zero_uint8_color":
        colors = colors * (rng.rand(len(colors), 1) > 0.6)  # most vertices black
    if case == "no_heads":
        verts = verts[:0]
    want, canvas, hit = _host_composite(verts, triangles, colors.astype(np.float32),
                                        height, width)
    got = port.pncc_render(torch.from_numpy(verts), torch.from_numpy(triangles),
                           torch.from_numpy(colors.astype(np.float32)), height, width)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (height, width, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "no_heads":
        assert not want.any()
        return
    assert want.any() and (hit.sum(0) >= 2).any()  # the heads overlap
    if case == "zero_uint8_color":
        # a later head hits a pixel with a color that casts to 0 and leaves
        # the earlier head's value there
        c8 = (255.0 * canvas).astype(np.uint8)
        black = hit[2] & (c8[2].sum(-1) == 0)
        earlier = (hit[0] & (c8[0].sum(-1) != 0)) | (hit[1] & (c8[1].sum(-1) != 0))
        assert (black & earlier).any()
        assert (want[black & earlier].sum(-1) != 0).all()


def test_index_range_is_read_once_per_table(monkeypatch):
    reads = []
    aminmax = torch.aminmax
    monkeypatch.setattr(torch, "aminmax", lambda t: reads.append(1) or aminmax(t))
    table = torch.tensor([[0, 1, 2], [2, 3, 1]], dtype=torch.int32)
    assert port._index_range(table) == (0, 3)
    assert port._index_range(table) == (0, 3) and len(reads) == 1
    table[0, 0] = 7  # written to: read again
    assert port._index_range(table) == (1, 7) and len(reads) == 2
    assert port._index_range(table.clone()) == (1, 7) and len(reads) == 3
