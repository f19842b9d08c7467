"""PyTorch port: the windowed correlation pyramid of ``raft/fs``
(``ops.windowed``, what its CUDA kernels are held against on the card) and
``ops.pool.avg_pool2d``, held against the JAX package on the CPU from the
same numpy inputs.

- the plain ``windowed_corr_pyramid`` against the JAX ``_wcp_reference``,
  forward and ``jax.vjp`` (df1, df2), float32 and bf16, and against the
  Pallas kernels in interpret mode (``_wcp_fwd_interpret`` /
  ``_wcp_bwd_interpret``, per-position and band forms); far out-of-bounds
  centres give exact zeros; coords get no gradient;
- ``mask_costs`` and ``normalize`` against the JAX ``windowed_corr_pyramid``;
- the plain forward, df1 and df2 against the Pallas kernels in
  interpret mode (per-position and band) in the two coordinate regimes
  the CUDA kernels tell apart (a smooth flow, whose 8x8 tiles of
  positions take their tile paths, and a motion boundary, whose tiles
  astride it take the direct or per-position path), and the kernels'
  rule for that choice (``tile_paths``) against a direct count at the
  side limits ``MAX_BOX``, 24 and 0 (the float32 forward's and df1's);
- the wrappers' check of ``path_counts``;
- ``avg_pool2d`` bit for bit in float32 and bf16;
- the kernel route refuses CPU tensors and counts nothing on the CPU.

Inputs: b2 16x24, C = 32, radius 4, 4 pooled levels, centres on the grid
plus a spread of 8 px and a few far out-of-bounds centres.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_meets_dicl_tpu.ops import pallas as jpallas
from raft_meets_dicl_tpu.ops.pool import avg_pool2d as javg_pool2d
from raft_meets_dicl_tpu_torch.ops import pool as tpool
from raft_meets_dicl_tpu_torch.ops import windowed as twindowed
from test_torch_port_train import _one_thread
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RADIUS = 4
LEVELS = 4
# the unnormalized correlation grows with |f1| |f2|: each check is
# |diff| <= ATOL_REL * max |expected| + ORDER_REL * S, S the same function
# of |f1| and |f2_l| (for df1, df2: of |dout| too), as on the card. Two
# float32 sums of the same n terms in other orders differ by at most
# 2 (n - 1) 2^-24 S; 2^-13 covers n <= 1,024 (C = 32 products per dot, up
# to 4 bilinear terms per tap and 81 taps per df1 or df2 element)
ATOL_REL = 1e-5
ORDER_REL = 2.0 ** -13
FAR = [(0, 0, 0, 1e4, -1e4), (1, 3, 5, -3e4, 5.5), (1, 9, 20, 40.0, 1e5)]


def _bf16_ulp(x):
    """Spacing of bfloat16 values at |x|: 2^(e - 7) for |x| in
    [2^e, 2^(e+1)); 0 at 0."""
    _, exp = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, exp - 8))


def _inputs(seed, dtype, b=2, h=16, w=24, c=32):
    """f1, f2 and coords as numpy float32 (bf16 inputs rounded once, so
    both packages see the same values); the level-0 grid plus a spread of
    8 px and the FAR centres."""
    rs = np.random.RandomState(seed)
    f1 = rs.randn(b, h, w, c).astype(np.float32)
    f2 = rs.randn(b, h, w, c).astype(np.float32)
    if dtype == "bfloat16":
        f1 = torch.from_numpy(f1).to(torch.bfloat16).float().numpy()
        f2 = torch.from_numpy(f2).to(torch.bfloat16).float().numpy()
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    coords = (np.stack([gx, gy], -1)[None].repeat(b, 0)
              + rs.randn(b, h, w, 2) * 8).astype(np.float32)
    for bi, y, x, cx, cy in FAR:
        if y < h and x < w:
            coords[bi, y, x] = (cx, cy)
    return f1, f2, coords


def _jax_levels(f2, dtype):
    levels = [jnp.asarray(f2, getattr(jnp, dtype))]
    for _ in range(LEVELS - 1):
        levels.append(javg_pool2d(levels[-1], 2))
    return tuple(levels)


def _torch_levels(f2, dtype, requires_grad=False):
    levels = [torch.from_numpy(f2).to(getattr(torch, dtype))]
    for _ in range(LEVELS - 1):
        levels.append(tpool.avg_pool2d(levels[-1], 2))
    if requires_grad:
        levels = [lvl.detach().requires_grad_(True) for lvl in levels]
    return levels


def _check(actual, expected, scale, bf16=False):
    """|actual - expected| <= ATOL_REL max|expected| + ORDER_REL * scale
    (+ one bf16 ulp of the larger value for a bf16 result)."""
    a = actual.detach().float().numpy()
    e = np.asarray(expected, np.float32)
    assert a.shape == e.shape
    bound = ATOL_REL * np.abs(e).max() + ORDER_REL * np.asarray(scale)
    if bf16:
        bound = bound + _bf16_ulp(np.maximum(np.abs(a), np.abs(e)))
    assert np.all(np.abs(a - e) <= bound), float(np.abs(a - e).max())


def _plain_with_scale(f1, levels, coords, dout=None):
    """The plain pyramid, and S: the same function of |f1| and |f2_l| (with
    ``dout``: the gradients of |dout| there)."""
    t1 = torch.from_numpy(f1).abs().requires_grad_(True)
    tl = [torch.from_numpy(np.array(lvl, np.float32)).abs()
          .requires_grad_(True) for lvl in levels]
    s = twindowed.windowed_corr_pyramid_reference(t1, tl, coords, RADIUS)
    if dout is None:
        return s.detach()
    return torch.autograd.grad(s, [t1, *tl], dout.abs())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_wcp_matches_jax_reference(dtype):
    f1, f2, coords = _inputs(3, dtype)
    jlevels = _jax_levels(f2, dtype)
    jf1 = jnp.asarray(f1, getattr(jnp, dtype))
    jc = jnp.asarray(coords)
    expected = jpallas._wcp_reference(jf1, jlevels, jc, RADIUS)

    tf1 = torch.from_numpy(f1).to(getattr(torch, dtype)).requires_grad_(True)
    tlevels = _torch_levels(f2, dtype, requires_grad=True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    before = (twindowed.launches, twindowed.df1_launches,
              twindowed.df2_launches)
    actual = twindowed.windowed_corr_pyramid(tf1, tlevels, tc, RADIUS,
                                             normalize=False)
    assert actual.dtype == torch.float32
    assert tuple(actual.shape) == (2, 16, 24, LEVELS * 81)
    levels_f32 = [np.asarray(lvl, np.float32) for lvl in jlevels]
    _check(actual, expected,
           _plain_with_scale(f1, levels_f32, torch.from_numpy(coords)))
    # a window wholly outside f2 is exact zeros at every level
    for bi, y, x, _, _ in FAR:
        assert torch.all(actual[bi, y, x] == 0)

    # the gradients against jax.vjp of the reference, in float32 (the bf16
    # jax.vjp sums the gather's cotangent in bf16; the port, as the JAX
    # TPU kernels, sums in float32 and rounds once)
    dout = np.random.RandomState(4).randn(*actual.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jpallas._wcp_reference(a, b, jc, RADIUS),
                     jnp.asarray(f1), tuple(jnp.asarray(lvl)
                                            for lvl in levels_f32))
    jdf1, jdf2 = vjp(jnp.asarray(dout))
    with _one_thread():
        actual.backward(torch.from_numpy(dout))
    scales = _plain_with_scale(f1, levels_f32, torch.from_numpy(coords),
                               torch.from_numpy(dout))
    bf16 = dtype == "bfloat16"
    assert tf1.grad.dtype == tf1.dtype
    _check(tf1.grad, jdf1, scales[0], bf16)
    for lvl, exp, scale in zip(tlevels, jdf2, scales[1:]):
        assert lvl.grad.dtype == lvl.dtype
        _check(lvl.grad, exp, scale, bf16)
    assert tc.grad is None
    assert (twindowed.launches, twindowed.df1_launches,
            twindowed.df2_launches) == before


@pytest.mark.parametrize("band", [False, True], ids=["per-position", "band"])
def test_plain_wcp_matches_pallas_interpret(band):
    """The TPU kernels in interpret mode: forward, df1 and every df2 level
    (float32 outputs before the cast)."""
    f1, f2, coords = _inputs(5, "float32", h=8, w=12)
    jlevels = _jax_levels(f2, "float32")
    jf1, jc = jnp.asarray(f1), jnp.asarray(coords)
    kernel = jpallas._wcp_fwd_interpret(jf1, jlevels, jc, RADIUS, band=band)

    tf1 = torch.from_numpy(f1).requires_grad_(True)
    tlevels = _torch_levels(f2, "float32", requires_grad=True)
    tc = torch.from_numpy(coords)
    actual = twindowed.windowed_corr_pyramid_reference(tf1, tlevels, tc,
                                                       RADIUS)
    levels_f32 = [np.asarray(lvl) for lvl in jlevels]
    _check(actual, kernel, _plain_with_scale(f1, levels_f32, tc))

    dout = np.random.RandomState(6).randn(*actual.shape).astype(np.float32)
    df1, df2 = jpallas._wcp_bwd_interpret(jf1, jlevels, jc,
                                          jnp.asarray(dout), RADIUS,
                                          band=band)
    with _one_thread():
        grads = torch.autograd.grad(actual, [tf1, *tlevels],
                                    torch.from_numpy(dout))
    scales = _plain_with_scale(f1, levels_f32, tc, torch.from_numpy(dout))
    _check(grads[0], df1, scales[0])
    assert len(df2) == LEVELS
    for got, exp, scale in zip(grads[1:], df2, scales[1:]):
        _check(got, exp, scale)


def _df2_inputs(regime, dtype, c, seed=11):
    """f1, f2 (level 0) and coords for one b1 8x96 grid as numpy float32
    (bf16 inputs rounded once): the grid plus a smooth flow of a few px;
    with ``"boundary"`` the positions from x = 60 on move 44 px left, so
    the tile astride x = 60 spans a box wider than MAX_BOX."""
    h, w = 8, 96
    rs = np.random.RandomState(seed)
    f1 = rs.randn(1, h, w, c).astype(np.float32)
    f2 = rs.randn(1, h, w, c).astype(np.float32)
    if dtype == "bfloat16":
        f1 = torch.from_numpy(f1).to(torch.bfloat16).float().numpy()
        f2 = torch.from_numpy(f2).to(torch.bfloat16).float().numpy()
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    phase = rs.rand(2) * 2 * np.pi
    u = 3 * np.sin(2 * np.pi * gx / w + phase[0])
    v = 2 * np.cos(2 * np.pi * gy / h + phase[1])
    if regime == "boundary":
        u = u - 44.0 * (gx >= 60)
    coords = np.stack([gx + u, gy + v], -1)[None].astype(np.float32)
    return f1, f2, coords


REGIMES = ("smooth", "boundary")


@functools.lru_cache(maxsize=None)
def _df2_pallas(dtype, c):
    """Both regimes as one batch of two images (the smooth one first) and
    the Pallas forward, df1 and df2 of its two levels in interpret mode
    (float32 before the cast), per-position and band kernels, computed
    once per dtype and C: f1, f2, coords, dout (numpy) and, per band
    form, the JAX forward, df1 and df2 levels."""
    f1, f2, coords = (np.concatenate(x) for x in zip(
        *(_df2_inputs(regime, dtype, c) for regime in REGIMES)))
    dout = np.random.RandomState(12).randn(2, 8, 96, 2 * 81) \
        .astype(np.float32)
    jdt = getattr(jnp, dtype)
    jf1, jc = jnp.asarray(f1, jdt), jnp.asarray(coords)
    jlevels = (jnp.asarray(f2, jdt), javg_pool2d(jnp.asarray(f2, jdt), 2))
    kernels = []
    for band in (False, True):
        fwd = jpallas._wcp_fwd_interpret(jf1, jlevels, jc, RADIUS, band=band)
        df1, df2 = jpallas._wcp_bwd_interpret(jf1, jlevels, jc,
                                              jnp.asarray(dout), RADIUS,
                                              band=band)
        kernels.append((np.asarray(fwd), np.asarray(df1),
                        [np.asarray(x) for x in df2]))
    return f1, f2, coords, dout, kernels


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_df2_matches_pallas_interpret_in_both_tile_regimes(dtype, c,
                                                                 regime):
    """The forward, df1 and df2 of two levels, the plain version and its
    autograd against the Pallas kernels in interpret mode (per-position
    and band; float32 before the cast), at the coordinates whose tiles the
    CUDA kernels take down their tile paths (smooth: every tile) or per
    position / directly (astride the boundary). Bound: 1e-5 max|expected|
    + 2^-13 S, S the plain function of |f1|, |f2_l| (gradients: and
    |dout|), plus one bf16 ulp where the plain gradient is bf16 (it
    rounds once)."""
    f1, f2, coords, dout, kernels = _df2_pallas(dtype, c)
    b = REGIMES.index(regime)
    tc = torch.from_numpy(coords)
    tf2 = torch.from_numpy(f2).to(getattr(torch, dtype))
    tlevels = [tf2, tpool.avg_pool2d(tf2, 2)]
    paths = [twindowed.tile_paths(tc[b:b + 1], lvl, *x.shape[1:3],
                                  twindowed.MAX_BOX)
             for lvl, x in enumerate(tlevels)]
    if regime == "smooth":
        assert all(p[1] == 0 and p[0] > 0 for p in paths), paths
    else:
        assert paths[0][1] >= 1 and paths[0][0] >= 1, paths

    bf16 = dtype == "bfloat16"
    tf1 = torch.from_numpy(f1).to(getattr(torch, dtype)).requires_grad_(True)
    tlevels = [x.detach().requires_grad_(True) for x in tlevels]
    with _one_thread():
        out = twindowed.windowed_corr_pyramid_reference(tf1, tlevels, tc,
                                                        RADIUS)
        grads = torch.autograd.grad(out, [tf1, *tlevels],
                                    torch.from_numpy(dout))
    levels_f32 = [x.detach().float().numpy() for x in tlevels]
    fwd_scale = _plain_with_scale(f1, levels_f32, tc)
    scales = _plain_with_scale(f1, levels_f32, tc, torch.from_numpy(dout))
    assert all(got.dtype == getattr(torch, dtype) for got in grads)
    for jfwd, jdf1, jdf2 in kernels:
        _check(out[b], jfwd[b], fwd_scale[b])
        _check(grads[0][b], jdf1[b], scales[0][b], bf16=bf16)
        assert len(jdf2) == 2
        for got, exp, scale in zip(grads[1:], jdf2, scales[1:]):
            _check(got[b], exp[b], scale[b], bf16=bf16)


def _rule_coords(level):
    """b2 13x77 centres for the path rule: the grid plus a spread of 12
    px, one tile wholly outside, one corner of far-flung windows."""
    b, h, w = 2, 13, 77
    rs = np.random.RandomState(20 + level)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = (np.stack([gx, gy], -1)[None].repeat(b, 0)
              + rs.randn(b, h, w, 2) * 12).astype(np.float32)
    coords[0, :8, :8] += 400.0                  # one tile wholly outside
    coords[1, 8:, 72:] = rs.rand(5, 5, 2) * 70  # far-flung windows
    return coords


def _direct_tile_paths(coords, level, h2, w2, max_box):
    """The tiles per path counted tile by tile: each tile's box of
    in-bounds taps at the level, tile path when both sides are at most
    ``max_box``, and tiles with no in-bounds tap apart."""
    b, h, w, _ = coords.shape
    expected = [0, 0, 0]
    c = np.clip(coords / 2 ** level, -5.0, None)
    cx = np.minimum(c[..., 0], w2 + 4.0)
    cy = np.minimum(c[..., 1], h2 + 4.0)
    x0 = np.floor(cx).astype(int) - 4
    y0 = np.floor(cy).astype(int) - 4
    t = twindowed.TILE
    for bi in range(b):
        for ty in range(0, h, t):
            for tx in range(0, w, t):
                xs, ys = x0[bi, ty:ty + t, tx:tx + t], y0[bi, ty:ty + t,
                                                          tx:tx + t]
                lo_x, hi_x = np.maximum(xs, 0), np.minimum(xs + 9, w2 - 1)
                lo_y, hi_y = np.maximum(ys, 0), np.minimum(ys + 9, h2 - 1)
                live = (lo_x <= hi_x) & (lo_y <= hi_y)
                if not live.any():
                    expected[2] += 1
                    continue
                fits = (hi_y[live].max() - lo_y[live].min() + 1 <= max_box
                        and hi_x[live].max() - lo_x[live].min() + 1
                        <= max_box)
                expected[0 if fits else 1] += 1
    return expected


@pytest.mark.parametrize("level", [0, 1, 2])
def test_df2_tile_paths_counts_each_tile_once(level):
    """The rule that picks df2's path (``tile_paths`` at MAX_BOX),
    against a direct count over the tiles; ragged tiles at the grid's edge
    and far centres included."""
    coords = _rule_coords(level)
    b, h, w, _ = coords.shape
    h2, w2 = h >> level, w >> level
    t = twindowed.TILE
    got = twindowed.tile_paths(torch.from_numpy(coords), level, h2, w2,
                               twindowed.MAX_BOX)
    assert list(got) == _direct_tile_paths(coords, level, h2, w2,
                                           twindowed.MAX_BOX)
    # level 0's boxes are wider than MAX_BOX in places, the coarser
    # levels' are not; one tile has no in-bounds tap at any level
    assert got[1] > 0 if level == 0 else got[1] == 0
    assert got[2] == 1
    assert sum(got) == b * -(-h // t) * -(-w // t)


@pytest.mark.parametrize("max_box", [0, 24])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_tile_paths_counts_each_tile_once_at_each_side_limit(level, max_box):
    """``tile_paths`` below MAX_BOX (the test above) against the same
    direct count: at 0 (the float32 forward and df1) no tile takes the
    tile path, at 24 some fewer do; the empty tiles never depend on the
    limit."""
    coords = _rule_coords(level)
    b, h, w, _ = coords.shape
    h2, w2 = h >> level, w >> level
    got = twindowed.tile_paths(torch.from_numpy(coords), level, h2, w2,
                               max_box)
    assert list(got) == _direct_tile_paths(coords, level, h2, w2, max_box)
    assert got[2] == 1
    if max_box == 0:
        assert got[0] == 0


def test_path_counts_argument_is_checked():
    """The wrappers' ``path_counts``: None counts nothing; otherwise rows
    of 3 contiguous int32 values, one row a level, on the inputs'
    device."""
    cpu = torch.device("cpu")
    assert twindowed._path_counts_arg(None, 4, cpu) is None
    good = torch.zeros(4, 3, dtype=torch.int32)
    assert twindowed._path_counts_arg(good, 4, cpu) == good.data_ptr()
    for bad in (torch.zeros(4, 3, dtype=torch.int64),
                torch.zeros(3, 3, dtype=torch.int32),
                torch.zeros(3, 4, dtype=torch.int32).t(),
                torch.zeros(4, 3, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="path_counts"):
            twindowed._path_counts_arg(bad, 4, cpu)


@pytest.mark.parametrize("mask_costs,normalize", [
    ((), True), ((3,), False), ((4, 6), True), ((5, 6), False)])
def test_wcp_mask_costs_and_normalize_match_jax(mask_costs, normalize):
    """Level masking by pyramid level id (l + 3) and the 1/sqrt(C) scale,
    against the public JAX ``windowed_corr_pyramid``."""
    f1, f2, coords = _inputs(7, "float32")
    jlevels = _jax_levels(f2, "float32")
    expected = jpallas.windowed_corr_pyramid(
        jnp.asarray(f1), jlevels, jnp.asarray(coords), RADIUS,
        mask_costs=mask_costs, normalize=normalize)
    actual = twindowed.windowed_corr_pyramid(
        torch.from_numpy(f1), _torch_levels(f2, "float32"),
        torch.from_numpy(coords), RADIUS, mask_costs=mask_costs,
        normalize=normalize)
    scale = _plain_with_scale(f1, [np.asarray(lvl) for lvl in jlevels],
                              torch.from_numpy(coords))
    if normalize:
        scale = scale / np.sqrt(f1.shape[-1])
    _check(actual, expected, scale)
    for lvl in range(LEVELS):
        chunk = actual[..., lvl * 81:(lvl + 1) * 81]
        assert bool(torch.all(chunk == 0)) == (lvl + 3 in mask_costs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 24, 32), (1, 7, 9, 5),
                                   (3, 1, 2, 8)])
def test_avg_pool2d_bit_exact(dtype, shape):
    """The JAX pool sums the 2x2 window in the input dtype, row-major, then
    divides by 4: under bf16 that differs from a float32 mean, and the port
    matches it bit for bit (odd sizes drop the last row / column)."""
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    expected = np.asarray(javg_pool2d(jnp.asarray(x, getattr(jnp, dtype)), 2)
                          .astype(jnp.float32))
    actual = tpool.avg_pool2d(torch.from_numpy(x).to(getattr(torch, dtype)),
                              2)
    assert actual.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(actual.float().numpy(), expected)


def test_wcp_kernel_route_refuses_cpu_tensors():
    """The kernel entry points take CUDA tensors only; on the CPU the
    public op takes the plain version and launches nothing."""
    f1, f2, coords = _inputs(9, "float32", h=4, w=6)
    tf1, tc = torch.from_numpy(f1), torch.from_numpy(coords)
    levels = _torch_levels(f2, "float32")[:2]
    dout = torch.zeros(2, 4, 6, 2 * 81)
    for call in (lambda: twindowed._launch(tf1, levels, tc, RADIUS),
                 lambda: twindowed._launch_df1(dout, tf1, levels, tc, RADIUS),
                 lambda: twindowed._launch_df2(dout, tf1, levels[1], tc, 1, 2,
                                               RADIUS)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    before = (twindowed.launches, twindowed.df1_launches,
              twindowed.df2_launches)
    twindowed.windowed_corr_pyramid(tf1, levels, tc, RADIUS)
    assert (twindowed.launches, twindowed.df1_launches,
            twindowed.df2_launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        twindowed.windowed_corr_pyramid(tf1.to("meta"),
                                        [x.to("meta") for x in levels],
                                        tc.to("meta"), RADIUS)
