"""PyTorch port: ``ops/corr.py`` and ``ops/upsample.py`` held against the
JAX package's ops on the CPU, float32, at small shapes. Inputs are made
with numpy from a seed and fed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_meets_dicl_tpu.ops import corr as jcorr
from raft_meets_dicl_tpu.ops import upsample as jup
from raft_meets_dicl_tpu_torch.ops import corr as tcorr
from raft_meets_dicl_tpu_torch.ops import upsample as tup
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# float32 dot products over C <= 32 channels and bilinear weights summed in
# another order: errors stay at a few ulps of O(1..10) values
ATOL = 2e-5


def _close(actual, expected, atol=ATOL):
    np.testing.assert_allclose(actual.detach().numpy(), np.asarray(expected),
                               rtol=0, atol=atol)


def _feats(rs, shape):
    return rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 8, 12, 16), (1, 9, 13, 32)])
def test_correlation_pyramid_direct_matches_jax(shape):
    rs = np.random.RandomState(0)
    f1, f2 = _feats(rs, shape), _feats(rs, shape)
    expected = jcorr.correlation_pyramid_direct(jnp.asarray(f1),
                                                jnp.asarray(f2), 4)
    actual = tcorr.correlation_pyramid_direct(torch.from_numpy(f1),
                                              torch.from_numpy(f2), 4)
    assert len(actual) == len(expected) == 4
    for a, e in zip(actual, expected):
        assert tuple(a.shape) == e.shape
        _close(a, e)


@pytest.mark.parametrize("mask_costs", [(), (4,)])
def test_lookup_pyramid_levels_matches_jax(mask_costs):
    rs = np.random.RandomState(1)
    b, h, w, c = 2, 8, 12, 16
    f1, f2 = _feats(rs, (b, h, w, c)), _feats(rs, (b, h, w, c))
    # coords around the pixel grid, some windows reaching outside the map
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack((xs, ys), -1).astype(np.float32)
    coords = grid[None] + 3.0 * rs.randn(b, h, w, 2).astype(np.float32)

    jp = jcorr.correlation_pyramid_direct(jnp.asarray(f1), jnp.asarray(f2), 4)
    tp = tcorr.correlation_pyramid_direct(torch.from_numpy(f1),
                                          torch.from_numpy(f2), 4)
    expected = jcorr.lookup_pyramid_levels(jp, jnp.asarray(coords), 4,
                                           mask_costs)
    actual = tcorr.lookup_pyramid_levels(tp, torch.from_numpy(coords), 4,
                                         mask_costs)
    for a, e in zip(actual, expected):
        assert tuple(a.shape) == e.shape == (b, h, w, 9, 9)
        _close(a, e)

    # the flat (level, dx, dy) contract of the JAX lookup_pyramid
    flat = jcorr.lookup_pyramid(jp, jnp.asarray(coords), 4, mask_costs)
    _close(tcorr.flatten_levels(actual), flat)


def test_window_delta_matches_jax():
    # same layout; jnp.linspace lands within an ulp of the integer offsets
    _close(tcorr.window_delta(3), jcorr.window_delta(3), atol=1e-6)
    assert tcorr.window_delta(3)[0, 6].tolist() == [-3.0, 3.0]  # (dx, dy)


@pytest.mark.parametrize("shape", [(1, 4, 6, 2), (2, 5, 7, 3)])
def test_neighbors3x3_matches_jax(shape):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(
        tup._neighbors3x3(torch.from_numpy(x)).numpy(),
        np.asarray(jup._neighbors3x3(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convex_upsample_8x_matches_jax(dtype):
    rs = np.random.RandomState(3)
    b, h, w = 2, 5, 7
    flow = (2 * rs.randn(b, h, w, 2)).astype(np.float32)
    logits = (3 * rs.randn(b, h, w, 576)).astype(np.float32)
    tl = torch.from_numpy(logits)
    if dtype == "bfloat16":
        tl = tl.to(torch.bfloat16)
        logits = tl.float().numpy()
    jl = jnp.asarray(logits, jnp.bfloat16 if dtype == "bfloat16"
                     else jnp.float32)

    expected = jup.convex_upsample_8x(jnp.asarray(flow), jl)
    actual = tup.convex_upsample_8x(torch.from_numpy(flow), tl)
    assert tuple(actual.shape) == expected.shape == (b, 8 * h, 8 * w, 2)
    assert actual.dtype == torch.float32
    _close(actual, expected, atol=1e-4)  # 8x-scaled flows of ~20 px


def test_interpolate_bilinear_matches_jax():
    x = np.random.RandomState(4).randn(2, 5, 7, 2).astype(np.float32)
    _close(tup.interpolate_bilinear(torch.from_numpy(x), (40, 56)),
           jup.interpolate_bilinear(jnp.asarray(x), (40, 56)))
