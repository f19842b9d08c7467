"""PyTorch port: the rest of the DICL family's modules held against the JAX
package on the CPU, from the same seeded numpy inputs and bridged weights
(``convert``'s rules; batch statistics drawn away from their (0, 1) init).

- ``ops.pool.max_pool2d`` bit for bit;
- the GA-Net blocks (``GaConv2xBlock``, ``GaConv2xBlockTransposed``),
  eval and live batch norm (output and running statistics);
- ``models/common/warp.py``'s ``warp_backwards``: the warped image and
  the mask, at the default and a wide ``eps``;
- the ``dicl-1x1``, ``dicl-emb`` and ``dot`` correlation modules with
  and without the DAP, eval and live batch norm, and all four cmods'
  readouts (``softargmax``, ``softargmax+dap``) through ``make_cmod`` /
  ``make_flow_regression``;
- every encoder family: ``dicl`` (s3, p34, the baseline's p26),
  ``raft-avgpool`` / ``raft-maxpool`` (p35, p34) and ``rfpm-raft`` (s3,
  p34), eval and live batch norm on an image pair (the GA-Net's
  statistics per image).

Tolerances: ``test_torch_port_dicl.py``'s MODULE_ATOL for the blocks and
cmods (float32 convolutions summed in another order through up to 8
conv/norm layers), ENCODER_REL for the deep encoders, and the running
statistics ``test_torch_port_ctf.py``'s STATS_ATOL. The port runs on one
thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_meets_dicl_tpu.models.common import corr as jcorr
from raft_meets_dicl_tpu.models.common import encoders as jenc
from raft_meets_dicl_tpu.models.common import warp as jwarp
from raft_meets_dicl_tpu.models.common.blocks import dicl as jdicl
from raft_meets_dicl_tpu.ops import pool as jpool
from raft_meets_dicl_tpu_torch import convert
from raft_meets_dicl_tpu_torch.models.common import corr as tcorr
from raft_meets_dicl_tpu_torch.models.common import encoders as tenc
from raft_meets_dicl_tpu_torch.models.common import warp as twarp
from raft_meets_dicl_tpu_torch.models.common.blocks import dicl as tdicl
from raft_meets_dicl_tpu_torch.ops import pool as tpool
from test_torch_port_ctf import STATS_ATOL
from test_torch_port_dicl import _close, _nchw
from test_torch_port_train import _one_thread
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


def _draw(path, leaf, rs):
    """A random value for a JAX variable: kernels lecun-scaled, biases
    and batch-norm scales near their init, batch statistics away from (0,
    1)."""
    name, shape = path[-1].key, leaf.shape
    if name == "kernel":
        value = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    elif name == "bias":
        value = 0.1 * rs.randn(*shape)
    elif name == "scale":
        value = 1.0 + 0.1 * rs.randn(*shape)
    elif name == "mean":
        value = 0.3 * rs.randn(*shape)
    else:
        value = 0.5 + rs.rand(*shape)
    return value.astype(np.float32)


def _jax_init(module, seed, *args):
    """Variables of the JAX ``module``'s tree, drawn from ``seed`` (the
    tree from ``eval_shape``: no init program to compile)."""
    shapes = jax.eval_shape(lambda key: module.init(key, *args),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: _draw(path, leaf, rs), shapes)


def _bridge(module, v, flax_name, rules):
    """Load the JAX variables ``v`` of one flax module into ``module``
    through ``rules`` written for the module at ``flax_name`` -> ``m``."""
    state = convert.jax_variables_to_state_dict(
        {col: {flax_name: tree} for col, tree in v.items()}, rules)
    module.load_state_dict({k.removeprefix("m."): t for k, t in state.items()},
                           strict=True)
    return module


def _jax_apply(module, v, *args, train=False, **kwargs):
    """Output and the batch statistics after it (in train mode updated),
    jitted."""
    if train:
        out, state = jax.jit(lambda v, *a: module.apply(
            v, *a, train=True, mutable=["batch_stats"], **kwargs))(v, *args)
        return out, jax.tree.map(np.asarray, state.get("batch_stats", {}))
    out = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(v, *args)
    return out, v.get("batch_stats", {})


def _check_stats(module, stats, flax_name, rules):
    """The port's running statistics against the JAX batch_stats tree."""
    if not stats:
        return
    expected = convert.jax_variables_to_state_dict(
        {"batch_stats": {flax_name: stats}}, rules)
    actual = module.state_dict()
    for key, e in expected.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                actual[key.removeprefix("m.")].numpy(), e.numpy(), rtol=0,
                atol=STATS_ATOL, err_msg=key)


def _tree_rel(actual, expected):
    """The largest |diff| of each map over that map's largest |value|."""
    if isinstance(expected, (tuple, list)):
        assert isinstance(actual, (tuple, list))
        assert len(actual) == len(expected)
        return max(_tree_rel(a, e) for a, e in zip(actual, expected))
    assert tuple(actual.shape) == tuple(expected.shape)
    e = np.asarray(expected)
    return float(np.abs(actual.numpy() - e).max() / np.abs(e).max())


# -- max_pool2d, the GA-Net blocks, the warp ---------------------------------------


@pytest.mark.parametrize("window,stride", [(2, None), (2, 1), (3, 2)])
def test_max_pool2d_matches_jax_bit_for_bit(window, stride):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 9, 13, 5).astype(np.float32)
    expected = np.asarray(jpool.max_pool2d(jnp.asarray(x), window, stride))
    actual = tpool.max_pool2d(torch.from_numpy(x), window, stride)
    assert tuple(actual.shape) == expected.shape
    assert np.array_equal(actual.numpy(), expected)


@pytest.mark.parametrize("transposed", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "live_bn"])
def test_ga_blocks_match_jax(transposed, train):
    rs = np.random.RandomState(2)
    c_in, c_out = 12, 8
    h = 6 if transposed else 12
    x = rs.randn(2, h, h, c_in).astype(np.float32)
    hr = 2 * h if transposed else h // 2
    res = rs.randn(2, hr, hr, c_out).astype(np.float32)
    name = "GaConv2xBlockTransposed_0" if transposed else "GaConv2xBlock_0"
    jmodule = (jdicl.GaConv2xBlockTransposed if transposed
               else jdicl.GaConv2xBlock)(c_out)
    v = _jax_init(jmodule, 3, jnp.asarray(x), jnp.asarray(res))
    expected, stats = _jax_apply(jmodule, v, jnp.asarray(x), jnp.asarray(res),
                                 train=train)

    rules = convert._ga_block_rules(name, "m", transposed)
    module = _bridge((tdicl.GaConv2xBlockTransposed if transposed
                      else tdicl.GaConv2xBlock)(c_in, c_out), v, name, rules)
    with _one_thread(), torch.no_grad():
        actual = module(_nchw(x), _nchw(res), train)
    _close(actual.permute(0, 2, 3, 1), expected)
    _check_stats(module, stats, name, rules)


@pytest.mark.parametrize("eps", [1e-5, 0.3])
def test_warp_backwards_matches_jax(eps):
    rs = np.random.RandomState(4)
    img = rs.randn(2, 10, 14, 3).astype(np.float32)
    # a spread that pushes some samples partly and some wholly outside
    flow = (3 * rs.randn(2, 10, 14, 2)).astype(np.float32)
    flow[0, :2, :3] = 0.25
    est_e, mask_e = jwarp.warp_backwards(jnp.asarray(img), jnp.asarray(flow),
                                         eps=eps)
    est, mask = twarp.warp_backwards(torch.from_numpy(img),
                                     torch.from_numpy(flow), eps=eps)
    assert tuple(mask.shape) == mask_e.shape and mask.dtype == torch.bool
    assert np.array_equal(mask.numpy(), np.asarray(mask_e))
    assert 0 < mask.sum() < mask.numel()
    _close(est, est_e, atol=1e-5)


# -- the correlation modules and their readouts ----------------------------------

RADIUS = 4
CMOD_KW = {"dicl-1x1": {"mnet_scale": 0.5}, "dicl-emb": {"embedding_dim": 8},
           "dot": {}}


def _cmod_inputs():
    rs = np.random.RandomState(5)
    f1 = rs.randn(2, 6, 8, 8).astype(np.float32)
    f2 = rs.randn(2, 6, 8, 8).astype(np.float32)
    base = np.stack(np.meshgrid(np.arange(8), np.arange(6)), -1)
    coords = (base + 2 * rs.randn(2, 6, 8, 2)).astype(np.float32)
    return f1, f2, coords


@pytest.fixture(scope="module")
def cmods():
    """Per cmod type the JAX module (radius 4, 8 channels, standard-init
    DAP) and its variables."""
    inputs = [jnp.asarray(x) for x in _cmod_inputs()]
    out = {}
    for i, (ty, kw) in enumerate(CMOD_KW.items()):
        jmodule = jcorr.make_cmod(ty, 8, RADIUS, dap_init="standard", **kw)
        out[ty] = jmodule, _jax_init(jmodule, 10 + i, *inputs)
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "live_bn"])
@pytest.mark.parametrize("dap", [True, False], ids=["dap", "no_dap"])
@pytest.mark.parametrize("ty", list(CMOD_KW))
def test_cmods_match_jax(cmods, ty, dap, train):
    jmodule, v = cmods[ty]
    inputs = _cmod_inputs()
    expected, stats = _jax_apply(jmodule, v, *(jnp.asarray(x) for x in inputs),
                                 train=train, dap=dap)

    rules = convert._cmod_rules("CorrelationModule_0", "m", ty)
    module = _bridge(tcorr.make_cmod(ty, 8, RADIUS, dap_init="standard",
                                     **CMOD_KW[ty]),
                     v, "CorrelationModule_0", rules)
    with _one_thread(), torch.no_grad():
        actual = module(*(torch.from_numpy(x) for x in inputs), dap=dap,
                        train=train)
    assert actual.dtype == torch.float32
    assert tuple(actual.shape) == (2, 6, 8, module.output_dim)
    _close(actual, expected)
    _check_stats(module, stats, "CorrelationModule_0", rules)


@pytest.mark.parametrize("reg", ["softargmax", "softargmax+dap"])
@pytest.mark.parametrize("ty", ["dicl", "dicl-1x1", "dicl-emb", "dot"])
def test_readouts_match_jax(ty, reg):
    rs = np.random.RandomState(6)
    extra = 8 if ty == "dicl-emb" else 0
    out = (2 * rs.randn(2, 5, 7, 81 + extra)).astype(np.float32)
    jmodule = jcorr.make_flow_regression(ty, reg, RADIUS)
    v = jax.tree.map(np.asarray, jmodule.init(jax.random.PRNGKey(7),
                                              jnp.asarray(out)))
    if v:
        v["params"]["DisplacementAwareProjection_0"]["Conv_0"]["kernel"] = (
            rs.randn(1, 1, 81, 81) / 9).astype(np.float32)
    expected = jmodule.apply(v, jnp.asarray(out))

    module = tcorr.make_flow_regression(ty, reg, RADIUS)
    if v:
        _bridge(module, v, "R_0", convert._readout_rules("R_0", "m"))
    with torch.no_grad():
        actual = module(torch.from_numpy(out))
    _close(actual, expected, atol=1e-5)


# -- the encoder families ----------------------------------------------------------

# each map relative to its largest |value|: float32 convolutions summed in
# another order behind up to ~60 conv/norm layers (rfpm p34: 4 stages of
# 6 residual blocks and 2 repair masks); reads <= 1.8e-6 in eval, <= 1.02e-5
# under live batch norm (dicl p34, whose per-image statistics at the
# coarsest rungs run over 2x2 and 1x1 maps)
ENCODER_REL = 5e-5

# (family, shape, image side); the GA-Net hourglass needs a side divisible
# by 2^(depth + 1)
ENCODERS = [
    ("dicl", "s3", 32),
    ("dicl", "p34", 64),
    ("dicl", "p26", 256),
    ("raft-avgpool", "p35", 64),
    ("raft-maxpool", "p34", 64),
    ("rfpm-raft", "s3", 32),
    ("rfpm-raft", "p34", 64),
]


def _encoder(pkg, family, shape):
    if shape == "p26":
        enc = jenc.dicl if pkg == "jax" else tenc.dicl
        return enc.p26(12)
    mod = jenc if pkg == "jax" else tenc
    return getattr(mod, f"make_encoder_{shape}")(family, 12, "batch", 0.0)


_JAX_ENCODERS = {}


def _jax_encoder(family, shape, pair):
    """The JAX encoder and its variables, built once per (family, shape)."""
    key = (family, shape)
    if key not in _JAX_ENCODERS:
        jmodule = _encoder("jax", family, shape)
        _JAX_ENCODERS[key] = jmodule, _jax_init(jmodule, 9, pair)
    return _JAX_ENCODERS[key]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "live_bn"])
@pytest.mark.parametrize("family,shape,side", ENCODERS,
                         ids=[f"{f}-{s}" for f, s, _ in ENCODERS])
def test_encoder_families_match_jax(family, shape, side, train):
    rs = np.random.RandomState(8)
    imgs = [rs.uniform(-1, 1, (1, side, side, 3)).astype(np.float32)
            for _ in range(2)]
    pair = tuple(jnp.asarray(x) for x in imgs)
    jmodule, v = _jax_encoder(family, shape, pair)
    expected, stats = _jax_apply(jmodule, v, pair, train=train)

    module = _encoder("torch", family, shape)
    name = f"{type(module).__name__}_0"
    rules = convert._encoder_rules((("m", module),))
    _bridge(module, v, name, rules)
    with _one_thread(), torch.no_grad():
        actual = module(tuple(_nchw(x) for x in imgs), train)
    actual = jax.tree.map(lambda t: t.permute(0, 2, 3, 1), actual)
    assert _tree_rel(actual, expected) <= ENCODER_REL
    _check_stats(module, stats, name, rules)
