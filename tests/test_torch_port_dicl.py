"""PyTorch port: the DICL pieces of ``raft+dicl`` held against the JAX
package on the CPU, from the same numpy inputs and (bridged) weights.

- the window sampler's plain version (``ops.sample``, what the CUDA kernel
  pair is held against on the card) against the JAX ``sample_window`` and
  the Pallas kernels in interpret mode (``_sw_fwd_interpret`` /
  ``_sw_bwd_interpret``), radius 1 and 4, float32 and bf16, with far
  out-of-bounds centres; the coordinates get no gradient;
- the MatchingNet's unstacked pair form against its stacked form, and the
  correlation module (sampler, MatchingNet, DAP) against JAX;
- the DAP, the pyramid encoder, the three hidden-state upsamplers and the
  multi-level sequence losses against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_meets_dicl_tpu.models.common import hsup as jhsup
from raft_meets_dicl_tpu.models.common.blocks import dicl as jdicl
from raft_meets_dicl_tpu.models.common.corr import dicl as jcorr
from raft_meets_dicl_tpu.models.common.encoders import raft as jenc
from raft_meets_dicl_tpu.models.common.loss import mlseq as jmlseq
from raft_meets_dicl_tpu.models.impls import raft_dicl_ctf as jctf
from raft_meets_dicl_tpu.ops import pallas as jpallas
from raft_meets_dicl_tpu.ops import sample as jsample
from raft_meets_dicl_tpu_torch import convert
from raft_meets_dicl_tpu_torch.models.common import hsup as thsup
from raft_meets_dicl_tpu_torch.models.common.blocks import dicl as tdicl
from raft_meets_dicl_tpu_torch.models.common.corr import dicl as tcorr
from raft_meets_dicl_tpu_torch.models.common.encoders import raft as tenc
from raft_meets_dicl_tpu_torch.models.common.loss import mlseq as tmlseq
from raft_meets_dicl_tpu_torch.models.common.util import init_parameters
from raft_meets_dicl_tpu_torch.models.impls import raft_dicl_ctf as tctf
from raft_meets_dicl_tpu_torch.ops import sample as tsample
from test_torch_port_train import _flax_init
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# float32, the same arithmetic in another order (two lerps; the XLA and
# interpret forms may fuse multiply-adds)
SAMPLE_ATOL = 1e-5
# float32 convolutions summed in another order (native torch vs XLA:CPU at
# 'highest') through up to 8 stacked conv/norm layers
MODULE_ATOL = 1e-4
# the pyramid's coarsest head sits behind 21 conv/norm layers: there the
# JAX package reads 1.1e-4 and the port 4.3e-5 off a float64 run of the
# port (at the 128x128 input below)
PYRAMID_ATOL = 2e-4


def _bf16_ulp(x):
    """Spacing of bfloat16 values at |x|: 2^(e - 7) for |x| in
    [2^e, 2^(e+1)); 0 at 0."""
    _, exp = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, exp - 8))


def _bf16_round(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _close(actual, expected, atol=MODULE_ATOL):
    np.testing.assert_allclose(actual.detach().float().numpy(),
                               np.asarray(expected, np.float32),
                               rtol=0, atol=atol)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# -- the window sampler --------------------------------------------------------

FAR = [(0, 0, 0, 1e4, -1e4), (1, 2, 3, -3e4, 5.5), (1, 5, 6, 40.0, 1e5)]


def _sampler_inputs(seed, dtype, b=2, h2=13, w2=17, c=5, h=6, w=7):
    """f2 and centres with a spread that pushes whole windows out of
    bounds, plus a few far out-of-bounds centres (FAR)."""
    rs = np.random.RandomState(seed)
    f2 = rs.randn(b, h2, w2, c).astype(np.float32)
    if dtype == "bfloat16":
        # round once through bf16 so both frameworks see identical values
        f2 = _bf16_round(f2)
    coords = (rs.randn(b, h, w, 2) * 12 + 6).astype(np.float32)
    for bi, y, x, cx, cy in FAR:
        coords[bi, y, x] = (cx, cy)
    return f2, coords


def _check(actual, expected, dtype):
    """float32: SAMPLE_ATOL; bf16 (one rounding of a float32 result on the
    port's side): SAMPLE_ATOL plus one bf16 ulp of the larger value."""
    a = actual.detach().float().numpy()
    e = np.asarray(expected, np.float32)
    assert a.shape == e.shape
    bound = SAMPLE_ATOL
    if dtype == "bfloat16":
        bound = bound + _bf16_ulp(np.maximum(np.abs(a), np.abs(e)))
    assert np.all(np.abs(a - e) <= bound), float(np.abs(a - e).max())


@pytest.mark.parametrize("radius", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_window_matches_jax(radius, dtype):
    f2, coords = _sampler_inputs(radius, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jf2, jc = jnp.asarray(f2, jdt), jnp.asarray(coords)
    xla = jsample.sample_window(jf2, jc, radius)
    kernel = jpallas._sw_fwd_interpret(jf2, jc, radius)

    tf2 = torch.from_numpy(f2).to(getattr(torch, dtype))
    actual = tsample.sample_window_fused(tf2, torch.from_numpy(coords), radius)
    assert actual.dtype == tf2.dtype
    k = 2 * radius + 1
    assert tuple(actual.shape) == (2, k, k, 6, 7, 5)
    _check(actual, xla, dtype)
    _check(actual, kernel, dtype)
    # a window wholly outside f2 is exact zeros
    for bi, y, x, _, _ in FAR:
        assert torch.all(actual[bi, :, :, y, x] == 0)
        assert np.all(np.asarray(kernel)[bi, :, :, y, x] == 0)


@pytest.mark.parametrize("radius", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_window_backward_matches_jax(radius, dtype):
    f2, coords = _sampler_inputs(10 + radius, dtype)
    k = 2 * radius + 1
    dout = np.random.RandomState(20 + radius).randn(
        2, k, k, 6, 7, 5).astype(np.float32)
    if dtype == "bfloat16":
        dout = _bf16_round(dout)
    jc, jd = jnp.asarray(coords), jnp.asarray(dout)
    # the reference gradient in float32
    xla = jax.grad(lambda m: jnp.sum(jsample.sample_window(m, jc, radius)
                                     * jd))(jnp.asarray(f2))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    kernel = jpallas._sw_bwd_interpret(jnp.asarray(f2, jdt), jc, jd, radius)

    tdt = getattr(torch, dtype)
    tf2 = torch.from_numpy(f2).to(tdt).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    tsample.sample_window_fused(tf2, tc, radius).backward(
        torch.from_numpy(dout).to(tdt))
    assert tf2.grad.dtype == tdt
    _check(tf2.grad, xla, dtype)
    _check(tf2.grad, kernel, dtype)
    # the lookup centres get no gradient
    assert tc.grad is None


def test_sample_window_kernel_route_refuses_cpu_tensors():
    """The kernel entry points take CUDA tensors only; on the CPU the
    public op takes the plain version and launches nothing."""
    f2, coords = _sampler_inputs(3, "float32")
    f2, coords = torch.from_numpy(f2), torch.from_numpy(coords)
    with pytest.raises(ValueError, match="CUDA"):
        tsample._launch(f2, coords, 4)
    before = (tsample.launches, tsample.bwd_launches)
    tsample.sample_window_fused(f2, coords, 4)
    assert (tsample.launches, tsample.bwd_launches) == before


# -- MatchingNet, correlation module, DAP ----------------------------------------


def _randomize_stats(module, seed):
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(0.3 * rs.randn(*buf.shape)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(0.5 + rs.rand(*buf.shape)))


@pytest.mark.parametrize("train", [False, True])
def test_matching_net_pair_form_matches_stacked(train):
    """The unstacked (f1, window) form computes the stacked volume's
    output, and in train mode the same batch statistics."""
    rs = np.random.RandomState(4)
    b, k, h, w, c = 2, 3, 6, 8, 8
    f1 = torch.from_numpy(rs.randn(b, h, w, c).astype(np.float32))
    window = torch.from_numpy(rs.randn(b, k, k, h, w, c).astype(np.float32))
    stacked = torch.cat((f1[:, None, None].expand(b, k, k, h, w, c), window),
                        dim=-1)

    nets = []
    for _ in range(2):
        net = tdicl.MatchingNet(c, scale=0.25)
        init_parameters(net, torch.Generator().manual_seed(5))
        _randomize_stats(net, 6)
        nets.append(net)
    with torch.no_grad():
        pair = nets[0]((f1, window), train)
        full = nets[1](stacked, train)
    assert tuple(pair.shape) == (b, h, w, k, k) and pair.dtype == torch.float32
    _close(pair, full.numpy(), atol=1e-5)
    for (name, a), (_, e) in zip(nets[0].named_buffers(),
                                 nets[1].named_buffers()):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.fixture(scope="module")
def cmod_variables():
    """JAX correlation-module variables (radius 2, 8 channels, MatchingNet
    at scale 0.5, standard-init DAP) drawn as flax initializes them
    (``_flax_init``), batch statistics away from their (0, 1) init."""
    rs = np.random.RandomState(7)
    f1 = jnp.asarray(rs.randn(2, 8, 12, 8), jnp.float32)
    coords = jnp.zeros((2, 8, 12, 2), jnp.float32)
    module = jcorr.CorrelationModule(8, 2, dap_init="standard", mnet_scale=0.5)
    return module, _flax_init(module, 3, f1, f1, coords)


@pytest.mark.parametrize("dap", [True, False])
def test_correlation_module_matches_jax(cmod_variables, dap):
    jmodule, v = cmod_variables
    rs = np.random.RandomState(8)
    f1 = rs.randn(2, 8, 12, 8).astype(np.float32)
    f2 = rs.randn(2, 8, 12, 8).astype(np.float32)
    base = np.stack(np.meshgrid(np.arange(12), np.arange(8)), -1)
    coords = (base + 3 * rs.randn(2, 8, 12, 2)).astype(np.float32)
    expected = jmodule.apply(v, *(jnp.asarray(x) for x in (f1, f2, coords)),
                             dap=dap)

    rules = convert._cmod_rules("CorrelationModule_0", "corr")
    state = convert.jax_variables_to_state_dict(
        {col: {"CorrelationModule_0": tree} for col, tree in v.items()},
        rules)
    module = tcorr.CorrelationModule(8, 2, dap_init="standard", mnet_scale=0.5)
    module.load_state_dict({k.removeprefix("corr."): t
                            for k, t in state.items()})
    with torch.no_grad():
        actual = module(*(torch.from_numpy(x) for x in (f1, f2, coords)),
                        dap=dap)
    assert tuple(actual.shape) == (2, 8, 12, 25)
    _close(actual, expected)


def test_dap_matches_jax():
    rs = np.random.RandomState(9)
    cost = rs.randn(2, 5, 6, 5, 5).astype(np.float32)
    kernel = rs.randn(1, 1, 25, 25).astype(np.float32) / 5
    expected = jdicl.DisplacementAwareProjection((2, 2)).apply(
        {"params": {"Conv_0": {"kernel": jnp.asarray(kernel)}}},
        jnp.asarray(cost))
    dap = tdicl.DisplacementAwareProjection(2)
    with torch.no_grad():
        dap.conv1.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        actual = dap(torch.from_numpy(cost))
    _close(actual, expected, atol=1e-5)
    # identity init is a no-op projection
    init_parameters(dap, torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(dap(torch.from_numpy(cost)), torch.from_numpy(cost))


# -- pyramid encoder, hidden-state upsamplers, losses ----------------------------


@pytest.mark.parametrize("levels,norm", [(3, "instance"), (2, "batch")])
def test_pyramid_encoder_matches_jax(levels, norm):
    rs = np.random.RandomState(10)
    # the coarsest level 4x4: an instance norm over 2x2 maps amplifies
    # rounding differences past MODULE_ATOL
    img = rs.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    jmodule = jenc.FeatureEncoderPyramid(output_dim=16, levels=levels,
                                         norm_type=norm)
    v = _flax_init(jmodule, 4, jnp.asarray(img))
    expected = jmodule.apply(v, jnp.asarray(img))

    state = convert.jax_variables_to_state_dict(
        {col: {"FeatureEncoderPyramid_0": tree} for col, tree in v.items()},
        convert._pyramid_rules("FeatureEncoderPyramid_0", "fnet", levels))
    module = tenc.FeatureEncoderPyramid(output_dim=16, levels=levels,
                                        norm_type=norm).eval()
    module.load_state_dict({k.removeprefix("fnet."): t
                            for k, t in state.items()})
    with torch.no_grad():
        actual = module(_nchw(img))
    assert len(actual) == len(expected) == levels
    for i, (a, e) in enumerate(zip(actual, expected)):
        assert tuple(a.shape) == (2, 16, 16 // 2**i, 16 // 2**i)
        _close(a.permute(0, 2, 3, 1), e, atol=PYRAMID_ATOL)


@pytest.mark.parametrize("kind", ["none", "bilinear", "crossattn"])
def test_hidden_state_upsamplers_match_jax(kind):
    rs = np.random.RandomState(11)
    h_prev = np.tanh(rs.randn(2, 4, 6, 16)).astype(np.float32)
    h_init = np.tanh(rs.randn(2, 8, 12, 16)).astype(np.float32)
    jmodule = jhsup.make_hidden_state_upsampler(kind, 16)
    v = _flax_init(jmodule, 5, jnp.asarray(h_prev), jnp.asarray(h_init))
    if kind == "bilinear":
        # away from the identity init, so the conv is exercised
        v["params"]["Conv_0"]["kernel"] = (
            v["params"]["Conv_0"]["kernel"]
            + 0.1 * rs.randn(1, 1, 16, 16)).astype(np.float32)
        v["params"]["Conv_0"]["bias"] = (0.1 * rs.randn(16)).astype(
            np.float32)
    expected = jmodule.apply(v, jnp.asarray(h_prev), jnp.asarray(h_init))

    module = thsup.make_hidden_state_upsampler(kind, 16)
    if v:
        name = {"bilinear": "HUpBilinear_0", "crossattn": "HUpCrossAttn_0"}
        rules = convert.ctf_rules(2, False, True, kind)
        state = convert.jax_variables_to_state_dict(
            {"params": {name[kind]: v["params"]}}, rules)
        module.load_state_dict({k.removeprefix("upnet_h."): t
                                for k, t in state.items()})
    with torch.no_grad():
        actual = module(_nchw(h_prev), _nchw(h_init))
    _close(actual.permute(0, 2, 3, 1), expected, atol=1e-5)


def _loss_inputs(prev=False):
    rs = np.random.RandomState(12)
    shapes = ((2, 4, 6), (2, 8, 12), (2, 32, 48))
    result = []
    for s in shapes:
        level = [(20 * rs.randn(*s, 2)).astype(np.float32) for _ in range(3)]
        if prev:
            level = [((20 * rs.randn(*s, 2)).astype(np.float32), f)
                     for f in level]
        result.append(level)
    target = (30 * rs.randn(2, 32, 48, 2)).astype(np.float32)
    valid = rs.rand(2, 32, 48) > 0.3
    return result, target, valid


def _tree(result, to):
    return [[tuple(to(x) for x in e) if isinstance(e, tuple) else to(e)
             for e in level] for level in result]


@pytest.mark.parametrize("kwargs", [
    {"ord": 1, "gamma": 0.85, "alpha": (0.38, 0.6, 1.0)},
    {"ord": 2, "gamma": 0.8, "alpha": (0.5, 0.7, 1.0), "scale": 0.5},
])
@pytest.mark.parametrize("restricted", [False, True])
def test_mlseq_losses_match_jax(kwargs, restricted):
    result, target, valid = _loss_inputs(prev=restricted)
    jcls, tcls = ((jctf.RestrictedMultiLevelSequenceLoss,
                   tctf.RestrictedMultiLevelSequenceLoss) if restricted
                  else (jmlseq.MultiLevelSequenceLoss,
                        tmlseq.MultiLevelSequenceLoss))
    if restricted:
        kwargs = {**kwargs, "delta_range": (40, 30, 20)}
    expected = jcls()(None, _tree(result, jnp.asarray), jnp.asarray(target),
                      jnp.asarray(valid), **kwargs)
    actual = tcls()(None, _tree(result, torch.from_numpy),
                    torch.from_numpy(target), torch.from_numpy(valid),
                    **kwargs)
    assert abs(float(actual) - float(expected)) <= 1e-5 * abs(float(expected))
    assert tcls().get_config() == jcls().get_config()
