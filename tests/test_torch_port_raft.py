"""PyTorch port: the whole ``raft/baseline`` forward held against the JAX
``RaftModule`` on the CPU, with weights bridged from JAX variables drawn
over the JAX init's shapes as flax initializes them, at 1x64x96 and 3
iterations: every iteration's flow, in float32 and under the
bf16 mixed-precision policy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import convert, evaluation
from test_torch_port_train import _flax_init
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ITERATIONS = 3

# float32: both run the same arithmetic with sums in another order
# (oneDNN vs XLA:CPU 'highest'); 3 recurrent iterations carry ~1e-5 px
F32_MAX_ABS_PX = 1e-4
# bf16 policy: the two frameworks round to bf16 at different places (conv
# bias adds, GRU gate sums, the split vs merged lookup conv); ~3 digits on
# flows of ~8 px
BF16_MAX_ABS_PX = 0.15


def _cfg(mixed_precision):
    return {
        "name": "RAFT baseline", "id": "raft/baseline",
        "model": {"type": "raft/baseline",
                  "parameters": {"mixed-precision": mixed_precision},
                  "arguments": {"iterations": ITERATIONS}},
        "loss": {"type": "raft/sequence"},
        "input": None,
    }


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(0)
    return tuple(rs.uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32)
                 for _ in range(2))


def _run_both(mixed_precision, images, **args):
    img1, img2 = (jnp.asarray(x) for x in images)
    jspec = jmodels.load(_cfg(mixed_precision))
    variables = jax.tree.map(jnp.asarray,
                             _flax_init(jspec.model, 1, img1, img2))
    expected = jax.jit(lambda v: jspec.model.apply(v, img1, img2, **args))(
        variables)

    tspec = tmodels.load(_cfg(mixed_precision))
    tspec.model.init(device="cpu")
    convert.load_jax_variables(tspec.model.module,
                               jax.tree.map(np.asarray, variables))
    step = evaluation.make_eval_fn(tspec.model, args)
    actual, final = step(*(torch.from_numpy(x) for x in images))
    return expected, actual, final


def _max_abs(actual, expected):
    return float(np.abs(actual.numpy() - np.asarray(expected)).max())


def test_raft_f32_matches_jax_every_iteration(images):
    # corr_flow adds the per-level soft-argmax readouts to the output
    expected, actual, final = _run_both(False, images, corr_flow=True)
    *exp_levels, exp_flows = expected
    *act_levels, act_flows = actual

    assert len(act_flows) == len(exp_flows) == ITERATIONS
    for a, e in zip(act_flows, exp_flows):
        assert tuple(a.shape) == e.shape == (1, 64, 96, 2)
        assert _max_abs(a, e) <= F32_MAX_ABS_PX
    assert final is act_flows[-1]

    assert len(act_levels) == len(exp_levels) == 4
    for al, el in zip(act_levels, exp_levels):
        for a, e in zip(al, el):
            assert tuple(a.shape) == e.shape == (1, 8, 12, 2)
            assert _max_abs(a, e) <= F32_MAX_ABS_PX


def test_raft_bf16_policy_matches_jax_every_iteration(images):
    expected, actual, _ = _run_both(True, images)
    assert len(actual) == len(expected) == ITERATIONS
    for a, e in zip(actual, expected):
        assert a.dtype == torch.float32
        assert _max_abs(a, e) <= BF16_MAX_ABS_PX


def test_raft_forward_only():
    """An inference forward reads batch norm's running statistics and
    writes nothing; a training forward with live batch norm updates them,
    and ``freeze_batchnorm`` keeps them as they were. Either way ``apply``
    returns the raw per-iteration flows."""
    tspec = tmodels.load(_cfg(False))
    tspec.model.init(device="cpu")
    module = tspec.model.module
    x1, x2 = (torch.from_numpy(x) for x in (
        np.random.RandomState(2).uniform(-1, 1, (2, 2, 64, 96, 3))
        .astype(np.float32)))
    stats = {k: v.clone() for k, v in module.state_dict().items()
             if "running" in k}

    def unchanged():
        return all(torch.equal(module.state_dict()[k], v)
                   for k, v in stats.items())

    with torch.no_grad():
        out = tspec.model.apply(x1, x2)
        assert len(out) == ITERATIONS and unchanged()
        tspec.model.on_stage(None, freeze_batchnorm=True)
        out = tspec.model.apply(x1, x2, train=True)
        assert len(out) == ITERATIONS and unchanged()
        tspec.model.on_stage(None, freeze_batchnorm=False)
        out = tspec.model.apply(x1, x2, train=True)
    assert len(out) == ITERATIONS and tuple(out[-1].shape) == (2, 64, 96, 2)
    assert not unchanged()


def test_sequence_loss_matches_jax():
    rs = np.random.RandomState(5)
    flows = [rs.randn(2, 6, 7, 2).astype(np.float32) for _ in range(3)]
    target = rs.randn(2, 6, 7, 2).astype(np.float32)
    valid = rs.rand(2, 6, 7) > 0.3
    jloss = jmodels.load(_cfg(False)).loss
    tloss = tmodels.load(_cfg(False)).loss
    for kwargs in ({}, {"ord": 2, "gamma": 0.85}, {"include_invalid": True},
                   {"ord": "absmean"}):
        e = jloss(None, [jnp.asarray(f) for f in flows], jnp.asarray(target),
                  jnp.asarray(valid), **kwargs)
        a = tloss(None, [torch.from_numpy(f) for f in flows],
                  torch.from_numpy(target), torch.from_numpy(valid), **kwargs)
        assert abs(float(a) - float(e)) <= 1e-5, kwargs
