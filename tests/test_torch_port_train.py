"""PyTorch port: training of ``raft/baseline`` held against the JAX package
on the CPU, from the same weights (bridged with ``convert``) and the same
numpy batch.

- the ``convex_combine_8x`` backward's plain version against the Pallas
  backward kernel (interpret mode) and against ``jax.vjp`` of the JAX op;
- batch norm in train mode against flax ``BatchNorm`` and its
  ``batch_stats`` update;
- the recurrence's gradient (the carried flow's gradient stopped at every
  iteration, ``corr_grad_stop``);
- one train step (loss, gradients, parameters, batch-norm statistics,
  norms) with frozen and with live batch norm, and a 3-step loss
  trajectory, each side built by its own ``strategy.spec``;
- the schedules, the clips and the optimizers against optax;
- ``main train`` on the CPU and its device rule.

The model is ``raft/baseline`` cut to corr-levels 2, radius 2, 32/16/16
channels and 2 iterations, on a 2x64x96 batch.
"""

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu.strategy.spec as jspec
from raft_meets_dicl_tpu.models.common.norm import Norm2d
from raft_meets_dicl_tpu.ops import pallas as jax_pallas
from raft_meets_dicl_tpu.parallel import TrainState as JTrainState
from raft_meets_dicl_tpu.parallel import make_train_step as jmake_train_step
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import convert, parallel, strategy
from raft_meets_dicl_tpu_torch import main as port_main
from raft_meets_dicl_tpu_torch.data import io as tio
from raft_meets_dicl_tpu_torch.models.common.norm import BatchNorm2d
from raft_meets_dicl_tpu_torch.ops import convex

tspec = strategy.spec

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).parent.parent

ITERATIONS = 2
MODEL_PARAMS = {"corr-levels": 2, "corr-radius": 2, "corr-channels": 32,
                "context-channels": 16, "recurrent-channels": 16}

# s1-things.yaml's optimizer and clip, but with eps 1e-3: with eps 1e-8
# Adam's first update is lr * sign(g), so a gradient element that is
# rounding noise on both sides (see ZERO_GRAD) moves its weight by +-lr at
# random and no parameter tolerance tighter than 2 lr would hold
OPTIMIZER = {"type": "adam-w",
             "parameters": {"lr": 1e-3, "weight_decay": 1e-4, "eps": 1e-3}}
GRADIENT = {"clip": {"type": "norm", "value": 1.0}}
SCHEDULE = {"type": "one-cycle",
            "parameters": {"max_lr": 1e-3, "total_steps": "{n_batches} * 4",
                           "pct_start": 0.25, "cycle_momentum": False,
                           "anneal_strategy": "linear"}}
SCHEDULE_VARS = {"n_samples": 10, "n_batches": 5, "n_epochs": 1,
                 "n_accum": 1, "batch_size": 2}
STEPS = 3

# float32 on both sides, sums in another order (native torch convs vs
# XLA:CPU at 'highest'): loss of the first step within 1e-5 relative
# (reads <= 3e-7), each gradient tensor within 1e-4 relative L2 (reads
# <= 2e-5, in the GRU gates) ...
LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
# ... except the feature encoder's half-resolution stem (conv1, layer1):
# its gradient is a sum that cancels through the instance norms, and each
# package alone is ~2e-3 off a float64 run of the port there (reads
# <= 2.7e-3 between them)
STEM = ("fnet.conv1.", "fnet.layer1.")
GRAD_REL_L2_STEM = 1e-2
# a conv bias right before an instance norm has a zero gradient by
# construction; both sides hold rounding noise there (reads <= 2e-8 of the
# global norm), bounded in norm instead of compared
ZERO_GRAD = 1e-6
# parameters after one AdamW + clip update at lr 1e-3: the update moves a
# weight by at most lr, and the gradients agree to ~1e-5 relative
PARAM_ATOL = 2e-6
# running statistics after one live batch-norm update (values ~1)
STATS_ATOL = 1e-5
# the 3-step trajectory: later losses inherit the updates' differences
TRAJECTORY_REL = 1e-4


def _cfg(corr_grad_stop=False):
    return {
        "name": "RAFT baseline, tiny", "id": "raft/baseline",
        "model": {"type": "raft/baseline", "parameters": dict(MODEL_PARAMS),
                  "arguments": {"iterations": ITERATIONS,
                                "corr_grad_stop": corr_grad_stop}},
        "loss": {"type": "raft/sequence"},
        "input": None,
    }


# -- convex_combine_8x backward ------------------------------------------------

CONVEX_M = 700  # not a multiple of the TPU kernel's 512-row tile
# float32 softmax backward summed in another order, on window values ~10
CONVEX_ATOL = 1e-5


def _bf16_ulp(x):
    """Spacing of bfloat16 values at |x|: 2^(e - 7) for |x| in
    [2^e, 2^(e+1)); 0 at 0."""
    _, exp = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, exp - 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_form", ["interpret", "vjp"])
def test_convex_backward_matches_jax(dtype, jax_form):
    rs = np.random.RandomState(21)
    logits = (4 * rs.randn(CONVEX_M, 576)).astype(np.float32)
    if dtype == "bfloat16":
        # round once through bf16 so both frameworks see identical values
        logits = torch.from_numpy(logits).to(torch.bfloat16).float().numpy()
    win = (8 * rs.randn(CONVEX_M, 18)).astype(np.float32)
    dout = rs.randn(CONVEX_M, 128).astype(np.float32)

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jl, jw, jd = jnp.asarray(logits, jdt), jnp.asarray(win), jnp.asarray(dout)
    if jax_form == "interpret":
        exp_dl, exp_dw = jax_pallas._run_bwd_interpret(jl, jw, jd, 0.25)
    else:
        # the public op: (..., 576) logits, (..., 9, 2) window, its
        # custom_vjp backward
        _, vjp = jax.vjp(
            lambda lg, wn: jax_pallas.convex_combine_8x(lg, wn, 4.0),
            jl.reshape(7, 100, 576), jw.reshape(7, 100, 9, 2))
        exp_dl, exp_dw = vjp(jd.reshape(7, 100, 128))
    exp_dl = np.asarray(exp_dl.astype(jnp.float32)).reshape(CONVEX_M, 576)
    exp_dw = np.asarray(exp_dw).reshape(CONVEX_M, 18)

    tl = torch.from_numpy(logits)
    if dtype == "bfloat16":
        tl = tl.to(torch.bfloat16)
    tl.requires_grad_(True)
    tw = torch.from_numpy(win).requires_grad_(True)
    out = convex.convex_combine_8x(tl.reshape(7, 100, 576),
                                   tw.reshape(7, 100, 9, 2), 4.0)
    out.backward(torch.from_numpy(dout).reshape(7, 100, 128))
    assert tl.grad.dtype == tl.dtype and tw.grad.dtype == torch.float32

    act_dl = tl.grad.float().numpy()
    np.testing.assert_allclose(tw.grad.numpy(), exp_dw, rtol=0,
                               atol=CONVEX_ATOL)
    if dtype == "float32":
        np.testing.assert_allclose(act_dl, exp_dl, rtol=0, atol=CONVEX_ATOL)
    else:
        # each side rounds its float32 gradient to bf16 once: float32-level
        # agreement plus at most one bf16 ulp of the larger value
        ulp = _bf16_ulp(np.maximum(np.abs(act_dl), np.abs(exp_dl)))
        assert np.all(np.abs(act_dl - exp_dl) <= CONVEX_ATOL + ulp)


# -- batch norm in train mode ----------------------------------------------------


@pytest.mark.parametrize("splits", [1, 2])
def test_batch_norm_train_mode_matches_flax(splits):
    """Two live updates in a row: outputs (batch statistics, float32) and
    the running statistics (flax momentum 0.9, biased batch variance)."""
    rs = np.random.RandomState(3 + splits)
    c = 5
    xs = [(2 * rs.randn(4, 6, 7, c) + 1).astype(np.float32) for _ in range(2)]
    scale = rs.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    mean = rs.randn(c).astype(np.float32)
    var = rs.uniform(0.5, 2, c).astype(np.float32)

    norm = Norm2d("batch", splits=splits)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}
    bn = BatchNorm2d(c, splits=splits)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))

    for x in xs:
        expected, mutated = norm.apply(variables, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
        variables = {**variables, "batch_stats": mutated["batch_stats"]}
        actual = bn(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
        np.testing.assert_allclose(actual.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(expected), rtol=0, atol=1e-5)
        stats = variables["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]), rtol=0, atol=1e-6)

    # evaluation reads the running statistics and leaves them be
    before = bn.running_var.clone()
    expected = norm.apply(variables, jnp.asarray(xs[0]), train=False)
    actual = bn(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(actual.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(expected), rtol=0, atol=1e-5)
    assert torch.equal(bn.running_var, before)


# -- train steps in lockstep -------------------------------------------------------


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(0)
    img1, img2 = (rs.uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
                  for _ in range(2))
    flow = (3 * rs.randn(2, 64, 96, 2)).astype(np.float32)
    valid = rs.rand(2, 64, 96) > 0.2
    return img1, img2, flow, valid


@pytest.fixture(scope="module")
def variables(batch):
    model = jmodels.load(_cfg()).model
    x1, x2 = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    init = jax.jit(lambda k: model.init(k, x1, x2))(jax.random.PRNGKey(1))
    return jax.tree.map(np.asarray, init)


_RUNS = {}


@contextlib.contextmanager
def _one_thread():
    """The port's side of the lockstep on one thread. ``torch.set_num_threads``
    (which other test files of a worker process call) also switches MKL's
    dynamic threading off for the rest of the process; MKL then splits the
    small GEMMs of these convolutions over every thread, in another order
    than a fresh process does, and one element of
    ``update_block.encoder.convf1.bias``'s gradient lies on a rounding tie:
    it moves by 3.5e-5 (the tensor by 2.35e-3 relative L2 against a float64
    run). On one thread the sums run in the fresh process's order whatever
    ran before."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _lockstep(variables, batch, frozen, corr_grad_stop=False):
    """STEPS train steps in both packages from the same weights and batch,
    learning rate from each package's one-cycle schedule. Returns per side
    the steps' learning rates and losses, the first step's aux and the
    state_dict after it."""
    key = (frozen, corr_grad_stop)
    if key in _RUNS:
        return _RUNS[key]

    jm = jmodels.load(_cfg(corr_grad_stop))
    jm.model.on_stage(None, freeze_batchnorm=frozen)
    jtx, jlr = jspec.OptimizerSpec.from_config(OPTIMIZER).build(
        jspec.GradientSpec.from_config(GRADIENT))
    jsched = jspec.SchedulerSpec.from_config(SCHEDULE).build(jlr, SCHEDULE_VARS)
    jstep = jmake_train_step(jm.model, jm.loss, jtx, external_lr=True,
                             with_grads=True, donate=False)
    state = JTrainState.create(jax.tree.map(jnp.asarray, variables), jtx)
    jax_side = {"lrs": [], "losses": []}
    for i in range(STEPS):
        lr = jsched.lr()
        state, aux = jstep(state, lr, *(jnp.asarray(x) for x in batch))
        jsched.step()
        jax_side["lrs"].append(lr)
        jax_side["losses"].append(float(aux["loss"]))
        if i == 0:
            aux = jax.tree.map(np.asarray, aux)
            jax_side["aux"] = aux
            jax_side["grads"] = {
                k: v.numpy() for k, v in convert.jax_variables_to_state_dict(
                    {"params": aux["grads"]}).items()}
            jax_side["state"] = {
                k: v.numpy() for k, v in convert.jax_variables_to_state_dict(
                    jax.tree.map(np.asarray, state.variables())).items()}

    tm = tmodels.load(_cfg(corr_grad_stop))
    tm.model.init(device="cpu")
    convert.load_jax_variables(tm.model.module, variables)
    tm.model.on_stage(None, freeze_batchnorm=frozen)
    ttx, tlr = tspec.OptimizerSpec.from_config(OPTIMIZER).build(
        tm.model.module.parameters(), tspec.GradientSpec.from_config(GRADIENT))
    tsched = tspec.SchedulerSpec.from_config(SCHEDULE).build(tlr, SCHEDULE_VARS)
    tstep = parallel.make_train_step(tm.model, tm.loss, with_grads=True)
    tstate = parallel.TrainState(tm.model, ttx)
    torch_side = {"lrs": [], "losses": []}
    for i in range(STEPS):
        lr = tsched.lr()
        # true float32 convolutions, as the JAX side runs at 'highest': on
        # some CPUs oneDNN picks a backward algorithm that is ~4e-3 off a
        # float64 run for these weights, where the native one is ~1e-6 off
        with torch.backends.mkldnn.flags(enabled=False), _one_thread():
            tstate, aux = tstep(tstate, lr,
                                *(torch.from_numpy(x) for x in batch))
        tsched.step()
        torch_side["lrs"].append(lr)
        torch_side["losses"].append(float(aux["loss"]))
        if i == 0:
            torch_side["aux"] = aux
            torch_side["grads"] = {k: g.numpy() for k, g in aux["grads"].items()}
            torch_side["state"] = {k: v.detach().clone().numpy() for k, v in
                                   tm.model.module.state_dict().items()}
    assert tstate.step == STEPS

    _RUNS[key] = (jax_side, torch_side)
    return _RUNS[key]


def _check_grads(expected, actual):
    """Each gradient tensor within GRAD_REL_L2 relative L2; those that are
    zero by construction (norm <= ZERO_GRAD of the global norm on the JAX
    side) bounded in norm on both sides. Returns the zero ones' names."""
    assert set(actual) == set(expected)
    total = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                        for g in expected.values()))
    zero = set()
    for name, e in expected.items():
        a = actual[name]
        assert a.shape == e.shape, name
        if np.linalg.norm(e) <= ZERO_GRAD * total:
            zero.add(name)
            assert np.linalg.norm(a) <= ZERO_GRAD * total, name
            continue
        rel = np.linalg.norm(a - e) / np.linalg.norm(e)
        bound = GRAD_REL_L2_STEM if name.startswith(STEM) else GRAD_REL_L2
        assert rel <= bound, (name, rel)
    return zero


@pytest.mark.parametrize("corr_grad_stop", [False, True])
def test_recurrence_gradient_matches_jax(variables, batch, corr_grad_stop):
    """Every iteration starts from the carried flow with its gradient
    stopped, and ``corr_grad_stop`` also stops it into the lookup (the JAX
    ``_RaftStep``): the whole gradient matches, and with the lookup
    stopped the feature encoder, which feeds nothing else, gets none."""
    jax_side, torch_side = _lockstep(variables, batch, frozen=True,
                                     corr_grad_stop=corr_grad_stop)
    _check_grads(jax_side["grads"], torch_side["grads"])

    fnet = [n for n in torch_side["grads"] if n.startswith("fnet.")]
    assert fnet
    fnet_norm = max(np.abs(torch_side["grads"][n]).max() for n in fnet)
    if corr_grad_stop:
        assert fnet_norm == 0.0
        assert all(np.all(jax_side["grads"][n] == 0) for n in fnet)
    else:
        assert fnet_norm > 0.0


@pytest.mark.parametrize("bn", ["frozen", "live"])
def test_train_step_matches_jax(variables, batch, bn):
    """One step: loss, norms, every gradient, and every parameter and
    batch-norm statistic after the AdamW + clip update."""
    jax_side, torch_side = _lockstep(variables, batch, frozen=bn == "frozen")
    jaux, taux = jax_side["aux"], torch_side["aux"]

    loss_rel = abs(torch_side["losses"][0] - jax_side["losses"][0]) \
        / abs(jax_side["losses"][0])
    assert loss_rel <= LOSS_REL
    assert bool(taux["finite"]) and bool(jaux["finite"])
    for key in ("grad_norm", "update_norm"):
        assert abs(float(taux[key]) - float(jaux[key])) \
            <= 1e-5 * float(jaux[key]), key
    # the clip engages: the raw gradient's norm is far above 1.0
    assert float(jaux["grad_norm"]) > 10.0
    np.testing.assert_allclose(taux["final"].numpy(), jaux["final"],
                               rtol=0, atol=1e-4)

    zero = _check_grads(jax_side["grads"], torch_side["grads"])
    assert zero and all(n.endswith(".bias") for n in zero)

    expected, actual = jax_side["state"], torch_side["state"]
    moved = 0
    for name, e in expected.items():
        a = actual[name]
        if "running" in name:
            np.testing.assert_allclose(a, e, rtol=0, atol=STATS_ATOL,
                                       err_msg=name)
            if bn == "live" and not np.array_equal(
                    a, convert.jax_variables_to_state_dict(
                        variables)[name].numpy()):
                moved += 1
        elif name.endswith("num_batches_tracked"):
            continue
        else:
            np.testing.assert_allclose(a, e, rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)
    # live batch norm moved the context encoder's statistics; frozen did not
    assert (moved > 0) == (bn == "live")


@pytest.mark.parametrize("bn", ["frozen", "live"])
def test_train_trajectory_matches_jax(variables, batch, bn):
    """Three steps, each side's own schedule, optimizer and clip."""
    jax_side, torch_side = _lockstep(variables, batch, frozen=bn == "frozen")
    assert torch_side["lrs"] == jax_side["lrs"]
    assert len(set(torch_side["lrs"])) == STEPS
    for a, e in zip(torch_side["losses"], jax_side["losses"]):
        assert abs(a - e) <= TRAJECTORY_REL * abs(e)
    assert torch_side["losses"][-1] != torch_side["losses"][0]


# -- schedules, clips and optimizers --------------------------------------------------


@pytest.mark.parametrize("cfg", [
    {"type": "one-cycle", "parameters": {
        "max_lr": 1.25e-4, "total_steps": "100000 + 100", "pct_start": 0.05,
        "cycle_momentum": False, "anneal_strategy": "linear"}},
    {"type": "one-cycle", "parameters": {
        "max_lr": 4e-4, "total_steps": "{n_epochs} * {n_batches}"}},
    {"type": "multi-step", "parameters": {
        "milestones": ["{n_batches}", "2 * {n_batches}"], "gamma": 0.5}},
], ids=["s1-things", "cos", "multi-step"])
def test_lr_schedule_matches_jax(cfg):
    variables = {"n_samples": 240, "n_batches": 40, "n_epochs": 3,
                 "n_accum": 1, "batch_size": 6}
    expected = jspec.SchedulerSpec.from_config(cfg).build(1e-3, variables)
    actual = tspec.SchedulerSpec.from_config(cfg).build(1e-3, variables)
    assert tspec.SchedulerSpec.from_config(cfg).get_config() == \
        jspec.SchedulerSpec.from_config(cfg).get_config()
    for _ in range(130):
        assert abs(actual.lr() - expected.lr()) <= 1e-12
        actual.step()
        expected.step()
    # past the end of the cycle the rate stays at its last value
    for sched in (actual, expected):
        sched.last_step = 10**6
    assert abs(actual.lr() - expected.lr()) <= 1e-12


def _grads(seed, scale):
    rs = np.random.RandomState(seed)
    return [(scale * rs.randn(*shape)).astype(np.float32)
            for shape in ((3, 4), (5,), (2, 2, 3))]


@pytest.mark.parametrize("clip,scale", [
    ({"type": "norm", "value": 1.0}, 3.0),
    ({"type": "norm", "value": 100.0}, 3.0),
    ({"type": "norm", "value": 2.0, "ord": "inf"}, 3.0),
    ({"type": "norm", "value": 2.0, "ord": 1}, 3.0),
    ({"type": "value", "value": 0.5}, 3.0),
], ids=["l2-engaged", "l2-idle", "inf", "l1", "value"])
def test_gradient_clip_matches_optax(clip, scale):
    grads = _grads(7, scale)
    tx = jspec.ClipGradient.from_config(clip).build_transform()
    expected, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    actual = [torch.from_numpy(g.copy()) for g in grads]
    tspec.ClipGradient.from_config(clip).apply(actual)
    for a, e in zip(actual, expected):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("opt", [
    {"type": "adam-w", "parameters": {"lr": 1e-3, "weight_decay": 1e-2}},
    {"type": "adam", "parameters": {"lr": 1e-3, "weight_decay": 1e-2,
                                    "betas": [0.8, 0.99], "eps": 1e-6}},
    {"type": "sgd", "parameters": {"lr": 1e-2, "momentum": 0.9,
                                   "weight_decay": 1e-3, "nesterov": True}},
    {"type": "sgd", "parameters": {"lr": 1e-2}},
], ids=["adam-w", "adam", "sgd-nesterov", "sgd"])
def test_optimizer_update_matches_optax(opt):
    """Three updates at changing learning rates, clip by norm first: the
    port's torch.optim chain against the JAX optax chain with the
    trainer's external ``-lr`` scaling."""
    gradient = {"clip": {"type": "norm", "value": 4.0}}
    params = _grads(1, 1.0)
    jtx, _ = jspec.OptimizerSpec.from_config(opt).build(
        jspec.GradientSpec.from_config(gradient))
    jparams = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jparams)

    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    ttx, _ = tspec.OptimizerSpec.from_config(opt).build(
        tparams, tspec.GradientSpec.from_config(gradient))

    for i, lr in enumerate((1e-2, 3e-2, 5e-3)):
        grads = _grads(10 + i, 2.0)
        updates, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate,
                                     jparams)
        jparams = optax.apply_updates(
            jparams, jax.tree.map(lambda u: -lr * u, updates))

        ttx.zero_grad()
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g.copy())
        ttx.update(lr)
        for a, e in zip(tparams, jparams):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(e),
                                       rtol=0, atol=1e-6)


def test_train_step_refuses_unported_options():
    tm = tmodels.load(_cfg())
    # (wire formats are ported: tests/test_torch_port_wire.py)
    for kwargs in ({"mesh": object()},
                   {"augment": object()}, {"accumulate": 2},
                   {"nonfinite": "skip"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            parallel.make_train_step(tm.model, tm.loss, **kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tspec.OptimizerSpec.from_config(OPTIMIZER).build(
            [torch.nn.Parameter(torch.zeros(2))],
            tspec.GradientSpec(accumulate=2))


# -- the train command ----------------------------------------------------------------


def _write_tree(root, frames=4, shape=(64, 96)):
    """A generic-layout scene of ``frames`` PNG frames and .flo flows, a
    tiny model config and a one-stage strategy."""
    h, w = shape
    rs = np.random.RandomState(5)
    (root / "frames").mkdir(parents=True)
    (root / "flows").mkdir()
    for i in range(frames):
        cv2.imwrite(str(root / "frames" / f"frame_{i:04d}.png"),
                    rs.randint(0, 256, (h, w, 3), dtype=np.uint8))
        tio.write_flow_mb(root / "flows" / f"frame_{i:04d}.flo",
                          rs.randn(h, w, 2).astype(np.float32))
    (root / "dataset.yaml").write_text(
        "name: synthetic\nid: synthetic\npath: .\n"
        "layout:\n  type: generic\n"
        "  images: 'frames/frame_{idx:04d}.png'\n"
        "  flows: 'flows/frame_{idx:04d}.flo'\n"
        "  key: 'synthetic/{idx:04d}'\n")
    (root / "model.yaml").write_text(json.dumps({
        "name": "RAFT baseline, tiny", "id": "raft/baseline",
        "model": {"type": "raft/baseline", "parameters": MODEL_PARAMS,
                  "arguments": {"iterations": ITERATIONS}},
        "loss": {"type": "raft/sequence"},
        "input": {"clip": [0, 1], "range": [-1, 1],
                  "padding": {"type": "modulo", "mode": "zeros",
                              "size": [8, 8]}}}))
    (root / "strategy.yaml").write_text(json.dumps({
        "mode": "continuous",
        "stages": [{
            "name": "synthetic", "id": "synthetic/s1",
            "data": {"epochs": 2, "batch-size": 1,
                     "source": {"type": "dataset", "spec": "dataset.yaml"}},
            "model": {"on-stage": {"freeze_batchnorm": True}},
            "optimizer": {"type": "adam-w", "parameters": {
                "lr": 1.25e-4, "weight_decay": 1e-4, "eps": 1e-8}},
            "lr-scheduler": {"instance": [SCHEDULE]},
            "gradient": GRADIENT,
            "loader": {"num_workers": 0},
        }]}))


def test_train_command_on_cpu(tmp_path):
    """``main train --device cpu --limit-steps 2``: two finite steps, the
    run directory, and a seeded rerun that repeats the losses exactly."""
    _write_tree(tmp_path / "data")
    seeds = ROOT / "cfg" / "seeds" / "fixed.yaml"
    histories = []
    for run in ("a", "b"):
        tctx = port_main.main([
            "train", "-d", str(tmp_path / "data" / "strategy.yaml"),
            "-m", str(tmp_path / "data" / "model.yaml"),
            "-o", str(tmp_path / "runs"), "--suffix", run,
            "-s", str(seeds), "--reproduce",
            "--limit-steps", "2", "--device", "cpu"])
        histories.append(tctx.history)
        assert tctx.step == 2 and len(tctx.history) == 2
        assert all(np.isfinite(h["loss"]) and h["finite"]
                   for h in tctx.history)

        files = {p.name for p in tctx.path.iterdir()}
        assert {"config.json", "main.log", "model.txt"} <= files
        config = json.loads((tctx.path / "config.json").read_text())
        assert config["seeds"] == {"python": 1234, "numpy": 5678,
                                   "torch": 9012}
        assert config["model"]["model"]["type"] == "raft/baseline"
        stage = config["strategy"]["stages"][0]
        assert stage["optimizer"]["type"] == "adam-w"
        assert "update_block" in (tctx.path / "model.txt").read_text()
    assert [h["loss"] for h in histories[0]] == \
        [h["loss"] for h in histories[1]]


def test_train_command_defaults_to_cuda(tmp_path):
    """Without --device the command trains on CUDA; here, with no CUDA, it
    exits non-zero naming it instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _write_tree(tmp_path / "data", frames=2)
    proc = subprocess.run(
        [sys.executable, "-m", "raft_meets_dicl_tpu_torch.main", "train",
         "-d", str(tmp_path / "data" / "strategy.yaml"),
         "-m", str(tmp_path / "data" / "model.yaml"),
         "-o", str(tmp_path / "runs"), "--limit-steps", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "torch.cuda.is_available()" in proc.stderr
    assert not (tmp_path / "runs").exists()
