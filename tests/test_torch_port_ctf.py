"""PyTorch port: the thesis flagship ``raft+dicl/ctf-l3`` held against the
JAX package on the CPU, with weights bridged from the JAX init
(``convert``), on the same numpy batch.

- the whole forward, every level's flows, in the plain, ``corr_flow`` and
  ``corr_flow`` + ``prev_flow`` output structures, in float32 and under the
  bf16 mixed-precision policy;
- one train step against the JAX ``make_train_step`` with live batch norm
  (the s0-chairs stage): loss, every gradient, parameters and batch-norm
  statistics after the AdamW + clip update;
- the weight bridge's coverage: a strict ``load_state_dict`` for ctf-l2,
  l3 and l4 with ``share-dicl``, ``share-rnn``, every ``upsample-hidden``
  and both readouts;
- ``raft/baseline`` with ``corr-reg-type: softargmax+dap``;
- the configs in both packages, serving and ``main train`` on the CPU.

The model is ctf-l3 at radius 4 cut to corr-channels 16, context and
recurrent 32 and a MatchingNet at scale 0.25, on a 2x64x128 batch.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu.strategy.spec as jspec
from raft_meets_dicl_tpu.parallel import TrainState as JTrainState
from raft_meets_dicl_tpu.parallel import make_train_step as jmake_train_step
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import convert, evaluation, parallel, serve
from raft_meets_dicl_tpu_torch import main as port_main
from raft_meets_dicl_tpu_torch import strategy
from raft_meets_dicl_tpu_torch.data import io as tio
from raft_meets_dicl_tpu_torch.serve import loadgen
from test_torch_port_train import _flax_init, _one_thread
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

PARAMS = {"corr-radius": 4, "corr-channels": 16, "context-channels": 32,
          "recurrent-channels": 32, "corr-args": {"mnet_scale": 0.25}}
LOSS = {"type": "raft+dicl/mlseq",
        "arguments": {"ord": 1, "gamma": 0.85, "alpha": [0.38, 0.6, 1.0]}}
# the forwards run two iterations at the coarsest level, one at the others
# (each level's every output structure, with the (prev, flow) pairs of a
# level's first iteration and a later one); the port's forward is most of
# a case's time
ITERATIONS = (2, 1, 1)
# the train step: the JAX side's unrolled live-BN step compiles in ~35 s
# at (2, 1, 1)
STEP_ITERATIONS = (2, 1, 1)

# Forward bounds, relative to each output's largest |flow| (the JAX init's
# random weights gave flows up to ~1 px at the coarsest level and ~130 px
# at the finest). float32: the same arithmetic summed in another order
# (native torch convs vs XLA:CPU at 'highest') through the recurrent
# iterations; 10 of them read <= 2.3e-6 (1.8e-4 px on the finest level's
# 129 px)
F32_REL = 1e-5
# bf16 policy: the two frameworks round to bf16 at other places (conv bias
# adds, GRU gate sums, the split first MatchingNet conv). That noise is
# the policy's own: the JAX bf16 run is 1.1-2.0% off the JAX f32 run, the
# port's bf16 run 1.3-1.8% off the JAX bf16 run. So this bound alone
# cannot tell a port that ignores the policy (one in f32 reads ~2% too):
# the test also holds the dtypes at the policy's rounding points and
# requires the bf16 run to differ from the port's f32 run
BF16_REL = 0.025
# the port's bf16 run against its f32 run, relative: at least this (the
# rounding happened), a tenth of the JAX runs' gap
BF16_MIN_EFFECT = 1e-3

# s0-chairs' AdamW (lr 4e-4, weight decay 1e-4) and clip, but eps 1e-3:
# with 1e-8 Adam's first update is lr * sign(g), so a gradient element
# that is rounding noise on both sides moves its weight by +-lr at random
OPTIMIZER = {"type": "adam-w",
             "parameters": {"lr": 4e-4, "weight_decay": 1e-4, "eps": 1e-3}}
GRADIENT = {"clip": {"type": "norm", "value": 1.0}}
LR = 4e-4
LOSS_REL = 1e-5
# each gradient tensor, relative L2: reads <= 2.1e-4 ...
GRAD_REL_L2 = 1e-3
# ... except on the finest level's path (its MatchingNet and heads, and
# the encoders' stems, whose gradient that level dominates): there the
# JAX f32 run is itself 5.3e-3 to 9.0e-3 off a float64 run of the port,
# the port's f32 run at most 1.9e-3 (2.7e-3 in fnet's instance-normalized
# stem, as on both sides for raft)
FINE = ("corr_3.", "fnet.out3.", "cnet.out3.", "fnet.conv1.", "cnet.conv1.",
        "cnet.norm1.", "fnet.layer1.", "fnet.layer2.", "fnet.layer3.",
        "cnet.layer1.", "cnet.layer2.", "cnet.layer3.")
GRAD_REL_L2_FINE = 2e-2
# a conv bias right before an instance norm has a zero gradient by
# construction: bounded in norm, not compared
ZERO_GRAD = 1e-6
# the update (each parameter tensor after the step minus before) is held
# to the gradient bounds, relative L2 (AdamW's first step at eps 1e-3 is
# about linear in the clipped gradient), plus the rounding of the stored
# parameters (one float32 ulp each: a batch-norm scale near 1 moves ~1e-4)
STATS_ATOL = 1e-5
# the lockstep's port side runs on this many torch threads, whatever the
# process had: the gradient sums' order follows the thread count, and one
# element on level 4's cost path lies at a rounding kink. At 2, 4, 5 and
# 12 threads corr_4.mnet.0.0.weight's gradient reads 2.183e-3 relative L2
# (over GRAD_REL_L2), at 3, 6, 7 and 8 threads 8.5e-6 to 9.2e-6; on one
# thread cnet.out4.conv1.weight reads 2.0e-3. A process left at its
# default gets every core with MKL's dynamic threading, which may run
# fewer under the suite's other workers: the reading moved between runs
LOCKSTEP_THREADS = 3


def _cfg(mixed_precision=False, iterations=ITERATIONS, params=PARAMS):
    return {
        "name": "RAFT+DICL ctf-l3, narrow", "id": "raft+dicl/ctf-l3",
        "model": {"type": "raft+dicl/ctf-l3",
                  "parameters": {**params,
                                 "mixed-precision": mixed_precision},
                  "arguments": {"iterations": list(iterations)}},
        "loss": LOSS,
        "input": None,
    }


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(0)
    img1, img2 = (rs.uniform(-1, 1, (2, 64, 128, 3)).astype(np.float32)
                  for _ in range(2))
    flow = (4 * rs.randn(2, 64, 128, 2)).astype(np.float32)
    valid = rs.rand(2, 64, 128) > 0.2
    return img1, img2, flow, valid


@pytest.fixture(scope="module")
def variables(batch):
    """JAX ctf-l3 variables (numpy tree) over the JAX init's shapes
    (``jax.eval_shape``: no init program compiled), drawn from a seed as
    flax initializes them (``_flax_init``), batch statistics away from
    their (0, 1) init. The f32 and the bf16-policy models share the
    tree."""
    return _flax_init(jmodels.load(_cfg()).model, 1, jnp.asarray(batch[0]),
                      jnp.asarray(batch[1]))


def _port_model(cfg, variables):
    spec = tmodels.load(cfg)
    spec.model.init(device="cpu")
    convert.load_jax_variables(spec.model.module, variables)
    return spec


def _max_rel(actual, expected):
    """Walk two output trees (lists of levels, lists of iterations, (prev,
    flow) tuples) in step: same structure and shapes; the largest |diff| of
    a flow over that flow's largest |value| (at least 1 px)."""
    if isinstance(expected, (list, tuple)):
        assert type(actual) is type(expected) and len(actual) == len(expected)
        return max(_max_rel(a, e) for a, e in zip(actual, expected))
    assert tuple(actual.shape) == expected.shape
    assert actual.dtype == torch.float32
    e = np.asarray(expected)
    return float(np.abs(actual.numpy() - e).max() / max(np.abs(e).max(), 1.0))


@pytest.fixture(scope="module")
def jax_outputs(variables, batch):
    """The JAX f32 forward with ``corr_flow`` and ``prev_flow``: every
    level's readout list before its flow list, entries (prev, flow)
    pairs. The flags only select what is returned (the readouts are
    computed either way), so the other structures are parts of this one
    (``_select``): one JAX program for the three cases."""
    x1, x2 = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    model = jmodels.load(_cfg()).model
    return jax.tree.map(np.asarray, jax.jit(
        lambda v: model.apply(v, x1, x2, corr_flow=True, prev_flow=True))(
            jax.tree.map(jnp.asarray, variables)))


def _select(outputs, args):
    """The JAX output structure for ``args`` out of ``jax_outputs``'."""
    if args.get("prev_flow"):
        return outputs
    levels = [[entry[-1] for entry in level] for level in outputs]
    return levels if args.get("corr_flow") else levels[1::2]


@pytest.mark.parametrize("args", [
    {}, {"corr_flow": True}, {"corr_flow": True, "prev_flow": True},
], ids=["flows", "corr_flow", "corr_flow+prev_flow"])
def test_ctf_l3_f32_matches_jax_every_level(variables, batch, jax_outputs,
                                            args):
    expected = _select(jax_outputs, args)

    spec = _port_model(_cfg(), variables)
    actual, final = evaluation.make_eval_fn(spec.model, args)(
        torch.from_numpy(batch[0]), torch.from_numpy(batch[1]))

    n_out = 6 if args.get("corr_flow") else 3
    assert len(actual) == len(expected) == n_out
    for level, n in zip(actual[n_out // 3 - 1::n_out // 3], ITERATIONS):
        assert len(level) == n
    assert _max_rel(actual, expected) <= F32_REL
    # coarse to fine: the finest level is upsampled to the input
    last = actual[-1][-1]
    assert (last[-1] if isinstance(last, tuple) else last) is final
    assert tuple(final.shape) == (2, 64, 128, 2)
    coarsest = actual[0][0]
    if isinstance(coarsest, tuple):
        coarsest = coarsest[-1]
    assert tuple(coarsest.shape) == (2, 2, 4, 2)


def _policy_dtypes(module):
    """Forward hooks that record the dtypes at the bf16 policy's rounding
    points: each conv's compute (output) dtype by module name, each
    MatchingNet's input pair (f1, window), and each correlation module's
    coords and cost. Returns the record and the hook handles."""
    from raft_meets_dicl_tpu_torch.models.common.blocks.dicl import MatchingNet
    from raft_meets_dicl_tpu_torch.models.common.corr.dicl import (
        CorrelationModule,
    )
    from raft_meets_dicl_tpu_torch.models.common.util import (
        Conv2d,
        ConvTranspose2d,
    )

    seen = {"conv": {}, "mnet_in": [], "coords": [], "cost": []}

    def cmod_hook(m, args, cost):
        seen["coords"].append(args[2].dtype)
        seen["cost"].append(cost.dtype)

    handles = []
    for name, m in module.named_modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            handles.append(m.register_forward_hook(
                lambda m, a, out, name=name:
                seen["conv"].setdefault(name, set()).add(out.dtype)))
        elif isinstance(m, MatchingNet):
            handles.append(m.register_forward_pre_hook(
                lambda m, a: seen["mnet_in"].append(
                    tuple(t.dtype for t in a[0]))))
        elif isinstance(m, CorrelationModule):
            handles.append(m.register_forward_hook(cmod_hook))
    return seen, handles


def test_ctf_l3_bf16_policy_matches_jax(variables, batch, jax_outputs):
    x1, x2 = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    model = jmodels.load(_cfg(mixed_precision=True)).model
    expected = jax.jit(lambda v: model.apply(v, x1, x2))(
        jax.tree.map(jnp.asarray, variables))
    imgs = torch.from_numpy(batch[0]), torch.from_numpy(batch[1])

    spec = _port_model(_cfg(mixed_precision=True), variables)
    assert spec.model.module.compute_dtype == torch.bfloat16
    seen, handles = _policy_dtypes(spec.model.module)
    actual, _ = evaluation.make_eval_fn(spec.model)(*imgs)
    for handle in handles:
        handle.remove()
    assert _max_rel(actual, expected) <= BF16_REL

    # the rounding points (JAX raft_dicl_ctf.py's policy): every conv of
    # the encoders, MatchingNets, update block and Up8 head computes in
    # bf16, the DAPs in float32; the window reaches each MatchingNet cast
    # to bf16 with f1; coords and costs stay float32 (flows: _max_rel)
    assert seen["conv"]
    for name, dtypes in seen["conv"].items():
        want = torch.float32 if ".dap." in name else torch.bfloat16
        assert dtypes == {want}, (name, dtypes)
    for part in ("fnet.", "cnet.", "corr_3.mnet.", "update_block.", "upnet."):
        assert any(n.startswith(part) for n in seen["conv"]), part
    assert seen["mnet_in"] == [(torch.bfloat16, torch.bfloat16)] \
        * sum(ITERATIONS)
    assert set(seen["coords"]) == set(seen["cost"]) == {torch.float32}

    # the policy changes the result: the same weights in float32 (JAX's
    # f32 run, which the port's matches within F32_REL) differ
    assert _max_rel(actual, _select(jax_outputs, {})) >= BF16_MIN_EFFECT


# -- one train step in lockstep ----------------------------------------------------


@pytest.fixture(scope="module")
def lockstep(variables, batch):
    """One train step with live batch norm in both packages from the same
    weights and batch. Returns (jax side, port side): loss, gradients by
    port name, state_dict after the step, aux."""
    cfg = _cfg(iterations=STEP_ITERATIONS)
    jm = jmodels.load(cfg)
    jm.model.on_stage(None, freeze_batchnorm=False)
    jtx, _ = jspec.OptimizerSpec.from_config(OPTIMIZER).build(
        jspec.GradientSpec.from_config(GRADIENT))
    jstep = jmake_train_step(jm.model, jm.loss, jtx, external_lr=True,
                             with_grads=True, donate=False)
    state = JTrainState.create(jax.tree.map(jnp.asarray, variables), jtx)
    state, jaux = jstep(state, LR, *(jnp.asarray(x) for x in batch))
    rules = convert.ctf_rules(3, False, True, "none")
    jax_side = {
        "aux": jax.tree.map(np.asarray, jaux),
        "grads": {k: v.numpy() for k, v in convert.jax_variables_to_state_dict(
            {"params": jax.tree.map(np.asarray, jaux["grads"])},
            rules).items()},
        "state": {k: v.numpy() for k, v in convert.jax_variables_to_state_dict(
            jax.tree.map(np.asarray, state.variables()), rules).items()},
    }

    tm = _port_model(cfg, variables)
    tm.model.on_stage(None, freeze_batchnorm=False)
    ttx, _ = strategy.spec.OptimizerSpec.from_config(OPTIMIZER).build(
        tm.model.module.parameters(),
        strategy.spec.GradientSpec.from_config(GRADIENT))
    tstep = parallel.make_train_step(tm.model, tm.loss, with_grads=True)
    # true float32 convolutions, as the JAX side runs at 'highest', on
    # LOCKSTEP_THREADS torch threads
    threads = torch.get_num_threads()
    torch.set_num_threads(LOCKSTEP_THREADS)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            _, taux = tstep(parallel.TrainState(tm.model, ttx), LR,
                            *(torch.from_numpy(x) for x in batch))
    finally:
        torch.set_num_threads(threads)
    torch_side = {
        "aux": taux,
        "grads": {k: g.numpy() for k, g in taux["grads"].items()},
        "state": {k: v.detach().clone().numpy()
                  for k, v in tm.model.module.state_dict().items()},
    }
    return jax_side, torch_side


def test_ctf_train_step_matches_jax(lockstep, variables):
    jax_side, torch_side = lockstep
    jaux, taux = jax_side["aux"], torch_side["aux"]

    loss_rel = abs(float(taux["loss"]) - float(jaux["loss"])) \
        / abs(float(jaux["loss"]))
    assert loss_rel <= LOSS_REL
    assert bool(taux["finite"]) and bool(jaux["finite"])
    for key in ("grad_norm", "update_norm"):
        assert abs(float(taux[key]) - float(jaux[key])) \
            <= 1e-4 * float(jaux[key]), key
    # batch statistics in train mode: reads 1.05e-5 (~1e-4 px)
    assert _max_rel(taux["final"], jaux["final"]) <= 5e-5

    expected, actual = jax_side["grads"], torch_side["grads"]
    assert set(actual) == set(expected)
    total = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                        for g in expected.values()))
    zero = set()
    for name, e in expected.items():
        a = actual[name]
        if np.linalg.norm(e) <= ZERO_GRAD * total:
            assert np.linalg.norm(a) <= ZERO_GRAD * total, name
            zero.add(name)
            continue
        rel = np.linalg.norm(a - e) / np.linalg.norm(e)
        bound = GRAD_REL_L2_FINE if name.startswith(FINE) else GRAD_REL_L2
        assert rel <= bound, (name, rel)
    # the MatchingNets and the pyramid heads of every level train
    for lvl in (3, 4, 5):
        assert np.abs(actual[f"corr_{lvl}.mnet.0.0.weight"]).max() > 0
    assert np.abs(actual["fnet.out5.conv1.weight"]).max() > 0

    initial = convert.jax_variables_to_state_dict(
        variables, convert.ctf_rules(3, False, True, "none"))
    moved = 0
    for name, e in jax_side["state"].items():
        a = torch_side["state"][name]
        if "running" in name:
            np.testing.assert_allclose(a, e, rtol=0, atol=STATS_ATOL,
                                       err_msg=name)
            moved += not np.array_equal(a, initial[name].numpy())
        elif name in expected and name not in zero:
            before = initial[name].numpy()
            bound = GRAD_REL_L2_FINE if name.startswith(FINE) else GRAD_REL_L2
            assert np.linalg.norm(a - e) <= bound * np.linalg.norm(e - before) \
                + np.linalg.norm(np.spacing(e)), name
    # live batch norm moved the MatchingNets' and the context encoder's
    # statistics
    assert moved > 0
    assert not np.array_equal(torch_side["state"]["corr_3.mnet.0.1.running_mean"],
                              initial["corr_3.mnet.0.1.running_mean"].numpy())


# -- the weight bridge's coverage --------------------------------------------------

# every level count with every hidden-state upsampler; each sharing
# combination and both readouts at least twice
_VARIANTS = [
    (2, "none", False, True, "softargmax"),
    (2, "bilinear", True, False, "softargmax+dap"),
    (2, "crossattn", False, False, "softargmax"),
    (3, "none", True, True, "softargmax+dap"),
    (3, "bilinear", False, True, "softargmax"),
    (3, "crossattn", True, False, "softargmax+dap"),
    (4, "none", False, False, "softargmax+dap"),
    (4, "bilinear", True, True, "softargmax"),
    (4, "crossattn", False, True, "softargmax+dap"),
]


@pytest.mark.parametrize("levels,hup,share_dicl,share_rnn,reg", _VARIANTS)
def test_bridge_covers_ctf_variants(levels, hup, share_dicl, share_rnn, reg):
    """Every JAX leaf has a rule and a port key of its shape, and every
    port parameter and buffer is covered: strict load, nothing missing or
    left over."""
    cfg = _cfg(iterations=(1,) * levels, params={
        "corr-radius": 2, "corr-channels": 8, "context-channels": 8,
        "recurrent-channels": 8, "corr-args": {"mnet_scale": 0.125},
        "share-dicl": share_dicl, "share-rnn": share_rnn,
        "upsample-hidden": hup, "corr-reg-type": reg})
    cfg["model"]["type"] = f"raft+dicl/ctf-l{levels}"
    size = 16 * 2 ** (levels - 1)
    img = jnp.zeros((1, size, size, 3), jnp.float32)
    model = jmodels.load(cfg).model
    shapes = jax.eval_shape(lambda k: model.init(k, img, img),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(levels)
    variables = jax.tree.map(
        lambda s: rs.randn(*s.shape).astype(np.float32), shapes)

    module = tmodels.load(cfg).model.module
    convert.load_jax_variables(module, variables)
    state = module.state_dict()
    n_leaves = len(jax.tree.leaves(variables))
    n_bn = sum(k.endswith("num_batches_tracked") for k in state)
    assert len(state) == n_leaves + n_bn
    assert any(k.startswith("corr.mnet" if share_dicl else f"corr_{levels + 2}.")
               for k in state)
    assert any(k.startswith("update_block." if share_rnn else
                            "update_block_3.") for k in state)
    assert any(k.startswith("upnet_h") for k in state) == (hup != "none")
    assert any(".dap.conv1" in k and k.startswith("flow_reg")
               for k in state) == (reg == "softargmax+dap")


# -- raft/baseline with the DAP readout -------------------------------------------


def test_raft_softargmax_dap_matches_jax():
    cfg = {
        "name": "RAFT baseline, DAP readout", "id": "raft/baseline",
        "model": {"type": "raft/baseline",
                  "parameters": {"corr-levels": 2, "corr-radius": 2,
                                 "corr-channels": 32, "context-channels": 16,
                                 "recurrent-channels": 16,
                                 "corr-reg-type": "softargmax+dap"},
                  "arguments": {"iterations": 2, "corr_flow": True}},
        "loss": {"type": "raft/sequence"},
        "input": None,
    }
    rs = np.random.RandomState(3)
    img1, img2 = (rs.uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32)
                  for _ in range(2))
    x1, x2 = jnp.asarray(img1), jnp.asarray(img2)
    jm = jmodels.load(cfg).model
    v = _flax_init(jm, 4, x1, x2)
    reg = v["params"]["ScanCheckpoint_RaftStep_0"]["SoftArgMaxFlowRegression_0"]
    assert sorted(reg) == ["DisplacementAwareProjection_0",
                           "DisplacementAwareProjection_1"]
    # away from the identity init, so the projections are exercised
    for dap in reg.values():
        dap["Conv_0"]["kernel"] = (dap["Conv_0"]["kernel"] + 0.05 * rs.randn(
            *dap["Conv_0"]["kernel"].shape)).astype(np.float32)
    expected = jax.jit(lambda v: jm.apply(v, x1, x2))(
        jax.tree.map(jnp.asarray, v))

    spec = tmodels.load(cfg)
    spec.model.init(device="cpu")
    convert.load_jax_variables(spec.model.module, v)
    actual, _ = evaluation.make_eval_fn(spec.model)(
        torch.from_numpy(img1), torch.from_numpy(img2))
    *levels, flows = actual
    assert len(levels) == 2
    # flows of ~2 px: the raft forward test's 1e-4 px, relative
    assert _max_rel(actual, expected) <= 1e-4


# -- configs, serving and training on the CPU ---------------------------------------


@pytest.mark.parametrize("name", ["raft+dicl-ctf2l.yaml", "raft+dicl-ctf3l.yaml",
                                  "raft+dicl-ctf4l.yaml"])
def test_ctf_configs_load_unchanged_in_both_packages(name):
    from pathlib import Path

    path = Path(__file__).parent.parent / "cfg" / "model" / name
    jsp, tsp = jmodels.load(path), tmodels.load(path)
    assert tsp.id == jsp.id
    assert tsp.model.get_config() == jsp.model.get_config()
    assert tsp.loss.get_config() == jsp.loss.get_config()
    assert tsp.input.get_config() == jsp.input.get_config()


def _tiny_cfg():
    cfg = _cfg(iterations=(2, 1, 1), params={
        "corr-radius": 4, "corr-channels": 8, "context-channels": 8,
        "recurrent-channels": 8, "corr-args": {"mnet_scale": 0.125}})
    cfg["input"] = {"clip": [0, 1], "range": [-1, 1],
                    "padding": {"type": "modulo", "mode": "zeros",
                                "size": [64, 64]}}
    return cfg


def test_ctf_serves_on_cpu():
    session = serve.ServeSession(tmodels.load(_tiny_cfg()), "64x128",
                                 batch_size=2, device="cpu")
    session.warm_pool()
    scheduler = serve.Scheduler(session, max_wait_ms=20).start()
    try:
        report = loadgen.run_open_loop(scheduler, [(64, 128), (56, 120)],
                                       requests=3, rate_hz=50, seed=4)
    finally:
        scheduler.stop()
    assert report["completed"] == 3 and not report["errors"]
    for result in report["results"]:
        assert result.flow.shape == (*result.shape, 2)
        assert np.isfinite(result.flow).all()


def test_ctf_train_command_on_cpu(tmp_path):
    """``main train --device cpu``: two finite steps with live batch norm
    (the s0-chairs stage setting) on a generic-layout tree."""
    root = tmp_path / "data"
    (root / "frames").mkdir(parents=True)
    (root / "flows").mkdir()
    rs = np.random.RandomState(6)
    for i in range(3):
        cv2.imwrite(str(root / "frames" / f"frame_{i:04d}.png"),
                    rs.randint(0, 256, (64, 128, 3), dtype=np.uint8))
        tio.write_flow_mb(root / "flows" / f"frame_{i:04d}.flo",
                          rs.randn(64, 128, 2).astype(np.float32))
    (root / "dataset.yaml").write_text(
        "name: synthetic\nid: synthetic\npath: .\n"
        "layout:\n  type: generic\n"
        "  images: 'frames/frame_{idx:04d}.png'\n"
        "  flows: 'flows/frame_{idx:04d}.flo'\n"
        "  key: 'synthetic/{idx:04d}'\n")
    (root / "model.yaml").write_text(json.dumps(_tiny_cfg()))
    (root / "strategy.yaml").write_text(json.dumps({
        "mode": "continuous",
        "stages": [{
            "name": "synthetic", "id": "synthetic/s0",
            "data": {"epochs": 1, "batch-size": 2,
                     "source": {"type": "dataset", "spec": "dataset.yaml"}},
            "model": {"on-stage": {"freeze_batchnorm": False}},
            "optimizer": {"type": "adam-w", "parameters": {
                "lr": 4e-4, "weight_decay": 1e-4, "eps": 1e-8}},
            "gradient": GRADIENT,
            "loader": {"num_workers": 0},
        }]}))
    with _one_thread():  # the suite's workers would oversubscribe the cores
        tctx = port_main.main([
            "train", "-d", str(root / "strategy.yaml"),
            "-m", str(root / "model.yaml"), "-o", str(tmp_path / "runs"),
            "--limit-steps", "1", "--device", "cpu"])
    assert tctx.step == 1 and len(tctx.history) == 1
    assert all(np.isfinite(h["loss"]) and h["finite"] for h in tctx.history)
    assert not tctx.model.frozen_batchnorm
