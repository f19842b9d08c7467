"""PyTorch port: both forms of gradient accumulation and the skip guard held
against the JAX package on the CPU, from the same weights and the same
numpy batch.

- in-step accumulation (``make_train_step(accumulate=2)``): one update
  from a 2-sample batch run as two microbatches of 1, against JAX's
  ``lax.scan`` over microbatches, with frozen and with live batch norm
  (whose statistics chain from microbatch to microbatch);
- the skip guard (``nonfinite='skip'``), on the live-BN in-step program:
  a step at a NaN learning rate leaves the port's parameters, batch-norm
  statistics and optimizer state bit for bit, counts one trip and
  reports the update not applied, as JAX does; the clean step after it
  is the in-step comparison above, and Adam's step count equals JAX's;
- a stage's ``gradient.accumulate: 2`` (JAX ``optax.MultiSteps``) on the
  same gradients on both sides: the first call changes no parameter, the
  second applies the clipped mean; a JAX ``RMDT2`` checkpoint written
  between the calls loads into the port and finishes the update as JAX
  does, and the port's own ``RMDP1`` file written there resumes to the
  uninterrupted run bit for bit;
- a stage's ``gradient.accumulate: 2`` under the skip guard with one
  microbatch skipped in the middle of a group: the updates land on the
  calls JAX's guarded ``optax.MultiSteps`` applies them on (the skip puts
  the group's count back), the first equal to JAX's, and the run equal
  bit for bit to the unguarded one that never saw the skipped batch;
- the port's in-step 2 x 1 against its own one step of 2;
- ``main train`` with a stage's ``gradient.accumulate: 2``: the step
  count moves every second batch, and no partial mean is left.

The model, the batch, the weights (the JAX init, bridged with
``convert``) and the bounds are ``test_torch_port_train.py``'s. The two
JAX step programs compile once in the module, in two threads.
"""

import concurrent.futures
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu.strategy.checkpoint as jchk
import raft_meets_dicl_tpu.strategy.spec as jspec
from raft_meets_dicl_tpu.parallel import TrainState as JTrainState
from raft_meets_dicl_tpu.parallel import make_train_step as jmake_train_step
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import convert, parallel, strategy
from raft_meets_dicl_tpu_torch import main as port_main
from raft_meets_dicl_tpu_torch.strategy import checkpoint as tchk
from test_torch_port_train import (  # noqa: F401 (fixtures)
    GRAD_REL_L2_STEM, GRADIENT, LOSS_REL, OPTIMIZER, PARAM_ATOL, STATS_ATOL,
    STEM, _cfg, _check_grads, _one_thread, _write_tree, batch, variables)
from test_torch_port_train import port_on_one_thread  # noqa: F401

tspec = strategy.spec

pytestmark = pytest.mark.torch_port

LR = 1e-3
# the feature encoder's half-resolution stem: its gradients are held to
# GRAD_REL_L2_STEM (the sum cancels through the instance norms). A first
# Adam update lr * g / (|g| + eps) moves by at most lr / eps times the
# gradient's change, element by element, so a stem weight after the
# update is held to lr / eps * GRAD_REL_L2_STEM * |g| of its tensor's JAX
# gradient g (reads <= 1.2e-5 with one-sample microbatches, where other
# weights hold PARAM_ATOL)
EPS = OPTIMIZER["parameters"]["eps"]


def port_model(variables, frozen):
    tm = tmodels.load(_cfg())
    tm.model.init(device="cpu")
    convert.load_jax_variables(tm.model.module, variables)
    tm.model.on_stage(None, freeze_batchnorm=frozen)
    return tm


def _port_tx(tm, gradient=GRADIENT):
    tx, _ = tspec.OptimizerSpec.from_config(OPTIMIZER).build(
        tm.model.module.parameters(), tspec.GradientSpec.from_config(gradient))
    return tx


def _run(step, state, lr, batch):
    with torch.backends.mkldnn.flags(enabled=False), _one_thread():
        return step(state, lr, *(torch.from_numpy(x) for x in batch))


def _grads(tree):
    return {k: v.numpy() for k, v in convert.jax_variables_to_state_dict(
        {"params": jax.tree.map(np.asarray, tree)}).items()}


def _jax_state_dict(variables):
    return {k: v.numpy() for k, v in convert.jax_variables_to_state_dict(
        jax.tree.map(np.asarray, variables)).items()}


def _check_state(expected, actual, grads):
    """Parameters within PARAM_ATOL (the stem's within the bound its
    gradients in ``grads`` give), statistics within STATS_ATOL."""
    for name, e in expected.items():
        a = actual[name].detach().numpy()
        if name.endswith("num_batches_tracked"):
            continue
        if "running" in name:
            bound = STATS_ATOL
        elif name.startswith(STEM):
            bound = max(PARAM_ATOL, LR / EPS * GRAD_REL_L2_STEM
                        * float(np.linalg.norm(grads[name])))
        else:
            bound = PARAM_ATOL
        np.testing.assert_allclose(a, e, rtol=0, atol=bound, err_msg=name)


def _adam_count(opt_state):
    counts = [leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(opt_state)[0]
              if "count" in jax.tree_util.keystr(path)]
    assert len(counts) == 1
    return int(counts[0])


@pytest.fixture(scope="module")
def jax_runs(variables, batch):
    """frozen: one in-step accumulation step. live: the skip-guarded
    in-step program, a step at a NaN rate, then one at LR."""
    def run(bn):
        jm = jmodels.load(_cfg())
        jm.model.on_stage(None, freeze_batchnorm=bn == "frozen")
        jtx, _ = jspec.OptimizerSpec.from_config(OPTIMIZER).build(
            jspec.GradientSpec.from_config(GRADIENT))
        guard = "skip" if bn == "live" else None
        jstep = jmake_train_step(jm.model, jm.loss, jtx, external_lr=True,
                                 with_grads=True, donate=False, accumulate=2,
                                 nonfinite=guard)
        state = JTrainState.create(jax.tree.map(jnp.asarray, variables), jtx)
        out = {}
        args = [jnp.asarray(x) for x in batch]
        if guard:
            state, aux = jstep(state, float("nan"), *args)
            out["nan"] = (jax.tree.map(np.asarray, aux), _adam_count(
                state.opt_state), _jax_state_dict(state.variables()))
        state, aux = jstep(state, LR, *args)
        out["clean"] = (jax.tree.map(np.asarray, aux),
                        _adam_count(state.opt_state),
                        _jax_state_dict(state.variables()))
        return out

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return dict(zip(("frozen", "live"), pool.map(run, ("frozen", "live"))))


_PORT = {}


def _port_runs(variables, batch, bn):
    """The port's side of ``jax_runs``."""
    if bn in _PORT:
        return _PORT[bn]
    tm = port_model(variables, bn == "frozen")
    tx = _port_tx(tm)
    guard = "skip" if bn == "live" else None
    step = parallel.make_train_step(tm.model, tm.loss, with_grads=True,
                                    accumulate=2, nonfinite=guard)
    state = parallel.TrainState(tm.model, tx)
    out = {"start": {k: v.clone() for k, v in
                     tm.model.module.state_dict().items()}}
    if guard:
        state, aux = _run(step, state, float("nan"), batch)
        out["nan"] = (aux, {k: v.clone() for k, v in
                            tm.model.module.state_dict().items()},
                      {k: v.clone() for k, v in tx.snapshot().items()})
    state, aux = _run(step, state, LR, batch)
    out["clean"] = (aux, tm.model.module.state_dict(), tx)
    _PORT[bn] = out
    return out


@pytest.mark.parametrize("bn", ["frozen", "live"])
def test_in_step_accumulation_matches_jax(variables, batch, jax_runs, bn):
    """Loss (mean of the microbatch means), the mean gradient, every
    parameter and statistic after the update, the finals concatenated."""
    jaux, _, expected = jax_runs[bn]["clean"]
    port = _port_runs(variables, batch, bn)
    taux, tstate, _ = port["clean"]

    assert abs(float(taux["loss"]) - float(jaux["loss"])) \
        <= LOSS_REL * abs(float(jaux["loss"]))
    assert bool(taux["finite"]) and bool(jaux["finite"])
    assert taux["final"].shape == batch[2].shape
    np.testing.assert_allclose(taux["final"].numpy(), jaux["final"],
                               rtol=0, atol=1e-4)
    for key in ("grad_norm", "update_norm"):
        assert abs(float(taux[key]) - float(jaux[key])) \
            <= 1e-5 * float(jaux[key]), key
    jgrads = _grads(jaux["grads"])
    _check_grads(jgrads, {k: g.numpy() for k, g in taux["grads"].items()})
    _check_state(expected, tstate, jgrads)
    moved = [k for k in expected if "running" in k
             and not torch.equal(tstate[k], port["start"][k])]
    assert bool(moved) == (bn == "live")


def test_skip_guard_matches_jax(variables, batch, jax_runs):
    """The NaN-rate step: nothing moves on the port, bit for bit, one trip
    on both sides; then Adam's count is 1 on both sides (the skipped step
    did not count), and the clean step matched (the test above)."""
    jaux, jcount, _ = jax_runs["live"]["nan"]
    port = _port_runs(variables, batch, "live")
    taux, tstate, topt = port["nan"]

    assert not bool(jaux["finite"]) and not bool(taux["finite"])
    assert int(jaux["nonfinite_count"]) == int(taux["nonfinite_count"]) == 1
    assert jcount == 0
    assert all(torch.equal(tstate[k], port["start"][k]) for k in tstate)
    # the optimizer's state after the trip: zeros and step 0, the state
    # a first step starts from
    for slot, value in topt.items():
        if slot[0] == "state":
            assert not value.any(), slot

    _, jcount, _ = jax_runs["live"]["clean"]
    taux, _, tx = port["clean"]
    assert int(taux["nonfinite_count"]) == 1
    steps = {float(s["step"]) for s in tx.optimizer.state.values()}
    assert jcount == 1 and steps == {1.0}


def test_in_step_accumulation_equals_one_big_step(variables, batch):
    """Frozen batch norm and every pixel valid (each microbatch loss then
    averages as many pixels): two microbatches of 1 and one batch of 2 are
    the same update, up to the order of the sums."""
    batch = (*batch[:3], np.ones_like(batch[3]))
    runs = []
    for accumulate in (2, 1):
        tm = port_model(variables, True)
        step = parallel.make_train_step(tm.model, tm.loss, with_grads=True,
                                        accumulate=accumulate)
        _, aux = _run(step, parallel.TrainState(tm.model, _port_tx(tm)),
                      LR, batch)
        runs.append((aux, tm.model.module.state_dict()))
    (acc, acc_state), (big, big_state) = runs
    assert abs(float(acc["loss"]) - float(big["loss"])) \
        <= LOSS_REL * abs(float(big["loss"]))
    grads = {k: g.numpy() for k, g in big["grads"].items()}
    _check_grads(grads, {k: g.numpy() for k, g in acc["grads"].items()})
    _check_state({k: v.numpy() for k, v in big_state.items()}, acc_state,
                 grads)


def test_stage_accumulation_matches_multisteps(variables, tmp_path):
    """Two calls of the stage's ``accumulate: 2`` transform, fed the same
    gradients as JAX's ``optax.MultiSteps`` chain: the first call moves
    nothing, the second applies the clipped running mean; resumed from
    JAX's mid-accumulation file and from the port's own, the second call
    gives the same weights."""
    gradient = dict(GRADIENT, accumulate=2)
    rs = np.random.RandomState(4)
    params = jax.tree.map(jnp.asarray, variables["params"])
    calls = [jax.tree.map(lambda p: jnp.asarray(
        (2 * rs.randn(*p.shape)).astype(np.float32)), params)
        for _ in range(2)]

    jtx, _ = jspec.OptimizerSpec.from_config(OPTIMIZER).build(
        jspec.GradientSpec.from_config(gradient))
    @jax.jit
    def update(grads, opt, params):
        updates, opt = jtx.update(grads, opt, params)
        return optax.apply_updates(
            params, jax.tree.map(lambda u: -LR * u, updates)), opt

    jopt = jtx.init(params)
    jparams = params
    for i, grads in enumerate(calls):
        jparams, jopt = update(grads, jopt, jparams)
        if i == 0:
            assert int(jopt.mini_step) == 1
            jpath = tmp_path / "mid.jax.ckpt"
            jchk.Checkpoint(
                model="raft/baseline", iteration=jchk.Iteration(0, 0, 0),
                metrics=None, state=jchk.State(
                    model=serialization.to_state_dict(
                        jax.tree.map(np.asarray, variables)),
                    optimizer=serialization.to_state_dict(
                        jax.tree.map(np.asarray, jopt)),
                    scaler={}, lr_sched_inst=[], lr_sched_epoch=[]),
                metadata={}).save(jpath)
    expected = _grads(jparams)  # the parameters, through the same rules
    mean = {k: (a + b) / 2 for (k, a), b in
            zip(_grads(calls[0]).items(), _grads(calls[1]).values())}

    def call(tm, tx, grads):
        named = dict(tm.model.module.named_parameters())
        for name, g in _grads(grads).items():
            named[name].grad = torch.from_numpy(g.copy())
        return tx.update(LR)

    tm = port_model(variables, True)
    start = {k: v.clone() for k, v in tm.model.module.state_dict().items()}
    tx = _port_tx(tm, gradient)
    assert call(tm, tx, calls[0]) is False and tx.mini_step == 1
    assert all(torch.equal(v, start[k])
               for k, v in tm.model.module.state_dict().items())
    tpath = tmp_path / "mid.port.ckpt"
    tchk.Checkpoint(
        model="raft/baseline", iteration=tchk.Iteration(0, 0, 0),
        metrics=None, state=tchk.State(
            model=tm.model.module.state_dict(), optimizer=tx.state_dict(),
            scaler={}, lr_sched_inst=[], lr_sched_epoch=[]),
        metadata={}).save(tpath)
    assert call(tm, tx, calls[1]) is True and tx.mini_step == 0
    final = {k: v.detach().clone()
             for k, v in tm.model.module.named_parameters()}
    _check_state(expected, final, mean)

    for path in (jpath, tpath):
        tm = port_model(variables, True)
        tx = _port_tx(tm, gradient)
        chkpt = tchk.Checkpoint.load(path)
        assert chkpt.format == ("jax" if path == jpath else "torch")
        chkpt.apply(module=tm.model.module, optimizer=tx)
        assert tx.mini_step == 1
        call(tm, tx, calls[1])
        resumed = {k: v.detach()
                   for k, v in tm.model.module.named_parameters()}
        if path == tpath:
            assert all(torch.equal(resumed[k], final[k]) for k in final)
        else:
            _check_state(expected, resumed, mean)


# the rate of each call of a stage's accumulate-2 group under the skip
# guard: the second call, the middle of the first group, at a NaN rate
SKIP_RATES = (LR, float("nan"), LR, LR, LR)


def test_skipped_microbatch_keeps_the_group_as_multisteps(variables, batch):
    """A stage's ``gradient.accumulate: 2`` under the skip guard, with one
    microbatch skipped in the middle of a group (a NaN rate): the step
    index of every applied update and the parameters after it, against
    JAX's guarded ``optax.MultiSteps`` on the same batches. The skip puts
    back the group's count with the running mean (JAX's ``where`` over
    ``mini_step``), so the skipped call does not close the group: the
    updates land on the third and fifth calls, each the clipped mean of
    the two microbatches around it that ran."""
    gradient = dict(GRADIENT, accumulate=2)
    rs = np.random.RandomState(5)
    batches = [tuple(np.ascontiguousarray(x[i:i + 1]) for x in batch)
               for i in rs.randint(0, batch[0].shape[0], len(SKIP_RATES))]

    jm = jmodels.load(_cfg())
    jm.model.on_stage(None, freeze_batchnorm=True)
    jtx, _ = jspec.OptimizerSpec.from_config(OPTIMIZER).build(
        jspec.GradientSpec.from_config(gradient))
    jstep = jmake_train_step(jm.model, jm.loss, jtx, external_lr=True,
                             with_grads=True, donate=False, nonfinite="skip")
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, variables), jtx)
    jparams, jgrads = [_jax_state_dict(jstate.variables())], [None]
    for lr, b in zip(SKIP_RATES, batches):
        jstate, jaux = jstep(jstate, lr, *(jnp.asarray(x) for x in b))
        jparams.append(_jax_state_dict(jstate.variables()))
        jgrads.append(_grads(jaux["grads"]))

    tm = port_model(variables, True)
    tx = _port_tx(tm, gradient)
    step = parallel.make_train_step(tm.model, tm.loss, nonfinite="skip")
    state = parallel.TrainState(tm.model, tx)
    tparams = [{k: v.clone() for k, v in tm.model.module.state_dict().items()}]
    for lr, b in zip(SKIP_RATES, batches):
        state, aux = _run(step, state, lr, b)
        tparams.append({k: v.clone()
                        for k, v in tm.model.module.state_dict().items()})
    assert int(state.nonfinite_count) == int(jstate.nonfinite_count) == 1

    def applied(history):
        return [i for i in range(1, len(history))
                if any(not np.array_equal(np.asarray(history[i][k]),
                                          np.asarray(history[i - 1][k]))
                       for k in history[i] if "running" not in k
                       and not k.endswith("num_batches_tracked"))]

    assert applied(jparams) == applied(tparams) == [3, 5]
    # the first update against JAX's from the same start, bounded as
    # ``_check_state`` bounds one update (the stem by the mean gradient of
    # the group's two microbatches that ran)
    mean = {k: (jgrads[1][k] + jgrads[3][k]) / 2 for k in jgrads[3]}
    _check_state(jparams[3], tparams[3], mean)

    # and the guarded run is, bit for bit, the unguarded run that never
    # saw the skipped microbatch (its later updates amplify the first
    # one's rounding through Adam, as any two lockstep updates do)
    tm = port_model(variables, True)
    tx = _port_tx(tm, gradient)
    step = parallel.make_train_step(tm.model, tm.loss)
    state = parallel.TrainState(tm.model, tx)
    for call in (1, 3, 4, 5):
        state, _ = _run(step, state, SKIP_RATES[call - 1], batches[call - 1])
        if call in (3, 5):
            assert all(torch.equal(v, tparams[call][k])
                       for k, v in tm.model.module.state_dict().items())


def test_stage_accumulation_in_main_train(tmp_path):
    """``main train`` with a stage's ``gradient.accumulate: 2`` over 3
    pairs an epoch, 2 epochs: 6 microbatches, 3 optimizer steps, the
    schedulers moved 3 times, no partial mean left."""
    _write_tree(tmp_path / "data")
    path = tmp_path / "data" / "strategy.yaml"
    strat = json.loads(path.read_text())
    strat["stages"][0]["gradient"] = dict(GRADIENT, accumulate=2)
    path.write_text(json.dumps(strat))
    with _one_thread():  # the suite's workers would oversubscribe the cores
        tctx = port_main.main([
            "train", "-d", str(path), "-m",
            str(tmp_path / "data" / "model.yaml"),
            "-o", str(tmp_path / "runs"), "--device", "cpu"])
    assert len(tctx.history) == 6 and tctx.step == 3
    assert [h["step"] for h in tctx.history] == [0, 0, 1, 1, 2, 2]
    assert [h["update_norm"] == 0 for h in tctx.history] == \
        [True, False] * 3
    assert tctx.state.tx.mini_step == 0
    assert tctx.lr_sched_inst[0].last_step == 3
