"""PyTorch port: training recovery held against the JAX package on the CPU.

- ``NonFinitePolicy``: configs (None, a name, a mapping with either key
  spelling) round-trip to JAX's, bad names refused alike;
- the escalation (``TrainingContext._resolve_finite`` and ``_rollback``):
  the same sequences of amortized fetches (the newest step's finite flag
  and the cumulative skip count) fed to both packages' methods on a small
  stub context, no model built: skip, rollback, the abort on
  ``max-consecutive``, on the window, on ``max-rollbacks`` and with no
  checkpoint, each with JAX's actions and messages;
- ``testing.faults``: the port's parser and firing rules against JAX's;
- the loop, on the port only (the JAX package's own loop tests take ~2 min
  each and are not repeated here): ``main train`` on the CPU with
  ``RMD_FAULT=nan_update@step=N``: ``skip`` drops the update bit for bit
  and continues; persistent trips escalate to ``failed.ckpt``; under
  ``rollback`` the newest checkpoint is restored bit for bit, once, and
  the run finishes;
- ``main train``'s ``--nonfinite``/``RMD_NONFINITE``/environment and
  ``--accumulate``/``RMD_ACCUMULATE``/``parallel.accumulate``
  precedence: both commands, run in this process up to the trainer's
  construction, resolve the same policy and factor;
- ``--detect-anomaly``: the run's backward passes raise on a NaN, and the
  switch is off again after the run.

The skip guard of the train step itself is held against JAX's in
``tests/test_torch_port_accumulate.py``, on the program that also
accumulates.
"""

import importlib
import json
import logging
import sys
import types
from collections import deque
from pathlib import Path

import jax
import pytest
import torch

import raft_meets_dicl_tpu.strategy.training as jtraining
from raft_meets_dicl_tpu.main import main as jax_main
from raft_meets_dicl_tpu.testing import faults as jfaults
from raft_meets_dicl_tpu_torch import main as port_main
from raft_meets_dicl_tpu_torch.strategy import checkpoint as tchk
from raft_meets_dicl_tpu_torch.strategy import training as ttraining
from raft_meets_dicl_tpu_torch.testing import faults as tfaults
from test_torch_port_train import _one_thread, _write_tree
from test_torch_port_train import port_on_one_thread  # noqa: F401

# the modules (each package's ``cmd`` binds ``train`` to the function)
jtrain_cmd = importlib.import_module("raft_meets_dicl_tpu.cmd.train")
ttrain_cmd = importlib.import_module("raft_meets_dicl_tpu_torch.cmd.train")

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _port_threads():
    """The port's side on one torch thread (the suite's parallel workers
    would oversubscribe the cores)."""
    with _one_thread():
        yield


# -- the policy and its escalation ------------------------------------------------


@pytest.mark.parametrize("cfg", [
    None, "raise", "skip", "rollback",
    {"policy": "rollback", "max-consecutive": 2, "window": 7,
     "max-rollbacks": 1},
    {"policy": "skip", "max_consecutive": 0, "max_rollbacks": -2},
    {"window": 0},
], ids=lambda c: json.dumps(c))
def test_nonfinite_policy_configs_match_jax(cfg):
    expected = jtraining.NonFinitePolicy.from_config(cfg).get_config()
    actual = ttraining.NonFinitePolicy.from_config(cfg)
    assert actual.get_config() == expected
    assert ttraining.NonFinitePolicy.from_config(actual) is actual
    for mod in (jtraining, ttraining):
        with pytest.raises(ValueError, match="invalid non-finite policy"):
            mod.NonFinitePolicy.from_config("ignore")


class _Log:
    """Records (level, message); both packages' method names."""

    def __init__(self):
        self.lines = []

    def _add(self, level):
        return lambda msg: self.lines.append((level, str(msg)))

    def __getattr__(self, name):
        level = {"warn": "warning"}.get(name, name)
        if level in ("warning", "error", "info", "debug"):
            return self._add(level)
        raise AttributeError(name)


class _Entry:
    path = Path("checkpoints/raft_baseline-s0_e0_b4.ckpt")


class _JaxCheckpoint:
    iteration = types.SimpleNamespace(step=4)

    def apply(self, variables=None, opt_state=None, scaler=None,
              lr_sched_inst=(), lr_sched_epoch=()):
        return variables, opt_state, scaler


class _PortCheckpoint:
    iteration = types.SimpleNamespace(step=4)

    def apply(self, module=None, optimizer=None, scaler=None,
              lr_sched_inst=(), lr_sched_epoch=()):
        return scaler


class _Manager:
    def __init__(self, chkpt):
        self.chkpt = chkpt

    def load_valid(self, sort="latest", stage=None, log=None):
        return None if self.chkpt is None else (_Entry(), self.chkpt)


def _stub(side, policy, with_checkpoint):
    """The fields and methods the two escalation methods read, on each
    package's class (the real methods, bound to a bare object)."""
    mod = jtraining if side == "jax" else ttraining
    ctx = types.SimpleNamespace(
        nonfinite=mod.NonFinitePolicy.from_config(policy),
        _nf_last_count=0, _nf_consecutive=0, _nf_window=deque(),
        _nf_rollbacks=0, _recent_samples=deque([(0, ["things/0"])]),
        step=0, scaler={}, lr_sched_inst=[], lr_sched_epoch=[], mesh=None,
        dumps=0, rollbacks=[])
    cls = mod.TrainingContext
    ctx._resolve_finite = types.MethodType(cls._resolve_finite, ctx)
    ctx._rollback = types.MethodType(cls._rollback, ctx)

    def dump(log, stage, epoch):
        ctx.dumps += 1
    ctx._dump_failed = dump
    if side == "jax":
        ctx.checkpoints = _Manager(_JaxCheckpoint() if with_checkpoint
                                   else None)
        ctx.train_variables = lambda: {"params": {}, "batch_stats": {}}
        ctx.state = types.SimpleNamespace(
            opt_state={}, replace=lambda **kw: ctx.state)
    else:
        ctx.checkpoints = _Manager(_PortCheckpoint() if with_checkpoint
                                   else None)
        ctx._samples = types.MethodType(cls._samples, ctx)
        ctx.model = types.SimpleNamespace(module=None)
        ctx.state = types.SimpleNamespace(tx=types.SimpleNamespace(
            reset=lambda: None))
    return ctx


# (finite flag of the newest step, cumulative skip count) per fetch, one
# step apart
SEQUENCES = {
    "skip-isolated": ("skip", True, [(False, 1), (True, 1), (True, 1),
                                     (False, 2), (True, 2), (True, 2)]),
    "skip-consecutive": ("skip", True, [(True, 0), (False, 1), (False, 2),
                                        (False, 3)]),
    "skip-window": ({"policy": "skip", "max-consecutive": 2, "window": 10},
                    True, [(False, 1), (True, 1), (False, 2), (True, 2),
                           (False, 3)]),
    "skip-window-expires": ({"policy": "skip", "max-consecutive": 2,
                             "window": 2},
                            True, [(False, 1), (True, 1), (True, 1),
                                   (False, 2), (True, 2), (True, 2),
                                   (False, 3)]),
    "rollback": ("rollback", True, [(False, 1), (False, 2), (False, 3),
                                    (True, 3), (False, 4), (True, 4)]),
    "rollback-limit": ({"policy": "rollback", "max-consecutive": 1,
                        "max-rollbacks": 1},
                       True, [(False, 1), (True, 1), (False, 2)]),
    "rollback-no-checkpoint": ("rollback", False, [(False, 1), (False, 2),
                                                   (False, 3)]),
    "raise": ("raise", True, [(True, 0), (False, 0)]),
    "fetch-batches-trips": ("skip", True, [(False, 2), (True, 3),
                                           (False, 5)]),
}


def _replay(side, policy, with_checkpoint, fetches):
    ctx = _stub(side, policy, with_checkpoint)
    log = _Log()
    stage = types.SimpleNamespace(index=0)
    actions = []
    for finite, count in fetches:
        ctx.step += 1
        try:
            ctx._resolve_finite(log, (finite, stage, 0, count),
                                "non-finite flow values detected")
            actions.append(("ok", ctx.step, ctx._nf_consecutive))
        except RuntimeError as e:
            actions.append(("abort", str(e)))
            break
    # the port appends JAX's event fields to its warning, and logs the
    # rollback's event as a second warning
    lines = [(level, msg.split(" [action=")[0]) for level, msg in log.lines
             if not msg.startswith("rolled back [")]
    return actions, lines, ctx.dumps, ctx._nf_rollbacks


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_escalation_matches_jax(case):
    policy, with_checkpoint, fetches = SEQUENCES[case]
    expected = _replay("jax", policy, with_checkpoint, fetches)
    actual = _replay("port", policy, with_checkpoint, fetches)
    assert actual == expected
    actions = expected[0]
    if case.startswith("rollback") and case != "rollback-limit":
        assert expected[3] == 1
    if case == "rollback":
        # rolled back to the checkpoint's step, then counted on from it
        assert ("ok", 4, 0) in actions and actions[-1][0] == "ok"
    if case in ("skip-isolated", "rollback", "skip-window-expires"):
        assert actions[-1][0] == "ok"
    else:
        assert actions[-1][0] == "abort"


def test_faults_match_jax(monkeypatch):
    spec = "nan_update@step=3,nan_update@step=5;times=2,sigterm@step=1," \
           "kill_worker@index=2"
    monkeypatch.setenv("RMD_FAULT", spec)
    for mod in (jfaults, tfaults):
        mod.reset()
    assert tfaults._directives() == jfaults._directives()
    fired = []
    for mod in (jfaults, tfaults):
        fired.append([mod.fire("nan_update", step=s) is not None
                      for s in (3, 3, 5, 5, 5, 4)])
    assert fired[0] == fired[1] == [True, False, True, True, False, False]
    for mod in (jfaults, tfaults):
        mod.reset()
    monkeypatch.delenv("RMD_FAULT")
    assert not tfaults.active() and tfaults.fire("nan_update", step=3) is None


# -- the loop: main train on the CPU ------------------------------------------------


def _tree(root, env=None, validation=None, frames=6):
    """The tiny raft tree (``frames - 1`` pairs a epoch, batch 1, 2
    epochs), an inspector of the loss only (or with a step-frequency
    validation and its checkpoints) and an environment."""
    _write_tree(root, frames=frames)
    inspect = {"metrics": [{"prefix": "Train:S{n_stage}:{id_stage}/",
                            "metrics": [{"type": "loss"}]}]}
    if validation is not None:
        strat = json.loads((root / "strategy.yaml").read_text())
        strat["stages"][0]["validation"] = [{
            "name": "val", "batch-size": 1,
            "source": {"type": "dataset", "spec": "dataset.yaml"}}]
        (root / "strategy.yaml").write_text(json.dumps(strat))
        inspect["validation"] = [{
            "type": "strategy", "frequency": validation,
            "checkpoint": True, "images": {"enabled": False},
            "metrics": [{"reduce": "mean", "metric": {"type": "epe"}}]}]
    (root / "inspect.yaml").write_text(json.dumps(inspect))
    (root / "env.yaml").write_text(json.dumps(env or {}))


def _train(root, *extra):
    return port_main.main([
        "train", "-d", str(root / "strategy.yaml"),
        "-m", str(root / "model.yaml"), "-i", str(root / "inspect.yaml"),
        "-e", str(root / "env.yaml"), "-o", str(root / "runs"),
        "--device", "cpu", "-s", str(ROOT / "cfg" / "seeds" / "fixed.yaml"),
        "--reproduce", *extra])


@pytest.fixture
def faulted(monkeypatch):
    """Arms ``RMD_FAULT`` with fresh fire counts and a fetch every step."""
    def arm(spec):
        tfaults.reset()
        monkeypatch.setenv("RMD_FAULT", spec)
        monkeypatch.setenv("RMD_FINITE_CHECK_EVERY", "1")
    yield arm
    tfaults.reset()


def _recording_steps(monkeypatch):
    """Wraps the trainer's step builder: each call's module state before
    and after."""
    states = []
    build = ttraining.make_train_step

    def wrapped(*args, **kwargs):
        step = build(*args, **kwargs)
        module = args[0].module

        def run(state, lr, *batch):
            before = {k: v.clone() for k, v in module.state_dict().items()}
            state, aux = step(state, lr, *batch)
            states.append((before, {k: v.clone() for k, v in
                                    module.state_dict().items()}))
            return state, aux
        return run

    monkeypatch.setattr(ttraining, "make_train_step", wrapped)
    return states


def test_skip_continues_in_main_train(tmp_path, monkeypatch, faulted,
                                      caplog):
    """``--nonfinite skip``, a NaN update at step 2: that step changes no
    weight or statistic bit for bit, is counted once, and the run trains
    on."""
    _tree(tmp_path)
    faulted("nan_update@step=2")
    states = _recording_steps(monkeypatch)
    with caplog.at_level(logging.WARNING):
        tctx = _train(tmp_path, "--nonfinite", "skip", "--limit-steps", "4")
    assert tctx.step == 4 and tctx.nonfinite.policy == "skip"
    assert [h["finite"] for h in tctx.history] == [True, True, False, True]
    assert int(tctx.state.nonfinite_count) == 1
    before, after = states[2]
    assert all(torch.equal(before[k], after[k]) for k in before)
    for before, after in (states[1], states[3]):
        assert not all(torch.equal(before[k], after[k]) for k in before)
    assert "dropped 1 optimizer update(s) (policy 'skip'" in caplog.text
    assert "samples=[{'step': 0" in caplog.text


def test_skip_escalates_to_failed_checkpoint(tmp_path, faulted):
    """Three consecutive trips under ``skip`` abort the run with a
    ``failed.ckpt`` of the (unpoisoned) state."""
    _tree(tmp_path, env={"nonfinite": "skip"})
    faulted("nan_update@step=1,nan_update@step=2,nan_update@step=3")
    with pytest.raises(RuntimeError,
                       match="persist under policy 'skip' \\(3 consecutive"):
        _train(tmp_path, "--limit-steps", "6")
    failed, = (tmp_path / "runs").glob("*/failed.ckpt")
    chkpt = tchk.Checkpoint.load(failed)
    assert chkpt.iteration.step == 4
    assert all(torch.isfinite(v).all() for v in chkpt.state.model.values()
               if v.is_floating_point())


def test_rollback_restores_checkpoint_in_main_train(tmp_path, monkeypatch,
                                                    faulted):
    """``cfg/env/resilient.yaml``'s policy at ``max-consecutive: 2``, a
    checkpoint every 3 steps, NaN updates at steps 4 and 5: one rollback,
    to the step-3 checkpoint, whose weights and statistics the module then
    holds bit for bit; the run finishes its steps."""
    env = json.loads(json.dumps(ttrain_cmd.Environment.load(
        ROOT / "cfg" / "env" / "resilient.yaml").get_config()))
    env["nonfinite"]["max-consecutive"] = 2
    env["loader"] = {}
    _tree(tmp_path, env=env, validation=3, frames=7)
    faulted("nan_update@step=4,nan_update@step=5")

    restored = []
    rollback = ttraining.TrainingContext._rollback

    def wrapped(self, log, stage, epoch):
        rollback(self, log, stage, epoch)
        # the file as it was restored: the re-run step 3 writes it again
        saved = tchk.Checkpoint.load(self.rollbacks[-1]["path"]).state.model
        restored.append((saved, {k: v.clone() for k, v in
                                 self.model.module.state_dict().items()}))
    monkeypatch.setattr(ttraining.TrainingContext, "_rollback", wrapped)

    tctx = _train(tmp_path, "--limit-steps", "8")
    assert tctx.step == 8 and len(restored) == 1
    record, = tctx.rollbacks
    assert (record["from_step"], record["to_step"]) == (6, 3)
    assert Path(record["path"]).name.startswith("raft_baseline-s0_e0_b3")
    saved, live = restored[0]
    assert set(saved) == set(live)
    assert all(torch.equal(saved[k], live[k]) for k in saved)
    # steps 3.. ran again after the rollback
    assert [h["step"] for h in tctx.history] == \
        [0, 1, 2, 3, 4, 5, 3, 4, 5, 6, 7]


# -- the command line ---------------------------------------------------------------


class _Built(Exception):
    pass


def _resolved(monkeypatch, side, root, extra, env):
    """The (policy config, accumulate) the side's train command hands its
    trainer; the command stops there."""
    seen = {}

    def stop(*args, **kwargs):
        policy = kwargs.get("nonfinite")
        seen["nonfinite"] = (policy.get_config() if policy is not None
                             else None)
        seen["accumulate"] = kwargs.get("accumulate", 1)
        raise _Built()

    argv = ["train", "-d", str(root / "strategy.yaml"), "-m",
            str(root / "model.yaml"), "-e", str(root / "env.yaml"),
            "-o", str(root / f"runs-{side}"), "--device", "cpu",
            "--suffix", str(len(list(root.glob(f"runs-{side}/*")))), *extra]
    with monkeypatch.context() as mp:
        for key, value in env.items():
            mp.setenv(key, value)
        if side == "jax":
            mp.setenv("RMD_NO_COMPILE_CACHE", "1")
            mp.setenv("RMD_AOT", "0")
            mp.setattr(jtrain_cmd, "TrainingContext", stop)
            mp.setattr(sys, "argv", ["main.py", *argv, "--device-ids", "0",
                                     "--no-telemetry"])
            try:
                with pytest.raises(_Built):
                    jax_main()
            finally:
                jax.config.update("jax_default_device", None)
        else:
            mp.setattr(ttrain_cmd, "TrainingContext", stop)
            with pytest.raises(_Built):
                port_main.main(argv)
    return seen


def test_flag_precedence_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("RMD_NONFINITE", raising=False)
    monkeypatch.delenv("RMD_ACCUMULATE", raising=False)
    _write_tree(tmp_path, frames=2)
    (tmp_path / "env.yaml").write_text(json.dumps({
        "nonfinite": {"policy": "rollback", "max-consecutive": 5},
        "parallel": {"accumulate": 3}}))
    cases = [
        ([], {}),
        ([], {"RMD_NONFINITE": "skip", "RMD_ACCUMULATE": "2"}),
        (["--nonfinite", "raise", "--accumulate", "4"],
         {"RMD_NONFINITE": "skip", "RMD_ACCUMULATE": "2"}),
    ]
    seen = []
    for extra, env in cases:
        expected = _resolved(monkeypatch, "jax", tmp_path, extra, env)
        actual = _resolved(monkeypatch, "port", tmp_path, extra, env)
        assert actual == expected
        seen.append(actual)
    assert [s["nonfinite"]["policy"] for s in seen] == \
        ["rollback", "skip", "raise"]
    assert [s["accumulate"] for s in seen] == [3, 2, 4]
    assert seen[0]["nonfinite"]["max-consecutive"] == 5


def test_detect_anomaly_raises_on_nan_backward(tmp_path, monkeypatch):
    """``--detect-anomaly`` (and the environment's ``debug-nans``) turn
    autograd's anomaly mode on for the run: a backward that makes a NaN
    raises there, and the mode is off after the run."""
    _write_tree(tmp_path, frames=2)
    seen = []

    class Probe:
        def __init__(self, *args, **kwargs):
            pass

        def run(self, *args):
            x = torch.zeros(3, requires_grad=True)
            with pytest.raises(RuntimeError, match="returned nan"):
                torch.sqrt(x - 1.0).sum().backward()
            seen.append(torch.is_anomaly_enabled())

    monkeypatch.setattr(ttrain_cmd, "TrainingContext", Probe)
    (tmp_path / "env.yaml").write_text(json.dumps(
        {"jax": {"debug-nans": True}}))
    for i, extra in enumerate((["--detect-anomaly"],
                               ["-e", str(tmp_path / "env.yaml")])):
        assert not torch.is_anomaly_enabled()
        port_main.main(["train", "-d", str(tmp_path / "strategy.yaml"),
                        "-m", str(tmp_path / "model.yaml"),
                        "-o", str(tmp_path / "runs"), "--device", "cpu",
                        "--suffix", str(i), *extra])
    assert seen == [True, True] and not torch.is_anomaly_enabled()
