"""PyTorch port: the inspector's hooks held against the JAX package on the
CPU (``tests/test_inspect.py``'s hook tests are the model).

- ``activation-stats`` and ``anomalydetect-activation`` through each
  package's ``SummaryInspector`` capture pass, on the same weights and
  images: the same set of tags (flax module paths, JAX's indices), the
  mean and variance scalars within 1e-5 of each activation's scale, the
  same tensors named by the activation detector;
- a NaN gradient and an activation above ``large``: one rolling debug
  checkpoint a step on both sides, the same file names and retention;
- the ``when`` switching around a validation pass, as JAX's;
- ``main train`` on the CPU with all three hooks: the tags are written,
  healthy training writes no debug checkpoint.

The model is ``test_torch_port_train.py``'s narrow raft with the port's
initial weights, put into the JAX variables tree through ``convert``'s
rules backwards over the tree ``jax.eval_shape`` gives (no init to
compile).
"""

import json
import logging
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.inspect as jinspect
import raft_meets_dicl_tpu.models as jmodels
from raft_meets_dicl_tpu.inspect.hooks.common import Hook as JHook
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import convert
from raft_meets_dicl_tpu_torch import inspect as tinspect
from raft_meets_dicl_tpu_torch import main as port_main
from raft_meets_dicl_tpu_torch.inspect.hooks.common import Hook as THook
from test_torch_port_train import MODEL_PARAMS, _cfg, _one_thread, _write_tree
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _port_threads():
    """The port's side on one torch thread (the suite's parallel workers
    would oversubscribe the cores)."""
    with _one_thread():
        yield


SHAPE = (64, 96)
# the modules named in the configs: the one tests/test_inspect.py uses, a
# whole encoder, the upsampler and the model
MODULES = ["FeatureEncoderS3_0._Stem_0", "FeatureEncoderS3_1",
           "Up8Network_0", "__call__"]
# mean and variance against the activation's scale, |mean| + std: float32
# forwards in another order (reads <= 2e-6)
STATS_REL = 1e-5


def jax_variables(state_dict):
    """The JAX variables of the narrow raft holding the port's
    ``state_dict``: each leaf of the tree ``jax.eval_shape`` gives for the
    JAX init, filled through ``convert.raft_rules`` backwards (OIHW conv
    kernels to HWIO)."""
    jm = jmodels.load(_cfg()).model
    x = jnp.zeros((1, *SHAPE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, x, x, iterations=1),
                            jax.random.PRNGKey(0))
    rules = convert.raft_rules(MODEL_PARAMS["corr-levels"])
    names = {"kernel": "weight", "bias": "bias", "scale": "weight",
             "mean": "running_mean", "var": "running_var"}

    def fill(node, path):
        if hasattr(node, "shape"):
            value = state_dict[f"{rules['.'.join(path[1:-1])]}."
                               f"{names[path[-1]]}"].detach().numpy()
            if path[-1] == "kernel":
                value = np.transpose(value, (2, 3, 1, 0))
            assert value.shape == tuple(node.shape), path
            return jnp.asarray(value, jnp.float32)
        return {k: fill(v, (*path, k)) for k, v in node.items()}

    return fill(shapes, ())


@pytest.fixture(scope="module")
def models():
    tm = tmodels.load(_cfg())
    tm.model.init(torch.Generator().manual_seed(5), device="cpu")
    # running statistics away from the init's 0 / 1
    rs = np.random.RandomState(2)
    with torch.no_grad():
        for name, buf in tm.model.module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rs.randn(*buf.shape) * 0.1))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rs.uniform(0.5, 2, buf.shape)))
    variables = jax_variables(tm.model.module.state_dict())
    back = convert.jax_variables_to_state_dict(
        jax.tree.map(np.asarray, variables))
    state = tm.model.module.state_dict()
    assert all(torch.equal(back[k], state[k]) for k in back
               if not k.endswith("num_batches_tracked"))
    jm = jmodels.load(_cfg())
    return tm, jm, variables


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(8)
    return [rs.uniform(-1, 1, (2, *SHAPE, 3)).astype(np.float32)
            for _ in range(2)]


def _hook_cfgs(large=1e10, checkpoint=False):
    return [
        {"type": "activation-stats", "modules": MODULES, "prefix": "Act/",
         "frequency": 1},
        {"type": "anomalydetect-activation", "large": large,
         "save-checkpoint": checkpoint, "max-checkpoints": 2},
    ]


def _scalars(tb_dir):
    """tag -> (step, value) of every scalar in a directory's event files."""
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader,
    )

    out = {}
    for f in sorted(Path(tb_dir).glob("events.out.tfevents.*")):
        for event in EventFileLoader(str(f)).Load():
            for value in event.summary.value:
                if value.HasField("simple_value"):
                    v = value.simple_value
                elif value.HasField("tensor"):
                    v = float(value.tensor.float_val[0])
                else:
                    continue
                out[value.tag] = (event.step, v)
    return out


class _Log:
    def __init__(self):
        self.lines = []

    def __getattr__(self, name):
        return lambda msg: self.lines.append((name, str(msg)))


def _capture(side, models, images, tmp_path, cfgs, step=0):
    """One capture pass of ``cfgs``' hooks through the side's inspector:
    the scalars it wrote and its log lines."""
    tm, jm, variables = models
    log = _Log()
    stage = types.SimpleNamespace(model_args={}, index=0)
    tb = tmp_path / f"tb-{side}"
    if side == "jax":
        hooks = [JHook.from_config(c) for c in cfgs]
        writer = jinspect.SummaryWriter(tb)
        insp = jinspect.SummaryInspector(writer, [], hooks, None, None, [])
        ctx = types.SimpleNamespace(model=jm.model, step=step,
                                    train_variables=lambda: variables,
                                    path=tmp_path)
        insp.setup(log, ctx)
        insp._run_intermediate_hooks(log, ctx, stage, *images)
    else:
        hooks = [THook.from_config(c) for c in cfgs]
        writer = tinspect.SummaryWriter(tb)
        insp = tinspect.SummaryInspector(writer, [], None, None, [], hooks)
        ctx = types.SimpleNamespace(model=tm.model, step=step,
                                    device=torch.device("cpu"),
                                    path=tmp_path)
        insp.setup(log, ctx)
        with torch.backends.mkldnn.flags(enabled=False):
            insp._run_intermediate_hooks(
                log, ctx, stage, *(torch.from_numpy(x) for x in images))
    writer.close()
    return _scalars(tb), log.lines


def test_activation_hooks_match_jax(models, images, tmp_path):
    expected, jlog = _capture("jax", models, images, tmp_path, _hook_cfgs())
    actual, tlog = _capture("port", models, images, tmp_path, _hook_cfgs())
    assert set(actual) == set(expected)
    # JAX's indices: e.g. the stem's own output after its 51 submodules
    assert "Act/FeatureEncoderS3_0._Stem_0.51/mean" in expected
    assert "Act/FeatureEncoderS3_0._Stem_0.52/mean" not in expected
    assert {"Act/__call__.0/var", "Act/__call__.1/var"} <= set(expected)
    for module in MODULES:
        n = len([t for t in expected if t.startswith(f"Act/{module}.")
                 and t.endswith("/mean")])
        for i in range(n):
            (_, em), (_, ev) = (expected[f"Act/{module}.{i}/{k}"]
                                for k in ("mean", "var"))
            (_, am), (_, av) = (actual[f"Act/{module}.{i}/{k}"]
                                for k in ("mean", "var"))
            scale = abs(em) + np.sqrt(ev)
            assert abs(am - em) <= STATS_REL * scale, (module, i)
            assert abs(av - ev) <= STATS_REL * ev, (module, i)
    # healthy forward at large 1e10: the activation detector is silent
    assert not [m for level, m in jlog + tlog if "anomaly" in m]


def _named(lines):
    """The tensors named by an anomaly log."""
    return sorted(m.split("'")[1] for _, m in lines
                  if "anomaly detected" in m)


def test_activation_anomaly_matches_jax(models, images, tmp_path):
    """``large: 1``: the same activations flagged, one debug checkpoint a
    step, the oldest dropped beyond ``max-checkpoints: 2``."""
    cfgs = _hook_cfgs(large=1.0, checkpoint=True)[1:]
    named = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        root.mkdir()
        run = _jax_anomaly if side == "jax" else _port_anomaly
        for step in (0, 1, 2):
            _, log = run(models, images, root, cfgs, step)
            named.setdefault(side, []).append(_named(log))
        assert sorted(p.name for p in root.glob("*.ckpt")) == [
            "anomaly_in_activation-b1.ckpt", "anomaly_in_activation-b2.ckpt"]
    assert named["port"] == named["jax"] and named["jax"][0]


# the JAX detector dumps through the live context's state accessors
def _jax_ctx(models, root, step):
    _, jm, variables = models
    return types.SimpleNamespace(
        model=jm.model, model_id="raft/baseline", step=step, path=root,
        current_stage=types.SimpleNamespace(index=0), current_epoch=0,
        train_variables=lambda: jax.tree.map(np.asarray, variables),
        opt_state=lambda: {}, scaler={}, lr_sched_inst=[],
        lr_sched_epoch=[])


def _port_ctx(models, root, step):
    tm = models[0]
    from raft_meets_dicl_tpu_torch.strategy import checkpoint as tchk

    ctx = types.SimpleNamespace(
        model=tm.model, step=step, path=root, device=torch.device("cpu"),
        current_stage=types.SimpleNamespace(index=0), current_epoch=0)
    ctx.snapshot_checkpoint = lambda stage, epoch: tchk.Checkpoint(
        model="raft/baseline", iteration=tchk.Iteration(0, epoch, step),
        metrics=None, state=tchk.State(tm.model.module.state_dict(), {}, {},
                                       [], []), metadata={})
    return ctx


_JAX_INSPECTORS = {}


def _jax_anomaly(models, images, root, cfgs, step):
    """The JAX detector's capture pass with a dump-capable context; one
    inspector per directory, as a run has one."""
    log = _Log()
    if root not in _JAX_INSPECTORS:
        hooks = [JHook.from_config(c) for c in cfgs]
        writer = jinspect.SummaryWriter(root / "tb")
        _JAX_INSPECTORS[root] = jinspect.SummaryInspector(
            writer, [], hooks, None, None, [])
        _JAX_INSPECTORS[root].setup(log, _jax_ctx(models, root, step))
    insp = _JAX_INSPECTORS[root]
    insp.writer.set_fmtargs({"n_step": step})
    stage = types.SimpleNamespace(model_args={}, index=0)
    insp._run_intermediate_hooks(log, _jax_ctx(models, root, step), stage,
                                 *images)
    return None, log.lines


_PORT_INSPECTORS = {}


def _port_anomaly(models, images, root, cfgs, step):
    log = _Log()
    if root not in _PORT_INSPECTORS:
        hooks = [THook.from_config(c) for c in cfgs]
        writer = tinspect.SummaryWriter(root / "tb")
        _PORT_INSPECTORS[root] = tinspect.SummaryInspector(
            writer, [], None, None, [], hooks)
        _PORT_INSPECTORS[root].setup(log, _port_ctx(models, root, step))
    insp = _PORT_INSPECTORS[root]
    insp.writer.set_fmtargs({"n_step": step})
    stage = types.SimpleNamespace(model_args={}, index=0)
    insp._run_intermediate_hooks(log, _port_ctx(models, root, step), stage,
                                 *(torch.from_numpy(x) for x in images))
    return None, log.lines


def test_gradient_anomaly_matches_jax(models, tmp_path):
    """A NaN gradient at steps 0-2 (twice at step 2) and one above
    ``large`` at step 3: one checkpoint a step, the two newest kept, the
    same tensors named."""
    from raft_meets_dicl_tpu.inspect.hooks.anomaly import (
        GradientAnomalyDetector as JDetector,
    )
    from raft_meets_dicl_tpu_torch.inspect.hooks.anomaly import (
        GradientAnomalyDetector as TDetector,
    )

    grads = [{"w": np.array([1.0, np.nan], np.float32),
              "b": np.ones(3, np.float32)}] * 4
    grads[3] = {"w": np.ones(2, np.float32),
                "b": np.array([0, 2e10, 0], np.float32)}
    named = {}
    for side, cls in (("jax", JDetector), ("port", TDetector)):
        root = tmp_path / side
        root.mkdir()
        hook = cls(checkpoint=True, checkpoint_max=2)
        writer = (jinspect if side == "jax" else tinspect).SummaryWriter(
            root / "tb")
        for step, g in zip((0, 1, 2, 2, 3), grads[:3] + grads[2:]):
            ctx = (_jax_ctx if side == "jax" else _port_ctx)(models, root,
                                                             step)
            if hook.writer is None:
                hook.register(ctx, writer)
            writer.set_fmtargs({"n_step": step})
            log = _Log()
            hook.on_grads(log, ctx, g if side == "jax" else
                          {k: torch.from_numpy(v) for k, v in g.items()})
            named.setdefault(side, []).append(_named(log.lines))
        writer.close()
        assert sorted(p.name for p in root.glob("*.ckpt")) == [
            "anomaly_in_gradient-b2.ckpt", "anomaly_in_gradient-b3.ckpt"]
    assert named["port"] == named["jax"] == [["w"]] * 4 + [["b"]]


@pytest.mark.parametrize("when", ["training", "validation", "all"])
def test_when_switching_matches_jax(tmp_path, when):
    """Hook activity before, during and after an epoch's validation."""
    states = {}
    for side in ("jax", "port"):
        hook = (JHook if side == "jax" else THook).from_config(
            {"type": "anomalydetect-gradient"})
        hook.when = when
        seen = []
        val = types.SimpleNamespace(
            frequency="epoch",
            run=lambda *args, hook=hook, seen=seen: seen.append(hook.active))
        if side == "jax":
            writer = jinspect.SummaryWriter(tmp_path / side)
            insp = jinspect.SummaryInspector(writer, [], [hook], None, None,
                                             [val])
        else:
            writer = tinspect.SummaryWriter(tmp_path / side)
            insp = tinspect.SummaryInspector(writer, [], None, None, [val],
                                             [hook])
        ctx = types.SimpleNamespace(step=0)
        insp.setup(_Log(), ctx)
        seen.append(hook.active)
        insp.on_epoch(_Log(), ctx, types.SimpleNamespace(index=0), 0)
        seen.append(hook.active)
        writer.close()
        states[side] = seen
    assert states["port"] == states["jax"]


def test_hooks_in_main_train(tmp_path, caplog):
    """All three hooks through ``main train`` on the CPU: activation tags
    at the hook's frequency (steps 0 and 2; the scalars read back are each
    tag's last), no anomaly and no debug checkpoint on a healthy run."""
    _write_tree(tmp_path)
    inspect = {
        "metrics": [{"prefix": "Train:S{n_stage}:{id_stage}/",
                     "metrics": [{"type": "loss"}]}],
        "hooks": _hook_cfgs(checkpoint=True) + [
            {"type": "anomalydetect-gradient", "save-checkpoint": True}],
    }
    inspect["hooks"][0]["frequency"] = 2
    (tmp_path / "inspect.yaml").write_text(json.dumps(inspect))
    with caplog.at_level(logging.WARNING):
        tctx = port_main.main([
            "train", "-d", str(tmp_path / "strategy.yaml"),
            "-m", str(tmp_path / "model.yaml"),
            "-i", str(tmp_path / "inspect.yaml"), "-o", str(tmp_path / "runs"),
            "--device", "cpu", "--limit-steps", "3"])
    assert tctx.inspector.wants_gradients
    scalars = _scalars(Path(tctx.inspector.writer.path).parent)
    steps = {s for t, (s, _) in scalars.items() if t.startswith("Act/")}
    assert steps == {2} and "Act/FeatureEncoderS3_1.0/mean" in scalars
    assert "anomaly" not in caplog.text
    assert not list(tctx.path.glob("*.ckpt"))
