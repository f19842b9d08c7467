"""PyTorch port: metrics, validation, the inspector and the whole training
lifecycle held against the JAX package on the CPU.

- every flow and training metric of ``metrics/`` against
  ``raft_meets_dicl_tpu/metrics`` on the same numpy inputs, masked and
  unmasked, and their reductions;
- the validation step (``make_eval_fn`` plus the stage's loss on the raw
  output) against JAX's ``model.apply`` -> ``wrap_result`` -> ``loss_fn``
  with bridged weights;
- the Middlebury color coding, and the event files: read back through
  ``tensorboard``'s own reader (scalars, and PNG images decoded by cv2);
- ``cfg/inspect/default.yaml`` and ``default-1k.yaml`` load to the JAX
  package's configs; hooks are refused by name;
- ``main train`` on both sides on a tiny synthetic tree, a two-stage
  ``mode: best`` strategy with validation and checkpoints, both started
  from one JAX-written checkpoint: the losses in lockstep, the
  checkpoints' (stage, epoch, step), names and metrics; then both resume
  from the same JAX checkpoint (the end of stage 1's first epoch) and run
  in lockstep again.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.inspect as jinspect
import raft_meets_dicl_tpu.metrics as jmetrics
import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu.strategy.checkpoint as jchk
from raft_meets_dicl_tpu import visual as jvisual
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import convert, inspect as tinspect
from raft_meets_dicl_tpu_torch import metrics as tmetrics
from raft_meets_dicl_tpu_torch import visual as tvisual
from raft_meets_dicl_tpu_torch.inspect import summary as tsummary
from raft_meets_dicl_tpu_torch.inspect import writer as twriter
from raft_meets_dicl_tpu_torch.strategy import checkpoint as tchk
from test_torch_port_train import _flax_init, _one_thread
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).parent.parent

# float32 reductions over ~10k pixels in another order
METRIC_REL = 1e-6
# tests/test_torch_port_train.py's tiny raft/baseline and its bounds:
# the final flow of 2 iterations (float32, sums in another order) and the
# loss of one forward
MODEL_PARAMS = {"corr-levels": 2, "corr-radius": 2, "corr-channels": 32,
                "context-channels": 16, "recurrent-channels": 16}
F32_MAX_ABS_PX = 1e-4
LOSS_REL = 1e-5
# main train in lockstep: 8 steps over two stages, each side's own
# optimizer and schedule, float32. The train test holds 3 steps to 1e-4;
# here Adam's first two updates (bias-corrected moments of one or two
# gradients: nearly lr * sign(g) even at eps 1e-3) carry the gradients'
# rounding differences into the weights, and the fresh run's losses read
# up to 2.2e-4 apart by step 6; the resumed run, which starts from the
# JAX state at Adam step 2, reads <= 2.5e-5. The checkpoints' losses and
# mean EPEs take the same bound ...
LOCKSTEP_REL = 1e-3
# ... their fractions of validation pixels (Npx, Fl-all) move by whole
# pixels near the thresholds: up to 10 of the 12,288 read apart
FRACTION_ATOL = 32 / (2 * 64 * 96)
INPUT = {"clip": [0, 1], "range": [-1, 1],
         "padding": {"type": "modulo", "mode": "zeros", "size": [8, 8]}}


def _tiny_cfg():
    return {"name": "RAFT baseline, tiny", "id": "raft/baseline",
            "model": {"type": "raft/baseline", "parameters": MODEL_PARAMS,
                      "arguments": {"iterations": 2}},
            "loss": {"type": "raft/sequence"}, "input": INPUT}


def _flows(seed, shape=(2, 40, 56)):
    rs = np.random.RandomState(seed)
    target = (6 * rs.randn(*shape, 2)).astype(np.float32)
    estimate = (target + 3 * rs.randn(*shape, 2)).astype(np.float32)
    return estimate, target


METRICS = [
    {"type": "epe"},
    {"type": "epe", "distances": [0.5, 2, 10], "key": "EPE/"},
    {"type": "fl-all"},
    {"type": "aae"},
    {"type": "aae", "masked": True},
    {"type": "flow-magnitude"},
    {"type": "flow-magnitude", "masked": True, "ord": 1},
    {"type": "loss"},
    {"type": "learning-rate"},
]


@pytest.mark.parametrize("mask", ["masked", "all-valid", "none-valid"])
@pytest.mark.parametrize("cfg", METRICS, ids=lambda c: json.dumps(c))
def test_flow_metrics_match_jax(cfg, mask):
    estimate, target = _flows(1)
    rs = np.random.RandomState(2)
    valid = {"masked": rs.rand(*target.shape[:-1]) > 0.3,
             "all-valid": np.ones(target.shape[:-1], bool),
             "none-valid": np.zeros(target.shape[:-1], bool)}[mask]
    loss = np.float32(3.25)

    jm, tm = jmetrics.Metric.from_config(cfg), tmetrics.Metric.from_config(cfg)
    assert tm.get_config() == jm.get_config()
    expected = jm(jmetrics.MetricContext(lr=1e-4), jnp.asarray(estimate),
                  jnp.asarray(target), jnp.asarray(valid), jnp.asarray(loss))
    computed = tm(tmetrics.MetricContext(lr=1e-4), torch.from_numpy(estimate),
                  torch.from_numpy(target), torch.from_numpy(valid),
                  torch.tensor(loss))
    actual, = tmetrics.fetch([computed])
    assert list(actual) == list(expected)
    for k, e in expected.items():
        assert abs(actual[k] - e) <= METRIC_REL * max(abs(e), 1.0), k

    # the reduction over two steps
    values = {k: [actual[k], 0.5 * actual[k]] for k in actual}
    assert tm.reduce(values) == jm.reduce(values)


def test_mean_collector_matches_jax():
    """The collector registry: per-key means over fetched metric dicts,
    NaN values skipped."""
    rs = np.random.RandomState(9)
    dicts = [{"EPE": float(v), "Fl-all": float(w)}
             for v, w in rs.rand(7, 2)]
    dicts[3]["EPE"] = float("nan")
    cfg = [{"type": "mean"}]
    expected = jmetrics.Collectors.from_config(cfg)
    actual = tmetrics.Collectors.from_config(cfg)
    for d in dicts:
        expected.collect(d)
        actual.collect(d)
    assert actual.results() == expected.results()
    assert np.isfinite(actual.results()["mean"]["EPE"])


NAMED = ("fnet.conv1.weight", "fnet.conv1.bias", "update_block.gru.w",
         "update_block.head.w")


@pytest.mark.parametrize("params", [
    "total", "all", ["fnet.conv1.bias", "total"],
    {"enc": ["fnet."], "gru": ["update_block.gru"], "whole": ["total"]},
], ids=["total", "all", "names", "groups"])
@pytest.mark.parametrize("kind", ["norm", "mean", "minmax"])
@pytest.mark.parametrize("of", ["grad", "param"])
def test_tree_metrics_match_jax(of, kind, params):
    rs = np.random.RandomState(4)
    named = {n: rs.randn(*s).astype(np.float32)
             for n, s in zip(NAMED, ((4, 3, 3, 3), (4,), (6, 5), (2,)))}
    cfg = {"type": f"{of}-{kind}", "parameters": params}
    if kind == "norm":
        cfg["ord"] = 1
    jm, tm = jmetrics.Metric.from_config(cfg), tmetrics.Metric.from_config(cfg)
    assert tm.get_config() == jm.get_config()

    jtree = {k: jnp.asarray(v) for k, v in named.items()}
    ttree = {k: torch.from_numpy(v) for k, v in named.items()}
    slot = "grads" if of == "grad" else "params"
    expected = jm(jmetrics.MetricContext(**{slot: jtree}), None, None, None,
                  None)
    actual, = tmetrics.fetch([tm(tmetrics.MetricContext(**{slot: ttree}),
                                 None, None, None, None)])
    assert list(actual) == list(expected) and expected
    for k, e in expected.items():
        assert abs(actual[k] - e) <= METRIC_REL * max(abs(e), 1.0), k
    values = {k: [actual[k], actual[k] - 1.0] for k in actual}
    assert tm.reduce(values) == jm.reduce(values)


def test_validation_step_matches_jax():
    """The port's validation forward (``make_eval_fn``) and loss on its raw
    output against JAX's ``model.apply`` -> ``wrap_result`` -> ``loss_fn``
    from the same weights; then the validation metrics of that output."""
    rs = np.random.RandomState(6)
    img1, img2 = (rs.uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
                  for _ in range(2))
    flow = (3 * rs.randn(2, 64, 96, 2)).astype(np.float32)
    valid = rs.rand(2, 64, 96) > 0.2
    loss_args = {"gamma": 0.85}

    jspec = jmodels.load(_tiny_cfg())
    x1, x2 = jnp.asarray(img1), jnp.asarray(img2)
    variables = jax.tree.map(jnp.asarray, _flax_init(jspec.model, 3, x1, x2))

    def jstep(v):
        out = jspec.model.apply(v, x1, x2)
        result = jspec.model.get_adapter().wrap_result(out, flow.shape[1:3])
        return result.final(), jspec.loss(
            jspec.model, result.output(), jnp.asarray(flow),
            jnp.asarray(valid), **loss_args)

    jfinal, jloss = jax.jit(jstep)(variables)

    tspec = tmodels.load(_tiny_cfg())
    tspec.model.init(device="cpu")
    convert.load_jax_variables(tspec.model.module,
                               jax.tree.map(np.asarray, variables))
    step = tsummary.make_val_step(tspec.model, tspec.loss,
                                  loss_args=loss_args)
    with _one_thread():
        final, loss = step(*(torch.from_numpy(x)
                             for x in (img1, img2, flow, valid)))
    assert np.abs(final.numpy() - np.asarray(jfinal)).max() <= F32_MAX_ABS_PX
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))

    spec = {"reduce": "mean", "metric": {"type": "epe"}}
    jval = jinspect.summary.ValidationMetricSpec.from_config(spec).build()
    tval = tsummary.ValidationMetricSpec.from_config(spec).build()
    for half in (slice(0, 1), slice(1, 2)):
        jval.add(jmetrics.MetricContext(), np.asarray(jfinal)[half],
                 flow[half], valid[half], float(jloss))
        tval.add(tmetrics.MetricContext(), final[half],
                 torch.from_numpy(flow[half]), torch.from_numpy(valid[half]),
                 loss)
    expected = dict(jval.result())
    actual = dict(tval.result(tmetrics.fetch(tval.values)))
    assert actual.keys() == expected.keys()
    for k, e in expected.items():
        # the flows differ by <= F32_MAX_ABS_PX; EPE moves at most as much
        assert abs(actual[k] - e) <= F32_MAX_ABS_PX, k


def test_flow_to_rgba_matches_jax():
    estimate, _ = _flows(3, shape=(30, 44))
    mask = np.random.RandomState(1).rand(30, 44) > 0.2
    estimate[3, 5] = np.nan
    mask[3, 5] = True
    for kwargs in ({}, {"mask": mask}, {"mrm": 7.5}, {"mask": mask,
                                                       "mrm": 3.0}):
        with pytest.warns(RuntimeWarning):
            expected = jvisual.flow_to_rgba(estimate, **kwargs)
        with pytest.warns(RuntimeWarning):
            actual = tvisual.flow_to_rgba(estimate, **kwargs)
        assert np.array_equal(actual, expected)


def _accumulate(path):
    from tensorboard.backend.event_processing import event_accumulator

    acc = event_accumulator.EventAccumulator(
        str(path), size_guidance={event_accumulator.IMAGES: 0,
                                  event_accumulator.SCALARS: 0})
    acc.Reload()
    return acc


def test_event_file_reads_back_through_tensorboard(tmp_path):
    rs = np.random.RandomState(7)
    writer = twriter.SummaryWriter(tmp_path / "tb")
    writer.set_fmtargs({"n_stage": 1, "id_stage": "things.s1"})
    scalars = [(0, 1.5), (1, -2.25), (7, 3e-5)]
    for step, value in scalars:
        writer.add_scalar("Train:S{n_stage}:{id_stage}/Loss", value, step)
    images = {
        "rgb": rs.randint(0, 256, (17, 23, 3), dtype=np.uint8),
        "rgba": rs.rand(9, 31, 4).astype(np.float32),
        "gray": rs.randint(0, 256, (5, 8), dtype=np.uint8),
    }
    for tag, img in images.items():
        writer.add_image(tag, img, 3)
    writer.add_image("chw", images["rgb"].transpose(2, 0, 1), 4,
                     dataformats="CHW")
    writer.close()

    acc = _accumulate(tmp_path / "tb")
    got = [(e.step, e.value) for e in acc.Scalars("Train:S1:things.s1/Loss")]
    assert got == [(s, float(np.float32(v))) for s, v in scalars]
    for tag, img in images.items():
        event, = acc.Images(tag)
        expected = img if img.dtype == np.uint8 else \
            (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if expected.ndim == 2:
            expected = expected[..., None]
        decoded = cv2.imdecode(np.frombuffer(event.encoded_image_string,
                                             np.uint8), cv2.IMREAD_UNCHANGED)
        if decoded.ndim == 2:
            decoded = decoded[..., None]
        elif decoded.shape[-1] == 3:
            decoded = decoded[..., ::-1]
        else:
            decoded = decoded[..., [2, 1, 0, 3]]
        assert (event.step, event.height, event.width) == \
            (3, *expected.shape[:2])
        assert np.array_equal(decoded, expected), tag
    assert acc.Images("chw")[0].step == 4

    # the port's own reader (what the card run uses) agrees
    events = twriter.read_events(writer.path)
    assert events[0]["file_version"] == "brain.Event:2"
    values = [v for e in events for v in e.get("values", [])]
    assert [v["simple_value"] for v in values if "simple_value" in v] == \
        [e for _, e in got]
    assert sum("image" in v for v in values) == 4


@pytest.mark.parametrize("name", ["default.yaml", "default-1k.yaml"])
def test_inspect_configs_match_jax(name):
    path = ROOT / "cfg" / "inspect" / name
    actual = tinspect.load(path).get_config()
    expected = jinspect.load(path).get_config()
    assert json.loads(json.dumps(actual)) == json.loads(json.dumps(expected))
    hooked = tinspect.config.utils.config.load(path) | {
        "hooks": [{"type": "activation-stats",
                   "modules": ["FeatureEncoderS3_0._Stem_0"]}]}
    assert json.loads(json.dumps(tinspect.load(hooked).get_config())) == \
        json.loads(json.dumps(jinspect.load(hooked).get_config()))


# -- main train on both sides ------------------------------------------------------


def _write_tree(root):
    """Train (4 pairs) and validation (2 pairs) scenes at 64x96, the tiny
    model, a two-stage ``mode: best`` strategy with validation entries
    (sample 0's images), and weights drawn as flax initializes them as a JAX
    checkpoint."""
    _write_data(root)
    spec = jmodels.load(_tiny_cfg())
    x = jnp.zeros((1, 64, 96, 3))
    variables = _flax_init(spec.model, 11, x, x)
    jchk.Checkpoint(
        model="raft/baseline", iteration=jchk.Iteration(0, None, 0),
        metrics=None,
        state=jchk.State(jax.tree.map(np.asarray, variables), {}, {}, [], []),
        metadata={"source": "init"}).save(root / "init.ckpt")


def _write_data(root):
    from raft_meets_dicl_tpu_torch.data import io as tio

    rs = np.random.RandomState(5)
    for sub, n in (("train", 5), ("val", 3)):
        (root / sub / "frames").mkdir(parents=True)
        (root / sub / "flows").mkdir()
        for i in range(n):
            cv2.imwrite(str(root / sub / "frames" / f"frame_{i:04d}.png"),
                        rs.randint(0, 256, (64, 96, 3), dtype=np.uint8))
            tio.write_flow_mb(root / sub / "flows" / f"frame_{i:04d}.flo",
                              (2 * rs.randn(64, 96, 2)).astype(np.float32))
        (root / f"{sub}.yaml").write_text(
            f"name: {sub}\nid: {sub}\npath: {sub}\nlayout:\n"
            "  type: generic\n  images: 'frames/frame_{idx:04d}.png'\n"
            "  flows: 'flows/frame_{idx:04d}.flo'\n"
            f"  key: '{sub}/{{idx:04d}}'\n")
    (root / "model.json").write_text(json.dumps(_tiny_cfg()))

    def stage(k):
        # AdamW at eps 1e-3, as the train test: at 1e-8 the first update is
        # lr * sign(g), and rounding-noise gradients flip signs at random
        return {
            "name": f"stage {k}", "id": f"synthetic/s{k}",
            "data": {"epochs": 2, "batch-size": 2,
                     "source": {"type": "dataset", "spec": "train.yaml"}},
            "validation": [{"name": "val", "batch-size": 2, "images": [0],
                            "source": {"type": "dataset",
                                       "spec": "val.yaml"}}],
            "model": {"on-stage": {"freeze_batchnorm": True}},
            "optimizer": {"type": "adam-w", "parameters": {
                "lr": 2e-4, "weight_decay": 1e-4, "eps": 1e-3}},
            "lr-scheduler": {"instance": [{"type": "one-cycle", "parameters": {
                "max_lr": 2e-4, "total_steps": "{n_epochs} * {n_batches}",
                "pct_start": 0.25, "cycle_momentum": False,
                "anneal_strategy": "linear"}}]},
            "gradient": {"clip": {"type": "norm", "value": 1.0}},
            "loader": {"num_workers": 0},
        }

    (root / "strategy.json").write_text(json.dumps(
        {"mode": "best", "stages": [stage(1), stage(2)]}))


# each side's runs in one process, one thread each (the other test files
# run beside it); an argument "glob:PATTERN" is the file PATTERN matches
# once the earlier runs of the process have written it
_RUNNER = {
    "jax": """
        import glob, sys
        from raft_meets_dicl_tpu.main import main
        import jax
        from raft_meets_dicl_tpu.models import model as jmodel
        init = jmodel.Model.init

        def shaped_init(self, rng, img1, img2, **kwargs):
            # zeros of the variables' shapes: the run's --checkpoint or
            # --resume replaces every leaf, and an eager init takes tens
            # of seconds
            shapes = jax.eval_shape(
                lambda r: init(self, r, img1, img2, **kwargs), rng)
            return jax.tree.map(lambda s: jax.numpy.zeros(s.shape, s.dtype),
                                shapes)

        jmodel.Model.init = shaped_init
        for argv in {runs!r}:
            sys.argv = ["main.py"] + [
                glob.glob(a[5:])[0] if a.startswith("glob:") else a
                for a in argv]
            main()
        """,
    "port": """
        import torch
        from raft_meets_dicl_tpu_torch.main import main
        # true float32 convolutions, as the JAX side runs at 'highest'
        torch.backends.mkldnn.enabled = False
        torch.set_num_threads(1)
        for argv in {runs!r}:
            main(argv)
        """,
}


def _launch(side, root, runs):
    # one CPU device (the conftest's 8 virtual ones would put the JAX run
    # on a data mesh), one thread, no AOT programs; JAX's compile cache in
    # the fixture's directory (stage 2 and the resumed run compile the
    # programs stage 1 compiled: the cache hands them back)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "RMD_COMPILE_CACHE": str(root / "jax-cache"), "RMD_AOT": "0",
           "PYTHONPATH": str(ROOT)}
    env.pop("RMD_NO_COMPILE_CACHE", None)
    return subprocess.Popen(
        [sys.executable, "-c",
         textwrap.dedent(_RUNNER[side]).format(runs=runs)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(proc):
    log = proc.communicate(timeout=900)[0]
    assert proc.returncode == 0, log[-3000:]


def _args(root, out, *extra):
    return ["train", "-d", str(root / "strategy.json"),
            "-m", str(root / "model.json"), "-o", str(out), "--device", "cpu",
            "-s", str(ROOT / "cfg" / "seeds" / "fixed.yaml"), "--reproduce",
            *extra]


def _run_dirs(out):
    return sorted(p for p in out.iterdir() if p.is_dir())


def _losses(run):
    """step -> loss of every stage, from the run's event file."""
    events = twriter.read_events(next((run / "tb.raft_baseline").iterdir()))
    out = {}
    for e in events:
        for v in e.get("values", []):
            if v["tag"].startswith("Train:") and v["tag"].endswith("/Loss"):
                out[e["step"]] = v["simple_value"]
    return out


def _checkpoints(run):
    return {p.name: tchk.Checkpoint.load(p)
            for p in sorted((run / "checkpoints").glob("*.ckpt"))}


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    """Both sides' ``main train`` from the JAX-written initial weights,
    then a resume of each from the JAX run's stage-1, epoch-1 checkpoint.
    The JAX process runs both; the port's fresh run goes beside it, its
    resumed run after it."""
    root = tmp_path_factory.mktemp("lifecycle")
    _write_tree(root)
    init = ["--checkpoint", str(root / "init.ckpt")]
    pattern = str(root / "jax" / "runs" / "*" / "checkpoints"
                  / "raft_baseline-s0_e0_b2-*.ckpt")
    jax_proc = _launch("jax", root, [
        _args(root, root / "jax" / "runs", *init),
        _args(root, root / "jax" / "resumed", "--resume", "glob:" + pattern)])
    port_proc = _launch("port", root, [
        _args(root, root / "port" / "runs", *init)])
    _finish(port_proc)
    _finish(jax_proc)

    source, = Path("/").glob(pattern.lstrip("/"))
    _finish(_launch("port", root, [
        _args(root, root / "port" / "resumed", "--resume", str(source))]))
    return root, source


@pytest.mark.parametrize("run", ["fresh", "resumed"])
def test_main_train_lockstep_with_jax(lifecycle, run):
    """The per-step losses (read from each side's event file) in lockstep;
    the resumed runs start at step 2 of stage 1's second epoch."""
    root, _ = lifecycle
    out = "runs" if run == "fresh" else "resumed"
    jrun, = _run_dirs(root / "jax" / out)
    trun, = _run_dirs(root / "port" / out)
    expected, actual = _losses(jrun), _losses(trun)
    steps = list(range(8)) if run == "fresh" else list(range(2, 8))
    assert sorted(expected) == sorted(actual) == steps
    for step in steps:
        assert abs(actual[step] - expected[step]) <= \
            LOCKSTEP_REL * abs(expected[step]), step
    assert len(set(actual.values())) == len(steps)


@pytest.mark.parametrize("run", ["fresh", "resumed"])
def test_main_train_checkpoints_match_jax(lifecycle, run):
    """Retention kept the same files (names carry the EPE to 4 digits),
    each with the same (stage, epoch, step) and validation metrics; the
    port's files are the port's format, the validation scalars and four
    images of sample 0 per validation are in the port's event file, and
    stage 2 started from stage 1's best checkpoint on both sides."""
    root, source = lifecycle
    out = "runs" if run == "fresh" else "resumed"
    jrun, = _run_dirs(root / "jax" / out)
    trun, = _run_dirs(root / "port" / out)
    expected, actual = _checkpoints(jrun), _checkpoints(trun)

    def key(name):
        return name.rsplit("-epe", 1)[0]

    assert sorted(map(key, actual)) == sorted(map(key, expected))
    assert len(actual) == (4 if run == "fresh" else 3)
    by_key = {key(n): c for n, c in expected.items()}
    for name, chkpt in actual.items():
        e = by_key[key(name)]
        assert chkpt.format == "torch" and e.format == "jax"
        assert chkpt.iteration == e.iteration
        assert chkpt.metrics.keys() == e.metrics.keys()
        for k, v in e.metrics.items():
            fraction = k.endswith("px") or k.endswith("Fl-all")
            bound = FRACTION_ATOL if fraction else LOCKSTEP_REL * abs(v)
            assert abs(chkpt.metrics[k] - v) <= bound, k
        assert chkpt.state.lr_sched_inst == [
            {"last_step": s["last_step"]} for s in e.state.lr_sched_inst]

    events = twriter.read_events(next((trun / "tb.raft_baseline").iterdir()))
    values = [v for e in events for v in e.get("values", [])]
    tags = {v["tag"] for v in values}
    for stage in (0, 1):
        pfx = f"Validation:S{stage}:synthetic.s{stage + 1}:val/"
        assert {f"{pfx}EndPointError/mean", f"{pfx}Fl-all",
                f"{pfx}Loss"} <= tags
    images = [v["tag"] for v in values if "image" in v]
    validations = 4 if run == "fresh" else 3
    assert len([t for t in images if t.startswith("Validation:")]) == \
        4 * validations
    assert {t.rsplit("/", 1)[1] for t in images} == \
        {"img1", "img2", "flow-gt", "flow-est"}

    for r in (jrun, trun):
        log = (r / "main.log").read_text()
        if run == "fresh":
            best = min((c for c in _checkpoints(r).values()
                        if c.iteration.stage == 0),
                       key=lambda c: c.metrics["EndPointError/mean"])
            assert "loading best checkpoint from previous stage" in log
            assert f"_e{best.iteration.epoch}_b{best.iteration.step}-" in \
                log.split("loading best checkpoint")[1].splitlines()[0]


@pytest.mark.parametrize("frequency", [1000, 2])
def test_main_train_step_frequency_validation_on_cpu(tmp_path, frequency):
    """``cfg/inspect/default-1k.yaml`` as shipped (validation every 1000
    steps: none in 3 steps, so no checkpoint) and with a frequency of 2:
    the step-frequency validation runs at step 2 and checkpoints."""
    from raft_meets_dicl_tpu_torch import main as port_main
    from raft_meets_dicl_tpu_torch.utils import config as tconfig

    _write_data(tmp_path)
    cfg = tconfig.load(ROOT / "cfg" / "inspect" / "default-1k.yaml")
    cfg["validation"][0]["frequency"] = frequency
    tconfig.store(tmp_path / "inspect.yaml", cfg)
    with _one_thread():
        tctx = port_main.main(_args(tmp_path, tmp_path / "runs", "-i",
                                    str(tmp_path / "inspect.yaml"),
                                    "--limit-steps", "3"))
    assert tctx.step == 3
    files = sorted(p.name for p in tctx.checkpoints.path.glob("*.ckpt")) \
        if tctx.checkpoints.path.exists() else []
    runs = tctx.inspector.val_step[0].runs
    if frequency == 1000:
        assert files == [] and runs == []
    else:
        assert [(r["step"], r["batches"]) for r in runs] == [(2, 1)]
        assert len(files) == 1 and files[0].startswith(
            "raft_baseline-s0_e1_b2-epe")
    events = twriter.read_events(tctx.inspector.writer.path)
    losses = [e["step"] for e in events for v in e.get("values", [])
              if v["tag"] == "Train:S0:synthetic.s1/Loss"]
    assert losses == [0, 1, 2]


def test_main_train_mode_best_loads_an_earlier_best_on_cpu(tmp_path,
                                                            monkeypatch,
                                                            caplog):
    """``cfg/inspect/default.yaml`` with a ``compare`` on the step count,
    so stage 1's first checkpoint is its best and not its latest: stage 2
    starts (read through the inspector's ``on_stage_start``) from that
    checkpoint's weights bit for bit, not from stage 1's last ones."""
    from raft_meets_dicl_tpu_torch import main as port_main
    from raft_meets_dicl_tpu_torch.inspect import summary
    from raft_meets_dicl_tpu_torch.utils import config as tconfig

    _write_data(tmp_path)
    cfg = tconfig.load(ROOT / "cfg" / "inspect" / "default.yaml")
    cfg["checkpoints"]["compare"] = ["{n_steps}"]
    tconfig.store(tmp_path / "inspect.yaml", cfg)
    starts = []
    original = summary.SummaryInspector.on_stage_start

    def record(self, log, ctx, stage):
        starts.append((stage.index, {
            k: v.detach().clone()
            for k, v in ctx.model.module.state_dict().items()}))
        return original(self, log, ctx, stage)

    monkeypatch.setattr(summary.SummaryInspector, "on_stage_start", record)
    # stage 1's two epochs of two steps, then stage 2's first step
    caplog.set_level("INFO", logger="train")
    # one torch thread: the suite's parallel workers would oversubscribe
    # the cores
    with _one_thread():
        tctx = port_main.main(_args(tmp_path, tmp_path / "runs", "-i",
                                    str(tmp_path / "inspect.yaml"),
                                    "--limit-steps", "5"))
    best = tctx.checkpoints.get_best(stage=0)
    last = tctx.checkpoints.get_latest(stage=0)
    assert (best.idx_epoch, best.idx_step) == (0, 2)
    assert (last.idx_epoch, last.idx_step) == (1, 4)
    (_, start), = [s for s in starts if s[0] == 1]
    best_state = best.load().state.model
    last_state = last.load().state.model
    assert start.keys() == best_state.keys()
    for k, v in start.items():
        assert v.dtype == best_state[k].dtype and torch.equal(v, best_state[k])
    assert any(not torch.equal(v, last_state[k]) for k, v in start.items())
    assert f"loading best checkpoint from previous stage, " \
           f"file='{best.path}'" in caplog.text
