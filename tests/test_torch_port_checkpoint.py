"""PyTorch port: checkpoints held against the JAX package on the CPU.

- the port's files round-trip bit for bit (state, and the file re-saved
  after loading);
- a flipped bit, a truncation or a foreign magic raises
  ``CheckpointCorrupt``; ``load_valid`` and ``find_auto_resume``
  quarantine such files and fall back to the next valid one, and never
  pick a ``failed.ckpt``;
- retention (``trim``), ``get_best``/``get_latest`` and the metric-named
  file names equal the JAX manager's for the same entries and ``compare``;
- the port's msgpack reader against flax's (``msgpack`` package) on flax's
  output;
- a checkpoint written by the JAX package's ``Checkpoint.save`` (``RMDT2``)
  loaded by the port: its forward equals the JAX forward within
  ``tests/test_torch_port_raft.py``'s float32 bound, also through ``serve
  --checkpoint --device cpu``; resumed with its AdamW state, one train step
  equals JAX's resumed step within ``tests/test_torch_port_train.py``'s
  step bounds;
- the ``raise`` policy's ``failed.ckpt``, and ``main checkpoint info|trim``.
"""

import io
import json
import os
import struct
import zlib
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu.strategy.checkpoint as jchk
import raft_meets_dicl_tpu.strategy.spec as jspec
from raft_meets_dicl_tpu.parallel import TrainState as JTrainState
from raft_meets_dicl_tpu.parallel import make_train_step as jmake_train_step
import raft_meets_dicl_tpu_torch.models as tmodels
from raft_meets_dicl_tpu_torch import convert, evaluation, parallel, strategy
from raft_meets_dicl_tpu_torch import main as port_main
from raft_meets_dicl_tpu_torch.serve import loadgen
from raft_meets_dicl_tpu_torch.strategy import checkpoint as tchk
from raft_meets_dicl_tpu_torch.utils import msgpack as tmsgpack
from test_torch_port_train import _flax_init
from test_torch_port_train import port_on_one_thread  # noqa: F401

tspec = strategy.spec

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).parent.parent

# tests/test_torch_port_train.py's tiny raft/baseline, optimizer and step
# bounds: float32 on both sides, sums in another order
MODEL_PARAMS = {"corr-levels": 2, "corr-radius": 2, "corr-channels": 32,
                "context-channels": 16, "recurrent-channels": 16}
OPTIMIZER = {"type": "adam-w",
             "parameters": {"lr": 1e-3, "weight_decay": 1e-4, "eps": 1e-3}}
GRADIENT = {"clip": {"type": "norm", "value": 1.0}}
SCHEDULE = {"type": "one-cycle",
            "parameters": {"max_lr": 1e-3, "total_steps": "{n_batches} * 4",
                           "pct_start": 0.25, "cycle_momentum": False,
                           "anneal_strategy": "linear"}}
SCHEDULE_VARS = {"n_samples": 10, "n_batches": 5, "n_epochs": 1,
                 "n_accum": 1, "batch_size": 2}
LOSS_REL = 1e-5
PARAM_ATOL = 2e-6
# the feature encoder's half-resolution stem: its gradient cancels through
# the instance norms, and the train test bounds it 100x looser than the
# rest (each package alone is ~2e-3 off float64 there). A resumed step's
# Adam update divides by the restored second moments, so the stem's
# weights move by up to lr x that difference: they are held to 10 x
# PARAM_ATOL (one weight of 9,408 reads 2.14e-6)
STEM = ("fnet.conv1.", "fnet.layer1.")
STEM_PARAM_ATOL = 2e-5
# tests/test_torch_port_raft.py's float32 forward bound (3 iterations of
# the full-width model at 64x96; here the tiny model, 3 iterations)
F32_MAX_ABS_PX = 1e-4
INPUT = {"clip": [0, 1], "range": [-1, 1],
         "padding": {"type": "modulo", "mode": "zeros", "size": [8, 8]}}


def _tiny_cfg(iterations=2):
    return {"name": "RAFT baseline, tiny", "id": "raft/baseline",
            "model": {"type": "raft/baseline", "parameters": MODEL_PARAMS,
                      "arguments": {"iterations": iterations}},
            "loss": {"type": "raft/sequence"}, "input": INPUT}


def _serve_cfg():
    return _tiny_cfg(iterations=3)


def _batch(seed=0, b=2):
    rs = np.random.RandomState(seed)
    img1, img2 = (rs.uniform(-1, 1, (b, 64, 96, 3)).astype(np.float32)
                  for _ in range(2))
    flow = (3 * rs.randn(b, 64, 96, 2)).astype(np.float32)
    valid = rs.rand(b, 64, 96) > 0.2
    return img1, img2, flow, valid


# -- the port's own files ---------------------------------------------------------


class _Stage:
    def __init__(self, index, id="synthetic/s1", epochs=2):
        self.index, self.id = index, id
        self.data = type("Data", (), {"epochs": epochs})()


class _Ctx:
    """What ``CheckpointManager.create`` reads of a training context."""

    def __init__(self, module, optimizer, step=0):
        self.module, self.optimizer, self.step = module, optimizer, step

    def snapshot_checkpoint(self, stage, epoch, metrics=None):
        return tchk.Checkpoint(
            model="raft/baseline",
            iteration=tchk.Iteration(stage.index, epoch, self.step),
            metrics=metrics,
            state=tchk.State(self.module.state_dict(),
                             self.optimizer.state_dict(),
                             {"enabled": False, "scale": 65536.0},
                             [{"last_step": self.step}], []),
            metadata={"timestamp": "t", "source": "training"})


@pytest.fixture(scope="module")
def trained():
    """A tiny model and its AdamW + clip after two steps (non-zero
    moments, step 2)."""
    spec = tmodels.load(_tiny_cfg())
    spec.model.init(torch.Generator().manual_seed(3), device="cpu")
    spec.model.on_stage(None, freeze_batchnorm=False)
    tx, _ = tspec.OptimizerSpec.from_config(OPTIMIZER).build(
        spec.model.module.parameters(),
        tspec.GradientSpec.from_config(GRADIENT))
    step = parallel.make_train_step(spec.model, spec.loss)
    state = parallel.TrainState(spec.model, tx)
    for lr in (1e-3, 5e-4):
        state, _ = step(state, lr, *(torch.from_numpy(x) for x in _batch()))
    return spec, tx


def _tensors_equal(a, b):
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tensors_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_tensors_equal, a, b))
    return a == b


def test_port_checkpoint_round_trips_bit_for_bit(tmp_path, trained):
    spec, tx = trained
    ctx = _Ctx(spec.model.module, tx.optimizer, step=4)
    chkpt = ctx.snapshot_checkpoint(_Stage(1), 0, {"EndPointError/mean": 2.5})
    chkpt.save(tmp_path / "a.ckpt")
    raw = (tmp_path / "a.ckpt").read_bytes()
    assert raw.startswith(tchk.MAGIC) and raw[:6] != jchk._MAGIC
    (crc,) = struct.unpack("<I", raw[6:10])
    assert crc == zlib.crc32(raw[10:])

    loaded = tchk.Checkpoint.load(tmp_path / "a.ckpt")
    assert loaded.format == "torch"
    assert loaded.iteration == tchk.Iteration(1, 0, 4)
    assert loaded.metrics == {"EndPointError/mean": 2.5}
    assert _tensors_equal(loaded.state.model, spec.model.module.state_dict())
    assert _tensors_equal(loaded.state.optimizer, tx.optimizer.state_dict())

    # re-saved after loading: the same bytes
    loaded.save(tmp_path / "b.ckpt", background=True).result()
    assert (tmp_path / "b.ckpt").read_bytes() == raw

    # applied to a fresh module and optimizer: every tensor bit for bit
    fresh = tmodels.load(_tiny_cfg())
    fresh.model.init(torch.Generator().manual_seed(9), device="cpu")
    ftx, _ = tspec.OptimizerSpec.from_config(OPTIMIZER).build(
        fresh.model.module.parameters(),
        tspec.GradientSpec.from_config(GRADIENT))
    sched = tspec.SchedulerSpec.from_config(SCHEDULE).build(1e-3,
                                                            SCHEDULE_VARS)
    scaler = loaded.apply(module=fresh.model.module, optimizer=ftx.optimizer,
                          scaler={}, lr_sched_inst=[sched])
    assert scaler == {"enabled": False, "scale": 65536.0}
    assert sched.last_step == 4
    assert _tensors_equal(fresh.model.module.state_dict(),
                          spec.model.module.state_dict())
    assert _tensors_equal(ftx.optimizer.state_dict(),
                          tx.optimizer.state_dict())


def _corrupt(path, how):
    raw = bytearray(path.read_bytes())
    if how == "flip":
        raw[len(raw) // 2] ^= 0x10
    elif how == "truncate":
        raw = raw[:len(raw) - 100]
    elif how == "magic":
        raw[:6] = b"NOTCK\n"
    elif how == "header":
        raw = raw[:8]
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("how", ["flip", "truncate", "magic", "header"])
def test_corrupt_checkpoint_raises(tmp_path, trained, how):
    spec, tx = trained
    path = tmp_path / "a.ckpt"
    _Ctx(spec.model.module, tx.optimizer).snapshot_checkpoint(
        _Stage(0), 0).save(path)
    _corrupt(path, how)
    with pytest.raises(tchk.CheckpointCorrupt):
        tchk.Checkpoint.load(path)


def _manager(path, compare=("{m_EndPointError_mean}",), keep_latest=None,
             keep_best=None, cls=tchk.CheckpointManager):
    name = ("{id_model}-s{n_stage}_e{n_epoch}_b{n_steps}"
            "-epe{m_EndPointError_mean:.4f}.ckpt")
    return cls("raft/baseline", path, name, list(compare), keep_latest,
               keep_best)


@pytest.mark.parametrize("background", ["1", "0"])
def test_load_valid_quarantines_and_falls_back(tmp_path, trained,
                                                monkeypatch, background):
    """The best checkpoint corrupt: ``load_valid`` quarantines it and
    returns the next best; the manager forgets it. Saves in the
    background (the default) and on the caller's thread
    (``RMD_ASYNC_CHECKPOINT=0``) alike."""
    monkeypatch.setenv("RMD_ASYNC_CHECKPOINT", background)
    spec, tx = trained
    mgr = _manager(tmp_path)
    for epoch, epe in enumerate((3.0, 1.0, 2.0)):
        ctx = _Ctx(spec.model.module, tx.optimizer, step=2 * (epoch + 1))
        mgr.create(_log(), ctx, _Stage(0), epoch, ctx.step,
                   {"EndPointError/mean": epe})
    mgr.wait()
    best = mgr.get_best()
    assert best.metrics["EndPointError/mean"] == 1.0
    _corrupt(best.path, "flip")

    entry, chkpt = mgr.load_valid(sort="best", stage=0)
    assert entry.metrics["EndPointError/mean"] == 2.0
    assert chkpt.metrics == {"EndPointError/mean": 2.0}
    assert not best.path.exists()
    assert best.path.with_name(best.path.name + ".corrupt").exists()
    assert len(mgr.checkpoints) == 2
    assert [s["step"] for s in mgr.saves] == [2, 4, 6]
    assert all(s["bytes"] > 0 and s["blocking_ms"] >= 0
               and s["background_ms"] >= 0 for s in mgr.saves)
    assert all((s["background_ms"] > 0) == (background == "1")
               for s in mgr.saves)


def _log():
    import logging
    return logging.getLogger("test")


def test_find_auto_resume_quarantines_and_falls_back(tmp_path, trained):
    """The newest checkpoint corrupt, a newer ``failed.ckpt`` and another
    model's: auto-resume quarantines the corrupt one and picks the next
    newest of the model; a JAX-written file of the model competes too."""
    spec, tx = trained
    run = tmp_path / "runs" / "a" / "checkpoints"
    run.mkdir(parents=True)
    for step, epoch in ((2, 0), (4, 1)):
        _Ctx(spec.model.module, tx.optimizer, step).snapshot_checkpoint(
            _Stage(0), epoch).save(run / f"s0_e{epoch}.ckpt")
    newest = run / "s1_e0.ckpt"
    _Ctx(spec.model.module, tx.optimizer, 6).snapshot_checkpoint(
        _Stage(1), 0).save(newest)
    _corrupt(newest, "truncate")
    _Ctx(spec.model.module, tx.optimizer, 8).snapshot_checkpoint(
        _Stage(1), 1).save(tmp_path / "runs" / "a" / "failed.ckpt")
    other = _Ctx(spec.model.module, tx.optimizer, 10).snapshot_checkpoint(
        _Stage(1), 1)
    other.model = "raft/fs"
    other.save(run / "other.ckpt")

    path, chkpt = tchk.find_auto_resume(tmp_path / "runs",
                                        model="raft/baseline")
    assert path == run / "s0_e1.ckpt"
    assert chkpt.iteration == tchk.Iteration(0, 1, 4)
    assert not newest.exists()
    assert newest.with_name(newest.name + ".corrupt").exists()

    # a JAX-written checkpoint further along wins, and loads as JAX format
    jax_file = tmp_path / "runs" / "jax.ckpt"
    jchk.Checkpoint(
        model="raft/baseline", iteration=jchk.Iteration(1, 0, 6),
        metrics=None, state=jchk.State({}, {}, {}, [], []),
        metadata={}).save(jax_file)
    path, chkpt = tchk.find_auto_resume(tmp_path / "runs",
                                        model="raft/baseline")
    assert path == jax_file and chkpt.format == "jax"


def _entries(rs, n=9):
    """(stage, epoch, step, epe) of n checkpoints over two stages."""
    out = []
    for i in range(n):
        stage = int(i >= 5)
        out.append((stage, i % 5, 2 * (i + 1),
                    float(np.round(rs.uniform(1, 5), 4))))
    return out


@pytest.mark.parametrize("keep", [(2, 2), (1, None), (None, 1), (3, 1)],
                         ids=["best2-latest2", "best1", "latest1",
                              "best3-latest1"])
@pytest.mark.parametrize("compare", [
    ["{m_EndPointError_mean}"],
    ["{m_Fl_all} + {m_EndPointError_mean}", "-{n_steps}"],
], ids=["epe", "two-keys"])
def test_trim_best_latest_and_names_match_jax(tmp_path, keep, compare):
    rs = np.random.RandomState(len(compare) + 7 * (keep[0] or 0))
    tm = _manager(tmp_path, compare)
    jm = _manager(tmp_path, compare, cls=jchk.CheckpointManager)
    for stage, epoch, step, epe in _entries(rs):
        metrics = {"EndPointError/mean": epe, "Fl-all": epe / 10,
                   "val:EndPointError/mean": epe}
        for mgr, cls in ((tm, tchk.CheckpointEntry),
                         (jm, jchk.CheckpointEntry)):
            entry = cls("raft/baseline", stage, epoch, step, metrics, None)
            args = mgr._args(entry) | {"id_stage": f"synthetic.s{stage}"}
            args["id_model"] = "raft_baseline"
            entry.path = tmp_path / mgr.name.format_map(args)
            mgr.checkpoints.append(entry)
    assert [c.path for c in tm.checkpoints] == [c.path for c in jm.checkpoints]
    assert tm._args(tm.checkpoints[0]) == jm._args(jm.checkpoints[0])

    def key(e):
        return e.path, (e.idx_stage, e.idx_epoch, e.idx_step)

    for stage in (None, 0, 1):
        assert key(tm.get_best(stage)) == key(jm.get_best(stage))
        assert key(tm.get_latest(stage)) == key(jm.get_latest(stage))
    tm.trim(*keep, delete=False)
    jm.trim(*keep, delete=False)
    assert [key(c) for c in tm.checkpoints] == [key(c) for c in jm.checkpoints]
    assert len(tm.checkpoints) < 9


# -- flax msgpack and the JAX package's files ---------------------------------------------


@pytest.fixture(scope="module")
def jax_tree():
    """A JAX checkpoint's tree with the tiny model's variables and its
    adam-w state, and leaves of every kind flax's msgpack writes."""
    model = jmodels.load(_tiny_cfg())
    x = jnp.zeros((1, 64, 96, 3))
    variables = jax.tree.map(jnp.asarray, _flax_init(model.model, 4, x, x))
    tx, _ = jspec.OptimizerSpec.from_config(OPTIMIZER).build(
        jspec.GradientSpec.from_config(GRADIENT))
    opt = serialization.to_state_dict(tx.init(variables["params"]))
    return {"model": "raft/baseline",
            "iteration": {"stage": 1, "epoch": None, "step": 12},
            "metrics": {"EndPointError/mean": 1.25, "val:Fl-all": 0.5},
            "state": {"model": jax.tree.map(np.asarray, variables),
                      "optimizer": jax.tree.map(np.asarray, opt),
                      "scaler": {"enabled": False, "scale": 65536.0},
                      "lr-scheduler": {"instance": [{"last_step": 12}],
                                       "epoch": []}},
            "metadata": {"timestamp": "2026-01-01T00:00:00",
                         "source": "training"},
            "extra": {"bf16": jnp.full((3, 2), 1.5, jnp.bfloat16),
                      "scalar": np.float32(2.5), "neg": -7, "big": 2**40,
                      "bool": True, "bytes": b"\x00\x01", "list": [1, "a"],
                      "f64": np.arange(3.0), "i8": np.arange(-3, 3, dtype=np.int8),
                      "complex": 1 + 2j, "empty": {}}}


def _same_tree(a, e):
    if isinstance(e, dict):
        assert isinstance(a, dict) and a.keys() == e.keys()
        for k in e:
            _same_tree(a[k], e[k])
    elif isinstance(e, (list, tuple)):
        assert len(a) == len(e)
        for x, y in zip(a, e):
            _same_tree(x, y)
    elif isinstance(e, (np.ndarray, np.generic)) or hasattr(e, "dtype"):
        e = np.asarray(e)
        if e.dtype.name == "bfloat16":
            e = e.astype(np.float32)
        assert np.asarray(a).dtype == e.dtype and np.array_equal(a, e)
    else:
        assert a == e and type(a) is type(e)


def test_msgpack_reader_matches_msgpack_package(jax_tree):
    tree = jax_tree
    payload = serialization.msgpack_serialize(tree)
    _same_tree(tmsgpack.restore(payload),
               serialization.msgpack_restore(payload))
    with pytest.raises(tmsgpack.MsgpackError):
        tmsgpack.restore(payload[:-3])
    with pytest.raises(tmsgpack.MsgpackError):
        tmsgpack.restore(payload + b"\x00")


def test_jax_checkpoint_crc_and_optimizer_refusal(tmp_path, jax_tree):
    """A JAX file with a flipped bit raises the port's CheckpointCorrupt;
    an optax state that is not Adam's is refused by its name."""
    path = tmp_path / "j.ckpt"
    tree = dict(jax_tree, state=dict(jax_tree["state"]))
    jchk.Checkpoint.from_dict(tree).save(path)
    assert tchk.Checkpoint.load(path).format == "jax"
    _corrupt(path, "flip")
    with pytest.raises(tchk.CheckpointCorrupt):
        convert.load_jax_checkpoint(path, None)

    spec = tmodels.load(_tiny_cfg())
    spec.model.init(device="cpu")
    sgd = {"type": "sgd", "parameters": {"lr": 1e-2, "momentum": 0.9}}
    jtx, _ = jspec.OptimizerSpec.from_config(sgd).build(
        jspec.GradientSpec.from_config(GRADIENT))
    tree["state"]["optimizer"] = jax.tree.map(
        np.asarray, serialization.to_state_dict(
            jtx.init(tree["state"]["model"]["params"])))
    jchk.Checkpoint.from_dict(tree).save(path)
    ttx, _ = tspec.OptimizerSpec.from_config(OPTIMIZER).build(
        spec.model.module.parameters())
    with pytest.raises(ValueError, match="trace"):
        convert.load_jax_checkpoint(path, spec.model.module, ttx.optimizer)
    # the weights alone still load
    convert.load_jax_checkpoint(path, spec.model.module)


@pytest.fixture(scope="module")
def full_jax(tmp_path_factory):
    """The tiny f32 raft/baseline at 3 iterations: weights drawn as flax
    initializes them (``_flax_init``), written by the JAX package's
    ``Checkpoint.save``, and the JAX forward
    of request 0 of the serve load generator (seed 0, 64x96)."""
    root = tmp_path_factory.mktemp("jaxckpt")
    spec = jmodels.load(_serve_cfg())
    raw1, raw2 = loadgen.synthetic_pair((64, 96), np.random.default_rng(0))
    img1, img2 = (jnp.asarray(2 * x[None] - 1) for x in (raw1, raw2))
    variables = jax.tree.map(jnp.asarray,
                             _flax_init(spec.model, 2, img1, img2))
    flows = jax.jit(lambda v: spec.model.apply(v, img1, img2))(variables)
    path = root / "jax.ckpt"
    jchk.Checkpoint(
        model="raft/baseline", iteration=jchk.Iteration(0, 3, 40),
        metrics={"EndPointError/mean": 4.0},
        state=jchk.State(jax.tree.map(np.asarray, variables), {},
                         {"enabled": False, "scale": 65536.0}, [], []),
        metadata={"source": "training"}).save(path)
    assert path.read_bytes().startswith(b"RMDT2\n")
    return root, path, np.asarray(flows[-1])


def test_jax_checkpoint_forward_matches_jax(full_jax):
    _, path, expected = full_jax
    spec = tmodels.load(_serve_cfg())
    spec.model.init(torch.Generator().manual_seed(1), device="cpu")
    chkpt = convert.load_jax_checkpoint(path, spec.model.module)
    assert chkpt.iteration == tchk.Iteration(0, 3, 40)
    assert chkpt.metrics == {"EndPointError/mean": 4.0}

    raw1, raw2 = loadgen.synthetic_pair((64, 96), np.random.default_rng(0))
    step = evaluation.make_eval_fn(spec.model)
    _, final = step(*(torch.from_numpy(2 * x[None] - 1) for x in (raw1, raw2)))
    assert np.abs(final.numpy() - expected).max() <= F32_MAX_ABS_PX


@pytest.mark.parametrize("how", ["flag", "config"])
def test_serve_checkpoint_on_cpu(full_jax, how):
    """``serve --checkpoint FILE --device cpu`` and the config's
    ``checkpoint:`` key (relative to the config file) serve the JAX
    checkpoint: request 0's flow equals the JAX forward of its pair."""
    root, path, expected = full_jax
    (root / "model.json").write_text(json.dumps(_serve_cfg()))
    cfg = {"model": "model.json", "buckets": "64x96", "batch-size": 1,
           "requests": 2, "rate": 100, "max-wait-ms": 1}
    argv = ["serve", "--device", "cpu"]
    if how == "config":
        cfg["checkpoint"] = path.name
    else:
        argv += ["--checkpoint", str(path)]
    (root / f"serve-{how}.json").write_text(json.dumps({"serve": cfg}))
    with redirect_stdout(io.StringIO()):
        report = port_main.main(argv + ["-c", str(root / f"serve-{how}.json")])
    assert report["completed"] == 2 and report["nonfinite"] == 0
    flow = report["results"][0].flow
    assert flow.shape == (64, 96, 2)
    assert np.abs(flow - expected[0]).max() <= F32_MAX_ABS_PX


def test_jax_checkpoint_resume_step_matches_jax(tmp_path):
    """JAX: two AdamW + clip steps, a checkpoint by JAX's
    ``Checkpoint.save``, and the resumed third step from the reloaded
    file. The port resumes from the same file (weights, the AdamW moments
    and count, the scheduler) and takes the third step: the restored
    state equals the JAX one bit for bit, the step's loss and parameters
    match within the step bounds."""
    batch = _batch(1)
    jm = jmodels.load(_tiny_cfg())
    jm.model.on_stage(None, freeze_batchnorm=True)
    x1 = jnp.asarray(batch[0])
    variables = jax.tree.map(jnp.asarray, _flax_init(jm.model, 5, x1, x1))
    jtx, jlr = jspec.OptimizerSpec.from_config(OPTIMIZER).build(
        jspec.GradientSpec.from_config(GRADIENT))
    jsched = jspec.SchedulerSpec.from_config(SCHEDULE).build(jlr,
                                                            SCHEDULE_VARS)
    jstep = jmake_train_step(jm.model, jm.loss, jtx, external_lr=True,
                             donate=False)
    state = JTrainState.create(variables, jtx)
    for _ in range(2):
        state, _ = jstep(state, jsched.lr(), *(jnp.asarray(x) for x in batch))
        jsched.step()

    path = tmp_path / "jax-s0_e0_b2.ckpt"
    jchk.Checkpoint(
        model="raft/baseline", iteration=jchk.Iteration(0, 0, 2),
        metrics=None,
        state=jchk.State(
            model=serialization.to_state_dict(state.variables()),
            optimizer=serialization.to_state_dict(state.opt_state),
            scaler={"enabled": False, "scale": 65536.0},
            lr_sched_inst=[jsched.state_dict()], lr_sched_epoch=[]),
        metadata={}).save(path)

    # JAX's resume: reload the file onto a fresh state and scheduler
    loaded = jchk.Checkpoint.load(path)
    fresh = JTrainState.create(variables, jtx)
    jvars, jopt, _ = loaded.apply(variables=fresh.variables(),
                                  opt_state=fresh.opt_state)
    jsched2 = jspec.SchedulerSpec.from_config(SCHEDULE).build(jlr,
                                                             SCHEDULE_VARS)
    jsched2.load_state_dict(loaded.state.lr_sched_inst[0])
    jstate = JTrainState.create(jvars, jtx).replace(opt_state=jopt)
    jlr3 = jsched2.lr()
    jstate, jaux = jstep(jstate, jlr3, *(jnp.asarray(x) for x in batch))

    # the port's resume from the same file
    tm = tmodels.load(_tiny_cfg())
    tm.model.init(torch.Generator().manual_seed(8), device="cpu")
    ttx, tlr = tspec.OptimizerSpec.from_config(OPTIMIZER).build(
        tm.model.module.parameters(), tspec.GradientSpec.from_config(GRADIENT))
    chkpt = convert.load_jax_checkpoint(path, tm.model.module, ttx.optimizer)
    tsched = tspec.SchedulerSpec.from_config(SCHEDULE).build(tlr,
                                                            SCHEDULE_VARS)
    chkpt.apply(lr_sched_inst=[tsched])
    assert tsched.last_step == 2 and tsched.lr() == jlr3

    expected = convert.jax_variables_to_state_dict(
        jax.tree.map(np.asarray, jvars))
    for name, value in tm.model.module.state_dict().items():
        assert torch.equal(value, expected[name]), name
    adam = jopt[1][0]
    mu = convert.jax_variables_to_state_dict(
        {"params": jax.tree.map(np.asarray, adam.mu)})
    nu = convert.jax_variables_to_state_dict(
        {"params": jax.tree.map(np.asarray, adam.nu)})
    for name, p in tm.model.module.named_parameters():
        st = ttx.optimizer.state[p]
        assert float(st["step"]) == int(adam.count) == 2
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name

    tm.model.on_stage(None, freeze_batchnorm=True)
    tstep = parallel.make_train_step(tm.model, tm.loss)
    with torch.backends.mkldnn.flags(enabled=False):
        _, taux = tstep(parallel.TrainState(tm.model, ttx), tsched.lr(),
                        *(torch.from_numpy(x) for x in batch))
    jloss = float(jaux["loss"])
    assert abs(float(taux["loss"]) - jloss) <= LOSS_REL * abs(jloss)

    after = convert.jax_variables_to_state_dict(
        jax.tree.map(np.asarray, jstate.variables()))
    for name, value in tm.model.module.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        atol = STEM_PARAM_ATOL if name.startswith(STEM) else PARAM_ATOL
        np.testing.assert_allclose(value.numpy(), after[name].numpy(),
                                   rtol=0, atol=atol, err_msg=name)


# -- failed.ckpt and the checkpoint command ----------------------------------------


def _write_tree(root, n=5):
    import cv2

    from raft_meets_dicl_tpu_torch.data import io as tio

    rs = np.random.RandomState(5)
    (root / "frames").mkdir(parents=True)
    (root / "flows").mkdir()
    for i in range(n):
        cv2.imwrite(str(root / "frames" / f"frame_{i:04d}.png"),
                    rs.randint(0, 256, (64, 96, 3), dtype=np.uint8))
        tio.write_flow_mb(root / "flows" / f"frame_{i:04d}.flo",
                          rs.randn(64, 96, 2).astype(np.float32))
    (root / "dataset.yaml").write_text(
        "name: synthetic\nid: synthetic\npath: .\n"
        "layout:\n  type: generic\n"
        "  images: 'frames/frame_{idx:04d}.png'\n"
        "  flows: 'flows/frame_{idx:04d}.flo'\n"
        "  key: 'synthetic/{idx:04d}'\n")
    (root / "model.json").write_text(json.dumps(_tiny_cfg()))
    stage = {"name": "synthetic", "id": "synthetic/s1",
             "data": {"epochs": 1, "batch-size": 2,
                      "source": {"type": "dataset", "spec": "dataset.yaml"}},
             "optimizer": OPTIMIZER, "gradient": GRADIENT,
             "loader": {"num_workers": 0}}
    (root / "strategy.json").write_text(json.dumps(
        {"mode": "continuous", "stages": [stage]}))


def test_nonfinite_step_writes_failed_checkpoint(tmp_path, monkeypatch):
    """Under ``raise`` a non-finite step aborts the run after writing
    ``failed.ckpt`` (the state at the fetch), which auto-resume skips."""
    from raft_meets_dicl_tpu_torch.strategy import training

    _write_tree(tmp_path / "data")
    build = training.make_train_step

    def poisoned(*args, **kwargs):
        step = build(*args, **kwargs)

        def wrapped(state, lr, *batch):
            state, aux = step(state, lr, *batch)
            return state, aux | {"finite": torch.tensor(state.step < 2)}
        return wrapped

    monkeypatch.setattr(training, "make_train_step", poisoned)
    with pytest.raises(RuntimeError, match=r"non-finite .* step\(s\) \[1\]"):
        port_main.main(["train", "-d", str(tmp_path / "data" / "strategy.json"),
                        "-m", str(tmp_path / "data" / "model.json"),
                        "-o", str(tmp_path / "runs"), "--device", "cpu"])
    failed, = (tmp_path / "runs").glob("*/failed.ckpt")
    chkpt = tchk.Checkpoint.load(failed)
    assert chkpt.iteration == tchk.Iteration(0, 0, 2)
    assert chkpt.state.optimizer["state"][0]["step"] == 2
    assert tchk.find_auto_resume(tmp_path / "runs") is None


def test_checkpoint_command_info_and_trim(tmp_path, trained, capsys):
    spec, tx = trained
    mgr = _manager(tmp_path)
    for epoch, epe in enumerate((3.0, 1.0, 2.0, 4.0)):
        ctx = _Ctx(spec.model.module, tx.optimizer, step=epoch + 1)
        mgr.create(_log(), ctx, _Stage(0), epoch, ctx.step,
                   {"EndPointError/mean": epe})
    mgr.wait()
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 4 and files[0] == \
        "raft_baseline-s0_e0_b1-epe3.0000.ckpt"

    port_main.main(["checkpoint", "info", str(tmp_path), "--sort",
                    "{m_EndPointError_mean}"])
    out = capsys.readouterr().out
    assert f"Directory: '{tmp_path}', Model: raft/baseline" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("  stage")]
    assert lines[0].startswith("  stage: 0, epoch: 1, step: 2")
    port_main.main(["checkpoint", "info", str(tmp_path / files[0])])
    assert "EndPointError/mean: 3.0000" in capsys.readouterr().out

    with pytest.raises(ValueError, match="--compare"):
        port_main.main(["checkpoint", "trim", str(tmp_path),
                        "--keep-best", "1"])
    port_main.main(["checkpoint", "trim", str(tmp_path), "--compare",
                    "{m_EndPointError_mean}", "--keep-best", "1",
                    "--keep-latest", "1"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "raft_baseline-s0_e1_b2-epe1.0000.ckpt",
        "raft_baseline-s0_e3_b4-epe4.0000.ckpt"]
    assert os.path.getsize(tmp_path / files[1]) > 0
