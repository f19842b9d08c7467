"""PyTorch port: host augmentation held against the JAX package on the CPU,
bit for bit.

- each of the 15 augmentations on one seeded sample, through explicit
  generators and through the legacy module-level numpy state;
- ``Augment`` with ``sync`` true and false over two epochs on a
  FlyingThings3D-shaped tree: the same ``(seed, epoch, sample)`` gives the
  same draw, another epoch another;
- ``seed: legacy`` under the loader's worker processes: each worker draws
  its own sequence;
- ``main train`` on both sides with a strategy shaped like
  ``s1-things.yaml`` (its six augmentations over ``concat`` of the clean
  and final passes, sizes scaled to the tree), 2 epochs with 2 loader
  workers, from one JAX-written checkpoint: the batches the step receives
  bit for bit in both epochs, the losses in lockstep.
"""

import hashlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raft_meets_dicl_tpu.data as jdata
import raft_meets_dicl_tpu.models as jmodels
import raft_meets_dicl_tpu.strategy.checkpoint as jchk
import raft_meets_dicl_tpu_torch.data as tdata
import raft_meets_dicl_tpu_torch.models.input as tinput
from raft_meets_dicl_tpu_torch.inspect import writer as twriter
from test_torch_port_combinators import (assert_samples_equal, things_source,
                                         things_tree)
from test_torch_port_train import _flax_init
from test_torch_port_train import port_on_one_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).parent.parent
SHAPE = (40, 56)

AUGMENTATIONS = [
    {"type": "color-jitter", "prob-asymmetric": 0.5, "brightness": 0.4,
     "contrast": 0.4, "saturation": 0.4, "hue": 0.1592},
    {"type": "color-jitter-8bit", "prob-asymmetric": 0.5, "brightness": 0.4,
     "contrast": [0.7, 1.2], "saturation": 0.4, "hue": [-0.1, 0.2]},
    {"type": "crop", "size": [40, 24]},
    {"type": "crop-center", "size": [41, 23]},
    {"type": "flip", "probability": [0.5, 0.5]},
    {"type": "noise-normal", "stddev": [0.0, 0.04]},
    {"type": "occlusion-forward", "probability": 0.8, "num": [1, 3],
     "min-size": [5, 5], "max-size": [12, 12], "skew-correction": False},
    {"type": "occlusion-backward", "probability": 0.8, "num": 2,
     "min-size": [4, 4], "max-size": [10, 10]},
    {"type": "restrict-flow-magnitude", "maximum": 4},
    {"type": "scale", "min-size": [30, 20], "min-scale": 0.7,
     "max-scale": 1.4, "max-stretch": 0.2, "prob-stretch": 0.8},
    {"type": "scale-sparse", "min-size": [30, 20], "min-scale": 0.7,
     "max-scale": 1.4, "max-stretch": 0.2, "mode": "nearest"},
    {"type": "scale-exp", "min-size": [48, 32], "min-scale": -0.4,
     "max-scale": 0.8, "max-stretch": 0.2, "prob-stretch": 0.8,
     "mode": "cubic", "th-valid": 0.9},
    {"type": "scale-sparse-exp", "min-size": [0, 0], "min-scale": -0.4,
     "max-scale": 0.8, "max-stretch": 0.2, "prob-stretch": 0.5},
    {"type": "translate", "min-size": [40, 30], "delta": [5, 4]},
    {"type": "rotate", "range": 10, "deviation": 2, "order": 2,
     "th-valid": 0.99},
]
SEEDS = range(4)


def _sample(module, seed, batch=2, shape=SHAPE):
    """A seeded pre-batched sample in ``module``'s own metadata types."""
    rs = np.random.RandomState(seed)
    b, (h, w) = batch, shape
    img1 = rs.rand(b, h, w, 3).astype(np.float32)
    img2 = rs.rand(b, h, w, 3).astype(np.float32)
    flow = (3 * rs.randn(b, h, w, 2)).astype(np.float32)
    valid = rs.rand(b, h, w) > 0.2
    meta = [module.Metadata(True, "synthetic", module.SampleId(
        "{idx:04d}", module.SampleArgs([], {"idx": i}),
        module.SampleArgs([], {"idx": i + 1})), ((0, h), (0, w)))
        for i in range(b)]
    return img1, img2, flow, valid, meta


def test_every_augmentation_is_covered():
    assert sorted(a["type"] for a in AUGMENTATIONS) == \
        sorted(tdata.augment._AUGMENTATIONS) == \
        sorted(jdata.augment._AUGMENTATIONS)


@pytest.mark.parametrize("rng", ["generator", "legacy"])
@pytest.mark.parametrize("cfg", AUGMENTATIONS, ids=lambda c: c["type"])
def test_augmentation_matches_jax(cfg, rng):
    """One sample of two pairs through the port's and the JAX package's
    augmentation from the same generator state: every array bit for bit,
    dtypes and the metadata's extents included; over a few seeds, so that
    each probability's branches are taken."""
    taug = tdata.augment.build_augmentation(cfg)
    jaug = jdata.augment.build_augmentation(cfg)
    assert taug.get_config() == jaug.get_config()
    outputs = set()
    for seed in SEEDS:
        if rng == "generator":
            actual = taug(*_sample(tdata, seed),
                          rng=np.random.default_rng(seed))
            expected = jaug(*_sample(jdata, seed),
                            rng=np.random.default_rng(seed))
        else:
            np.random.seed(seed)
            actual = taug(*_sample(tdata, seed))
            np.random.seed(seed)
            expected = jaug(*_sample(jdata, seed))
        assert_samples_equal(actual, expected)
        outputs.add(hashlib.blake2b(actual[0].tobytes()
                                    + actual[2].tobytes()).hexdigest())
    if cfg["type"] != "crop-center":
        assert len(outputs) == len(SEEDS)  # the draws change the result


def test_sparse_scale_rescatters_valid_vectors():
    """``scale-sparse`` at twice the size: each valid vector moves to its
    scaled position, twice as long (KITTI-style); the rest stays invalid."""
    cfg = {"type": "scale-sparse", "min-scale": 2.0, "max-scale": 2.0,
           "max-stretch": 0.0}
    img1, img2, flow, valid, meta = _sample(tdata, 5, batch=1)
    out = tdata.augment.build_augmentation(cfg)(
        img1, img2, flow, valid, meta, rng=np.random.default_rng(0))
    assert out[2].shape == (1, 2 * SHAPE[0], 2 * SHAPE[1], 2)
    ys, xs = np.nonzero(valid[0])
    assert out[3][0].sum() == len(ys)
    assert np.array_equal(out[2][0, 2 * ys, 2 * xs], 2 * flow[0, ys, xs])


@pytest.fixture(scope="module")
def things(tmp_path_factory):
    root = tmp_path_factory.mktemp("things")
    return root, things_tree(root, shape=SHAPE, outliers=0.05)


def _augment_cfg(spec, sync):
    """s1-things' chain at the tree's size: color-jitter-8bit,
    occlusion-forward, scale-exp, flip, crop, restrict-flow-magnitude."""
    chain = [AUGMENTATIONS[i] for i in (1, 6, 11, 4, 2, 8)]
    return {"type": "augment", "sync": sync, "seed": 7,
            "augmentations": chain,
            "source": {"type": "forwards-backwards-batch",
                       "forwards": things_source(spec, "forwards"),
                       "backwards": things_source(spec, "backwards")}}


@pytest.mark.parametrize("sync", [True, False])
def test_augment_matches_jax_over_two_epochs(things, sync):
    """``augment`` over a source of two pairs an index, ``sync`` (one draw
    for both) and not (one each): both packages give the same samples in
    epoch 0 and in epoch 1, whatever the order of access; the draw is keyed
    by epoch, so epoch 1 differs from epoch 0 and epoch 0 comes back."""
    root, spec = things
    actual = tdata.load(root, _augment_cfg(spec, sync))
    expected = jdata.load(root, _augment_cfg(spec, sync))
    assert actual.get_config() == expected.get_config()
    assert actual.description() == expected.description()
    n = len(actual)

    epochs = []
    for epoch in (0, 1, 0):
        actual.set_epoch(epoch)
        expected.set_epoch(epoch)
        samples = [actual[i] for i in reversed(range(n))][::-1]
        for i in range(n):
            assert_samples_equal(samples[i], expected[i])
        epochs.append(samples)
    for a, b in zip(epochs[0], epochs[2]):
        assert_samples_equal(a, b)
    changed = [not np.array_equal(a[0], b[0])
               for a, b in zip(epochs[0], epochs[1])]
    assert all(changed)


class _Constant(tdata.Collection):
    """The same pair at every index (so any difference between two samples
    is the augmentation's draw)."""

    def __init__(self, n=4):
        self.n = n
        self.sample = _sample(tdata, 3, batch=1)

    def __getitem__(self, index):
        img1, img2, flow, valid, (meta,) = self.sample
        return img1, img2, flow, valid, [tdata.Metadata(
            True, "constant", tdata.SampleId(
                "{idx}", tdata.SampleArgs([], {"idx": index}),
                tdata.SampleArgs([], {"idx": index})), meta.original_extents)]

    def __len__(self):
        return self.n


def test_legacy_seeding_draws_apart_in_each_worker():
    """``seed: legacy`` draws from the module-level numpy state of the
    process that decodes: with 2 workers, batch 0 and batch 1 are each
    their worker's first draw and differ (had both workers inherited one
    state they would be equal); in the caller the draws follow the
    global seed."""
    aug = tdata.augment.Augment(
        [tdata.augment.build_augmentation(
            {"type": "noise-normal", "stddev": 0.1})], _Constant(), seed="legacy")
    loader = tinput.Loader(aug, batch_size=1, num_workers=2)
    batches = [b[0].numpy() for b in loader]
    assert len(batches) == 4
    assert len({b.tobytes() for b in batches}) == 4

    np.random.seed(5)
    first = [aug[i][0] for i in range(2)]
    np.random.seed(5)
    again = [aug[i][0] for i in range(2)]
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert not np.array_equal(first[0], first[1])


# -- main train on both sides ------------------------------------------------

TREE_SHAPE = (108, 192)           # FlyingThings' 540x960 / 5
TREE_SEQUENCES = (("A", 0, range(6, 9)),)   # 2 pairs a pass
MODEL_PARAMS = {"corr-levels": 2, "corr-radius": 2, "corr-channels": 32,
                "context-channels": 16, "recurrent-channels": 16}
# the loss bound of tests/test_torch_port_inspect.py's lockstep: the fresh
# run's losses there read up to 2.2e-4 apart (Adam's first updates carry
# the gradients' rounding differences into the weights)
LOCKSTEP_REL = 2.2e-4


def _s1_things_augmentations():
    """``s1-things.yaml``'s six augmentations, as shipped, with its sizes
    scaled to the tree (a fifth of FlyingThings' frames)."""
    import yaml

    stage, = yaml.safe_load((ROOT / "cfg" / "strategy" / "baseline" / "raft"
                             / "s1-things.yaml").read_text())["stages"]
    augs = stage["data"]["source"]["augmentations"]
    assert [a["type"] for a in augs] == [
        "color-jitter-8bit", "occlusion-forward", "scale-exp", "flip",
        "crop", "restrict-flow-magnitude"]
    scaled = {"occlusion-forward": {"min-size": [10, 10],
                                    "max-size": [20, 20]},
              "scale-exp": {"min-size": [152, 88]},
              "crop": {"size": [144, 80]},
              "restrict-flow-magnitude": {"maximum": 80}}
    return [a | scaled.get(a["type"], {}) for a in augs]


def _write_lockstep_tree(root):
    spec = things_tree(root / "things", shape=TREE_SHAPE,
                       sequences=TREE_SEQUENCES, seed=2, outliers=0.02)
    (root / "things.json").write_text(json.dumps(spec))
    model = {"name": "RAFT baseline, tiny", "id": "raft/baseline",
             "model": {"type": "raft/baseline", "parameters": MODEL_PARAMS,
                       "arguments": {"iterations": 2}},
             "loss": {"type": "raft/sequence"},
             "input": {"clip": [0, 1], "range": [-1, 1],
                       "padding": {"type": "modulo", "mode": "zeros",
                                   "size": [8, 8]}}}
    (root / "model.json").write_text(json.dumps(model))
    passes = [{"type": "dataset", "spec": "things.json",
               "parameters": {"type": "train", "pass": p,
                              "direction": "forwards", "camera": "left"}}
              for p in ("clean", "final")]
    stage = {
        "name": "things, s1 recipe", "id": "things/s1",
        "data": {"epochs": 2, "batch-size": 2, "source": {
            "type": "augment", "augmentations": _s1_things_augmentations(),
            "source": {"type": "concat", "sources": passes}}},
        "model": {"on-stage": {"freeze_batchnorm": True}},
        "loss": {"arguments": {"gamma": 0.8}},
        # AdamW at eps 1e-3, as the other lockstep tests: at 1e-8 the first
        # update is lr * sign(g), and rounding noise flips signs at random
        "optimizer": {"type": "adam-w", "parameters": {
            "lr": 1.25e-4, "weight_decay": 1e-4, "eps": 1e-3}},
        "lr-scheduler": {"instance": [{"type": "one-cycle", "parameters": {
            "max_lr": 1.25e-4, "total_steps": "100000 + 100",
            "pct_start": 0.05, "cycle_momentum": False,
            "anneal_strategy": "linear"}}]},
        "gradient": {"clip": {"type": "norm", "value": 1.0}},
        "loader": {"num_workers": 2},
    }
    (root / "strategy.json").write_text(json.dumps(
        {"mode": "continuous", "stages": [stage]}))

    jspec = jmodels.load(model)
    x = jnp.zeros((1, 80, 144, 3))
    variables = _flax_init(jspec.model, 11, x, x)
    jchk.Checkpoint(
        model="raft/baseline", iteration=jchk.Iteration(0, None, 0),
        metrics=None,
        state=jchk.State(jax.tree.map(np.asarray, variables), {}, {}, [], []),
        metadata={"source": "init"}).save(root / "init.ckpt")


# each side's run records, per step, the epoch, a digest of each array of
# the batch the step receives and the pairs' keys
_RUNNER = {
    "jax": """
        import sys
        from raft_meets_dicl_tpu.main import main
        from raft_meets_dicl_tpu.strategy import training
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
        {record}
        original = training.TrainingContext.run_instance

        def run_instance(self, log, stage, epoch, i, host, dev, meta,
                         **kwargs):
            record(epoch, host, meta)
            return original(self, log, stage, epoch, i, host, dev, meta,
                            **kwargs)

        training.TrainingContext.run_instance = run_instance
        sys.argv = ["main.py"] + {argv!r}
        main()
        dump()
        """,
    "port": """
        import torch
        from raft_meets_dicl_tpu_torch.main import main
        from raft_meets_dicl_tpu_torch.strategy import training
        {record}
        original = training.TrainingContext.run_instance

        def run_instance(self, stage, epoch, i, batch):
            record(epoch, [x.numpy() for x in batch[:4]], batch[4])
            return original(self, stage, epoch, i, batch)

        training.TrainingContext.run_instance = run_instance
        # true float32 convolutions, as the JAX side runs at 'highest'
        torch.backends.mkldnn.enabled = False
        torch.set_num_threads(1)
        main({argv!r})
        dump()
        """,
}

_RECORD = """
        import hashlib, json
        import numpy as np
        steps = []

        def record(epoch, arrays, meta):
            steps.append({{"epoch": int(epoch), "keys": [
                str(m.sample_id) for m in meta], "arrays": [
                [str(a.dtype), list(a.shape), hashlib.blake2b(
                    np.ascontiguousarray(a).tobytes()).hexdigest()]
                for a in arrays]}})

        def dump():
            with open({out!r}, "w") as fd:
                json.dump(steps, fd)
"""


def _launch(side, root):
    # one CPU device (the conftest's 8 virtual ones would put the JAX run
    # on a data mesh), one thread, no compile caches or AOT programs
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "RMD_NO_COMPILE_CACHE": "1", "RMD_AOT": "0",
           "PYTHONPATH": str(ROOT)}
    argv = ["train", "-d", str(root / "strategy.json"),
            "-m", str(root / "model.json"), "-o", str(root / side),
            "--device", "cpu", "-s", str(ROOT / "cfg" / "seeds" / "fixed.yaml"),
            "--reproduce", "--checkpoint", str(root / "init.ckpt")]
    record = textwrap.indent(textwrap.dedent(_RECORD).format(
        out=str(root / f"{side}.steps.json")), " " * 8)
    script = textwrap.dedent(_RUNNER[side].format(record=record.strip(),
                                                  argv=argv))
    return subprocess.Popen(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _losses(out):
    run, = [p for p in out.iterdir() if p.is_dir()]
    events = twriter.read_events(next((run / "tb.raft_baseline").iterdir()))
    return {e["step"]: v["simple_value"] for e in events
            for v in e.get("values", [])
            if v["tag"] == "Train:S0:things.s1/Loss"}


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    root = tmp_path_factory.mktemp("lockstep")
    _write_lockstep_tree(root)
    procs = {side: _launch(side, root) for side in ("jax", "port")}
    for side, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, f"{side}:\n{log[-3000:]}"
    return {side: (json.loads((root / f"{side}.steps.json").read_text()),
                   _losses(root / side)) for side in procs}


def test_main_train_batches_match_jax(lockstep):
    """The batches ``main train`` hands the step: the same pairs in the
    same order, every array bit for bit, in both epochs (2 worker
    processes forked at each epoch on the port's side, 2 threads on
    JAX's); epoch 1 augments afresh."""
    expected, _ = lockstep["jax"]
    actual, _ = lockstep["port"]
    assert [s["epoch"] for s in actual] == [0, 0, 1, 1]
    assert actual == expected
    for s in actual:
        assert [a[:2] for a in s["arrays"]] == [
            ["float32", [2, 80, 144, 3]], ["float32", [2, 80, 144, 3]],
            ["float32", [2, 80, 144, 2]], ["bool", [2, 80, 144]]]
    images = [{s["arrays"][0][2] for s in actual if s["epoch"] == e}
              for e in (0, 1)]
    assert not images[0] & images[1]


def test_main_train_losses_match_jax(lockstep):
    _, expected = lockstep["jax"]
    _, actual = lockstep["port"]
    assert sorted(actual) == sorted(expected) == [0, 1, 2, 3]
    for step, e in expected.items():
        assert abs(actual[step] - e) <= LOCKSTEP_REL * abs(e), step
    assert len(set(actual.values())) == 4
