"""PyTorch port: the host-side data path of training held against the JAX
package on the CPU: file I/O, generic-layout datasets (parameters, filters,
sequence tails), collated and shuffled batches from the loader, expression
and seed configs, the strategy config, and the refusal of the ``synth``
source, which is not ported yet."""

import json
import random
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import raft_meets_dicl_tpu.data as jdata
import raft_meets_dicl_tpu.models.input as jinput
import raft_meets_dicl_tpu.strategy as jstrategy
from raft_meets_dicl_tpu.utils import expr as jexpr
from raft_meets_dicl_tpu.utils import seeds as jseeds
import raft_meets_dicl_tpu_torch.data as tdata
import raft_meets_dicl_tpu_torch.models.input as tinput
import raft_meets_dicl_tpu_torch.strategy as tstrategy
from raft_meets_dicl_tpu_torch.utils import config as tconfig
from raft_meets_dicl_tpu_torch.utils import expr as texpr
from raft_meets_dicl_tpu_torch.utils import seeds as tseeds

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).parent.parent
SHAPE = (60, 92)  # not a multiple of 8: the model input pads it


def _norm(cfg):
    """A config as JSON would hold it (tuples -> lists)."""
    return json.loads(json.dumps(cfg))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two passes of two scenes in the generic layout; scene ``b`` has a
    gap (frames 0-2 and 5-6), so its runs' tail frames drop."""
    root = tmp_path_factory.mktemp("tree")
    rs = np.random.RandomState(8)
    h, w = SHAPE
    frames = {"a": range(4), "b": (0, 1, 2, 5, 6)}
    for pass_ in ("clean", "final"):
        for scene, idxs in frames.items():
            img_dir = root / pass_ / scene
            img_dir.mkdir(parents=True)
            for i in idxs:
                cv2.imwrite(str(img_dir / f"frame_{i:04d}.png"),
                            rs.randint(0, 256, (h, w, 3), dtype=np.uint8))
    for scene, idxs in frames.items():
        (root / "flow" / scene).mkdir(parents=True)
        for i in idxs:
            flow = (4 * rs.randn(h, w, 2)).astype(np.float32)
            flow[0, 0] = 2e3  # beyond uvmax: an invalid pixel
            tdata.io.write_flow_mb(root / "flow" / scene / f"frame_{i:04d}.flo",
                                   flow)
    (root / "split.txt").write_text("1 2 1 2 1\n")
    return root


def _spec(tree, **extra):
    spec = {
        "name": "synthetic", "id": "synthetic", "path": str(tree),
        "layout": {"type": "generic",
                   "images": "{pass}/{scene}/frame_{idx:04d}.png",
                   "flows": "flow/{scene}/frame_{idx:04d}.flo",
                   "key": "{pass}/{scene}/{idx:04d}"},
        "parameters": {"pass": {"values": ["clean", "final"], "sub": "pass"}},
    }
    return spec | extra


CASES = {
    "clean": {"parameters": {"pass": "clean"}},
    "both-passes": {},
    "exclude": {"parameters": {"pass": "final"},
                "filter": {"type": "exclude", "exclude": [{"scene": "b"}]}},
    "file-filter": {"parameters": {"pass": "clean"},
                    "filter": {"type": "file", "file": "split.txt",
                               "value": 2}},
}


def _source(tree, case):
    return {"type": "dataset", "spec": _spec(tree), **CASES[case]}


@pytest.mark.parametrize("case", list(CASES))
def test_generic_dataset_matches_jax(tree, case):
    cfg = _source(tree, case)
    expected = jdata.load(tree, cfg)
    actual = tdata.load(tree, cfg)

    assert len(actual) == len(expected) > 0
    assert [str(f[3]) for f in actual.files] == \
        [str(f[3]) for f in expected.files]
    assert [tuple(map(str, f[:3])) for f in actual.files] == \
        [tuple(map(str, f[:3])) for f in expected.files]
    assert _norm(actual.get_config()) == _norm(expected.get_config())

    for index in (0, len(actual) - 1):
        a, e = actual[index], expected[index]
        for x, y in zip(a[:4], e[:4]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        (am,), (em,) = a[4], e[4]
        assert (am.valid, am.dataset_id, str(am.sample_id),
                am.original_extents) == (em.valid, em.dataset_id,
                                         str(em.sample_id),
                                         em.original_extents)
    # the uvmax mask marks the planted pixel invalid
    assert not actual[0][3][0, 0, 0] and actual[0][3].mean() > 0.99


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_match_jax(tree, num_workers):
    """Input contract (clip, range, modulo padding), adapter and loader:
    the same seed gives the same shuffled batches, two epochs running."""
    cfg = _source(tree, "both-passes")
    padding = {"type": "modulo", "mode": "zeros", "size": [8, 8]}
    jspec = jinput.InputSpec.from_config({"padding": padding})
    tspec = tinput.InputSpec.from_config({"padding": padding})
    expected = jspec.apply(jdata.load(tree, cfg)).jax().loader(
        batch_size=3, shuffle=True, num_workers=0, drop_last=True, seed=7)
    actual = tspec.apply(tdata.load(tree, cfg)).torch().loader(
        batch_size=3, shuffle=True, num_workers=num_workers, drop_last=True,
        seed=7)
    assert len(actual) == len(expected) == 4  # 12 pairs

    for _ in range(2):
        batches = 0
        for a, e in zip(actual, expected, strict=True):
            img1, img2, flow, valid, meta = a
            assert tuple(img1.shape) == (3, 64, 96, 3)
            for x, y in zip((img1, img2, flow, valid), e[:4]):
                assert np.array_equal(x.numpy(), y)
            assert [str(m.sample_id) for m in meta] == \
                [str(m.sample_id) for m in e[4]]
            assert [m.original_extents for m in meta] == \
                [m.original_extents for m in e[4]]
            batches += 1
        assert batches == 4


def test_collate_matches_jax(tree):
    source = tdata.load(tree, _source(tree, "clean"))
    samples = [source[i] for i in range(4)]
    for shuffle in (False, True):
        a = tinput.collate(samples, shuffle, np.random.default_rng(3))
        e = jinput.collate(samples, shuffle, np.random.default_rng(3))
        for x, y in zip(a[:4], e[:4]):
            assert np.array_equal(x, y)
        assert [str(m.sample_id) for m in a[4]] == \
            [str(m.sample_id) for m in e[4]]
    with pytest.raises(ValueError, match="mixed shapes"):
        tinput.collate([samples[0], (samples[1][0][:, :8],) + samples[1][1:]])


def test_flow_io_matches_jax(tmp_path):
    rs = np.random.RandomState(2)
    uv = (20 * rs.randn(5, 7, 2)).astype(np.float32)
    tdata.io.write_flow_mb(tmp_path / "a.flo", uv)
    assert np.array_equal(tdata.io.read_flow_mb(tmp_path / "a.flo"), uv)
    assert np.array_equal(jdata.io.read_flow_mb(tmp_path / "a.flo"), uv)

    valid = rs.rand(5, 7) > 0.3
    jdata.io.write_flow_kitti(tmp_path / "k.png", uv, valid)
    flow_t, valid_t = tdata.io.read_flow_kitti(tmp_path / "k.png")
    flow_j, valid_j = jdata.io.read_flow_kitti(tmp_path / "k.png")
    assert np.array_equal(flow_t, flow_j) and np.array_equal(valid_t, valid_j)
    assert np.array_equal(valid_t, valid)
    # the KITTI format stores 1/64 px steps, truncated
    assert np.abs(flow_t - uv)[valid].max() <= 1 / 64

    img = rs.randint(0, 256, (5, 7, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "i.png"), img)
    a = tdata.io.read_image_generic(tmp_path / "i.png")
    assert np.array_equal(a, jdata.io.read_image_generic(tmp_path / "i.png"))


@pytest.mark.parametrize("expression,expected", [
    ("100000 + 100", 100100),
    ("{n_epochs} * {n_batches}", 120),
    ("2 ** 3 - -1 + {n_batches} / 4", 19.0),
    (1e-4, 1e-4),
])
def test_math_expressions_match_jax(expression, expected):
    args = {"n_epochs": 3, "n_batches": 40}
    assert texpr.eval_math_expr(expression, args) == expected
    assert jexpr.eval_math_expr(expression, args) == expected
    for bad in ("__import__('os')", "{n_epochs}()", "[1]"):
        with pytest.raises((TypeError, ValueError)):
            texpr.eval_math_expr(bad, args)


@pytest.mark.parametrize("name", ["dev", "fixed"])
def test_seed_files_load_unchanged(name):
    raw = tconfig.load(ROOT / "cfg" / "seeds" / f"{name}.yaml")
    actual = tseeds.from_config(raw)
    expected = jseeds.from_config(raw)
    assert (actual.python, actual.numpy) == (expected.python, expected.numpy)
    # the JAX package's 'jax' seed seeds torch here
    assert actual.torch == raw["jax"]

    def draws(seeds):
        gen = seeds.apply()
        return (random.random(), np.random.rand(), torch.rand(1).item(),
                torch.rand(1, generator=gen).item())

    assert draws(actual) == draws(tseeds.from_config(raw))


@pytest.mark.parametrize("ty", ["synth"])
def test_unported_sources_are_refused(tree, ty):
    with pytest.raises(NotImplementedError, match="ROADMAP slice 7 entry 5"):
        tdata.load(tree, {"type": ty, "source": _source(tree, "clean")})


def test_strategy_config_matches_jax(tree):
    """A one-stage strategy in the s1-things form loads in both packages
    to the same config, also with a validation entry and ``mode: best``,
    which the port's trainer takes."""
    (tree / "dataset.yaml").write_text(json.dumps(_spec(tree)))
    stage = {
        "name": "synthetic", "id": "synthetic/s1",
        "data": {"epochs": 2, "batch-size": 3,
                 "source": {"type": "dataset", "spec": "dataset.yaml",
                            "parameters": {"pass": "clean"}}},
        "model": {"on-stage": {"freeze_batchnorm": True},
                  "arguments": {"iterations": 12}},
        "loss": {"arguments": {"gamma": 0.8}},
        "optimizer": {"type": "adam-w", "parameters": {
            "lr": 1.25e-4, "weight_decay": 1e-4, "eps": 1e-8}},
        "lr-scheduler": {"instance": [{"type": "one-cycle", "parameters": {
            "max_lr": 1.25e-4, "total_steps": "100000 + 100",
            "pct_start": 0.05, "cycle_momentum": False,
            "anneal_strategy": "linear"}}]},
        "gradient": {"clip": {"type": "norm", "value": 1.0}},
    }
    (tree / "strategy.yaml").write_text(json.dumps(
        {"mode": "continuous", "stages": [stage]}))
    expected = jstrategy.load(tree / "strategy.yaml")
    actual = tstrategy.load(tree / "strategy.yaml")
    assert _norm(actual.get_config()) == _norm(expected.get_config())
    again = tstrategy.load(tree, actual.get_config())
    assert _norm(again.get_config()) == _norm(actual.get_config())

    with_validation = dict(stage, validation=[
        {"source": stage["data"]["source"], "batch-size": 2,
         "images": [0]}])
    cfg = {"mode": "best", "stages": [with_validation]}
    strat = tstrategy.load(tree, cfg)
    assert _norm(strat.get_config()) == \
        _norm(jstrategy.load(tree, cfg).get_config())
    tctx = tstrategy.TrainingContext(tree, strat, "raft/baseline", None,
                                     None, None, None, device="cpu")
    assert tctx.strategy.stages[0].validation[0].batch_size == 2
