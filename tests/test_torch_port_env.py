"""PyTorch port: ``main train``'s environments and full configurations
held against the JAX package on the CPU.

- every ``cfg/env/*.yaml`` loads to the JAX ``Environment``'s
  ``get_config()``, or is refused naming its ROADMAP item;
- each of the 21 ``cfg/full/baseline/*.json`` goes through
  ``load_config_parts`` on both sides, and its model, strategy (each
  stage built as the trainer builds it), inspector and environment load
  to JAX's configs (none is refused: ``FULL_REFUSED`` is empty); the
  dataset roots are stubs, as in ``tests/test_cfg_corpus.py``;
- the port registers the model and loss types the JAX package does;
- ``load_config_parts``: the part flags override ``-c``'s parts;
- ``main train -c <run>/config.json --reproduce`` repeats the run's
  losses bit for bit, its ``config.json`` carries the environment, and
  the wire format takes the flag, then ``RMD_WIRE_FORMAT``, then the
  environment's section;
- the deterministic switches: the windowed df2 kernel, which adds with
  atomics, refuses under them; the sampler's backward, which sums in a
  fixed order, does not.
"""

import importlib
import json
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_meets_dicl_tpu import inspect as jinspect
from raft_meets_dicl_tpu import models as jmodels
from raft_meets_dicl_tpu import strategy as jstrategy
from raft_meets_dicl_tpu_torch import inspect as tinspect
from raft_meets_dicl_tpu_torch import main as tmain
from raft_meets_dicl_tpu_torch import models as tmodels
from raft_meets_dicl_tpu_torch import strategy as tstrategy
from raft_meets_dicl_tpu_torch.ops import sample, windowed
from test_torch_port_cfg_corpus import _build
from test_torch_port_train import _one_thread, _write_tree
from test_torch_port_train import port_on_one_thread  # noqa: F401

# the modules (each package's ``cmd`` binds ``train`` to the function)
jtrain_cmd = importlib.import_module("raft_meets_dicl_tpu.cmd.train")
ttrain_cmd = importlib.import_module("raft_meets_dicl_tpu_torch.cmd.train")

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent
ENVS = sorted((ROOT / "cfg" / "env").glob("*.yaml"))
FULL = sorted((ROOT / "cfg" / "full" / "baseline").glob("*.json"))

# environments the port refuses, by the ROADMAP item named
ENV_REFUSED = {
    "device-aug": "slice 7 item 5",
    "fastboot": "slice 7 item 3",
    "spmd": "slice 2 item 10",
}

# full configs the port refuses, by the ROADMAP item named: none, since
# every model type is ported
FULL_REFUSED = {}


def _norm(cfg):
    return json.loads(json.dumps(cfg))


def test_corpus_sizes():
    assert len(ENVS) == 9 and len(FULL) == 21
    assert set(ENV_REFUSED) < {p.stem for p in ENVS}
    assert set(FULL_REFUSED) < {p.stem for p in FULL}


def test_registries_match_jax():
    """Every model and loss type the JAX package registers, and no other."""
    assert tmodels.config.model_types() == jmodels.config.model_types()
    assert tmodels.config.loss_types() == jmodels.config.loss_types()


@pytest.mark.parametrize("path", ENVS, ids=lambda p: p.stem)
def test_environments_match_jax(path):
    expected = jtrain_cmd.Environment.load(path).get_config()
    if path.stem in ENV_REFUSED:
        with pytest.raises(NotImplementedError,
                           match=ENV_REFUSED[path.stem]):
            ttrain_cmd.Environment.load(path)
        return
    assert _norm(ttrain_cmd.Environment.load(path).get_config()) == \
        _norm(expected)


def _stub(base, node):
    """Create the dataset roots a frozen strategy names, resolved against
    ``base`` as the trainer resolves them: every directory on the way (a
    ``..`` needs the directory before it to exist), files touched."""
    if isinstance(node, dict):
        for value in node.values():
            _stub(base, value)
    elif isinstance(node, list):
        for value in node:
            _stub(base, value)
    elif isinstance(node, str) and "datasets/" in node:
        path = Path(base)
        for part in Path(node).parts:
            if part != "..":
                path.mkdir(parents=True, exist_ok=True)
            path = path / part
        if path.suffix in (".txt", ".json", ".csv"):
            path.parent.mkdir(parents=True, exist_ok=True)
            path.touch()
        else:
            path.mkdir(parents=True, exist_ok=True)


def _args(**kwargs):
    fields = dict(config=None, seeds=None, env=None, model=None, data=None,
                  inspect=None)
    return types.SimpleNamespace(**(fields | kwargs))


@pytest.mark.parametrize("path", FULL, ids=lambda p: p.stem)
def test_full_configs_match_jax(path, tmp_path, monkeypatch):
    """``-c`` with a shipped full config: the parts each side builds."""
    config = tmp_path / "cfg" / path.name
    config.parent.mkdir()
    config.write_text(path.read_text())
    monkeypatch.chdir(tmp_path)
    args = _args(config=str(config.relative_to(tmp_path)))
    jparts = jtrain_cmd.load_config_parts(args)
    tparts = ttrain_cmd.load_config_parts(args)
    seeds, env, model, strat, inspc, base = tparts
    assert _norm(seeds) == _norm(jparts[0]) and str(base) == str(jparts[5])
    _stub(base, strat)

    expected_env = jtrain_cmd.Environment.load(jparts[1]).get_config()
    assert _norm(ttrain_cmd.Environment.load(env).get_config()) == \
        _norm(expected_env)
    assert _norm(tinspect.load(inspc).get_config()) == \
        _norm(jinspect.load(jparts[4]).get_config())
    np.random.seed(0)
    expected = jstrategy.load(jparts[5], jparts[3]).get_config()
    np.random.seed(0)
    actual = tstrategy.load(base, strat)
    assert _norm(actual.get_config()) == _norm(expected)

    if path.stem in FULL_REFUSED:
        with pytest.raises(NotImplementedError,
                           match=FULL_REFUSED[path.stem]):
            tmodels.load(model)
        return
    assert _norm(tmodels.load(model).get_config()) == \
        _norm(jmodels.load(jparts[2]).get_config())
    for stage in actual.stages:
        _build(stage)


def test_part_flags_override_the_config(tmp_path):
    config = {"seeds": {"python": 1, "numpy": 2, "jax": 3},
              "model": {"m": 1}, "strategy": {"s": 1},
              "inspect": {"i": 1}, "environment": {"loader": {}}}
    (tmp_path / "run").mkdir()
    path = tmp_path / "run" / "config.json"
    path.write_text(json.dumps(config))
    seeds = ROOT / "cfg" / "seeds" / "fixed.yaml"
    cases = [_args(config=str(path)),
             _args(config=str(path), seeds=str(seeds), env="e.yaml",
                   model="m.yaml", inspect="i.yaml"),
             _args(config=str(path), data="s.yaml"),
             _args(data="s.yaml", model="m.yaml")]
    for args in cases:
        actual = ttrain_cmd.load_config_parts(args)
        expected = jtrain_cmd.load_config_parts(args)
        assert [str(x) for x in actual] == [str(x) for x in expected]
    assert ttrain_cmd.load_config_parts(cases[0])[5] == tmp_path / "run"
    assert ttrain_cmd.load_config_parts(cases[3])[1] == ttrain_cmd.DEFAULT_ENV


def _train(tmp_path, *extra):
    # the default inspector: its image summary at step 0 reads the images
    # decoded on the host. One torch thread: the suite's parallel workers
    # would oversubscribe the cores
    with _one_thread():
        return tmain.main([
            "train", "-o", str(tmp_path / "runs"), "--limit-steps", "2",
            "--device", "cpu", *extra])


def test_rerun_from_config_json(tmp_path, monkeypatch):
    """A run's own ``config.json`` through ``-c ... --reproduce`` trains
    the same batches to the same losses, bit for bit, and keeps the
    environment (here its loader's workers and wire format)."""
    monkeypatch.delenv("RMD_WIRE_FORMAT", raising=False)
    data = tmp_path / "data"
    _write_tree(data)
    env = {"loader": {"num_workers": 2, "retries": 1}, "wire": "bf16",
           "jax": {"debug-nans": False, "deterministic": False}}
    (data / "env.yaml").write_text(json.dumps(env))
    strategy = json.loads((data / "strategy.yaml").read_text())
    del strategy["stages"][0]["loader"]
    (data / "strategy.yaml").write_text(json.dumps(strategy))

    first = _train(tmp_path, "-d", str(data / "strategy.yaml"), "-m",
                   str(data / "model.yaml"), "-e", str(data / "env.yaml"),
                   "-s", str(ROOT / "cfg" / "seeds" / "fixed.yaml"),
                   "--reproduce", "--suffix", "a")
    config = json.loads((first.path / "config.json").read_text())
    assert config["environment"] == jtrain_cmd.Environment.load(
        data / "env.yaml").get_config()
    assert first.data.num_workers == 2 and first.data.retries == 1
    assert first.wire.images == "bf16"

    again = _train(tmp_path, "-c", str(first.path / "config.json"),
                   "--reproduce", "--suffix", "b")
    assert again.data.num_workers == 2 and again.wire.images == "bf16"
    assert [h["loss"] for h in again.history] == \
        [h["loss"] for h in first.history]
    # bf16 images, f16 flow and a packed mask at 64x96: 16.125 B/px
    assert [h["wire_bytes"] for h in first.history] == [64 * 96 * 16.125] * 2

    # the wire format: the flag, then RMD_WIRE_FORMAT, then the env's
    monkeypatch.setenv("RMD_WIRE_FORMAT", "u8")
    from_env = _train(tmp_path, "-c", str(first.path / "config.json"),
                      "--reproduce", "--suffix", "c")
    flag = _train(tmp_path, "-c", str(first.path / "config.json"),
                  "--reproduce", "--suffix", "d", "--wire-format", "f32")
    assert from_env.wire.images == "u8" and flag.wire.images == "f32"
    assert [h["wire_bytes"] for h in from_env.history] == \
        [64 * 96 * 10.125] * 2
    assert [h["wire_bytes"] for h in flag.history] == [64 * 96 * 33] * 2


def test_loader_procs_sets_the_workers(tmp_path, monkeypatch):
    monkeypatch.setenv("RMD_LOADER_PROCS", "3")
    adapter = [None] * 4
    from raft_meets_dicl_tpu_torch.models.input import Loader

    assert Loader(adapter, num_workers=1).num_workers == 3
    assert Loader(adapter, num_workers=1, procs=0).num_workers == 1
    args = tmain.build_parser().parse_args(
        ["train", "-c", "c.json", "--loader-procs", "5"])
    assert args.loader_procs == 5 and args.config == "c.json"


@pytest.fixture
def deterministic():
    """The process-wide switches, as ``Environment.apply`` leaves them,
    restored after the test."""
    state = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    env = ttrain_cmd.Environment.load(ROOT / "cfg" / "env" /
                                      "deterministic.yaml")
    try:
        env.apply()
        yield env
    finally:
        torch.use_deterministic_algorithms(state[0])
        torch.backends.cudnn.deterministic = state[1]
        torch.backends.cudnn.benchmark = state[2]
        if state[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def test_deterministic_switches_and_atomic_kernels(deterministic):
    assert deterministic.deterministic
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    # the sampler's backward sums in a fixed order: it gets past the
    # switches to its argument checks (CUDA tensors only); the windowed
    # df2 kernel adds with atomics and refuses, by name, before it looks
    # at its arguments
    dout = torch.zeros((1, 9, 9, 2, 3, 4))
    coords = torch.zeros((1, 2, 3, 2))
    with pytest.raises(ValueError, match="take CUDA tensors"):
        sample._launch_bwd(dout, coords, (1, 5, 6, 4), 4)
    with pytest.raises(RuntimeError, match="df2 kernel"):
        windowed._launch_df2(None, None, None, None, 0, 1, 4)
