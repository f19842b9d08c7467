"""PyTorch port: the shipped config corpus loads in the port as in the JAX
package, over ``tests/test_cfg_corpus.py``'s tree of stub dataset roots.

- every data source config under ``cfg/data`` loads in both packages to
  the same ``get_config()`` and ``description()``;
- every strategy and stage config under ``cfg/strategy`` loads in both
  packages to the same config, and each of its stages builds in the port
  (optimizer with clip, schedulers, scaler, the loader from the stage's
  ``loader`` arguments), except the strategies listed in ``WAITING`` with
  the ROADMAP item each waits on, whose build the port refuses naming it.
"""

import json

import numpy as np
import pytest
import torch

from raft_meets_dicl_tpu import data as jdata
from raft_meets_dicl_tpu import strategy as jstrategy
from raft_meets_dicl_tpu_torch import data as tdata
from raft_meets_dicl_tpu_torch import strategy as tstrategy
from raft_meets_dicl_tpu_torch.models import input as tinput
from test_cfg_corpus import CFG, _all, _retarget, cfg_tree  # noqa: F401

pytestmark = pytest.mark.torch_port

# strategy configs the port loads but cannot build yet, by the ROADMAP
# item each waits on
WAITING = {}


def _norm(cfg):
    return json.loads(json.dumps(cfg))


def _name(path):
    return str(path.relative_to(CFG / "strategy"))


DATA = _all("data", exclude=("data/dataset", "data/splits"))


def test_corpus_sizes():
    assert len(DATA) == 78
    assert not [p for p in DATA if "synth" in p.read_text()]
    assert set(WAITING) <= {_name(p) for p in _all("strategy")}


def _load_source(module, path):
    # a subset without a seed draws one from the global numpy RNG
    np.random.seed(0)
    return module.load(path)


@pytest.mark.parametrize("path", DATA, ids=lambda p: p.stem)
def test_data_source_configs_match_jax(path, cfg_tree):
    path = _retarget(cfg_tree, path)
    actual, expected = _load_source(tdata, path), _load_source(jdata, path)
    assert type(actual).__name__ == type(expected).__name__
    assert _norm(actual.get_config()) == _norm(expected.get_config())
    assert actual.description() == expected.description()
    assert len(actual) == len(expected)


def _load(module, path):
    np.random.seed(0)  # as _load_source
    if "stages:" in path.read_text():
        return module.load(path).stages
    return [module.config.load_stage(path)]


def _build(stage):
    """What the trainer builds from a stage before its first step."""
    param = torch.nn.Parameter(torch.zeros(3))
    _, base_lr = stage.optimizer.build([param], stage.gradient)
    stage.scheduler.build(base_lr, {"n_samples": 12, "n_batches": 4,
                                    "n_epochs": stage.data.epochs,
                                    "n_accum": stage.gradient.accumulate,
                                    "batch_size": stage.data.batch_size})
    stage.gradient.scaler.build()
    tinput.InputSpec().apply(stage.data.source).torch().loader(
        batch_size=stage.data.batch_size, shuffle=stage.data.shuffle,
        drop_last=stage.data.drop_last, **stage.loader_args)


@pytest.mark.parametrize("path", _all("strategy"), ids=_name)
def test_strategy_configs_match_jax(path, cfg_tree):
    name = _name(path)
    path = _retarget(cfg_tree, path)
    actual, expected = _load(tstrategy, path), _load(jstrategy, path)
    assert [_norm(s.get_config()) for s in actual] == \
        [_norm(s.get_config()) for s in expected]

    if name in WAITING:
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP {WAITING[name]}"):
            for stage in actual:
                _build(stage)
    else:
        for stage in actual:
            _build(stage)
