"""Data-source config loading with file-relative path resolution.

Counterpart of ``raft_meets_dicl_tpu/data/config.py``. ``load`` accepts a
config-file path, a (path, cfg-dict) pair, or a (path, relative-config-file)
pair; nested ``source`` references inside configs resolve relative to the
file they appear in, which is what makes the ``cfg/`` graph composable.
Every source type of the JAX package is registered but ``synth``, which
renders on the device and raises.
"""

from pathlib import Path

from ..utils import config
from .augment import Augment
from .combinators import Cache, Concat, Repeat, Subset
from .dataset import Dataset
from .fw_bw import ForwardsBackwardsBatch, ForwardsBackwardsEstimate

_TYPES = {
    cls.type: cls
    for cls in (
        Dataset, Augment, Cache, Concat, Repeat, Subset,
        ForwardsBackwardsBatch, ForwardsBackwardsEstimate,
    )
}


def _dispatch(path, cfg):
    ty = cfg["type"]
    if ty == "synth":
        raise NotImplementedError(
            "data source type 'synth' is not ported yet (ROADMAP slice 7 "
            "entry 5, the on-device data engine)")
    if ty not in _TYPES:
        raise ValueError(f"unknown data collection type '{ty}'")
    return _TYPES[ty].from_config(path, cfg)


def load(path, cfg=None):
    path = Path(path)

    if cfg is None:  # path is a config file; resolve relative to it
        return _dispatch(path.parent, config.load(path))

    if not isinstance(cfg, dict):  # cfg is a file path relative to `path`
        return _dispatch((path / cfg).parent, config.load(path / cfg))

    return _dispatch(path, cfg)
