"""Data-source config loading with file-relative path resolution.

Counterpart of ``raft_meets_dicl_tpu/data/config.py``. ``load`` accepts a
config-file path, a (path, cfg-dict) pair, or a (path, relative-config-file)
pair; nested ``source`` references inside configs resolve relative to the
file they appear in. Only the ``dataset`` source type is ported; the
wrapper types of the JAX package raise.
"""

from pathlib import Path

from ..utils import config
from .dataset import Dataset

_TYPES = {Dataset.type: Dataset}

_LATER = ("augment", "concat", "cache", "repeat", "subset",
          "forwards-backwards-batch", "forwards-backwards-estimate", "synth")


def _dispatch(path, cfg):
    ty = cfg["type"]
    if ty in _LATER:
        raise NotImplementedError(
            f"data source type '{ty}' is not ported yet (ROADMAP slice 2 "
            "item 4, host augmentation and data combinators)")
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
