"""Data pipeline, host side: file I/O, file-pattern datasets and config
loading (counterpart of ``raft_meets_dicl_tpu/data``, the ``dataset``
source with the ``generic`` layout)."""

from . import collection, config, dataset, io, patterns
from .collection import Collection, Metadata, SampleArgs, SampleId
from .config import load
from .dataset import Dataset

__all__ = [
    "collection", "config", "dataset", "io", "patterns",
    "Collection", "Dataset", "Metadata", "SampleArgs", "SampleId", "load",
]
