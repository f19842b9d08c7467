"""Data pipeline, host side: file I/O, file-pattern datasets, augmentation,
combinators, forwards/backwards pairing and config loading (counterpart of
``raft_meets_dicl_tpu/data``; everything here is numpy/cv2/scipy, and the
conversion to torch tensors happens in the model-input loader)."""

from . import augment, collection, combinators, config, dataset, fw_bw, io, patterns
from .collection import Collection, Metadata, SampleArgs, SampleId
from .config import load
from .dataset import Dataset
from .fw_bw import estimate_backwards_flow, estimate_backwards_flow_sparse

__all__ = [
    "augment", "collection", "combinators", "config", "dataset", "fw_bw",
    "io", "patterns", "Collection", "Dataset", "Metadata", "SampleArgs",
    "SampleId", "load", "estimate_backwards_flow",
    "estimate_backwards_flow_sparse",
]
