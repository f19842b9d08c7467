"""Test support: fault injection (counterpart of
``raft_meets_dicl_tpu/testing``)."""

from . import faults

__all__ = ["faults"]
