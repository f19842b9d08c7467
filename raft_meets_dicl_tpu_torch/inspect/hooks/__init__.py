"""Inspector hooks (counterpart of ``raft_meets_dicl_tpu/inspect/hooks``)."""

from . import activation, anomaly, common
from .common import Handle, Hook, capture_activations

__all__ = ["activation", "anomaly", "common", "Handle", "Hook",
           "capture_activations"]
