"""Observability: TensorBoard summaries, validation and the checkpoints it
creates (counterpart of ``raft_meets_dicl_tpu/inspect``)."""

from . import config, summary, writer
from .config import load
from .summary import InspectorSpec, SummaryInspector
from .writer import SummaryWriter

__all__ = ["config", "summary", "writer", "load", "InspectorSpec",
           "SummaryInspector", "SummaryWriter"]
