"""Training strategy layer: specs, the training loop, checkpoints and the
inspector protocol (counterpart of ``raft_meets_dicl_tpu/strategy``)."""

from . import checkpoint, config, inspector, spec, training
from .checkpoint import (
    Checkpoint, CheckpointCorrupt, CheckpointManager, find_auto_resume,
)
from .config import load, load_stage
from .inspector import Inspector
from .spec import Stage, Strategy
from .training import TrainingContext

__all__ = [
    "checkpoint", "config", "inspector", "spec", "training",
    "Checkpoint", "CheckpointCorrupt", "CheckpointManager", "Inspector",
    "Stage", "Strategy", "TrainingContext", "find_auto_resume", "load",
    "load_stage",
]
