"""Training strategy layer: specs and the training loop (counterpart of
``raft_meets_dicl_tpu/strategy``; checkpoints and the inspector are not
ported yet)."""

from . import config, spec, training
from .config import load, load_stage
from .spec import Stage, Strategy
from .training import TrainingContext

__all__ = [
    "config", "spec", "training",
    "Stage", "Strategy", "TrainingContext", "load", "load_stage",
]
