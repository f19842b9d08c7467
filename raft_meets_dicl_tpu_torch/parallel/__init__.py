"""Training step (counterpart of ``raft_meets_dicl_tpu/parallel``; the
single-device path — meshes come with DDP, ROADMAP slice 2 item 10)."""

from . import train
from .train import TrainState, make_train_step

__all__ = ["train", "TrainState", "make_train_step"]
