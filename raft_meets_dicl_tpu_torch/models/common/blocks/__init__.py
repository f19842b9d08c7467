from . import raft

__all__ = ["raft"]
