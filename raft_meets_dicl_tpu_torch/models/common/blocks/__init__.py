from . import dicl, raft

__all__ = ["dicl", "raft"]
