"""Model zoo. Importing this package registers all model/loss types.

Only ``raft/baseline`` is ported so far (ROADMAP queue A).
"""

from . import raft

__all__ = ["raft"]
