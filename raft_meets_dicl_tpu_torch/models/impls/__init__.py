"""Model zoo. Importing this package registers all model/loss types.

Ported so far: ``raft/baseline``, ``raft/fs`` and the ``raft+dicl``
coarse-to-fine family (``ctf-l2``, ``ctf-l3``, ``ctf-l4``) with the
multi-level sequence losses (ROADMAP queue A).
"""

from . import raft, raft_dicl_ctf, raft_fs
from ..common.loss import mlseq  # noqa: F401  (registers raft+dicl/mlseq)

__all__ = ["raft", "raft_dicl_ctf", "raft_fs"]
