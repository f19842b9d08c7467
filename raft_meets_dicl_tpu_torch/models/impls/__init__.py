"""Model zoo. Importing this package registers all model/loss types.

Ported so far: ``raft/baseline``, ``raft/fs``, the ``raft+dicl``
coarse-to-fine family (``ctf-l2``, ``ctf-l3``, ``ctf-l4``) with the
multi-level sequence losses, ``raft+dicl/ml``, ``raft+dicl/sl``, and
``dicl/baseline`` / ``dicl/64to8`` with the ``dicl/multiscale`` loss
(ROADMAP queue A).
"""

from . import dicl, raft, raft_dicl_ctf, raft_dicl_ml, raft_dicl_sl, raft_fs
from ..common.loss import mlseq  # noqa: F401  (registers raft+dicl/mlseq)

__all__ = ["dicl", "raft", "raft_dicl_ctf", "raft_dicl_ml", "raft_dicl_sl",
           "raft_fs"]
