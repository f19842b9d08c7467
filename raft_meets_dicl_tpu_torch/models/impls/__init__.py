"""Model zoo. Importing this package registers all model/loss types: every
type the JAX package registers.

``raft/baseline``, ``raft/sl``, ``raft/fs``, the ``raft/sl-ctf`` and
``raft+dicl`` coarse-to-fine families (``ctf-l2``, ``ctf-l3``, ``ctf-l4``)
with the multi-level sequence losses, ``raft+dicl/ml``, ``raft+dicl/sl``,
``dicl/baseline`` / ``dicl/64to8`` with the ``dicl/multiscale`` loss, and
the kept experiments in ``outdated``.
"""

from . import (dicl, outdated, raft, raft_dicl_ctf, raft_dicl_ml,
               raft_dicl_sl, raft_fs, raft_sl, raft_sl_ctf)
from ..common.loss import mlseq  # noqa: F401  (registers raft+dicl/mlseq)

__all__ = ["dicl", "outdated", "raft", "raft_dicl_ctf", "raft_dicl_ml",
           "raft_dicl_sl", "raft_fs", "raft_sl", "raft_sl_ctf"]
