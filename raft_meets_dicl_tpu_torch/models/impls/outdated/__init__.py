"""Kept experiments (counterpart of the JAX ``impls/outdated``):
``raft/cl``, ``raft+dicl/sl-ca``, ``wip/warp/1`` and ``wip/warp/2``, with
their losses. Importing this package registers them."""

from . import raft_cl, raft_dicl_sl_ca, wip_recwarp, wip_warp

__all__ = ["raft_cl", "raft_dicl_sl_ca", "wip_recwarp", "wip_warp"]
