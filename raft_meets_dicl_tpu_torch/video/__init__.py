"""The streaming-video engine (counterpart of
``raft_meets_dicl_tpu/video``): temporal warm start over frame sequences.

- ``warmstart`` — forward flow projection across frames (the twin of the
  projection inside ``evaluation.make_warm_fn``'s step);
- ``sequence`` — the sequence runner: a full-budget cold frame 0, then
  warm frames entering at the bottom ladder rung with the previous frame's
  carry, escalating by the ladder's delta policy; and the doubled-batch
  fw/bw helper;
- ``products`` — forwards-backwards consistency products (occlusion masks
  and confidence) from fetched flow pairs, host numpy;
- ``cache`` — the bounded, TTL-evicted per-client session store the serve
  scheduler keys warm-start state on.
"""

from . import products
from .cache import CarryMismatch, SessionCache
from .products import fw_bw_products, fw_bw_products_batch, warp_flow
from .sequence import (FrameResult, SequenceResult, SequenceRunner,
                       fw_bw_flows)
from .warmstart import project_flow

__all__ = [
    "CarryMismatch",
    "SessionCache",
    "fw_bw_products",
    "fw_bw_products_batch",
    "warp_flow",
    "FrameResult",
    "SequenceResult",
    "SequenceRunner",
    "fw_bw_flows",
    "project_flow",
    "products",
]
