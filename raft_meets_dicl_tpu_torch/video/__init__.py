"""Video helpers (counterpart of ``raft_meets_dicl_tpu/video``): for now
only the forwards-backwards consistency products (``products``) that
``main evaluate --fwbw`` writes; the streaming engine comes with ROADMAP
slice 7."""

from . import products
from .products import fw_bw_products, fw_bw_products_batch, warp_flow

__all__ = ["products", "fw_bw_products", "fw_bw_products_batch",
           "warp_flow"]
