"""Compute layer: plain-torch correlation/pooling/upsampling ops, the
quantized matching tier (``quant``) and the hand-written CUDA kernels
(``convex``, ``sample``, ``windowed``, ``lookup``) with their build/load
module (``cuda_build``), and backwards warping (``warp``, plain torch)."""

from . import (convex, corr, cuda_build, lookup, pool, quant, sample,
               upsample, warp, windowed)

__all__ = ["convex", "corr", "cuda_build", "lookup", "pool", "quant",
           "sample", "upsample", "warp", "windowed"]
