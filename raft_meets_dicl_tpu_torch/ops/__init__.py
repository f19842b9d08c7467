"""Compute layer: plain-torch correlation/upsampling ops and the
hand-written CUDA kernels (``convex``) with their build/load module
(``cuda_build``)."""

from . import convex, corr, cuda_build, upsample

__all__ = ["convex", "corr", "cuda_build", "upsample"]
