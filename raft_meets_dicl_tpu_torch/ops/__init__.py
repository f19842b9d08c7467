"""Compute layer: plain-torch correlation/upsampling ops and the
hand-written CUDA kernels (``convex``, ``sample``) with their build/load
module (``cuda_build``)."""

from . import convex, corr, cuda_build, sample, upsample

__all__ = ["convex", "corr", "cuda_build", "sample", "upsample"]
