"""Compute layer: plain-torch correlation/pooling/upsampling ops and the
hand-written CUDA kernels (``convex``, ``sample``, ``windowed``) with their
build/load module (``cuda_build``)."""

from . import convex, corr, cuda_build, pool, sample, upsample, windowed

__all__ = ["convex", "corr", "cuda_build", "pool", "sample", "upsample",
           "windowed"]
