from . import blocks, encoders, grid, norm, util

__all__ = ["blocks", "encoders", "grid", "norm", "util"]
