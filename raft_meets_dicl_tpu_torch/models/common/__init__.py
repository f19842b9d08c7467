from . import adapters, blocks, corr, encoders, grid, hsup, loss, norm, util

__all__ = ["adapters", "blocks", "corr", "encoders", "grid", "hsup", "loss",
           "norm", "util"]
