from . import (adapters, blocks, carry, corr, encoders, grid, hsup, loss,
               norm, util)

__all__ = ["adapters", "blocks", "carry", "corr", "encoders", "grid", "hsup", "loss",
           "norm", "util"]
