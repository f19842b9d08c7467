"""Utility modules."""

from . import config, expr, seeds

__all__ = ["config", "expr", "seeds"]
