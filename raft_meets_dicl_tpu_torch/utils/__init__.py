"""Utility modules."""

from . import config, env, expr, seeds

__all__ = ["config", "env", "expr", "seeds"]
