"""Utility modules."""

from . import config, env, expr, msgpack, seeds

__all__ = ["config", "env", "expr", "msgpack", "seeds"]
