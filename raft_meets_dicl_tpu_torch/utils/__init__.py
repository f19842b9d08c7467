"""Utility modules."""

from . import config

__all__ = ["config"]
