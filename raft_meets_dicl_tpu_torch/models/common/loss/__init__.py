from . import mlseq

__all__ = ["mlseq"]
