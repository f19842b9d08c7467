"""RNG seed management (counterpart of ``raft_meets_dicl_tpu/utils/seeds.py``).

``apply()`` seeds python ``random``, numpy and torch (every device) and
returns a CPU ``torch.Generator`` seeded the same way, which model init
draws from. Seed files load unchanged: the JAX package's ``jax`` key and
the reference's ``torch`` key both name the torch seed.
"""

import random
import secrets

import numpy as np
import torch


class Seeds:
    @classmethod
    def new_random(cls):
        return cls(
            python=secrets.randbits(32),
            numpy=secrets.randbits(32),
            torch=secrets.randbits(32),
        )

    @classmethod
    def from_config(cls, cfg):
        cfg = cfg or {}
        return cls(
            python=cfg.get("python", 0),
            numpy=cfg.get("numpy", 0),
            torch=cfg.get("torch", cfg.get("jax", 0)),
        )

    def __init__(self, python, numpy, torch):
        self.python = int(python)
        self.numpy = int(numpy)
        self.torch = int(torch)

    def get_config(self):
        return {"python": self.python, "numpy": self.numpy, "torch": self.torch}

    def apply(self):
        """Seed the host RNGs and torch; returns the root generator."""
        random.seed(self.python)
        np.random.seed(self.numpy % (2**32))
        torch.manual_seed(self.torch)
        return torch.Generator().manual_seed(self.torch)


def random_seeds():
    return Seeds.new_random()


def from_config(cfg):
    return Seeds.from_config(cfg)
