"""Dataset combinators: concat, repeat, random subset and cache.

Counterpart of the JAX package's ``data/combinators.py``, an own copy of
it. Config-compatible with the reference combinators (src/data/concat.py,
repeat.py, subset.py) but implemented in one module — they are all thin
index-transformers over a source Collection.
"""

from dataclasses import replace

import numpy as np

from .collection import Collection


class Concat(Collection):
    type = "concat"

    @classmethod
    def from_config(cls, path, cfg):
        from . import config as data_config

        cls._typecheck(cfg)
        return cls([data_config.load(path, c) for c in cfg["sources"]])

    def __init__(self, sources):
        super().__init__()
        self.sources = sources

    def get_config(self):
        return {"type": self.type, "sources": [s.get_config() for s in self.sources]}

    def __getitem__(self, index):
        if index < 0:
            index += len(self)
        if not 0 <= index < len(self):
            raise IndexError("index out of range")
        for source in self.sources:
            if index < len(source):
                return source[index]
            index -= len(source)
        raise IndexError("index out of range")

    def __len__(self):
        return sum(len(s) for s in self.sources)

    def description(self):
        return f"[{', '.join(repr(s.description()) for s in self.sources)}]"


class Repeat(Collection):
    type = "repeat"

    @classmethod
    def from_config(cls, path, cfg):
        from . import config as data_config

        cls._typecheck(cfg)
        return cls(cfg["times"], data_config.load(path, cfg["source"]))

    def __init__(self, times, source):
        super().__init__()
        self.times = times
        self.source = source

    def get_config(self):
        return {
            "type": self.type,
            "times": self.times,
            "source": self.source.get_config(),
        }

    def __getitem__(self, index):
        if not 0 <= index < len(self):
            raise IndexError(
                f"index '{index}' is out of range for dataset of size '{len(self)}'"
            )
        return self.source[index % len(self.source)]

    def __len__(self):
        return self.times * len(self.source)

    def description(self):
        return f"{self.source.description()}, repeat times {self.times}"


class Cache(Collection):
    """In-memory memoization of decoded samples by index.

    Place it UNDER ``augment`` so randomized augmentations stay fresh per
    epoch: a hit returns the decoded (pre-augmentation) arrays, made
    read-only, with a fresh ``Metadata`` copy each time (the adapter flips
    ``meta.valid`` in place on bad batches, and a shared object would
    poison the sample for every later hit).

    ``budget-gib`` caps the resident size (default 16 GiB); beyond it,
    further samples pass through uncached (a warning is logged once).

    What it keeps lives in the process that decodes. Under the port's
    ``Loader`` with worker processes (``num_workers > 0``) each worker,
    forked anew at every epoch's ``__iter__``, fills its own copy and
    drops it when the epoch's workers exit: hits come only within one
    epoch and one worker (an index fetched twice there, as under
    ``repeat``), and every epoch decodes afresh. With ``num_workers: 0``
    the cache lives in the caller and is kept across epochs, as the JAX
    package's thread pool keeps its one cache.
    """

    type = "cache"

    @classmethod
    def from_config(cls, path, cfg):
        from . import config as data_config

        cls._typecheck(cfg)
        return cls(data_config.load(path, cfg["source"]),
                   budget_gib=cfg.get("budget-gib", 16.0))

    def __init__(self, source, budget_gib=16.0):
        super().__init__()
        self.source = source
        self.budget = int(budget_gib * 2 ** 30)
        self._cache = {}
        self._bytes = 0
        self._warned = False

    def get_config(self):
        return {
            "type": self.type,
            "budget-gib": self.budget / 2 ** 30,
            "source": self.source.get_config(),
        }

    def __getitem__(self, index):
        hit = self._cache.get(index)
        if hit is not None:
            return self._fresh_meta(hit)

        sample = self.source[index]
        img1, img2, flow, valid, meta = sample
        size = sum(a.nbytes for a in (img1, img2, flow, valid)
                   if a is not None)
        if self._bytes + size <= self.budget:
            for a in (img1, img2, flow, valid):
                # loud failure instead of silent cache corruption should
                # any consumer ever mutate a sample in place
                if a is not None and a.flags.owndata:
                    a.setflags(write=False)
            # store a pristine Metadata copy: the adapter flips
            # ``meta.valid`` in place on transiently-bad batches, and a
            # retained reference would poison this sample for every
            # later epoch
            self._cache[index] = self._fresh_meta(sample)
            self._bytes += size
        elif not self._warned:
            self._warned = True
            import logging

            logging.getLogger("data:cache").warning(
                f"sample cache budget ({self.budget / 2**30:.1f} GiB) "
                f"exhausted after {len(self._cache)} samples; further "
                f"samples stream uncached")
        return sample

    @staticmethod
    def _fresh_meta(sample):
        img1, img2, flow, valid, meta = sample
        return img1, img2, flow, valid, [replace(m) for m in meta]

    def __len__(self):
        return len(self.source)

    def description(self):
        return f"{self.source.description()}, cached"


class Subset(Collection):
    """Random subset with replacement, drawn once at construction.

    The draw comes from an own ``Generator``: an explicit config ``seed``
    pins the subset outright; without one the seed derives from the
    (run-seeded, utils.seeds) global numpy RNG — one draw, so the subset
    stays reproducible without coupling its contents to how many global
    draws other pipeline stages happened to consume first.
    """

    type = "subset"

    @classmethod
    def from_config(cls, path, cfg):
        from . import config as data_config

        cls._typecheck(cfg)
        return cls(cfg["size"], data_config.load(path, cfg["source"]),
                   seed=cfg.get("seed"))

    def __init__(self, size, source, seed=None):
        super().__init__()
        self.size = size
        self.source = source
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        self.seed = int(seed)
        # an empty source yields an empty subset (a not-yet-populated
        # dataset root must still spec-load)
        n = len(source)
        rng = np.random.default_rng(self.seed)
        self.map = (rng.integers(0, n, size=size) if n
                    else np.empty(0, np.int64))

    def __len__(self):
        return len(self.map)

    def get_config(self):
        return {
            "type": self.type,
            "size": self.size,
            "seed": self.seed,
            "source": self.source.get_config(),
        }

    def __getitem__(self, index):
        return self.source[self.map[index]]

    def description(self):
        return f"{self.source.description()}, subset {self.size}"
