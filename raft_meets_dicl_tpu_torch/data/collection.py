"""Collection protocol: the dataset-pipeline building block.

A Collection yields *pre-batched* numpy samples
``(img1[B,H,W,3], img2[B,H,W,3], flow[B,H,W,2], valid[B,H,W], meta: list)``
— most sources have B=1, but pairing sources (forwards-backwards-batch)
return B=2, and the loader concatenates sample batches into the global batch.
Matches the reference protocol (src/data/collection.py:1-22).

Everything here is host-side numpy; conversion to torch tensors happens in
the model-input loader, nowhere else. (An own copy of the JAX package's
``data/collection.py``.)
"""

from dataclasses import dataclass, field
from typing import Dict, List, Tuple, Union


class Collection:
    """Abstract indexed sample source, constructible from config."""

    type = None

    @classmethod
    def _typecheck(cls, cfg):
        if cfg["type"] != cls.type:
            raise ValueError(
                f"invalid data collection type '{cfg['type']}', expected '{cls.type}'"
            )

    def get_config(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def description(self):
        raise NotImplementedError

    def set_epoch(self, epoch):
        """Advance epoch-dependent state (seeded augmentation draws).

        Recurses through the wrapper graph via the conventional
        ``source``/``sources`` attributes; the trainer calls this before
        iterating each epoch, *before* the loader forks its worker
        processes, so every worker inherits the value.
        """
        for attr in ("source", "sources"):
            val = getattr(self, attr, None)
            if val is None:
                continue
            for child in val if isinstance(val, (list, tuple)) else (val,):
                if isinstance(child, Collection):
                    child.set_epoch(epoch)


@dataclass
class SampleArgs:
    """Format arguments identifying one image of a sample."""

    args: List[Union[str, int]] = field(default_factory=list)
    kwargs: Dict[str, Union[str, int]] = field(default_factory=dict)


@dataclass
class SampleId:
    """Human-readable sample key: a format string plus per-image arguments."""

    format: str
    img1: SampleArgs
    img2: SampleArgs

    def __str__(self):
        return self.format.format(*self.img1.args, **self.img1.kwargs)


@dataclass
class Metadata:
    """Per-sample metadata carried through the pipeline.

    ``valid`` is flipped to False by the input adapter when a batch fails
    validation (non-finite data); the trainer skips such batches.
    ``original_extents`` tracks the un-padded region ((y0,y1),(x0,x1)) so
    outputs can be cropped back after modulo padding.
    """

    valid: bool
    dataset_id: str
    sample_id: SampleId
    original_extents: Tuple[Tuple[int, int], Tuple[int, int]]
