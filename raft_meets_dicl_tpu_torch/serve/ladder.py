"""Iteration-ladder policy: latency classes over recurrence budgets.

Copy of ``raft_meets_dicl_tpu/serve/ladder.py`` (the port imports nothing
of the JAX package). The recurrent models spend most of their serving
latency in the GRU update loop, and the loop's iteration count is a pure
quality/latency dial (the paper's 12 is the quality end). The ladder
makes that dial a first-class serving concept: every rung is a
fixed-``iterations`` inference step (``evaluation.make_rung_fn``), rungs
chain bit-exactly through the ``(flow, hidden)`` carry the models return,
and the host reads a cheap per-sample convergence norm (``delta``)
*between* programs to decide whether the next rung is worth its latency.

Three latency classes map onto ladder policies:

- ``fast`` — the base rung only (``rungs[0]`` iterations): minimum
  latency, no escalation;
- ``balanced`` — start at the base rung, escalate through continuation
  rungs while the batch's worst convergence norm still exceeds
  ``threshold``: adaptive latency, quality close to the full budget;
- ``quality`` — the monolithic full-budget program (``rungs[-1]``
  iterations): the paper's setting, one program, no host round-trips.

This module is host-side policy only (no torch); the device half lives
in :meth:`~.session.ServeSession.run_ladder`.
"""

from dataclasses import dataclass
from typing import Tuple

from ..utils import env

CLASSES = ("fast", "balanced", "quality")


@dataclass(frozen=True)
class LadderSpec:
    """One ladder: ascending iteration budgets plus the escalation
    threshold on the per-sample flow-delta norm (coarse-grid px)."""

    rungs: Tuple[int, ...] = (4, 8, 12)
    threshold: float = 0.1

    def __post_init__(self):
        if len(self.rungs) < 2:
            raise ValueError(
                f"a ladder needs at least two rungs, got {self.rungs!r}")
        if any(r <= 0 for r in self.rungs):
            raise ValueError(f"rung budgets must be positive: {self.rungs!r}")
        if list(self.rungs) != sorted(set(self.rungs)):
            raise ValueError(
                f"rung budgets must be strictly ascending: {self.rungs!r}")
        if self.threshold <= 0:
            raise ValueError(
                f"escalation threshold must be positive: {self.threshold!r}")

    @classmethod
    def from_config(cls, spec=None, threshold=None):
        """Parse ``'4,8,12'`` (default: the ``RMD_LADDER`` knob); the
        threshold defaults to ``RMD_LADDER_THRESHOLD``."""
        if spec is None or spec is True:
            spec = env.get_str("RMD_LADDER")
        if isinstance(spec, str):
            rungs = tuple(int(p) for p in spec.replace(" ", "").split(",")
                          if p)
        else:
            rungs = tuple(int(r) for r in spec)
        if threshold is None:
            threshold = env.get_float("RMD_LADDER_THRESHOLD")
        return cls(rungs=rungs, threshold=float(threshold))

    def increments(self):
        """Continuation budgets between consecutive rungs."""
        return tuple(b - a for a, b in zip(self.rungs, self.rungs[1:]))

    def programs(self):
        """Every ``(iterations, cont)`` program this ladder executes:
        the base rung, the monolithic full budget, and one continuation
        program per *distinct* increment — one program per rung, however
        many fill levels or classes ride it."""
        out = [(self.rungs[0], False), (self.rungs[-1], False)]
        for inc in sorted(set(self.increments())):
            out.append((inc, True))
        return out

    def describe(self):
        return (f"rungs {','.join(str(r) for r in self.rungs)} "
                f"threshold {self.threshold:g}")
