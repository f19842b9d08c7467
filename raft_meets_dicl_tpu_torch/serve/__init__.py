"""Flow-as-a-service: the online inference path (counterpart of the JAX
``serve`` package, plain path).

- :mod:`.batcher` — request/result types, typed rejection/error classes,
  per-bucket coalescing with deterministic batch selection (numpy-only);
- :mod:`.scheduler` — admission, the dispatch loop, sticky per-client
  response ordering, per-request latency spans, video sessions' carries
  and fw/bw products;
- :mod:`.session` — the model replica on its device, its warm-up, the
  iteration ladder's rung steps and the video warm-start step;
- :mod:`.ladder` — the iteration ladder's latency classes (``fast``,
  ``balanced``, ``quality``) over recurrence budgets (host policy only);
- :mod:`.loadgen` — the open-loop synthetic load generator behind the
  ``serve`` command's built-in client.

Telemetry, SLO tracking and traces (ROADMAP slice 7 item 7), the
observability plane and the fleet (slice 7 item 4) and multi-device
serving (``mesh``, slice 7 item 6) come with later slices.
"""

from . import batcher, ladder, loadgen, scheduler, session
from .batcher import (BucketBatcher, FlowRequest, FlowResult, ServeError,
                      ServeRejected)
from .ladder import CLASSES, LadderSpec
from .scheduler import Scheduler, Ticket
from .session import ServeSession

__all__ = [
    "batcher", "ladder", "loadgen", "scheduler", "session",
    "BucketBatcher", "CLASSES", "FlowRequest", "FlowResult", "LadderSpec",
    "ServeError", "ServeRejected", "Scheduler", "Ticket", "ServeSession",
]
