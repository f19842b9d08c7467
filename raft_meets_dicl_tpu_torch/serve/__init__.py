"""Flow-as-a-service: the online inference path (counterpart of the JAX
``serve`` package, plain path).

- :mod:`.batcher` — request/result types, typed rejection/error classes,
  per-bucket coalescing with deterministic batch selection (numpy-only);
- :mod:`.scheduler` — admission, the dispatch loop, sticky per-client
  response ordering, per-request latency spans;
- :mod:`.session` — the model replica on its device and its warm-up;
- :mod:`.loadgen` — the open-loop synthetic load generator behind the
  ``serve`` command's built-in client.

Ladder, video sessions, the quantized tier, wire formats, telemetry and
the fleet come with later slices (ROADMAP queue A).
"""

from . import batcher, loadgen, scheduler, session
from .batcher import (BucketBatcher, FlowRequest, FlowResult, ServeError,
                      ServeRejected)
from .scheduler import Scheduler, Ticket
from .session import ServeSession

__all__ = [
    "batcher", "loadgen", "scheduler", "session",
    "BucketBatcher", "FlowRequest", "FlowResult", "ServeError",
    "ServeRejected", "Scheduler", "Ticket", "ServeSession",
]
