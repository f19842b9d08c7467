"""Bounded, TTL-evicted per-client video session state (counterpart of
``raft_meets_dicl_tpu/video/cache.py``).

A video stream served through the scheduler is a sticky session: the
client id that orders its responses also keys its warm-start state, the
previous frame's coarse flow carry as the serve path fetched it. The
cache is conservative:

- **bounded** (``RMD_VIDEO_SESSIONS``, least recently used past capacity),
  so many short-lived clients cannot grow host memory without limit;
- **TTL-evicted** (``RMD_VIDEO_SESSION_TTL_S``), so a stream that stalls
  longer than the TTL restarts cold: stale motion is worse than none;
- **shape-checked** on lookup, so a client that switches resolution
  restarts cold instead of feeding a mis-shaped carry to a warm step.

A miss of any kind returns None and the caller starts from zero flow,
which is bit for bit the plain rung: warm start is an optimization, never
a correctness hazard. JAX's ``rmd_serve_session_*`` metrics are the plain
counters ``hits``, ``misses``, ``evictions`` and ``active`` here; its
``session`` telemetry events are not ported (ROADMAP slice 7 item 7).
"""

import base64
import threading
import time
import zlib

import numpy as np

from ..utils import env


class CarryMismatch(ValueError):
    """An imported carry snapshot failed validation (shape, dtype, CRC):
    the receiving replica starts the session cold rather than feed a
    damaged or mis-shaped carry to a warm step."""


class SessionCache:
    """Client-keyed warm-start store: ``put(client, flow)`` after a frame
    completes, ``get(client, shape)`` before the next dispatch.

    ``flow`` is the coarse-grid carry the serve path fetched (host numpy);
    ``shape`` the expected carry shape, a mismatch being a miss.
    Thread-safe: the dispatch loop and callers touch it from different
    threads. ``clock`` is the monotonic clock TTLs are read on.
    """

    def __init__(self, capacity=None, ttl_s=None, clock=time.monotonic):
        self.capacity = int(capacity if capacity is not None
                            else env.get_int("RMD_VIDEO_SESSIONS"))
        self.ttl_s = float(ttl_s if ttl_s is not None
                           else env.get_float("RMD_VIDEO_SESSION_TTL_S"))
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {self.ttl_s}")
        self._clock = clock
        self._lock = threading.Lock()
        self._entries = {}  # client -> (flow, t_touch); dict order = LRU
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.active = 0

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def _expire_locked(self, now):
        dead = [c for c, (_, t) in self._entries.items()
                if now - t > self.ttl_s]
        for c in dead:
            del self._entries[c]
        return dead

    def get(self, client, shape=None):
        """The client's cached carry flow, or None (cold start).

        Expired entries are dropped on the way; a shape mismatch drops the
        entry too (the old resolution's carry is of no use now)."""
        now = self._clock()
        with self._lock:
            self.evictions += len(self._expire_locked(now))
            entry = self._entries.pop(client, None)
            if entry is not None and shape is not None \
                    and tuple(entry[0].shape) != tuple(shape):
                entry = None  # resolution switch: restart cold
            if entry is not None:
                # touch: re-insert at the most recently used end
                self._entries[client] = (entry[0], now)
            self.active = len(self._entries)
            if entry is None:
                self.misses += 1
                return None
            self.hits += 1
            return entry[0]

    def put(self, client, flow):
        """Store the just-completed frame's carry for the client."""
        now = self._clock()
        with self._lock:
            self.evictions += len(self._expire_locked(now))
            self._entries.pop(client, None)
            while len(self._entries) >= self.capacity:
                del self._entries[next(iter(self._entries))]
                self.evictions += 1
            self._entries[client] = (flow, now)
            self.active = len(self._entries)

    def drop(self, client):
        """End a session (stream closed); whether it was held."""
        with self._lock:
            had = self._entries.pop(client, None) is not None
            self.active = len(self._entries)
        return had

    def clients(self):
        """Live (unexpired) client ids, least to most recently used."""
        now = self._clock()
        with self._lock:
            self._expire_locked(now)
            return list(self._entries)

    # -- handoff snapshots ----------------------------------------------------

    def export_carry(self, client):
        """A JSON-safe snapshot of the client's carry (shape, dtype, CRC32
        and base64 payload), or None. The session is left as it is."""
        now = self._clock()
        with self._lock:
            self._expire_locked(now)
            entry = self._entries.get(client)
            if entry is None:
                return None
            flow = entry[0]
        flow = np.ascontiguousarray(flow)
        raw = flow.tobytes()
        return {
            "client": client,
            "shape": list(flow.shape),
            "dtype": str(flow.dtype),
            "crc": zlib.crc32(raw),
            "data": base64.b64encode(raw).decode("ascii"),
        }

    def import_carry(self, snapshot, client=None, shape=None):
        """Install an exported snapshot as ``client``'s carry.

        Validates the structure, the dtype, the byte length against the
        declared shape, the CRC and, when given, the expected carry
        ``shape``, raising :class:`CarryMismatch` on any failure. Returns
        the installed carry array."""
        if not isinstance(snapshot, dict):
            raise CarryMismatch(f"snapshot is not an object: "
                                f"{type(snapshot).__name__}")
        missing = {"shape", "dtype", "crc", "data"} - snapshot.keys()
        if missing:
            raise CarryMismatch(f"snapshot missing {sorted(missing)}")
        client = client or snapshot.get("client")
        if not client:
            raise CarryMismatch("snapshot names no client")
        try:
            dtype = np.dtype(snapshot["dtype"])
        except TypeError as e:
            raise CarryMismatch(f"bad dtype {snapshot['dtype']!r}: {e}") \
                from e
        try:
            raw = base64.b64decode(snapshot["data"], validate=True)
        except Exception as e:  # noqa: BLE001 - any decode failure is a mismatch
            raise CarryMismatch(f"payload decode failed: {e}") from e
        declared = tuple(int(d) for d in snapshot["shape"])
        if shape is not None and declared != tuple(shape):
            raise CarryMismatch(
                f"carry shape {declared} does not match the receiving "
                f"replica's expected {tuple(shape)}")
        expect_bytes = int(np.prod(declared)) * dtype.itemsize if declared \
            else dtype.itemsize
        if len(raw) != expect_bytes:
            raise CarryMismatch(
                f"payload is {len(raw)} bytes, shape {declared} "
                f"{dtype} needs {expect_bytes}")
        if zlib.crc32(raw) != int(snapshot["crc"]):
            raise CarryMismatch("payload CRC mismatch")
        flow = np.frombuffer(raw, dtype=dtype).reshape(declared).copy()
        self.put(client, flow)
        return flow
