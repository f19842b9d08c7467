"""Continuous-batching request scheduler for the serving path.

Counterpart of ``raft_meets_dicl_tpu/serve/scheduler.py`` (the plain
dispatch branch). One dispatch thread pulls batches from the
:class:`BucketBatcher` and runs them through a
:class:`~.session.ServeSession`; callers submit image pairs from any
thread and block on the returned :class:`Ticket`. The invariants:

- **The dispatch loop never stalls.** Overload sheds at admission with a
  typed :class:`ServeRejected` (bounded per-bucket queues). A batch whose
  dispatch raises completes each of its tickets with a typed
  :class:`ServeError` (``internal``) that carries the original exception
  as its cause; the failure is logged with its traceback and counted in
  :attr:`Scheduler.errors`, and the loop carries on.
- **Sticky per-client ordering.** Responses release to each client in
  submission order.
- **Latency classes.** With a session that serves an iteration ladder a
  request names its class (``ladder.CLASSES``, ``balanced`` when unset);
  lanes coalesce same-class requests only, and a batch runs its class's
  ladder policy (``ServeSession.run_ladder``).
- **Video sessions.** With ``ServeSession(video=True)`` a client id is
  also a sticky video session: ``submit(..., sequence=True)`` requests
  ride lanes of their own onto the warm-start step, seeded per member
  from the bounded, TTL-evicted :class:`~..video.SessionCache` (the
  previous frame's coarse carry, keyed by client). A member without a
  usable carry gets a zero row, bit for bit the plain cold rung, so
  eviction and resolution switches degrade, never corrupt.
  ``submit(..., products=True)`` also runs the batch's reversed pairs
  through the same step and attaches fw/bw occlusion masks and confidence
  to the result.

Each dispatched batch appends a record to :attr:`Scheduler.batch_log`
(bucket, size, fill, class, rungs, iterations and, for video batches,
``warm_members`` and ``products``): the fields of JAX's ``serve`` batch
event. Telemetry, SLO tracking and traces (ROADMAP slice 7 item 7), fault
injection's serve directives and the fleet's pre-encoded submissions
(slice 7 item 4) come with later slices.
"""

import logging
import threading
import time

import numpy as np

from ..video.cache import SessionCache
from ..video.products import fw_bw_products
from . import ladder as ladder_mod
from .batcher import (BucketBatcher, FlowRequest, FlowResult, ServeError,
                      ServeRejected)

# the dispatch loop wakes at least this often even when idle
_IDLE_WAKE_S = 1.0

DEFAULT_MAX_WAIT_MS = 50.0
DEFAULT_QUEUE_LIMIT = 64


class Ticket:
    """Caller handle for one admitted request: blocks on :meth:`result`
    until the scheduler releases the response (in per-client submission
    order)."""

    def __init__(self, rid, client):
        self.rid = rid
        self.client = client
        self._event = threading.Event()
        self._result = None
        self._error = None

    def _complete(self, result=None, error=None):
        self._result = result
        self._error = error
        self._event.set()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """The :class:`FlowResult`, or raises the request's typed
        :class:`ServeError`; ``TimeoutError`` if nothing arrives in
        ``timeout`` seconds."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} still in flight "
                               f"after {timeout} s")
        if self._error is not None:
            raise self._error
        return self._result


class Scheduler:
    """Admission control + dispatch loop over one serve session.

    ``batches`` counts dispatched device batches (``batches_by_bucket``
    per ``"HxW"`` bucket, ``batch_log`` one record each) and ``errors`` the
    requests that failed in dispatch. A video session's scheduler keeps
    its clients' carries in ``sessions`` (a ``video.SessionCache``).
    """

    def __init__(self, session, batch_size=None,
                 max_wait_ms=DEFAULT_MAX_WAIT_MS,
                 queue_limit=DEFAULT_QUEUE_LIMIT):
        if batch_size is None:
            batch_size = session.batch_size
        self.session = session
        self.batcher = BucketBatcher(session.buckets, batch_size, queue_limit)
        self.max_wait_s = float(max_wait_ms) / 1e3

        self.batches = 0
        self.batches_by_bucket = {}
        self.batch_log = []
        self.errors = 0

        # video sessions: per-client warm-start carry, bounded + TTL
        self.sessions = None
        self._carry_factor = None  # (fy, fx) image-to-coarse-grid ratio
        if getattr(session, "video", False):
            self.sessions = SessionCache()

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._rid = 0
        self._seq = {}            # client -> next sequence number to assign
        self._release_next = {}   # client -> next sequence number to release
        self._held = {}           # client -> {seq: (request, result, error)}
        self._stopping = False
        self._thread = None

    # -- admission (caller threads) -----------------------------------------

    def submit(self, img1, img2, client="default", klass=None,
               sequence=False, products=False):
        """Admit one raw (un-normalized f32 HWC) image pair.

        ``klass`` picks the latency class (``ladder.CLASSES``) when the
        session serves an iteration ladder, ``balanced`` by default;
        requests only batch with same-class neighbours. Without a ladder
        the class must stay unset.

        ``sequence=True`` marks a video frame: the request is warm-started
        from the client's cached carry and routed to the fast rung
        (``klass`` is ignored); it needs a video session.
        ``products=True`` also returns fw/bw occlusion and confidence.

        Returns a :class:`Ticket` on acceptance. Raises synchronously:
        :class:`ServeError` (``malformed``/``oversized``/
        ``unknown_class``/``no_video``) when the payload can never be
        served, :class:`ServeRejected` (``queue_full``/``shutdown``) when
        the system sheds it.
        """
        t0 = time.perf_counter()
        with self._lock:
            rid = self._rid
            self._rid += 1

        if sequence:
            if self.sessions is None:
                raise ServeError(
                    "no_video",
                    "sequence requests need a video session "
                    "(serve --video)")
            # warm-start frames always enter at the fast rung, on lanes of
            # their own per bucket
            klass = ("fast" if getattr(self.session, "ladder", None)
                     is not None else "")
        else:
            klass = self._validate_klass(klass)
        self._validate(img1, img2)
        h, w = int(img1.shape[0]), int(img1.shape[1])
        bucket = self.batcher.assign(h, w)
        if bucket is None:
            raise ServeError(
                "oversized",
                f"{h}x{w} fits no bucket ({self.session.buckets.describe()})")

        e1, e2 = self.batcher.encode_pair(img1, img2, bucket,
                                          self.session.encode_image)
        ticket = Ticket(rid, client)
        req = FlowRequest(rid=rid, client=client, seq=0, bucket=bucket,
                          shape=(h, w), img1=e1, img2=e2, ticket=ticket,
                          t_submit=t0, klass=klass, sequence=bool(sequence),
                          products=bool(products))

        with self._cond:
            if self._stopping:
                raise ServeRejected("shutdown")
            req.spans["admission"] = time.perf_counter() - t0
            if not self.batcher.offer(req):
                raise ServeRejected(
                    "queue_full",
                    f"bucket {bucket[0]}x{bucket[1]} queue at bound "
                    f"({self.batcher.queue_limit})")
            req.seq = self._seq.get(client, 0)
            self._seq[client] = req.seq + 1
            self._cond.notify()
        return ticket

    def _validate_klass(self, klass):
        has_ladder = getattr(self.session, "ladder", None) is not None
        if klass is None:
            return "balanced" if has_ladder else ""
        if not has_ladder:
            raise ServeError(
                "unknown_class",
                f"latency class {klass!r} needs a session with an "
                f"iteration ladder (serve --ladder)")
        if klass not in ladder_mod.CLASSES:
            raise ServeError(
                "unknown_class",
                f"{klass!r} is not one of {'/'.join(ladder_mod.CLASSES)}")
        return klass

    def _validate(self, img1, img2):
        for img in (img1, img2):
            if not isinstance(img, np.ndarray) or img.ndim != 3 \
                    or img.shape[-1] != 3:
                raise ServeError(
                    "malformed",
                    f"expected HWC RGB arrays, got "
                    f"{getattr(img, 'shape', type(img).__name__)}")
        if img1.shape != img2.shape:
            raise ServeError(
                "malformed", f"pair shapes differ: {img1.shape} vs "
                             f"{img2.shape}")

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="serve-dispatch", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain=True):
        """Stop admitting; by default drain queued requests (partials
        dispatch immediately), otherwise fail them with a typed error."""
        flushed = []
        with self._cond:
            self._stopping = True
            if not drain:
                while True:
                    bucket, batch = self.batcher.take(
                        time.perf_counter(), 0.0, drain=True)
                    if bucket is None:
                        break
                    flushed.extend(batch)
            self._cond.notify_all()
        for r in flushed:
            self._complete(r, error=ServeError("internal", "shutdown"))
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- dispatch loop -------------------------------------------------------

    def _loop(self):
        while True:
            with self._cond:
                while True:
                    now = time.perf_counter()
                    bucket, batch = self.batcher.take(
                        now, self.max_wait_s, drain=self._stopping)
                    if bucket is not None:
                        break
                    if self._stopping:
                        return
                    deadline = batch  # (None, deadline) overload of take()
                    timeout = (_IDLE_WAKE_S if deadline is None
                               else min(_IDLE_WAKE_S, max(0.0, deadline - now)))
                    self._cond.wait(timeout)
            try:
                self._dispatch(bucket, batch)
            except Exception as e:  # noqa: BLE001 - the loop must survive
                logging.exception(f"serve: dispatch of a {len(batch)}-request "
                                  f"batch at {bucket[0]}x{bucket[1]} failed")
                for r in batch:
                    err = ServeError("internal", f"{type(e).__name__}: {e}")
                    err.__cause__ = e
                    self._complete(r, error=err)

    def _dispatch(self, bucket, batch):
        t0 = time.perf_counter()
        for r in batch:
            r.spans["queue"] = t0 - r.t_enqueue

        img1, img2, fill = self.batcher.assemble(batch)
        klass = batch[0].klass  # lanes are same-class by construction
        sequence = batch[0].sequence  # and same-sequence-ness
        warm_rows = [None] * len(batch)
        state = None
        if sequence:
            carry, warm_rows = self._gather_carry(batch, bucket, fill)
            flow, state, info = self.session.run_video(img1, img2, carry)
        elif klass:
            flow, info = self.session.run_ladder(img1, img2, klass)
        else:
            flow, info = self.session.run(img1, img2), None
        products = any(r.products for r in batch)
        if products:
            # the reversed pairs ride the same step (same shapes); video
            # batches reverse cold, a carry has no meaning backwards
            if sequence:
                bw_dev, _, _ = self.session.run_video(img2, img1)
            elif klass:
                bw_dev, _ = self.session.run_ladder(img2, img1, klass)
            else:
                bw_dev = self.session.run(img2, img1)
        self.batches += 1
        key = f"{bucket[0]}x{bucket[1]}"
        self.batches_by_bucket[key] = self.batches_by_bucket.get(key, 0) \
            + 1
        t1 = time.perf_counter()
        flow = self.session.fetch(flow)
        flow_bw = self.session.fetch(bw_dev) if products else None
        if sequence:
            self._store_carry(batch, bucket, state)
        t2 = time.perf_counter()

        record = dict(bucket=key, size=len(batch), fill=fill,
                      seconds=round(t1 - t0, 6))
        if info is not None:
            record.update(klass=klass, rungs=info["rungs"],
                          iterations=info["iterations"])
        if sequence:
            record.update(video=True, warm_members=sum(
                1 for row in warm_rows if row is not None))
        if products:
            record.update(products=True)
        self.batch_log.append(record)

        for i, r in enumerate(batch):
            h, w = r.shape
            r.spans["dispatch"] = t1 - t0
            r.spans["device"] = t2 - t1
            occ = conf = None
            if r.products:
                occ, conf = fw_bw_products(flow[i, :h, :w, :],
                                           flow_bw[i, :h, :w, :])
            self._complete(r, result=FlowResult(
                rid=r.rid, client=r.client, bucket=bucket, shape=r.shape,
                flow=flow[i, :h, :w, :], spans=r.spans, klass=klass,
                iterations=info["iterations"] if info else 0,
                warm=warm_rows[i] is not None, occlusion=occ,
                confidence=conf))

    # -- video session carry -------------------------------------------------

    def _carry_shape(self, bucket):
        """The expected coarse-carry row shape for ``bucket``, or None
        until the model's downsampling factor has been observed (before
        any video dispatch the cache is empty anyway)."""
        if self._carry_factor is None:
            return None
        fy, fx = self._carry_factor
        return (int(round(bucket[0] / fy)), int(round(bucket[1] / fx)), 2)

    def carry_shapes(self):
        """Every configured bucket's expected carry shape (what an
        imported session snapshot must match), or None until the model's
        downsampling factor has been observed."""
        if self._carry_factor is None:
            return None
        return {self._carry_shape(b) for b in self.session.buckets.sizes}

    def _gather_carry(self, batch, bucket, fill):
        """The members' cached carries stacked into one batch array.

        Members without a usable carry (a new client, a TTL eviction, a
        resolution switch) get zero rows: the warm step is bit for bit the
        cold rung on zeros, so a partly warm batch is always right. Fill
        rows repeat the last row. Returns ``(carry or None, per-member
        rows)``; None when no member is warm (the batch runs the plain
        cold rung)."""
        expected = self._carry_shape(bucket)
        rows = [self.sessions.get(r.client, expected) for r in batch]
        have = [row for row in rows if row is not None]
        if not have:
            return None, rows
        proto = have[0]
        carry = np.stack([row if row is not None else np.zeros_like(proto)
                          for row in rows])
        if fill > 0:
            carry = np.concatenate(
                [carry, np.repeat(carry[-1:], fill, axis=0)])
        return carry, rows

    def _store_carry(self, batch, bucket, state):
        """Store each member's fresh coarse-flow carry for its client
        (fill rows dropped); the first store pins the image-to-coarse-grid
        factor the shape check needs."""
        coarse = self.session.fetch(state["flow"])
        if self._carry_factor is None:
            self._carry_factor = (bucket[0] / coarse.shape[1],
                                  bucket[1] / coarse.shape[2])
        for i, r in enumerate(batch):
            self.sessions.put(r.client, coarse[i])

    # -- completion / sticky per-client release ------------------------------

    def _complete(self, req, result=None, error=None):
        with self._lock:
            if error is not None:
                self.errors += 1
            held = self._held.setdefault(req.client, {})
            held[req.seq] = (req, result, error)
            nxt = self._release_next.get(req.client, 0)
            ready = []
            while nxt in held:
                ready.append(held.pop(nxt))
                nxt += 1
            self._release_next[req.client] = nxt
        for r, res, err in ready:
            if err is None:
                res.spans["total"] = time.perf_counter() - r.t_submit
            r.ticket._complete(result=res, error=err)
