"""Open-loop synthetic load generator: the serving measurement harness.

Counterpart of ``raft_meets_dicl_tpu/serve/loadgen.py`` (``synthetic_pair``,
``run_open_loop``, ``summarize``). Open-loop means requests fire on a
fixed wall-clock schedule regardless of completions — a closed loop
self-throttles and hides queueing delay. The generator cycles through a
mixed-resolution shape list (and, for a ladder session, a latency-class
list), submits raw synthetic pairs at ``rate_hz``, collects every ticket,
and reports p50/p99/mean latency, per-span means, throughput, the
shed/error counts, with classes a per-class breakdown and, for a video
session's sticky streams, the warm/cold split. JAX's client-side retry of
retryable sheds is not ported (it serves the fleet, ROADMAP slice 7 item
4).
"""

import time

import numpy as np

from .batcher import ServeError, ServeRejected


def _percentile(sorted_vals, q):
    """Nearest-rank percentile of an ascending list (0.0 when empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def synthetic_pair(shape, rng):
    """One deterministic pseudo-random raw image pair in [0, 1)."""
    h, w = shape
    img1 = rng.random((h, w, 3), dtype=np.float32)
    img2 = rng.random((h, w, 3), dtype=np.float32)
    return img1, img2


def run_open_loop(scheduler, shapes, requests, rate_hz, client="loadgen",
                  seed=0, result_timeout_s=120.0, classes=None,
                  sequence=False, streams=4):
    """Drive ``scheduler`` with ``requests`` submissions at ``rate_hz``
    over the (H, W) cycle ``shapes``; ``classes`` an optional latency-class
    cycle (ladder sessions), request i taking ``classes[i % len]``. With
    ``sequence=True`` (video sessions) the requests are ``streams``
    interleaved sticky client streams, request i going to stream ``i %
    streams`` (client ``f"{client}-{stream}"``), each stream pinned to one
    shape so its frames share a bucket and its carry stays usable.
    Returns the report dict (see ``summarize``) plus ``results``, the
    completed ``FlowResult``s in submission order; deterministic inputs
    for a fixed seed."""
    rng = np.random.default_rng(seed)
    interval = 1.0 / float(rate_hz)
    tickets = []
    rejects = {}
    errors = {}

    t_start = time.perf_counter()
    for i in range(int(requests)):
        delay = t_start + i * interval - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if sequence:
            stream = i % max(1, int(streams))
            shape = shapes[stream % len(shapes)]
            name = f"{client}-{stream}"
        else:
            shape = shapes[i % len(shapes)]
            name = client
        img1, img2 = synthetic_pair(shape, rng)
        klass = classes[i % len(classes)] if classes else None
        try:
            tickets.append(scheduler.submit(img1, img2, client=name,
                                            klass=klass, sequence=sequence))
        except ServeRejected as e:
            rejects[e.reason] = rejects.get(e.reason, 0) + 1
        except ServeError as e:
            errors[e.kind] = errors.get(e.kind, 0) + 1

    results = []
    for ticket in tickets:
        try:
            results.append(ticket.result(timeout=result_timeout_s))
        except TimeoutError:
            errors["timeout"] = errors.get("timeout", 0) + 1
        except ServeError as e:
            errors[e.kind] = errors.get(e.kind, 0) + 1
    wall = time.perf_counter() - t_start

    report = summarize(int(requests), results, rejects, errors, wall)
    report["results"] = results
    return report


def summarize(requests, results, rejects, errors, wall_s):
    """Aggregate completed :class:`FlowResult`s into the report."""
    latencies = sorted(r.spans.get("total", 0.0) for r in results)
    span_names = sorted({k for r in results for k in r.spans})
    spans_ms = {}
    for name in span_names:
        vals = [r.spans[name] for r in results if name in r.spans]
        spans_ms[name] = round(1e3 * sum(vals) / len(vals), 3)

    completed = len(results)
    report = {
        "requests": requests,
        "completed": completed,
        "rejected": rejects,
        "errors": errors,
        "wall_s": round(wall_s, 3),
        "pairs_per_sec": round(completed / wall_s, 3) if wall_s > 0 else 0.0,
        "p50_ms": round(1e3 * _percentile(latencies, 0.50), 3),
        "p99_ms": round(1e3 * _percentile(latencies, 0.99), 3),
        "mean_ms": (round(1e3 * sum(latencies) / completed, 3)
                    if completed else 0.0),
        "spans_ms": spans_ms,
    }

    # ladder breakdown: per-class latency + executed-iterations histogram
    by_class = {}
    for r in results:
        if not r.klass:
            continue
        c = by_class.setdefault(r.klass, {"lat": [], "iterations": {}})
        c["lat"].append(r.spans.get("total", 0.0))
        its = c["iterations"]
        its[r.iterations] = its.get(r.iterations, 0) + 1
    if by_class:
        report["classes"] = {
            k: {
                "completed": len(c["lat"]),
                "p50_ms": round(1e3 * _percentile(sorted(c["lat"]), 0.50), 3),
                "p99_ms": round(1e3 * _percentile(sorted(c["lat"]), 0.99), 3),
                "mean_ms": round(1e3 * sum(c["lat"]) / len(c["lat"]), 3),
                "iterations": dict(sorted(c["iterations"].items())),
            } for k, c in sorted(by_class.items())
        }

    # video breakdown: warm starts across completed frames
    warm = sum(1 for r in results if r.warm)
    if warm:
        report["video"] = {"warm": warm, "cold": completed - warm}
    return report
