"""The ``serve`` subcommand: online flow inference as a service.

Counterpart of ``raft_meets_dicl_tpu/cmd/serve.py`` (the single-replica,
non-prebuild branch). Boots one replica on the device (model with seeded
weights, or a checkpoint's: ``--checkpoint`` or the config's
``checkpoint`` key, relative to the config file; one warm-up batch per
bucket), runs the built-in open-loop load
generator against the scheduler and prints the report (p50/p99 latency,
pairs/s, shed/error counts; with ``--ladder``, the per-class breakdown;
with ``--video``, the warm/cold split) as JSON.

Precedence: CLI flag > config file (``serve:`` section) > default; the
wire format (``--wire-format``, the config's ``wire-format`` key) then
falls back to ``RMD_WIRE_FORMAT``, the ladder's rungs given bare
(``--ladder``, ``ladder: true``) to ``RMD_LADDER``, its threshold to
``RMD_LADDER_THRESHOLD`` and the quantized tier (``--quant``, the
config's ``quant`` key) to ``RMD_QUANT``, as in JAX. With a ladder the
built-in client cycles the latency classes ``fast``, ``balanced`` and
``quality`` over its requests. With ``--video`` (the config's ``video``
key) the session builds the warm-start step, the scheduler keeps each
client's carry, and the built-in client submits four sticky frame streams
(no classes). ``cfg/serve/example.yaml`` serves as it ships (u8 wire),
with ``--ladder 4,8,12 --quant u8`` and with ``--video`` too. The device
is ``cuda`` unless ``--device cpu`` is given; without CUDA the command
fails rather than running on the CPU. The fleet, ``--prebuild``, the AOT
store, telemetry and the observability plane are not ported (ROADMAP
slice 7 items 3, 4 and 7).
"""

import json
import logging
from pathlib import Path

import numpy as np

from .. import models, serve as serving, utils
from ..models.input import ShapeBuckets
from ..models.wire import WireFormat

_DEFAULTS = {"batch-size": 4, "requests": 32, "rate": 50.0,
             "max-wait-ms": serving.scheduler.DEFAULT_MAX_WAIT_MS,
             "queue-limit": serving.scheduler.DEFAULT_QUEUE_LIMIT}


def _pick(cli, cfg, cfg_key, default=None):
    if cli is not None:
        return cli
    return cfg.get(cfg_key, _DEFAULTS.get(cfg_key, default))


def _resolve(path, cfg_path):
    """Config-file-relative path resolution: a relative path inside the
    serve config means "next to this file"."""
    if cfg_path is None or Path(path).is_absolute():
        return path
    return str(Path(cfg_path).parent / path)


def serve(args):
    """Run the serve command; returns the report it prints, which also
    counts the dispatched device batches (``batches``, per bucket
    ``batches_by_bucket``, one record each in ``batch_log``), a video
    session cache's counts (``video_sessions``), the served flows
    with a non-finite value (``nonfinite``) and lists the warm-up runs,
    with the completed ``FlowResult``s in submission order (``results``,
    not printed)."""
    cfg = {}
    if getattr(args, "config", None):
        cfg = utils.config.load(args.config)
        cfg = cfg.get("serve", cfg)

    model_src = getattr(args, "model", None)
    if model_src is None:
        model_src = cfg.get("model")
        if isinstance(model_src, str):
            model_src = _resolve(model_src, getattr(args, "config", None))
    if model_src is None:
        raise ValueError("serve needs a model: --model or the config's "
                         "'model' key")
    model_cfg = (utils.config.load(model_src) if isinstance(model_src, str)
                 else model_src)
    if "strategy" in model_cfg:
        model_cfg = model_cfg["model"]
    spec = models.load(model_cfg)
    logging.info(f"serving model '{spec.id}'")

    buckets = ShapeBuckets.from_config(_pick(args.buckets, cfg, "buckets"))
    if buckets is None or not buckets.sizes:
        raise ValueError(
            "serve needs explicit bucket sizes: --buckets 'HxW,...' or the "
            "config's 'buckets' key")
    logging.info(f"shape buckets: {buckets.describe()}")

    wire = WireFormat.from_config(_pick(
        getattr(args, "wire_format", None), cfg, "wire-format",
        utils.env.get_str("RMD_WIRE_FORMAT")))
    if wire is not None:
        logging.info(f"request wire format: {wire.describe()}")

    batch_size = int(_pick(args.batch_size, cfg, "batch-size"))
    checkpoint = getattr(args, "checkpoint", None)
    if checkpoint is None and cfg.get("checkpoint") is not None:
        checkpoint = _resolve(cfg["checkpoint"], getattr(args, "config", None))

    ladder_spec = _pick(getattr(args, "ladder", None), cfg, "ladder")
    ladder = None
    if ladder_spec:
        ladder = serving.LadderSpec.from_config(
            ladder_spec, threshold=_pick(
                getattr(args, "ladder_threshold", None), cfg,
                "ladder-threshold"))
        logging.info(f"iteration ladder: {ladder.describe()}")
    video = bool(_pick(getattr(args, "video", None) or None, cfg, "video"))
    if video:
        logging.info("video sessions enabled: warm-start programs + "
                     "sticky per-client carry cache")
    quant = _pick(getattr(args, "quant", None), cfg, "quant",
                  utils.env.get_str("RMD_QUANT"))
    if quant:
        logging.info(f"quantized matching tier: {quant} (fast class + "
                     "video warm frames)")

    session = serving.ServeSession(spec, buckets, wire=wire,
                                   checkpoint=checkpoint,
                                   batch_size=batch_size, ladder=ladder,
                                   video=video, quant=quant,
                                   device=args.device)

    warmup = session.warm_pool()
    for o in warmup:
        rung = f" rung {o['rung']}" if "rung" in o else ""
        logging.info(f"warm-up: {o['model']} bucket {o['bucket']} batch "
                     f"{o['batch']}{rung} on {o['device']} "
                     f"({o['seconds']:.2f} s)")

    scheduler = serving.Scheduler(
        session, batch_size=batch_size,
        max_wait_ms=float(_pick(args.max_wait_ms, cfg, "max-wait-ms")),
        queue_limit=int(_pick(args.queue_limit, cfg, "queue-limit"))).start()

    # built-in open-loop client: every bucket size plus an off-bucket
    # variant of each (exercises quantization + partial batches)
    shapes = []
    for h, w in session.buckets.sizes:
        shapes.append((h, w))
        if h > 8 and w > 8:
            shapes.append((h - 8, w - 8))

    requests = int(_pick(args.requests, cfg, "requests"))
    rate = float(_pick(args.rate, cfg, "rate"))
    classes = list(serving.CLASSES) if ladder is not None else None
    if video:
        # sticky streams force the fast rung; class cycling is moot
        classes = None
    logging.info(f"open-loop load: {requests} requests at {rate}/s over "
                 f"{len(shapes)} shapes"
                 + (f", classes {'/'.join(classes)}" if classes else "")
                 + (", sticky video streams" if video else ""))

    try:
        report = serving.loadgen.run_open_loop(
            scheduler, shapes, requests=requests, rate_hz=rate,
            classes=classes, sequence=video)
    finally:
        scheduler.stop(drain=True)
    results = report.pop("results")
    report["nonfinite"] = sum(1 for r in results
                              if not np.isfinite(r.flow).all())
    report["batches"] = scheduler.batches
    report["batches_by_bucket"] = dict(scheduler.batches_by_bucket)
    report["batch_log"] = scheduler.batch_log
    report["warmup"] = warmup
    report["wire"] = wire.describe() if wire is not None else None
    report["ladder"] = ladder.describe() if ladder is not None else None
    report["quant"] = session.quant
    report["video_sessions"] = (None if scheduler.sessions is None else dict(
        hits=scheduler.sessions.hits, misses=scheduler.sessions.misses,
        evictions=scheduler.sessions.evictions,
        active=scheduler.sessions.active))

    logging.info(
        f"served {report['completed']}/{report['requests']} requests: "
        f"p50 {report['p50_ms']:.1f} ms, p99 {report['p99_ms']:.1f} ms, "
        f"{report['pairs_per_sec']:.2f} pairs/s")
    for name, c in report.get("classes", {}).items():
        logging.info(
            f"class {name}: {c['completed']} requests, p50 "
            f"{c['p50_ms']:.1f} ms, p99 {c['p99_ms']:.1f} ms, iterations "
            f"{c['iterations']}")
    print(json.dumps(report))
    return report | {"results": results}
