"""The ``serve`` subcommand: online flow inference as a service.

Counterpart of ``raft_meets_dicl_tpu/cmd/serve.py`` (the single-replica,
non-prebuild branch). Boots one replica on the device (model with seeded
weights, or a checkpoint's: ``--checkpoint`` or the config's
``checkpoint`` key, relative to the config file; one warm-up batch per
bucket), runs the built-in open-loop load
generator against the scheduler and prints the report (p50/p99 latency,
pairs/s, shed/error counts) as JSON.

Precedence: CLI flag > config file (``serve:`` section) > default. The
device is ``cuda`` unless ``--device cpu`` is given; without CUDA the
command fails rather than running on the CPU.
"""

import json
import logging
from pathlib import Path

import numpy as np

from .. import models, serve as serving, utils
from ..models.input import ShapeBuckets

_DEFAULTS = {"batch-size": 4, "requests": 32, "rate": 50.0,
             "max-wait-ms": serving.scheduler.DEFAULT_MAX_WAIT_MS,
             "queue-limit": serving.scheduler.DEFAULT_QUEUE_LIMIT}


def _pick(cli, cfg, cfg_key):
    if cli is not None:
        return cli
    return cfg.get(cfg_key, _DEFAULTS.get(cfg_key))


def _resolve(path, cfg_path):
    """Config-file-relative path resolution: a relative path inside the
    serve config means "next to this file"."""
    if cfg_path is None or Path(path).is_absolute():
        return path
    return str(Path(cfg_path).parent / path)


def serve(args):
    """Run the serve command; returns the report it prints, which also
    counts the dispatched device batches (``batches``, and per bucket
    ``batches_by_bucket``), the served flows
    with a non-finite value (``nonfinite``) and lists the warm-up runs,
    with the completed ``FlowResult``s in submission order (``results``,
    not printed)."""
    cfg = {}
    if getattr(args, "config", None):
        cfg = utils.config.load(args.config)
        cfg = cfg.get("serve", cfg)

    for key in ("wire-format", "ladder", "video", "quant"):
        if cfg.get(key):
            raise NotImplementedError(
                f"serve config key '{key}' is not ported yet (ROADMAP "
                "queue A)")

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

    batch_size = int(_pick(args.batch_size, cfg, "batch-size"))
    checkpoint = getattr(args, "checkpoint", None)
    if checkpoint is None and cfg.get("checkpoint") is not None:
        checkpoint = _resolve(cfg["checkpoint"], getattr(args, "config", None))
    session = serving.ServeSession(spec, buckets, checkpoint=checkpoint,
                                   batch_size=batch_size, device=args.device)

    warmup = session.warm_pool()
    for o in warmup:
        logging.info(f"warm-up: {o['model']} bucket {o['bucket']} batch "
                     f"{o['batch']} on {o['device']} ({o['seconds']:.2f} s)")

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
    logging.info(f"open-loop load: {requests} requests at {rate}/s over "
                 f"{len(shapes)} shapes")

    try:
        report = serving.loadgen.run_open_loop(
            scheduler, shapes, requests=requests, rate_hz=rate)
    finally:
        scheduler.stop(drain=True)
    results = report.pop("results")
    report["nonfinite"] = sum(1 for r in results
                              if not np.isfinite(r.flow).all())
    report["batches"] = scheduler.batches
    report["batches_by_bucket"] = dict(scheduler.batches_by_bucket)
    report["warmup"] = warmup

    logging.info(
        f"served {report['completed']}/{report['requests']} requests: "
        f"p50 {report['p50_ms']:.1f} ms, p99 {report['p99_ms']:.1f} ms, "
        f"{report['pairs_per_sec']:.2f} pairs/s")
    print(json.dumps(report))
    return report | {"results": results}
