"""The ``evaluate`` subcommand: per-sample metrics, reports, flow images
(counterpart of ``raft_meets_dicl_tpu/cmd/eval.py``, its single-device
path; reference src/cmd/eval.py:112-303).

The forward passes run through the evaluation generator
(``evaluation.evaluate``, one batch in flight). Per-sample loss and
metrics are computed on the device from each sample's own slice of its
batch and read back once per dispatched batch (``metrics.fetch``); a
flow image's inputs are copied to the host only for the format that
reads them. Runs on ``cuda`` unless ``--device cpu`` is given, and fails
without CUDA rather than running elsewhere.

``--wire-format`` (or ``RMD_WIRE_FORMAT``; the flag wins) sends the
images to the device in a compact dtype, un-normalized, and the step
decodes them there (``models.wire``); not with ``--fwbw``, as in JAX.

Flags of parts not ported yet are accepted, so that a JAX command line
parses, and refused by name: ``--precompile`` and ``--compile-cache``
(slice 7, ``compile/``),
``--telemetry`` (slice 7, the ops plane) and ``--device-ids`` with more
than one id (slice 2 item 10, data parallelism).
"""

import json
import logging
from pathlib import Path

import cv2
import numpy as np
import torch

from .. import data, evaluation, metrics, models, strategy, utils, visual
from ..models.input import ShapeBuckets
from ..models.wire import WireFormat
from ..video.products import fw_bw_products

_DEFAULT_METRICS = (Path(__file__).resolve().parents[2] / "cfg" / "eval"
                    / "default.yaml")

FLOW_FORMATS = (
    "flow:flo", "flow:kitti", "visual:epe", "visual:bp-fl", "visual:flow",
    "visual:flow:dark", "visual:flow:gt", "visual:i1",
    "visual:warp:backwards", "visual:intermediate:flow",
    "visual:occlusion", "visual:confidence",
)

# formats derived from the forwards-backwards pass (--fwbw)
_FWBW_FORMATS = ("visual:occlusion", "visual:confidence")

# formats that read the input images
_IMAGE_FORMATS = ("visual:i1", "visual:warp:backwards", "visual:occlusion")

_REFUSED = (
    ("precompile", "--precompile", "ROADMAP slice 7, compile/"),
    ("compile_cache", "--compile-cache", "ROADMAP slice 7, compile/"),
    ("telemetry", "--telemetry", "ROADMAP slice 7, the ops plane"),
)


def select_device(device, device_ids=None):
    """The torch device of ``--device`` (``cuda``, ``cuda:N`` or ``cpu``)
    and ``--device-ids`` (one index into that platform's devices); fails
    without CUDA for a CUDA device."""
    ids = ([int(i.strip()) for i in device_ids.split(",")]
           if device_ids else [])
    if len(ids) > 1:
        raise NotImplementedError(
            f"--device-ids {device_ids}: evaluation over more than one "
            "device is not ported yet (ROADMAP slice 2 item 10, data "
            "parallelism)")
    device = torch.device(device)
    if ids:
        if device.index is not None and device.index != ids[0]:
            raise ValueError(f"--device {device} and --device-ids "
                             f"{device_ids} name different devices")
        if device.type == "cpu" and ids[0] != 0:
            raise ValueError(f"--device-ids {device_ids}: the CPU is "
                             "device 0")
        if device.type == "cuda":
            device = torch.device("cuda", ids[0])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "evaluating on 'cuda' needs a CUDA device, and "
            "torch.cuda.is_available() is False; pass --device cpu to "
            "evaluate on the CPU")
    return device


def evaluate(args):
    """Run the evaluate command; returns the report (``samples``,
    ``summary``; empty lists/dicts under ``--flow-only``) with the sweep's
    ``EvalRunStats`` as ``stats``."""
    for attr, flag, item in _REFUSED:
        if getattr(args, attr, None):
            raise NotImplementedError(
                f"{flag} is not ported yet ({item})")

    # fail fast on a bad format, before the model loads
    if args.flow and args.flow_format not in FLOW_FORMATS:
        raise ValueError(
            f"unknown flow format '{args.flow_format}'; "
            f"choose one of {', '.join(FLOW_FORMATS)}"
        )

    fwbw = bool(getattr(args, "fwbw", False))
    if args.flow and args.flow_format in _FWBW_FORMATS and not fwbw:
        raise ValueError(
            f"flow format '{args.flow_format}' derives from the "
            f"forwards-backwards pass; add --fwbw")

    # wire format: images cross host->device compact and un-normalized,
    # the normalization runs in the eval step
    wire = WireFormat.from_config(getattr(args, "wire_format", None)
                                  or utils.env.get_str("RMD_WIRE_FORMAT"))
    if fwbw and wire is not None:
        # the backwards forward re-enters the step with the yielded
        # (decoded) images, which a wire step would decode again
        raise ValueError("--fwbw needs the plain f32 input path "
                         "(drop --wire-format)")

    device = select_device(args.device, getattr(args, "device_ids", None))

    # model (a full training config's model section is accepted too)
    logging.info(f"loading model specification, file='{args.model}'")
    model_cfg = utils.config.load(args.model)
    if "strategy" in model_cfg:
        model_cfg = model_cfg["model"]

    spec = models.load(model_cfg)
    model, loss, input = spec.model, spec.loss, spec.input
    model_adapter = model.get_adapter()
    if wire is not None:
        wire = wire.bound(input.clip, input.range)
        logging.info(f"input wire format: {wire.describe()}")

    logging.info(f"loading checkpoint, file='{args.checkpoint}'")
    chkpt = strategy.Checkpoint.load(args.checkpoint)
    model.init(torch.Generator().manual_seed(0), device)
    chkpt.apply(module=model.module)

    # metrics
    metrics_path = args.metrics if args.metrics else _DEFAULT_METRICS
    logging.info(f"loading metrics specification, file='{metrics_path}'")

    metrics_cfg = utils.config.load(metrics_path)
    mtx = metrics.Metrics.from_config(metrics_cfg["metrics"])
    collectors = metrics.Collectors.from_config(metrics_cfg["summary"])

    # data
    logging.info(f"loading data specification, file='{args.data}'")
    compute_metrics = not args.flow_only

    # shape buckets: quantize mixed per-image resolutions onto a small
    # canonical set and batch same-bucket samples, so that batches stay
    # full on a KITTI-like sweep
    buckets_spec = (getattr(args, "buckets", None)
                    or utils.env.get_str("RMD_EVAL_BUCKETS"))
    buckets = ShapeBuckets.from_config(buckets_spec)
    if buckets is not None:
        logging.info(f"shape buckets: {buckets.describe()}")

    dataset = data.load(args.data)
    loader = input.apply(dataset, buckets=buckets,
                         normalize=wire is None).torch(
        compute_metrics, wire=wire).loader(
            batch_size=args.batch_size, shuffle=False, drop_last=False,
            pin_memory=device.type == "cuda",
            group_by_shape=buckets is not None)

    path_out = Path(args.output) if args.output else None
    if path_out is not None:
        path_out.parent.mkdir(parents=True, exist_ok=True)

    path_flow = Path(args.flow) if args.flow else None

    # visual-format argument plumbing (src/cmd/eval.py:177-204)
    visual_args = {}
    if args.flow_mrm:
        visual_args["mrm"] = float(args.flow_mrm)
    if args.flow_gamma:
        visual_args["gamma"] = float(args.flow_gamma)

    visual_dark_args = dict(visual_args)
    if args.flow_transform:
        visual_dark_args["transform"] = args.flow_transform

    epe_args = {}
    if args.epe_cmap is not None:
        epe_args["cmap"] = args.epe_cmap
    if args.epe_max is not None:
        epe_args["vmax"] = float(args.epe_max)

    logging.info(f"evaluating {len(loader.source)} samples on {device}")

    # partial per-bucket batches (epoch-end remainders) are padded up to
    # the full batch size, so that every batch of a bucket has its shape
    pad_to = args.batch_size if buckets is not None else None
    stats = evaluation.EvalRunStats(name="evaluate")

    # recurrence-budget override: CLI --iterations > RMD_ITERATIONS > the
    # model config's default (0/unset means no override)
    iterations = getattr(args, "iterations", None)
    if iterations is None:
        iterations = utils.env.get_int("RMD_ITERATIONS") or None
    model_args = {"iterations": int(iterations)} if iterations else None
    if iterations:
        logging.info(f"iteration override: {iterations}")

    eval_fn = evaluation.make_eval_fn(model, model_args, wire=wire)

    # incremental per-sample JSONL: one line per evaluated sample, flushed
    # as it is computed, so that a crash mid-sweep keeps everything up to
    # the crash
    inc_path = None
    if not getattr(args, "no_incremental", False):
        if getattr(args, "incremental", None):
            inc_path = Path(args.incremental)
        elif path_out is not None and compute_metrics:
            inc_path = path_out.parent / (path_out.stem + ".samples.jsonl")
    inc_fd = None
    if inc_path is not None and compute_metrics:
        inc_path.parent.mkdir(parents=True, exist_ok=True)
        inc_fd = open(inc_path, "w")
        logging.info(f"appending per-sample metrics to '{inc_path}'")

    output = []
    ctx_m = metrics.MetricContext()

    def finish(batch):
        """One dispatched batch's samples: loss and metrics on the device,
        read back in one copy; the fw/bw products; the records, log lines
        and flow images."""
        computed, products = [], []
        with torch.inference_mode():
            for sample in batch:
                occlusion = confidence = None
                if fwbw:
                    # the reversed pair through the same step, batch 1
                    _, flow_bw = eval_fn(sample.img2[None],
                                         sample.img1[None])
                    occlusion, confidence = fw_bw_products(
                        _host(sample.final), _host(flow_bw[0]))
                products.append((occlusion, confidence))

                if sample.target is None or not compute_metrics:
                    computed.append(None)
                    continue
                target, valid = sample.target[None], sample.valid[None]
                out = model_adapter.wrap_result(sample.output, None)
                sample_loss = loss(model, out.output(), target, valid)
                computed.append(mtx(ctx_m, sample.final[None], target,
                                    valid, sample_loss))

        fetched = iter(metrics.fetch([c for c in computed if c is not None]))
        for sample, c, (occlusion, confidence) in zip(batch, computed,
                                                      products):
            sample_id = sample.meta.sample_id
            if c is not None:
                sample_metrs = dict(next(fetched))
                record = {"id": str(sample_id), "metrics": sample_metrs}
                if occlusion is not None:
                    record["fwbw"] = {
                        "occlusion_ratio": round(float(occlusion.mean()), 5),
                        "confidence_mean": round(float(confidence.mean()), 5),
                    }
                output.append(record)
                collectors.collect(sample_metrs)
                if inc_fd is not None:
                    inc_fd.write(json.dumps(record) + "\n")
                    inc_fd.flush()

                info = [f"{k}: {v:.04f}" for k, v in sample_metrs.items()]
                logging.info(f"sample: {sample_id}, {', '.join(info)}")
            else:
                logging.info(f"sample: {sample_id}")

            if path_flow is not None:
                img1 = img2 = None
                if args.flow_format in _IMAGE_FORMATS:
                    img1 = (sample.img1 + 1) / 2
                    img2 = (sample.img2 + 1) / 2
                out = model_adapter.wrap_result(sample.output, None)
                save_flow_image(
                    path_flow, args.flow_format, sample_id, img1, img2,
                    sample.target, sample.valid, sample.final, out,
                    sample.meta.original_extents, visual_args,
                    visual_dark_args, epe_args, occlusion=occlusion,
                    confidence=confidence,
                )

    try:
        batch = []
        for sample in evaluation.evaluate(model, loader, eval_fn=eval_fn,
                                          pad_to=pad_to, stats=stats,
                                          wire=wire):
            batch.append(sample)
            if sample.end_of_batch:
                finish(batch)
                batch = []
    finally:
        if inc_fd is not None:
            inc_fd.close()

    logging.info(
        f"evaluation sweep: {stats.samples} samples in {stats.batches} "
        f"batches ({stats.samples_per_sec():.2f} samples/s, "
        f"pad waste {stats.pad_waste_ratio() * 100:.1f}%)")

    report = {"samples": output, "summary": {}}
    if compute_metrics:
        logging.info("summary:")
        for collector in collectors.collectors:
            info = [f"{k}: {v:.04f}" for k, v in collector.result().items()]
            logging.info(f"  {collector.type}: {', '.join(info)}")

        # plain dicts, which a yaml report can hold
        report["summary"] = {k: dict(v)
                             for k, v in collectors.results().items()}
        if path_out is not None:
            utils.config.store(path_out, report)

    return {**report, "stats": stats}


def _host(x):
    """A tensor (or array) as host numpy: floating point as float32 or
    wider, the rest as is."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.dtype not in (torch.float32,
                                                     torch.float64):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def save_flow_image(dir, format, sample_id, img1, img2, target, valid, flow,
                    out, size, visual_args, visual_dark_args, epe_args,
                    batch_index=0, occlusion=None, confidence=None):
    """One sample's output in the requested format (src/cmd/eval.py:
    274-303). The inputs may be device tensors: only those the format
    reads are cropped to ``size`` (the sample's original extents) and
    copied to the host.

    ``batch_index`` selects the sample within ``out``'s batch dimension
    for the intermediates dump (the evaluation generator yields
    per-sample outputs, so the default 0 addresses that sample).
    ``occlusion``/``confidence`` are the forwards-backwards products
    (``--fwbw``), required by the ``visual:occlusion`` and
    ``visual:confidence`` formats.
    """
    (h0, h1), (w0, w1) = size
    inputs = {"flow": flow, "img1": img1, "img2": img2, "target": target,
              "valid": valid, "occlusion": occlusion,
              "confidence": confidence}

    def crop(name):
        x = inputs[name]
        if x is None:
            return None
        x = _host(x[h0:h1, w0:w1])
        return x.astype(bool) if name == "valid" else x

    formats = {
        "flow:flo": (data.io.write_flow_mb, ["flow"], {}, "flo"),
        "flow:kitti": (data.io.write_flow_kitti, ["flow"], {}, "png"),
        "visual:epe": (save_flow_visual_epe, ["flow", "target", "valid"],
                       epe_args, "png"),
        "visual:bp-fl": (save_flow_visual_fl_error,
                         ["flow", "target", "valid"], {}, "png"),
        "visual:flow": (save_flow_visual, ["flow"], visual_args, "png"),
        "visual:flow:dark": (save_flow_visual_dark, ["flow"],
                             visual_dark_args, "png"),
        "visual:flow:gt": (save_flow_visual, ["target"], visual_args, "png"),
        "visual:i1": (save_image, ["img1"], {}, "png"),
        "visual:warp:backwards": (save_flow_visual_warp_backwards,
                                  ["img2", "flow"], {}, "png"),
        "visual:intermediate:flow": (save_intermediate_flow_visual, None,
                                     visual_args, "png"),
        "visual:occlusion": (save_occlusion_visual, ["img1", "occlusion"],
                             {}, "png"),
        "visual:confidence": (save_confidence_visual, ["confidence"],
                              {}, "png"),
    }

    write, names, kwargs, ext = formats[format]
    wargs = ([out, batch_index] if names is None
             else [crop(name) for name in names])

    path = Path(dir) / f"{sample_id}.{ext}"
    path.parent.mkdir(parents=True, exist_ok=True)
    write(path, *wargs, **kwargs)


def _to_u8(img):
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def save_image(path, img, **kwargs):
    cv2.imwrite(str(path), _to_u8(img[:, :, ::-1]))


def save_flow_visual(path, uv, **kwargs):
    rgba = visual.flow_to_rgba(uv, **kwargs)
    cv2.imwrite(str(path), _to_u8(visual.utils.rgba_to_bgra(rgba)))


def save_flow_visual_dark(path, uv, **kwargs):
    rgba = visual.flow_to_rgba_dark(uv, **kwargs)
    cv2.imwrite(str(path), _to_u8(visual.utils.rgba_to_bgra(rgba)))


def save_flow_visual_epe(path, uv, uv_target, mask, cmap="gray", **kwargs):
    if cmap == "absflow":
        rgba = visual.end_point_error_abs(uv, uv_target, mask)
    else:
        rgba = visual.end_point_error(uv, uv_target, mask, cmap=cmap, **kwargs)
    cv2.imwrite(str(path), _to_u8(visual.utils.rgba_to_bgra(rgba)))


def save_flow_visual_fl_error(path, uv, uv_target, mask):
    rgba = visual.fl_error(uv, uv_target, mask)
    cv2.imwrite(str(path), _to_u8(visual.utils.rgba_to_bgra(rgba)))


def save_flow_visual_warp_backwards(path, img2, flow):
    cv2.imwrite(str(path), _to_u8(visual.warp_backwards(img2, flow)[:, :, ::-1]))


def save_occlusion_visual(path, img1, occlusion, **kwargs):
    rgba = visual.occlusion_overlay(img1, occlusion, **kwargs)
    cv2.imwrite(str(path), _to_u8(visual.utils.rgba_to_bgra(rgba)))


def save_confidence_visual(path, confidence, **kwargs):
    rgba = visual.confidence_to_rgba(confidence, **kwargs)
    cv2.imwrite(str(path), _to_u8(visual.utils.rgba_to_bgra(rgba)))


def save_intermediate_flow_visual(path, output, batch_index=0, mrm=None,
                                  **kwargs):
    """Dump every intermediate flow, magnitude-normalized across levels by
    width ratio (src/cmd/eval.py:338-383).

    ``batch_index`` picks the sample out of each node's leading batch
    dimension, so a batched result dumps the requested sample's
    intermediates.
    """
    inter = output.intermediate_flow()

    flat = {}

    def unpack(node, key=""):
        if isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                unpack(x, f"{key}.{i}")
        elif isinstance(node, dict):
            for k, x in node.items():
                unpack(x, f"{key}.{k}")
        else:
            flat[key] = _host(node[batch_index])

    unpack(inter)

    ref_width = max(uv.shape[1] for uv in flat.values())

    if mrm is None:
        mrm = 1e-5
        for uv in flat.values():
            level_max = float(np.max(np.linalg.norm(uv, ord=2, axis=-1)))
            mrm = max(mrm, level_max * ref_width / uv.shape[1])

    path = Path(path)
    for k, uv in flat.items():
        p = path.parent / f"{path.stem}{k}{path.suffix}"
        rgba = visual.flow_to_rgba(uv, mrm=mrm * uv.shape[1] / ref_width, **kwargs)
        cv2.imwrite(str(p), _to_u8(visual.utils.rgba_to_bgra(rgba)))
