"""Evaluation runtime: the inference step and the per-sample evaluation
generator (counterpart of ``raft_meets_dicl_tpu/evaluation``, its plain
single-device path).

``make_eval_fn(model)`` returns ``step(img1, img2) -> (raw_output,
final_flow)`` under ``torch.inference_mode()`` on the device the model
lives on; validation (``inspect.summary.make_val_step``), serving and
``evaluate`` run it. With a wire format (``models.wire.WireFormat``) the
step takes the images as they crossed the host→device copy and decodes
them first. ``warmup_eval_fn`` runs it once per shape on zero images of
the wire's dtype. ``evaluate`` yields one ``EvalSample`` per dataset
sample, with one batch in flight, and ``EvalRunStats`` accounts a sweep
(``main evaluate``, ``cmd/eval.py``).

Left out of the JAX module: the compile counters (``compiles``, the
program registry and AOT store: eager PyTorch compiles no programs), the
telemetry ``emit`` (ROADMAP slice 7's ops plane), meshes, and the rung
and video programs (``make_rung_fn``, ``make_warm_fn``: slice 7's ladder
and video).
"""

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch


def make_eval_fn(model, model_args=None, wire=None):
    """``step(img1, img2) -> (raw_output, final_flow)`` for NHWC image
    batches already on the model's device (in ``wire``'s dtype, decoded
    first, when one is given); ``model_args`` merge over the model's
    config-default arguments."""
    model_args = dict(model_args or {})
    adapter = model.get_adapter()

    def step(img1, img2):
        with torch.inference_mode():
            if wire is not None:
                img1, img2, _, _ = wire.decode(img1, img2)
            out = model.apply(img1, img2, train=False, **model_args)
            result = adapter.wrap_result(out, tuple(img1.shape[1:3]))
            return out, result.final()

    return step


def warmup_eval_fn(eval_fn, shapes, batch_size, device, wire=None):
    """One forward of ``eval_fn`` per ``(H, W)`` in ``shapes`` at
    ``batch_size``, on zero images in the wire's image dtype (float32
    without one), so that the kernels build and the convolution library
    picks its algorithms before the first real batch. Returns the seconds
    each took, by shape."""
    dtype = wire.image_dtype() if wire is not None else torch.float32
    seconds = {}
    for h, w in shapes:
        img = torch.zeros((batch_size, h, w, 3), dtype=dtype, device=device)
        t0 = time.perf_counter()
        eval_fn(img, img)
        if torch.device(device).type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        seconds[(h, w)] = time.perf_counter() - t0
    return seconds


@dataclass
class EvalSample:
    """One evaluated sample: inputs, ground truth and model output.

    Unlike the JAX sample, whose arrays are already on the host, every
    tensor here stays on the model's device: ``img1``/``img2`` (H, W, 3)
    normalized (decoded from the wire on the device, with the host
    decode's arithmetic, when there is one), ``target`` (H, W, 2) and
    ``valid`` (H, W) (None without flow), ``final`` the finest full-resolution flow (H, W, 2), ``output``
    the model's raw output for this sample (batch 1; what the loss
    consumes). The caller moves to the host what it uses: raft's 12
    full-resolution intermediate flows of a b2 436x1024 batch alone are
    86 MB. ``batch`` numbers the dispatched batch the sample came from and
    ``end_of_batch`` marks its last real sample, so a caller can fetch a
    batch's results in one copy.
    """

    img1: torch.Tensor
    img2: torch.Tensor
    target: Optional[torch.Tensor]
    valid: Optional[torch.Tensor]
    final: torch.Tensor
    output: Any
    meta: Any
    batch: int = 0
    end_of_batch: bool = True


@dataclass
class EvalRunStats:
    """Aggregate accounting for one evaluation sweep.

    Tracks batches/samples per dispatch shape ("bucket"), host seconds per
    phase (``dispatch``: the upload and the forward enqueued; ``drain``:
    the wait for a batch's forward to finish, the next batch already
    queued behind it) and the pad-waste ratio, the fraction of dispatched
    pixels that are padding (modulo/bucket pad plus batch fill). The JAX
    stats' compile counters have no counterpart: eager PyTorch compiles no
    programs per shape.
    """

    name: str = "eval"
    samples: int = 0
    batches: int = 0
    pad_samples: int = 0
    real_pixels: int = 0
    total_pixels: int = 0
    phases: Dict[str, float] = field(default_factory=dict)
    buckets: Dict[str, Dict[str, int]] = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)

    def add_phase(self, phase, seconds):
        self.phases[phase] = self.phases.get(phase, 0.0) + seconds

    def add_batch(self, shape, samples, pad_samples, real_pixels):
        h, w = shape
        bucket = self._bucket(shape)
        bucket["batches"] += 1
        bucket["samples"] += samples
        self.batches += 1
        self.samples += samples
        self.pad_samples += pad_samples
        self.real_pixels += int(real_pixels)
        self.total_pixels += (samples + pad_samples) * h * w

    def _bucket(self, shape):
        key = f"{shape[0]}x{shape[1]}"
        return self.buckets.setdefault(key, {"batches": 0, "samples": 0})

    def pad_waste_ratio(self):
        if not self.total_pixels:
            return 0.0
        return 1.0 - self.real_pixels / self.total_pixels

    def samples_per_sec(self):
        dt = time.perf_counter() - self._t0
        return self.samples / dt if dt > 0 else 0.0


def _real_pixels(meta, shape, samples):
    """Un-padded content pixels of a batch, from per-sample metadata
    extents; metadata without extents counts the full dispatch area, i.e.
    zero measured waste."""
    h, w = shape
    total = 0
    for m in meta:
        ext = getattr(m, "original_extents", None)
        if ext is None:
            total += h * w
        else:
            (y0, y1), (x0, x1) = ext
            total += (y1 - y0) * (x1 - x0)
    return total


def _tensors(tree):
    """The tensors of a nested list/tuple/dict output."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def evaluate(model, data, model_args=None, eval_fn=None, pad_to=None,
             stats=None, wire=None):
    """Yield an ``EvalSample`` per dataset sample.

    ``data`` iterates batches ``(img1, img2, flow, valid, meta)`` of NHWC
    CPU tensors (a ``models.input.Loader``, pinned for a CUDA model); the
    model's module is already on its device. Pass a prebuilt ``eval_fn``
    (from ``make_eval_fn``) to share it with the caller. With ``wire``,
    ``data`` yields wire-format images (an adapter built with the same
    WireFormat): they upload compact, the step decodes them, and the
    yielded ``img1``/``img2`` are decoded to the normalized float32
    contract.

    One batch in flight: batch n+1 is uploaded (``non_blocking``) and its
    forward enqueued before batch n's samples are yielded, and on a CUDA
    device the uploads and forwards run on a stream of their own, so that
    what the caller does with batch n on its current stream (metrics, the
    copies of what it uses to the host) waits only for batch n's forward,
    not for the next one's. Batch n's samples are yielded once its
    forward has finished (``drain``); their tensors are recorded on the
    caller's stream, so their memory outlives the caller's work on them.

    ``pad_to`` fills every short batch up to that size by repeating its
    last sample (a bucket's remainder then runs at the full batch's
    shape); the padded outputs are dropped and only real samples yielded.
    ``stats`` (an :class:`EvalRunStats`) accumulates throughput, per-shape
    batch counts, the dispatch/drain phases and the pad-waste ratio.
    """
    adapter = model.get_adapter()
    step = eval_fn if eval_fn is not None else make_eval_fn(
        model, model_args, wire=wire)
    device = next(model.module.parameters()).device
    cuda = device.type == "cuda"
    if cuda:
        caller = torch.cuda.current_stream(device)
        stream = torch.cuda.Stream(device)

    def upload(x):
        return None if x is None else x.to(device, non_blocking=True)

    def dispatch(n, item):
        img1, img2, flow, valid, meta = item
        batch = img1.shape[0]
        pad = max(batch, int(pad_to or 0)) - batch

        t0 = time.perf_counter()
        if cuda:
            # the model's weights and anything else the caller queued
            stream.wait_stream(caller)
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            j1, j2, flow, valid = map(upload, (img1, img2, flow, valid))
            i1, i2 = j1, j2
            if pad:
                i1 = torch.cat([j1, j1[-1:].expand(pad, *j1.shape[1:])])
                i2 = torch.cat([j2, j2[-1:].expand(pad, *j2.shape[1:])])
            out, final = step(i1, i2)
            done = torch.cuda.Event() if cuda else None
            if cuda:
                done.record(stream)

        if stats is not None:
            stats.add_phase("dispatch", time.perf_counter() - t0)
            stats.add_batch(tuple(img1.shape[1:3]), batch, pad,
                            _real_pixels(meta, img1.shape[1:3], batch))
        return n, (j1, j2, flow, valid, meta), out, final, done

    def drain(dispatched):
        n, (img1, img2, flow, valid, meta), out, final, done = dispatched
        batch = img1.shape[0]
        t0 = time.perf_counter()
        if cuda:
            done.synchronize()
            for t in [img1, img2, flow, valid, final, *_tensors(out)]:
                if t is not None:
                    t.record_stream(caller)
        if wire is not None:
            img1, img2 = wire.decode_image(img1), wire.decode_image(img2)
        result = adapter.wrap_result(out, tuple(img1.shape[1:3]))
        if stats is not None:
            stats.add_phase("drain", time.perf_counter() - t0)

        for b in range(batch):
            yield EvalSample(
                img1=img1[b],
                img2=img2[b],
                target=flow[b] if flow is not None else None,
                valid=valid[b] if valid is not None else None,
                final=final[b],
                output=result.output(b),
                meta=meta[b],
                batch=n,
                end_of_batch=b == batch - 1,
            )

    pending = None
    for n, item in enumerate(data):
        dispatched = dispatch(n, item)
        if pending is not None:
            yield from drain(pending)
        pending = dispatched
    if pending is not None:
        yield from drain(pending)

