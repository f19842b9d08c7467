"""Evaluation runtime: the inference step and the per-sample evaluation
generator (counterpart of ``raft_meets_dicl_tpu/evaluation``, its plain
single-device path).

``make_eval_fn(model)`` returns ``step(img1, img2) -> (raw_output,
final_flow)`` under ``torch.inference_mode()`` on the device the model
lives on; validation (``inspect.summary.make_val_step``), serving and
``evaluate`` run it. With a wire format (``models.wire.WireFormat``) the
step takes the images as they crossed the host→device copy and decodes
them first. ``make_rung_fn(model, iterations, cont)`` returns the
iteration ladder's rung step, which also returns the ``(flow, hidden)``
carry and the convergence norm ``delta`` (``serve.ServeSession``), and
``make_warm_fn(model, iterations)`` the video warm-start step, which
re-enters the recurrence from the previous frame's projected coarse flow
(``video.SequenceRunner``, video serving).
``evaluate`` yields one ``EvalSample`` per dataset sample, with one batch
in flight, and ``EvalRunStats`` accounts a sweep (``main evaluate``,
``cmd/eval.py``).

Left out of the JAX module: the compile counters (``compiles``, the
program registry and AOT store: eager PyTorch compiles no programs, so a
step is a plain closure and there is no cache of built programs either),
the telemetry ``emit`` (ROADMAP slice 7's ops plane) and meshes.
"""

import contextlib
import inspect
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from ..ops import quant as quant_ops
from ..ops import warp
from ..utils import env


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


#: the forward arguments a rung step sets itself
_RUNG_RESERVED = ("iterations", "flow_init", "hidden_init", "return_state",
                  "quant", "quant_clip")


def _rung_forward(model, iterations, wire, model_args, quant):
    """The forward a rung or warm step runs: ``forward(img1, img2, flow,
    hidden, project=False) -> (final_flow, state)`` under
    ``torch.inference_mode()``, the wire's decode first; ``project`` moves
    the carried coarse ``flow`` to the current frame
    (``warp_backwards(flow, -flow)``) before it seeds ``flow_init``."""
    quant = quant_ops.normalize_mode(quant)
    model_args = dict(model_args or {})
    for reserved in _RUNG_RESERVED:
        model_args.pop(reserved, None)
    forward_args = dict(model_args, iterations=iterations, return_state=True)
    if quant is not None:
        if "quant" not in inspect.signature(model.module.forward).parameters:
            raise ValueError(
                f"model '{model.type}' has no quantized matching tier: a "
                f"'{quant}' rung needs raft/baseline or raft/fs")
        forward_args["quant"] = quant
        forward_args["quant_clip"] = float(env.get_float("RMD_QUANT_CLIP"))
    adapter = model.get_adapter()

    def forward(img1, img2, flow, hidden, project=False):
        with torch.inference_mode():
            if wire is not None:
                img1, img2, _, _ = wire.decode(img1, img2)
            kwargs = dict(forward_args)
            if project:
                flow = flow.to(torch.float32)
                flow, _ = warp.warp_backwards(flow, -flow)
            if flow is not None:
                kwargs["flow_init"] = flow
            if hidden is not None:
                kwargs["hidden_init"] = hidden
            out, state = model.apply(img1, img2, train=False, **kwargs)
            result = adapter.wrap_result(out, tuple(img1.shape[1:3]))
            return result.final(), state

    forward.quant = quant
    return forward


def make_rung_fn(model, iterations, cont=False, wire=None, model_args=None,
                 quant=None):
    """The iteration ladder's rung step: a fixed-``iterations`` inference
    step that returns the continuation carry beside the final flow.

    - ``cont=False``: ``step(img1, img2) -> (final_flow, state)``, a base
      rung starting from zero flow;
    - ``cont=True``: ``step(img1, img2, flow, hidden) -> (final_flow,
      state)``, a continuation rung re-entering the recurrence from a
      previous rung's carry (bit for bit: the models carry flow, not
      coords, across iterations).

    ``state`` is ``{"flow", "hidden", "delta"}``: the coarse carry, left on
    the device for the next rung, and the per-sample convergence norm the
    host reads between rungs. ``quant`` (``u8``/``i8``, ``ops.quant``) runs
    the rung on quantized correlation volumes, with the clip ratio
    ``RMD_QUANT_CLIP`` read when the step is built; a model whose forward
    takes no ``quant`` refuses it here. The step sets ``.iterations``,
    ``.cont`` and ``.quant``. Like ``make_eval_fn`` it runs under
    ``torch.inference_mode()``, with the wire's decode first."""
    iterations = int(iterations)
    cont = bool(cont)
    forward = _rung_forward(model, iterations, wire, model_args, quant)

    if cont:
        def step(img1, img2, flow, hidden):
            return forward(img1, img2, flow, hidden)
    else:
        def step(img1, img2):
            return forward(img1, img2, None, None)

    step.iterations = iterations
    step.cont = cont
    step.quant = forward.quant
    return step


def make_warm_fn(model, iterations, wire=None, model_args=None, quant=None):
    """The video warm-start step: ``step(img1, img2, flow) -> (final_flow,
    state)``, ``flow`` the previous frame's coarse carry (a rung's or warm
    step's ``state["flow"]``, on the model's device).

    Inside the step, after the wire's decode, the carry is projected to the
    current frame (``warp_backwards(flow, -flow)``: ``out(p) = flow(p -
    flow(p))``, zero where the sample leaves the frame) and seeds
    ``flow_init``; the hidden state starts fresh (a carried hidden rides
    the ``cont=True`` rungs). A zero carry projects to exactly zero, so the
    step is then bit for bit the base rung of ``iterations``: a cache miss
    degrades to the cold path, never to another answer. ``quant`` routes
    the step onto the quantized tier as in :func:`make_rung_fn`. The step
    sets ``.iterations``, ``.cont = False``, ``.warm = True`` and
    ``.quant``."""
    iterations = int(iterations)
    forward = _rung_forward(model, iterations, wire, model_args, quant)

    def step(img1, img2, flow):
        return forward(img1, img2, flow, None, project=True)

    step.iterations = iterations
    step.cont = False
    step.warm = True
    step.quant = forward.quant
    return step


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

