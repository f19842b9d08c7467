"""One serving replica: model + weights on one device.

Counterpart of ``raft_meets_dicl_tpu/serve/session.py`` (plain path). The
session owns everything device-side: the model spec, its module on the
device (seeded initial weights, then a checkpoint's when one is given:
the port's or the JAX package's), the inference step (``evaluation.make_eval_fn``), and a warm-up
per bucket so that the first request does not pay the kernel build or the
first-call cost of the convolution library.

With a wire format (``models.wire.WireFormat``) requests are encoded to
the wire dtype on the host at admission, cross to the device compact and
are decoded there, inside the inference step; without one they are
normalized on the host.

With an iteration ladder (``ladder.LadderSpec``) the session also builds
one rung step per ``(iterations, cont)`` program of the ladder
(``evaluation.make_rung_fn``) and serves the latency classes through
:meth:`ServeSession.run_ladder`. ``quant`` (``u8``/``i8``) puts the fast
class's base rung on the quantized matching tier; continuations and the
full budget stay at full precision, as in JAX.

With ``video=True`` the session also builds the warm-start step
(``evaluation.make_warm_fn``) at the ladder's bottom rung, or at
``RMD_VIDEO_WARM_ITERATIONS`` without a ladder, with its plain-rung twin
for cold frames, both on the session's ``quant``, and serves video
batches through :meth:`ServeSession.run_video`.

Left out of the JAX session: ``program_fingerprint`` and ``compiles()``
(eager PyTorch builds no programs to fingerprint or count), the readiness
flag of the observability plane (ROADMAP slice 7 item 4) and ``mesh``
(multi-device serving, slice 7 item 6), which refuses by name.

The session runs on ``device`` ("cuda" unless the caller asks for the
CPU); a CUDA device without CUDA raises rather than running elsewhere.
"""

import logging
import time

import numpy as np
import torch

from .. import evaluation
from ..models import wire as wire_
from ..models.input import ShapeBuckets
from ..ops import quant as quant_ops
from ..strategy.checkpoint import Checkpoint
from ..utils import env

_LATER = {
    "mesh": "multi-device serving is not ported yet (ROADMAP slice 7 item "
            "6)",
}


class ServeSession:
    """Device-side half of the serving path.

    ``spec`` is a loaded ``models.ModelSpec``; ``buckets`` the canonical
    ``ShapeBuckets`` (explicit sizes required); ``wire`` an optional
    ``WireFormat`` (bound to the model's clip/range here). Submitted
    images are raw un-normalized f32; :meth:`encode_image` encodes them to
    the wire dtype, or without a wire format normalizes them, on the host.
    ``ladder`` an optional ``LadderSpec`` and ``quant`` the quantized
    tier (``u8``/``i8``) of the fast class's base rung and of the video
    warm frames; ``video`` builds the warm-start step.
    """

    def __init__(self, spec, buckets, wire=None, checkpoint=None,
                 batch_size=4, mesh=None, ladder=None, video=False,
                 quant=None, device="cuda"):
        if mesh:
            raise NotImplementedError(f"serving: {_LATER['mesh']}")

        buckets = ShapeBuckets.from_config(buckets) \
            if not isinstance(buckets, ShapeBuckets) else buckets
        if buckets is None or not buckets.sizes:
            raise ValueError(
                "serving needs explicit bucket sizes ('HxW,...'): warm-up "
                "and admission control are per bucket")
        self.spec = spec
        self.model = spec.model
        self.input = spec.input
        buckets.check_compatible(self.input.padding)
        if wire is not None:
            wire = wire.bound(self.input.clip, self.input.range)
        self.wire = wire
        # requests pad raw pixels then encode/normalize, so bucket pad
        # constants translate into raw space
        self.buckets = buckets.raw_variant(self.input.clip, self.input.range)
        self.batch_size = int(batch_size)

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "serving on 'cuda' needs a CUDA device, and "
                "torch.cuda.is_available() is False; pass --device cpu to "
                "run on the CPU")
        self._init_variables(checkpoint)
        self.eval_fn = evaluation.make_eval_fn(self.model, wire=wire)

        # one rung step per (iterations, cont) program of the ladder; only
        # the base rung takes the quantized tier
        self.ladder = ladder
        self.quant = quant_ops.normalize_mode(quant)
        self._rung_fns = {}
        if ladder is not None:
            for its, cont in ladder.programs():
                q = self.quant if (not cont and its == ladder.rungs[0]) \
                    else None
                self._rung_fns[(its, cont)] = evaluation.make_rung_fn(
                    self.model, its, cont=cont, wire=wire, quant=q)

        # video sessions: the warm-start step (the fast rung re-entered
        # from the previous frame's carry, projected inside the step) and
        # its plain-rung twin for cold frames; with a ladder the bottom
        # rung is the twin
        self.video = bool(video)
        self._warm_fn = None
        if self.video:
            self.warm_iterations = (
                ladder.rungs[0] if ladder is not None
                else env.get_int("RMD_VIDEO_WARM_ITERATIONS"))
            self._warm_fn = evaluation.make_warm_fn(
                self.model, self.warm_iterations, wire=wire,
                quant=self.quant)
            if (self.warm_iterations, False) not in self._rung_fns:
                self._rung_fns[(self.warm_iterations, False)] = \
                    evaluation.make_rung_fn(
                        self.model, self.warm_iterations, wire=wire,
                        quant=self.quant)

    def _init_variables(self, checkpoint):
        # seed 0 on a CPU generator, as the JAX session's PRNGKey(0): the
        # same weights on every device
        self.model.init(torch.Generator().manual_seed(0), self.device)
        if checkpoint is not None:
            logging.info(f"loading checkpoint, file='{checkpoint}'")
            Checkpoint.load(checkpoint).apply(module=self.model.module)

    def _normalize(self, img):
        lo, hi = self.input.clip
        rmin, rmax = self.input.range
        x = np.clip(np.asarray(img, np.float32), lo, hi)
        return (rmax - rmin) * x + rmin

    # -- request encoding (host, admission path) -----------------------------

    def encode_image(self, img):
        """Raw un-normalized image -> what the step's inputs expect: the
        wire dtype (decoded on the device) or host-normalized f32."""
        if self.wire is not None:
            return self.wire.encode_image(img)
        return self._normalize(img)

    # -- device work (dispatch thread) ---------------------------------------

    def run(self, img1, img2):
        """One batch (host NHWC arrays as :meth:`encode_image` made them)
        through the inference step; returns the final flow as a device
        tensor (NHWC, f32) whose computation has finished: the device
        stream is synchronised, so the dispatch span covers device
        compute."""
        _, flow = self.eval_fn(*self._to_device(img1, img2))
        self._synchronize()
        return flow

    def run_ladder(self, img1, img2, klass):
        """One batch through the ladder policy for ``klass``; returns
        ``(flow, info)``: the final flow as a device tensor whose
        computation has finished, and ``{"rungs", "iterations"}``.

        ``fast`` and ``quality`` are one rung step each (the base rung, the
        monolithic full budget). ``balanced`` chains continuation rungs:
        the ``(flow, hidden)`` carry stays on the device between steps,
        and only the per-sample ``delta`` crosses to the host, where the
        batch's largest decides whether the next rung runs."""
        lad = self.ladder
        x1, x2 = self._to_device(img1, img2)
        if klass == "quality":
            flow, _ = self._rung_fns[(lad.rungs[-1], False)](x1, x2)
            self._synchronize()
            return flow, {"rungs": 1, "iterations": lad.rungs[-1]}

        flow, state = self._rung_fns[(lad.rungs[0], False)](x1, x2)
        executed, rungs = lad.rungs[0], 1
        if klass == "balanced":
            for inc in lad.increments():
                # the rung decision point: the host reads the convergence
                # norm between steps
                if state["delta"].max().item() <= lad.threshold:
                    break
                flow, state = self._rung_fns[(inc, True)](
                    x1, x2, state["flow"], state["hidden"])
                executed += inc
                rungs += 1
        self._synchronize()
        return flow, {"rungs": rungs, "iterations": executed}

    def run_video(self, img1, img2, carry=None):
        """One video batch; returns ``(flow, state, info)``.

        ``carry`` is the batch's previous-frame coarse flow (the
        scheduler's stacked per-member rows, host numpy or a tensor): the
        warm step projects it inside. ``carry=None`` runs the plain rung
        twin, a true cold start, bit for bit what the warm step gives on an
        all-zero carry. ``flow`` is a device tensor whose computation has
        finished; ``state`` stays on the device (the scheduler fetches its
        ``flow`` rows and stores them per client)."""
        if not self.video:
            raise RuntimeError("run_video needs a video=True session")
        x1, x2 = self._to_device(img1, img2)
        warm = carry is not None
        if warm:
            flow, state = self._warm_fn(
                x1, x2, torch.as_tensor(carry).to(self.device))
        else:
            flow, state = self._rung_fns[(self.warm_iterations, False)](
                x1, x2)
        self._synchronize()
        return flow, state, {"rungs": 1, "iterations": self.warm_iterations,
                             "warm": warm}

    def _to_device(self, img1, img2):
        return tuple(wire_.as_tensor(np.ascontiguousarray(x)).to(self.device)
                     for x in (img1, img2))

    def _synchronize(self):
        """The dispatch span must cover device compute: the stream is
        synchronised before a result is handed back."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def fetch(self, flow):
        """Device flow -> host numpy (the per-request ``device`` span)."""
        return flow.cpu().numpy()

    # -- warm-up --------------------------------------------------------------

    def warm_pool(self):
        """Run one zero batch per bucket at the serve batch size, in the
        wire's image dtype (builds the CUDA kernels and warms the
        convolution library before the first request); with a ladder,
        then the base rung, each continuation increment fed the base
        rung's carry, and the full budget, in JAX's order. Returns one
        outcome record per bucket and, with a ladder, one per (bucket,
        rung), the rung named ``base:N``, ``cont:+N`` or ``full:N`` (and
        its ``quant`` where set)."""
        dtype = (self.wire.image_dtype() if self.wire is not None
                 else torch.float32)
        outcomes = []

        def record(bucket, rung, step, run):
            t0 = time.perf_counter()
            out = run()
            self._synchronize()
            outcome = {
                "model": self.spec.id,
                "bucket": bucket,
                "wire": (self.wire.describe() if self.wire is not None
                         else "f32 host-normalized"),
                "batch": self.batch_size,
                "device": str(self.device),
                "seconds": round(time.perf_counter() - t0, 4),
            }
            if rung is not None:
                outcome["rung"] = rung
            if getattr(step, "quant", None):
                outcome["quant"] = step.quant
            outcomes.append(outcome)
            return out

        for h, w in self.buckets.sizes:
            bucket = f"{h}x{w}"
            img = torch.zeros((self.batch_size, h, w, 3), dtype=dtype,
                              device=self.device)
            record(bucket, None, self.eval_fn,
                   lambda: self.eval_fn(img, img))
            carry = None
            if self.ladder is not None:
                lad = self.ladder
                base = self._rung_fns[(lad.rungs[0], False)]
                _, carry = record(bucket, f"base:{lad.rungs[0]}", base,
                                  lambda: base(img, img))
                for inc in sorted(set(lad.increments())):
                    step = self._rung_fns[(inc, True)]
                    record(bucket, f"cont:+{inc}", step,
                           lambda: step(img, img, carry["flow"],
                                        carry["hidden"]))
                full = self._rung_fns[(lad.rungs[-1], False)]
                record(bucket, f"full:{lad.rungs[-1]}", full,
                       lambda: full(img, img))
            if not self.video:
                continue
            # the cold twin (with a ladder its base rung was it), then the
            # warm step fed the twin's carry (the coarse shape, without
            # knowing the model's downsampling factor)
            if carry is None:
                twin = self._rung_fns[(self.warm_iterations, False)]
                _, carry = record(bucket, f"base:{self.warm_iterations}",
                                  twin, lambda: twin(img, img))
            record(bucket, f"warm:{self.warm_iterations}", self._warm_fn,
                   lambda: self._warm_fn(img, img, carry["flow"]))
        return outcomes
