"""Sequence runner: temporal warm start over a frame sequence
(counterpart of ``raft_meets_dicl_tpu/video/sequence.py``).

Walks consecutive frame pairs of one video, carrying the previous frame's
coarse flow (and optionally the GRU hidden state) into the next frame's
recurrence:

- **frame 0** runs the full-budget rung: there is no prior;
- **warm frames** enter through the warm-start step
  (``evaluation.make_warm_fn``: the bottom ladder rung, the previous flow
  projected inside the step) and escalate through the ``cont=True``
  continuation rungs only while the batch's largest flow-delta norm
  exceeds the ladder threshold: the balanced serve class's policy.

The runner measures what the warm-start claim needs: per-frame iterations
spent, wall seconds (each frame ends in a device synchronisation on the
card) and EPE when ground truth is given. JAX's ``video`` telemetry events
and compile counters are not ported (eager PyTorch compiles no programs;
telemetry is ROADMAP slice 7 item 7).
"""

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from .. import evaluation
from ..serve.ladder import LadderSpec
from .warmstart import project_flow


def fw_bw_flows(step, img1, img2):
    """Forward and backward flow in one doubled-batch call of ``step``.

    Runs ``[img1; img2]`` against ``[img2; img1]`` on the batch axis, so
    the forwards-backwards products cost one dispatch at twice the batch.
    ``step`` is any ``(a, b) -> flow`` or ``(a, b) -> (flow, ...)`` step
    (eval or rung); returns ``(flow_fw, flow_bw)`` at the input batch."""
    b = img1.shape[0]
    out = step(torch.cat([img1, img2], dim=0), torch.cat([img2, img1], dim=0))
    flow = out[0] if isinstance(out, tuple) else out
    return flow[:b], flow[b:]


@dataclass
class FrameResult:
    """One estimated frame pair of a sequence run."""
    frame: int
    flow: Optional[np.ndarray]  # full resolution (B, H, W, 2), on the host
    warm: bool
    iterations: int
    rungs: int
    seconds: float
    epe: Optional[float] = None
    carry: Any = None           # the device-side {"flow", "hidden", "delta"}


@dataclass
class SequenceResult:
    """A whole sequence run: per-frame results and their accounting."""
    frames: List[FrameResult] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def flows(self):
        return [f.flow for f in self.frames]

    def mean_iterations(self):
        if not self.frames:
            return 0.0
        return sum(f.iterations for f in self.frames) / len(self.frames)

    def mean_epe(self):
        vals = [f.epe for f in self.frames if f.epe is not None]
        return sum(vals) / len(vals) if vals else None

    def frames_per_sec(self):
        return len(self.frames) / self.seconds if self.seconds > 0 else 0.0

    def warm_frames(self):
        return sum(1 for f in self.frames if f.warm)


class SequenceRunner:
    """Builds the rung and warm steps once, then runs sequences.

    ``ladder`` defaults to the configured :class:`LadderSpec`
    (``RMD_LADDER``, ``RMD_LADDER_THRESHOLD``): warm frames start at
    ``rungs[0]`` and may escalate through the continuation increments up to
    ``rungs[-1]``; cold frames run the ``rungs[-1]`` rung.

    ``carry_hidden=True`` also threads the GRU hidden state across frames:
    warm frames then enter through a ``cont=True`` rung of ``rungs[0]`` fed
    ``(project_flow(prev_flow), prev_hidden)`` instead of the warm step.
    This gives up the zero-carry parity (a carried hidden has no cold
    equivalent) for a better prior. ``model`` is a loaded model whose
    module holds its weights on the device the frames are run on."""

    def __init__(self, model, ladder=None, model_args=None, wire=None,
                 carry_hidden=False):
        self.model = model
        self.ladder = ladder if ladder is not None else LadderSpec.from_config()
        self.carry_hidden = bool(carry_hidden)
        self.device = next(model.module.parameters()).device
        kw = dict(model_args=model_args, wire=wire)
        lad = self.ladder
        self._full = evaluation.make_rung_fn(model, lad.rungs[-1], **kw)
        self._warm = evaluation.make_warm_fn(model, lad.rungs[0], **kw)
        self._conts = {
            inc: evaluation.make_rung_fn(model, inc, cont=True, **kw)
            for inc in sorted(set(lad.increments()))}
        if self.carry_hidden:
            # the warm entry through a base-rung-sized continuation
            self._warm_cont = evaluation.make_rung_fn(
                model, lad.rungs[0], cont=True, **kw)

    def _epe(self, flow, target, valid=None):
        d = np.asarray(flow, np.float32) - np.asarray(target, np.float32)
        err = np.sqrt(np.sum(d * d, axis=-1))
        if valid is not None:
            v = np.asarray(valid, bool)
            return float(err[v].mean()) if v.any() else float("nan")
        return float(err.mean())

    def _run_frame(self, i1, i2, carry):
        """One frame pair: (flow, state, warm, iterations, rungs)."""
        lad = self.ladder
        if carry is None:
            flow, state = self._full(i1, i2)
            return flow, state, False, lad.rungs[-1], 1
        if self.carry_hidden:
            with torch.inference_mode():
                init = project_flow(carry["flow"])
            flow, state = self._warm_cont(i1, i2, init, carry["hidden"])
        else:
            flow, state = self._warm(i1, i2, carry["flow"])
        executed, rungs = lad.rungs[0], 1
        for inc in lad.increments():
            # the escalation decision reads the delta norm on the host
            if state["delta"].max().item() <= lad.threshold:
                break
            flow, state = self._conts[inc](i1, i2, state["flow"],
                                           state["hidden"])
            executed += inc
            rungs += 1
        return flow, state, True, executed, rungs

    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, frames, targets=None, valids=None, warm=True,
            keep_flows=True):
        """Walk ``frames`` (a list of (B, H, W, 3) arrays or tensors, in
        the model's input range) pairwise.

        ``targets``/``valids`` optionally give per-pair ground truth
        (``len(frames) - 1`` entries) for EPE. ``warm=False`` runs every
        pair cold through the full rung: the baseline of the cold-vs-warm
        comparison. Returns a :class:`SequenceResult`."""
        if len(frames) < 2:
            raise ValueError("a sequence needs at least two frames")
        result = SequenceResult()
        t_seq = time.perf_counter()
        carry = None
        for t in range(len(frames) - 1):
            i1 = torch.as_tensor(frames[t]).to(self.device)
            i2 = torch.as_tensor(frames[t + 1]).to(self.device)
            t0 = time.perf_counter()
            flow, state, was_warm, its, rungs = self._run_frame(
                i1, i2, carry if warm else None)
            # per-frame wall seconds are what this runner measures
            self._synchronize()
            dt = time.perf_counter() - t0
            host = flow.cpu().numpy() if (keep_flows or targets is not None) \
                else None
            epe = None
            if targets is not None:
                epe = self._epe(host, targets[t],
                                None if valids is None else valids[t])
            result.frames.append(FrameResult(
                frame=t, flow=host if keep_flows else None, warm=was_warm,
                iterations=its, rungs=rungs, seconds=dt, epe=epe,
                carry=state))
            carry = state
        result.seconds = time.perf_counter() - t_seq
        return result
