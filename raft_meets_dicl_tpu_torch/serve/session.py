"""One serving replica: model + weights on one device.

Counterpart of ``raft_meets_dicl_tpu/serve/session.py`` (plain path). The
session owns everything device-side: the model spec, its module on the
device (seeded initial weights, then a checkpoint's when one is given:
the port's or the JAX package's), the inference step (``evaluation.make_eval_fn``), and a warm-up
per bucket so that the first request does not pay the kernel build or the
first-call cost of the convolution library.

The session runs on ``device`` ("cuda" unless the caller asks for the
CPU); a CUDA device without CUDA raises rather than running elsewhere.
"""

import logging
import time

import numpy as np
import torch

from .. import evaluation
from ..models.input import ShapeBuckets
from ..strategy.checkpoint import Checkpoint

_LATER = {
    "wire": "wire formats",
    "mesh": "multi-device serving",
    "ladder": "the iteration ladder",
    "video": "video sessions",
    "quant": "the quantized matching tier",
}


class ServeSession:
    """Device-side half of the serving path.

    ``spec`` is a loaded ``models.ModelSpec``; ``buckets`` the canonical
    ``ShapeBuckets`` (explicit sizes required). Submitted images are raw
    un-normalized f32; :meth:`encode_image` normalizes them on the host.
    """

    def __init__(self, spec, buckets, wire=None, checkpoint=None,
                 batch_size=4, mesh=None, ladder=None, video=False,
                 quant=None, device="cuda"):
        for name, value in (("wire", wire), ("mesh", mesh), ("ladder", ladder),
                            ("video", video), ("quant", quant)):
            if value:
                raise NotImplementedError(
                    f"serving with {_LATER[name]} is not ported yet "
                    "(ROADMAP queue A)")

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
        # requests pad raw pixels then normalize, so bucket pad constants
        # translate into raw space
        self.buckets = buckets.raw_variant(self.input.clip, self.input.range)
        self.batch_size = int(batch_size)

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "serving on 'cuda' needs a CUDA device, and "
                "torch.cuda.is_available() is False; pass --device cpu to "
                "run on the CPU")
        self._init_variables(checkpoint)
        self.eval_fn = evaluation.make_eval_fn(self.model)

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
        """Raw un-normalized image -> host-normalized f32."""
        return self._normalize(img)

    # -- device work (dispatch thread) ---------------------------------------

    def run(self, img1, img2):
        """One batch (host NHWC f32 arrays) through the inference step;
        returns the final flow as a device tensor (NHWC, f32) whose
        computation has finished: the device stream is synchronised, so
        the dispatch span covers device compute."""
        x1 = torch.from_numpy(np.ascontiguousarray(img1)).to(self.device)
        x2 = torch.from_numpy(np.ascontiguousarray(img2)).to(self.device)
        _, flow = self.eval_fn(x1, x2)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return flow

    def fetch(self, flow):
        """Device flow -> host numpy (the per-request ``device`` span)."""
        return flow.cpu().numpy()

    # -- warm-up --------------------------------------------------------------

    def warm_pool(self):
        """Run one zero batch per bucket at the serve batch size (builds
        the CUDA kernels and warms the convolution library before the
        first request). Returns one outcome record per bucket."""
        outcomes = []
        for h, w in self.buckets.sizes:
            img = np.zeros((self.batch_size, h, w, 3), np.float32)
            t0 = time.perf_counter()
            self.run(img, img)
            outcomes.append({
                "model": self.spec.id,
                "bucket": f"{h}x{w}",
                "batch": self.batch_size,
                "device": str(self.device),
                "seconds": round(time.perf_counter() - t0, 4),
            })
        return outcomes
