"""Model input contract and the training loader.

Counterpart of ``raft_meets_dicl_tpu/models/input.py``. Host-side numpy
(NHWC float32 images): padding, the canonical serving shape buckets, the
``InputSpec`` clip/range/padding contract, and the data path's ``Input``
(clip + range + padding over a collection), its adapter (validation,
NHWC float32) and the batching ``Loader``, built on ``torch.utils.data``:
the epoch order and within-batch shuffle come from the loader's own numpy
generator, exactly as in the JAX ``Loader``, and a ``DataLoader`` decodes
the batches in worker processes and hands them over as CPU tensors
(pinned when asked, for a ``non_blocking`` copy to the card). With a wire
format (``models.wire``) the adapter encodes the un-normalized images in
the workers, and the loader's fetch heals: a sample that fails to decode
is retried, then a neighbour takes its place, within a budget.
With shape buckets (``InputSpec.apply(source, buckets)``) and
``group_by_shape`` the loader batches mixed resolutions as the JAX one
does: full same-shape batches first, the remainders at the end.
"""

import copy
import logging
import multiprocessing
import queue
import threading
from dataclasses import replace

import numpy as np
import torch
import torch.utils.data

from ..utils import env
from . import wire as wire_

# clip bound for non-finite flow values (the JAX ``FLOW_INF``)
FLOW_INF = 1e10


# numpy pad modes shared by every padding flavor; the aliases map the
# reference configs' torch-style names onto the equivalent numpy modes
_NUMPY_PAD_MODES = (
    "edge", "maximum", "mean", "median", "minimum", "reflect",
    "symmetric", "wrap",
)
_PAD_MODE_ALIASES = {
    "zeros": ("constant", {"constant_values": 0.0}),
    "ones": ("constant", {"constant_values": 1.0}),
    "torch.replicate": ("edge", {}),
    "torch.reflect": ("reflect", {}),
    "torch.circular": ("wrap", {}),
}


def _raw_pad_constant(value, clip, range):
    """Map a *normalized-space* constant padding value into raw space.

    Wire-format pipelines pad un-normalized values on the host; the
    device-side clip+scale must map the padding back onto the configured
    normalized constant, so the raw constant is the inverse normalization
    (clamped into the clip interval, which the normalization saturates
    anyway)."""
    rmin, rmax = range
    lo, hi = clip
    c = (value - rmin) / (rmax - rmin)
    return float(min(max(c, lo), hi))


def _pad_arrays(img1, img2, flow, valid, meta, pad_h, pad_w, mode, args):
    """Pad one NHWC sample batch by ``pad_h=(top, bottom)`` /
    ``pad_w=(left, right)``: images with ``mode``, flow/valid always
    zero-padded (padded pixels are invalid), metadata extents shifted."""
    ph1, ph2 = pad_h
    pw1, pw2 = pad_w

    pad4 = ((0, 0), (ph1, ph2), (pw1, pw2), (0, 0))
    pad3 = ((0, 0), (ph1, ph2), (pw1, pw2))

    img1 = np.pad(img1, pad4, mode=mode, **args)
    img2 = np.pad(img2, pad4, mode=mode, **args)

    if flow is not None:
        flow = np.pad(flow, pad4, mode="constant", constant_values=0)
        valid = np.pad(valid, pad3, mode="constant", constant_values=False)

    # new Metadata objects — sources may hand out the same instances on
    # every access (e.g. wrap_single), so in-place shifts would accumulate
    meta = [
        replace(
            m,
            original_extents=(
                (m.original_extents[0][0] + ph1, m.original_extents[0][1] + ph1),
                (m.original_extents[1][0] + pw1, m.original_extents[1][1] + pw1),
            ),
        )
        for m in meta
    ]

    return img1, img2, flow, valid, meta


class Padding:
    type = None

    @classmethod
    def _typecheck(cls, cfg):
        if cfg["type"] != cls.type:
            raise ValueError(f"invalid padding type '{cfg['type']}', expected '{cls.type}'")

    def get_config(self):
        raise NotImplementedError

    def apply(self, img1, img2, flow, valid, meta):
        raise NotImplementedError

    def __call__(self, img1, img2, flow, valid, meta):
        return self.apply(img1, img2, flow, valid, meta)

    def raw_variant(self, clip, range):
        """Variant for un-normalized (wire-format) pipelines.

        Constant padding values are defined in *normalized* space
        ("zeros" pads with normalized 0); when normalization moves into
        the device step, the host pads raw values, so constants must be
        mapped through the inverse normalization. Non-constant modes
        (edge/reflect/...) are value-independent and pass through.
        """
        return self


class ModuloPadding(Padding):
    """Pad images to a multiple of ``size`` with configurable alignment.

    Flow/valid are always zero-padded (padded pixels are invalid);
    ``meta.original_extents`` shifts so outputs can be cropped back.
    ``torch.replicate``/``torch.reflect``/``torch.circular`` mode aliases
    from reference configs map onto the equivalent numpy modes.
    """

    type = "modulo"

    _NUMPY_MODES = _NUMPY_PAD_MODES
    _ALIASES = _PAD_MODE_ALIASES

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        size = [int(x) for x in cfg["size"]]
        if len(size) != 2:
            raise ValueError("expected list/tuple of 2 integers for attribute 'size'")

        return cls(
            cfg["mode"],
            size,
            align_hz=cfg.get("align-horizontal", "left"),
            align_vt=cfg.get("align-vertical", "top"),
        )

    def __init__(self, mode, size, align_hz="left", align_vt="top"):
        super().__init__()

        if mode not in self._NUMPY_MODES and mode not in self._ALIASES:
            raise ValueError(f"invalid padding mode: {mode}")
        if align_hz not in ("left", "center", "right"):
            raise ValueError(f"invalid horizontal alignment for padding: {align_hz}")
        if align_vt not in ("bottom", "center", "top"):
            raise ValueError(f"invalid vertical alignment for padding: {align_vt}")

        self.mode = mode
        self.size = size
        self.align_hz = align_hz
        self.align_vt = align_vt

    def get_config(self):
        return {
            "type": self.type,
            "mode": self.mode,
            "size": self.size,
            "align-horizontal": self.align_hz,
            "align-vertical": self.align_vt,
        }

    def _split(self, total, align_lo_name, align):
        if align == align_lo_name:
            return 0, total
        if align == "center":
            return total // 2, total - total // 2
        return total, 0

    def raw_variant(self, clip, range):
        mode, args = self._ALIASES.get(self.mode, (self.mode, {}))
        if "constant_values" not in args:
            return self
        out = copy.copy(self)
        # raw-space constant, clipped into the clip interval so the
        # device-side clip+scale maps it back to the normalized constant
        out._raw_constant = _raw_pad_constant(
            args["constant_values"], clip, range)
        return out

    def apply(self, img1, img2, flow, valid, meta):
        mode, args = self._ALIASES.get(self.mode, (self.mode, {}))
        raw = getattr(self, "_raw_constant", None)
        if raw is not None and "constant_values" in args:
            args = dict(args, constant_values=raw)

        _, h, w, _ = img1.shape
        new_h = -(-h // self.size[1]) * self.size[1]
        new_w = -(-w // self.size[0]) * self.size[0]
        if (new_h, new_w) == (h, w):
            # already aligned: np.pad with zero widths would still copy
            # every array
            return img1, img2, flow, valid, meta

        pad_h = self._split(new_h - h, "top", self.align_vt)
        pad_w = self._split(new_w - w, "left", self.align_hz)

        return _pad_arrays(img1, img2, flow, valid, meta, pad_h, pad_w,
                           mode, args)


_PADDINGS = {ModuloPadding.type: ModuloPadding}


def _build_padding(cfg):
    if cfg is None:
        return None
    return _PADDINGS[cfg["type"]].from_config(cfg)


class ShapeBuckets:
    """Canonical evaluation shapes: quantize mixed per-sample resolutions
    up to a small fixed set so a whole sweep runs at most ``len(sizes)``
    device shapes instead of one per distinct padded shape.

    Each sample is padded (bottom/right, so ``meta.original_extents``
    stays put) from its modulo-padded size up to the smallest configured
    bucket that fits; the ``valid`` mask is extended with ``False`` over
    the padded pixels, so masked metrics (EPE, Fl-all, the masked losses)
    provably never see them. An empty ``sizes`` list is the pure
    *grouping* policy (no quantization pad), which the data path's loader
    uses; serving needs explicit sizes.

    Assignment is deterministic: buckets are ordered by (area, height,
    width) and the first one that fits both dimensions wins; samples
    larger than every bucket keep their own shape (they batch among
    themselves at their own shape).
    """

    def __init__(self, sizes=(), mode="zeros"):
        if mode not in _NUMPY_PAD_MODES and mode not in _PAD_MODE_ALIASES:
            raise ValueError(f"invalid bucket padding mode: {mode}")

        parsed = []
        for hw in sizes:
            h, w = (int(x) for x in hw)
            if h <= 0 or w <= 0:
                raise ValueError(f"invalid bucket size {hw!r}")
            parsed.append((h, w))

        self.sizes = sorted(set(parsed), key=lambda s: (s[0] * s[1], s))
        self.mode = mode

    @classmethod
    def from_config(cls, cfg):
        """``None`` | spec string (see :meth:`parse`) | mapping with
        ``sizes`` (list of [H, W]) and optional ``mode``."""
        if cfg is None:
            return None
        if isinstance(cfg, str):
            return cls.parse(cfg)
        if isinstance(cfg, (list, tuple)):
            return cls(cfg)
        return cls(cfg.get("sizes", ()), cfg.get("mode", "zeros"))

    @classmethod
    def parse(cls, spec):
        """CLI/env spec: ``'group'`` (shape grouping only) or a
        comma-separated ``HxW`` list, e.g. ``'384x1280,448x1024'``."""
        spec = spec.strip()
        if not spec:
            return None
        if spec in ("group", "shape"):
            return cls(())
        sizes = []
        for part in spec.split(","):
            try:
                h, w = part.strip().lower().split("x")
                sizes.append((int(h), int(w)))
            except ValueError:
                raise ValueError(
                    f"invalid bucket spec '{part.strip()}' in '{spec}': "
                    "expected 'group' or a comma-separated HxW list "
                    "like '384x1280,448x1024'") from None
        return cls(sizes)

    def get_config(self):
        return {"sizes": [list(s) for s in self.sizes], "mode": self.mode}

    def describe(self):
        if not self.sizes:
            return "group-by-shape (no canonical sizes)"
        return ", ".join(f"{h}x{w}" for h, w in self.sizes)

    def assign(self, h, w):
        """Smallest-area bucket fitting an (h, w) sample, or None when no
        bucket fits (the sample keeps its own shape)."""
        for bh, bw in self.sizes:
            if bh >= h and bw >= w:
                return bh, bw
        return None

    def check_compatible(self, padding):
        """Every bucket must satisfy the model's modulo constraint, else
        the quantized shapes would be rejected by the network's pyramid —
        fail at config time with the offending bucket named."""
        if padding is None or not isinstance(padding, ModuloPadding):
            return
        mw, mh = padding.size  # config order: (w multiple, h multiple)
        for bh, bw in self.sizes:
            if bh % mh or bw % mw:
                raise ValueError(
                    f"bucket {bh}x{bw} is not a multiple of the input "
                    f"padding size {mh}x{mw} (h x w): the model would "
                    "reject the quantized shape")

    def raw_variant(self, clip, range):
        """Variant for un-normalized (wire-format) pipelines: constant
        padding values translate into raw space (see ModuloPadding)."""
        mode, args = _PAD_MODE_ALIASES.get(self.mode, (self.mode, {}))
        if "constant_values" not in args:
            return self
        out = ShapeBuckets(self.sizes, self.mode)
        out._raw_constant = _raw_pad_constant(
            args["constant_values"], clip, range)
        return out

    def pad_image(self, img, bucket):
        """Pad a single HWC (or NHWC) image up to ``bucket`` bottom/right.

        The serving admission path pads each request's images directly to
        their assigned bucket (``check_compatible`` guarantees buckets
        satisfy the model's modulo constraint, so no intermediate modulo
        pad is needed); on a ``raw_variant`` the constant translates into
        raw space exactly like the batch path.
        """
        h, w = img.shape[-3], img.shape[-2]
        bh, bw = bucket
        if (h, w) == (bh, bw):
            return img

        mode, args = _PAD_MODE_ALIASES.get(self.mode, (self.mode, {}))
        raw = getattr(self, "_raw_constant", None)
        if raw is not None and "constant_values" in args:
            args = dict(args, constant_values=raw)

        pad = [(0, 0)] * (img.ndim - 3) + [(0, bh - h), (0, bw - w), (0, 0)]
        return np.pad(img, pad, mode=mode, **args)

    def pad(self, img1, img2, flow, valid, meta):
        """Pad one sample batch up to its bucket (no-op when no bucket
        fits or the sample already sits on one)."""
        _, h, w, _ = img1.shape
        bucket = self.assign(h, w)
        if bucket is None or bucket == (h, w):
            return img1, img2, flow, valid, meta

        mode, args = _PAD_MODE_ALIASES.get(self.mode, (self.mode, {}))
        raw = getattr(self, "_raw_constant", None)
        if raw is not None and "constant_values" in args:
            args = dict(args, constant_values=raw)

        bh, bw = bucket
        return _pad_arrays(img1, img2, flow, valid, meta,
                           (0, bh - h), (0, bw - w), mode, args)

    def __call__(self, img1, img2, flow, valid, meta):
        return self.pad(img1, img2, flow, valid, meta)


class InputSpec:
    """Model input contract: clip range, value range, optional padding."""

    @classmethod
    def from_config(cls, cfg):
        cfg = cfg if cfg is not None else {}

        clip = [float(x) for x in cfg.get("clip", (0, 1))]
        if len(clip) != 2:
            raise ValueError("invalid value for 'clip', expected list/tuple of two floats")

        range_ = cfg.get("range", (-1, 1))
        if len(range_) != 2:
            raise ValueError("invalid value for 'range', expected list/tuple of two floats")

        return cls(clip, range_, _build_padding(cfg.get("padding")))

    def __init__(self, clip=(0.0, 1.0), range=(-1.0, 1.0), padding=None):
        self.clip = clip
        self.range = range
        self.padding = padding

    def apply(self, source, buckets=None, normalize=True):
        """Wrap a collection in this input contract (the JAX
        ``InputSpec.apply``). ``buckets`` (a ShapeBuckets) quantizes each
        sample's padded size up to a canonical bucket for mixed-resolution
        batching; ``normalize=False`` keeps raw pixel values for a wire
        format (padding constants mapped into raw space)."""
        return Input(source, self.clip, self.range, self.padding,
                     normalize=normalize, buckets=buckets)

    def get_config(self):
        return {
            "clip": self.clip,
            "range": self.range,
            "padding": self.padding.get_config() if self.padding is not None else None,
        }


class Input:
    """Applies clip + range scaling (unless ``normalize=False``, for a wire
    format that normalizes on the device) + padding, then the shape
    buckets' pad, over a Collection. The buckets must be multiples of the
    padding's modulo (``ShapeBuckets.check_compatible``)."""

    def __init__(self, source, clip=(0.0, 1.0), range=(-1.0, 1.0),
                 padding=None, normalize=True, buckets=None):
        self.source = source
        self.clip = clip
        self.range = range
        self.normalize = normalize
        self.padding = padding
        if padding is not None and not normalize:
            self.padding = padding.raw_variant(clip, range)
        if buckets is not None:
            buckets.check_compatible(padding)
            if not normalize:
                buckets = buckets.raw_variant(clip, range)
        self.buckets = buckets

    def __getitem__(self, index):
        img1, img2, flow, valid, meta = self.source[index]

        if self.normalize:
            lo, hi = self.clip
            rmin, rmax = self.range
            img1 = (rmax - rmin) * np.clip(img1, lo, hi) + rmin
            img2 = (rmax - rmin) * np.clip(img2, lo, hi) + rmin

        if self.padding is not None:
            img1, img2, flow, valid, meta = self.padding(img1, img2, flow, valid, meta)

        if self.buckets is not None:
            img1, img2, flow, valid, meta = self.buckets(img1, img2, flow, valid, meta)

        return img1, img2, flow, valid, meta

    def __len__(self):
        return len(self.source)

    def torch(self, flow=True, wire=None, wire_targets=False):
        return TorchAdapter(self, flow, wire=wire, wire_targets=wire_targets)


class TorchAdapter:
    """Validates samples and normalizes them to NHWC float32 numpy (the JAX
    ``JaxAdapter``). Non-finite images or flow, or empty valid masks, mark
    the whole sample batch invalid via ``meta.valid``; the trainer skips
    those batches with a warning. With ``flow=False`` no flow or valid
    mask is returned (both None).

    With ``wire`` (a ``models.wire.WireFormat`` over an un-normalized
    ``Input``) the images are encoded to the wire dtype here, in the
    loader's workers, so that the compact form is what crosses processes
    and the host→device copy. Flow and valid stay exact for the host's
    metrics, unless ``wire_targets``: training, where nothing on the host
    reads them, has them compressed here too (f16, bit-packed), which JAX
    does at its device put, in its prefetch thread; either way off the
    training loop's thread.
    """

    def __init__(self, source, flow=True, wire=None, wire_targets=False):
        self.source = source
        self.flow = flow
        self.wire = wire
        self.wire_targets = wire is not None and wire_targets
        self.log = logging.getLogger("data:torch-adapter")

    def __getitem__(self, index):
        img1, img2, flow, valid, meta = self.source[index]
        self._validate_images(img1, img2, meta)

        if self.wire is not None:
            img1 = self.wire.encode_image(img1)
            img2 = self.wire.encode_image(img2)
        else:
            img1 = np.ascontiguousarray(img1, dtype=np.float32)
            img2 = np.ascontiguousarray(img2, dtype=np.float32)

        if not self.flow:
            return img1, img2, None, None, meta

        assert flow is not None and valid is not None
        self._validate_flow(flow, valid, meta)

        flow = np.nan_to_num(flow, nan=0.0, posinf=FLOW_INF, neginf=-FLOW_INF)
        flow = np.clip(flow, -FLOW_INF, FLOW_INF)

        flow = np.ascontiguousarray(flow, dtype=np.float32)
        valid = np.ascontiguousarray(valid, dtype=bool)
        if self.wire_targets:
            flow = self.wire.encode_flow(flow)
            valid = self.wire.encode_valid(valid)

        return img1, img2, flow, valid, meta

    def _mark_invalid(self, meta, which, bad_mask):
        for i, bad in enumerate(bad_mask):
            if bad:
                self.log.warning(f"{which}: {meta[i].sample_id}")
        for m in meta:
            m.valid = False

    def _validate_images(self, img1, img2, meta):
        bad1 = ~np.all(np.isfinite(img1), axis=(1, 2, 3))
        if bad1.any():
            self._mark_invalid(meta, "non-finite values in img1 detected", bad1)

        bad2 = ~np.all(np.isfinite(img2), axis=(1, 2, 3))
        if bad2.any():
            self._mark_invalid(meta, "non-finite values in img2 detected", bad2)

    def _validate_flow(self, flow, valid, meta):
        no_valid = ~np.any(valid, axis=(1, 2))
        if no_valid.any():
            self._mark_invalid(meta, "sample contains no valid flow pixels", no_valid)

        nonfinite = np.array(
            [not np.all(np.isfinite(flow[b][valid[b]])) for b in range(flow.shape[0])]
        )
        if nonfinite.any():
            self._mark_invalid(meta, "non-finite values in flow detected", nonfinite)

    def __len__(self):
        return len(self.source)

    def loader(self, batch_size=1, shuffle=False, num_workers=4,
               drop_last=False, seed=None, pin_memory=False,
               group_by_shape=False, procs=None, retries=None,
               bad_sample_budget=None):
        # no **kwargs catch-all: unknown loader arguments (typos in stage
        # configs) must fail loudly instead of being silently dropped
        return Loader(self, batch_size, shuffle, num_workers, drop_last,
                      seed, pin_memory, group_by_shape, procs=procs,
                      retries=retries, bad_sample_budget=bad_sample_budget)


def _check_shapes(samples):
    base = samples[0][0].shape[1:]
    for s in samples[1:]:
        if s[0].shape[1:] != base:
            def describe(smp, shape):
                meta = smp[4]
                ds = meta[0].dataset_id if meta and hasattr(
                    meta[0], "dataset_id") else "<unknown dataset>"
                return f"{shape[0]}x{shape[1]} (dataset '{ds}')"
            raise ValueError(
                "cannot batch samples of mixed shapes: "
                f"{describe(samples[0], base)} vs "
                f"{describe(s, s[0].shape[1:])} — use shape buckets "
                "(--buckets / RMD_EVAL_BUCKETS / loader "
                "group_by_shape=True) or batch size 1 for "
                "mixed-resolution datasets")


def collate(samples, shuffle=False, rng=None):
    """Concatenate pre-batched samples into one global batch (numpy),
    optionally shuffled within the batch (the JAX ``collate``); flow and
    valid stay None for flow-less samples."""
    _check_shapes(samples)

    img1 = np.concatenate([s[0] for s in samples], axis=0)
    img2 = np.concatenate([s[1] for s in samples], axis=0)

    if samples[0][2] is not None:
        flow = np.concatenate([s[2] for s in samples], axis=0)
        valid = np.concatenate([s[3] for s in samples], axis=0)
    else:
        flow, valid = None, None

    meta = [m for s in samples for m in s[4]]

    if shuffle and img1.shape[0] > 1:
        rng = rng if rng is not None else np.random
        perm = rng.permutation(img1.shape[0])
        img1, img2 = img1[perm], img2[perm]
        if flow is not None:
            flow, valid = flow[perm], valid[perm]
        meta = [meta[i] for i in perm]

    return img1, img2, flow, valid, meta


def _from_numpy(x):
    return None if x is None else torch.from_numpy(x)


def _collate_tensors(samples):
    """``DataLoader`` collate, in a worker: the samples concatenated in
    index order (the caller shuffles the batch within itself); wire images
    keep their dtype (bf16 bit patterns become a bfloat16 tensor)."""
    img1, img2, flow, valid, meta = collate(samples)
    return (wire_.as_tensor(img1), wire_.as_tensor(img2),
            _from_numpy(flow), _from_numpy(valid), meta)


def _cat_tensors(samples):
    """Concatenate tensor samples of one shape, in order."""
    _check_shapes(samples)
    img1 = torch.cat([s[0] for s in samples])
    img2 = torch.cat([s[1] for s in samples])
    flow = valid = None
    if samples[0][2] is not None:
        flow = torch.cat([s[2] for s in samples])
        valid = torch.cat([s[3] for s in samples])
    return img1, img2, flow, valid, [m for s in samples for m in s[4]]


def _in_background(items, depth):
    """Iterate ``items`` in a background thread, up to ``depth`` ahead, in
    order. An exception raised there is raised in the caller; closing the
    generator stops the thread and waits for it."""
    results = queue.Queue(depth)
    stop = threading.Event()
    end = object()

    def put(entry):
        while not stop.is_set():
            try:
                results.put(entry, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def run():
        try:
            for item in items:
                if not put((item, None)):
                    return
            put((end, None))
        except Exception as e:  # noqa: BLE001 - raised in the caller
            put((end, e))

    thread = threading.Thread(target=run, name="loader-shuffle", daemon=True)
    thread.start()
    try:
        while True:
            item, error = results.get()
            if error is not None:
                raise error
            if item is end:
                return
            yield item
    finally:
        stop.set()
        thread.join()


def _shut_down(loader):
    """Stop a ``DataLoader`` iterator's workers now. After a worker's error
    the iterator sits in a reference cycle with the traceback, and the
    garbage collector's shutdown then waits out each worker's 5 s status
    poll."""
    stop = getattr(loader, "_shutdown_workers", None)
    if stop is not None:
        stop()


class _Healing(torch.utils.data.Dataset):
    """The dataset the ``DataLoader`` workers read: each index through
    the loader's healing fetch."""

    def __init__(self, loader):
        self.loader = loader

    def __getitem__(self, index):
        return self.loader._fetch(index)

    def __len__(self):
        return len(self.loader.source)


class Loader:
    """Batching iterator over an adapter on ``torch.utils.data``.

    The epoch order reshuffles on every ``__iter__`` when ``shuffle`` is
    set, and each batch is shuffled within itself after its samples are
    concatenated, both drawn from the loader's own numpy generator in the
    JAX ``Loader``'s order (the epoch permutation, then one permutation of
    each collated batch, batch by batch), so the same seed gives the same
    batches as the JAX package, also for sources that yield more than one
    pair per index (``forwards-backwards-batch`` yields two). Without an
    explicit ``seed`` the generator is seeded from the global numpy RNG,
    so run-level seeding (``utils.seeds``) still makes data order
    reproducible.

    Batches are ``(img1, img2, flow, valid, meta)`` with NHWC float32 CPU
    tensors (``valid`` bool), decoded by ``num_workers`` worker processes
    (0 decodes in the caller) forked anew at every ``__iter__``, so they
    inherit the source's state as it is then (``Collection.set_epoch``).
    With workers, a shuffled batch's permutation is drawn and gathered by
    a thread of the caller's process, in batch order, as many batches
    ahead as the workers have in flight (two each).
    With ``pin_memory`` the batches are in pinned memory: copied there
    after the gather, or by ``torch.utils.data``'s pinning thread when
    nothing is shuffled.

    ``group_by_shape`` reorders the epoch into full same-shape batches, as
    the JAX ``Loader._iter_grouped`` does: samples are fetched in epoch
    order, one index at a time (the ``DataLoader``'s sampler hands the
    workers single indices), buffered per (H, W) in the caller's process
    and a batch is emitted whenever one shape's buffer fills; partial
    buffers flush at the end, first-seen shape first (dropped under
    ``drop_last``). Within a batch the epoch order, and with it the
    ``meta`` order, is kept; a shuffled batch is then permuted as above.
    With workers the grouping runs in a thread of the caller's process.

    ``procs > 0`` sets the number of worker processes (the JAX Loader's
    decode processes; the port's workers are processes already), ``None``
    reads ``RMD_LOADER_PROCS`` (0 or unset: ``num_workers``).

    The fetch heals as the JAX ``Loader._fetch`` does: a sample whose
    decode raises is tried ``retries + 1`` times, then the neighbours
    ``(i + k) % n`` for ``k < min(n, 8)`` are tried in its place. Every
    sample given up on counts against ``bad_sample_budget`` over the
    loader's whole life (a ``multiprocessing.Value`` made here, before the
    workers fork, so that the count outlives each epoch's workers); going
    over the budget raises ``RuntimeError``, and a budget of 0 re-raises
    the sample's own error. Defaults: ``RMD_LOADER_RETRIES`` (2) and
    ``RMD_BAD_SAMPLE_BUDGET`` (16).
    """

    def __init__(self, source, batch_size=1, shuffle=False, num_workers=4,
                 drop_last=False, seed=None, pin_memory=False,
                 group_by_shape=False, procs=None, retries=None,
                 bad_sample_budget=None):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        if procs is None:
            procs = env.get_int("RMD_LOADER_PROCS")
        self.num_workers = int(procs) if int(procs) > 0 else num_workers
        self.drop_last = drop_last
        self.pin_memory = pin_memory
        self.group_by_shape = bool(group_by_shape)
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        self.rng = np.random.default_rng(seed)

        if retries is None:
            retries = env.get_int("RMD_LOADER_RETRIES",
                                  env.LOADER_RETRIES_DEFAULT)
        self.retries = max(0, int(retries))
        if bad_sample_budget is None:
            bad_sample_budget = env.get_int("RMD_BAD_SAMPLE_BUDGET",
                                            env.BAD_SAMPLE_BUDGET_DEFAULT)
        self.bad_sample_budget = max(0, int(bad_sample_budget))
        self._bad = multiprocessing.Value("i", 0)
        self._fetching = _Healing(self)

    @property
    def bad_samples(self):
        """Samples given up on (substituted) so far, over every epoch."""
        return self._bad.value

    def _note_bad_sample(self, index, error):
        if self.bad_sample_budget <= 0:
            # budget 0 = healing off: the original error propagates as-is
            raise error
        with self._bad.get_lock():
            self._bad.value += 1
            bad = self._bad.value
        logging.getLogger("data:loader").warning(
            f"sample {index} failed to decode after {self.retries + 1} "
            f"attempt(s) ({type(error).__name__}: {error}); substituting a "
            f"neighbor ({bad}/{self.bad_sample_budget} bad-sample budget)")
        if bad > self.bad_sample_budget:
            raise RuntimeError(
                f"bad-sample budget exceeded ({bad} > "
                f"{self.bad_sample_budget}): the input data is "
                "persistently failing to decode") from error

    def _fetch(self, index):
        """``source[index]`` with bounded retry, then substitution (the
        JAX ``Loader._fetch``)."""
        index = int(index)
        last = None
        for _ in range(self.retries + 1):
            try:
                return self.source[index]
            except Exception as e:  # noqa: BLE001 - a sample's decode error
                last = e
        self._note_bad_sample(index, last)

        n = len(self.source)
        for k in range(1, min(n, 8)):
            sub = (index + k) % n
            try:
                return self.source[sub]
            except Exception as e:  # noqa: BLE001 - a sample's decode error
                self._note_bad_sample(sub, e)
        raise RuntimeError(
            f"sample {index} and every substitution candidate failed to "
            "decode") from last

    def __len__(self):
        n = len(self.source)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self):
        n = len(self.source)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)

        batches = []
        for start in range(0, n, self.batch_size):
            chunk = order[start: start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            batches.append([int(i) for i in chunk])
        return batches

    def _shuffle(self, batch):
        """The JAX ``collate``'s within-batch permutation of a collated
        batch (none for a single pair or without ``shuffle``), then pinned
        if ``pin_memory``."""
        img1, img2, flow, valid, meta = batch
        perm = None
        if self.shuffle and img1.shape[0] > 1:
            perm = self.rng.permutation(img1.shape[0])
            index = torch.from_numpy(perm)
            meta = [meta[i] for i in perm]

        def gather(t):
            if t is None:
                return None
            if perm is not None:
                t = torch.index_select(t, 0, index)
            # pinned by a copy: ``pin_memory()`` reuses the caching host
            # allocator's blocks, where ``torch.empty(pin_memory=True)``
            # gathered straight into pinned memory took longer a batch
            return t.pin_memory() if self.pin_memory else t

        return gather(img1), gather(img2), gather(flow), gather(valid), meta

    def _grouped(self, samples):
        """The JAX ``_iter_grouped`` over fetched tensor samples."""
        groups, seen = {}, []
        for sample in samples:
            key = tuple(sample[0].shape[1:3])
            if key not in groups:
                groups[key] = []
                seen.append(key)
            buf = groups[key]
            buf.append(sample)
            if sum(s[0].shape[0] for s in buf) >= self.batch_size:
                groups[key] = []
                yield self._shuffle(_cat_tensors(buf))

        if not self.drop_last:
            for key in seen:
                if groups[key]:
                    yield self._shuffle(_cat_tensors(groups[key]))

    def _iter_grouped(self):
        n = len(self.source)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        # one index a batch: the workers decode single samples, grouped
        # here; they start here, in the caller's thread
        samples = iter(torch.utils.data.DataLoader(
            self._fetching, batch_sampler=[[int(i)] for i in order],
            num_workers=self.num_workers, collate_fn=_collate_tensors))
        try:
            if self.num_workers <= 0:
                yield from self._grouped(samples)
            else:
                yield from _in_background(self._grouped(samples),
                                          depth=2 * self.num_workers)
        finally:
            _shut_down(samples)

    def __iter__(self):
        if self.group_by_shape:
            yield from self._iter_grouped()
            return

        loader = iter(torch.utils.data.DataLoader(
            self._fetching, batch_sampler=self._batches(),
            num_workers=self.num_workers, collate_fn=_collate_tensors,
            pin_memory=self.pin_memory and not self.shuffle))
        try:
            if not self.shuffle:
                yield from loader
            elif self.num_workers <= 0:
                yield from map(self._shuffle, loader)
            else:
                # as far ahead as the workers' batches in flight (two each)
                yield from _in_background(map(self._shuffle, loader),
                                          depth=2 * self.num_workers)
        finally:
            _shut_down(loader)
