"""Data augmentation: 15 config-typed transforms over pre-batched samples.

Counterpart of the JAX package's ``data/augment.py``, an own copy of it.
Covers the reference augmentation set (src/data/augment.py, itself modeled
on the RAFT augmentor): color jitter (float and 8-bit variants),
random/center crop, flips, gaussian noise, occlusion eraser patches,
flow-magnitude restriction, dense/sparse linear/exponential scaling,
translation, and rotation.

All transforms are host-side numpy/cv2/scipy over ``(img1, img2, flow,
valid, meta)`` batches, run by the loader's worker processes; no kernel is
involved. Color jitter is implemented natively in numpy (HSV-based,
torchvision-style semantics: factor ranges, random op order,
symmetric-vs-asymmetric draw) rather than delegating to torchvision. The
numpy, cv2 and scipy calls are the JAX package's, on the same inputs, so
the same draws give the same arrays bit for bit.

Random draws go through an explicit ``numpy.random.Generator`` threaded into
``process`` — ``Augment`` derives it per sample from
``(seed, epoch, sample_id)``, so augmentation is reproducible whichever
worker process decodes a sample. ``seed: legacy`` in the config keeps the
historical unseeded behavior.
"""

import hashlib

import cv2
import numpy as np
import scipy.ndimage as ndimage

from .collection import Collection


class _LegacyRandom:
    """Generator-API shim over the module-level ``np.random`` state.

    Keeps ``seed: legacy`` configs (and direct ``aug(*sample)`` calls without
    an explicit Generator) byte-compatible with the historical draw sequence.
    """

    def random(self):
        return np.random.rand()

    def uniform(self, low=0.0, high=1.0, size=None):
        return np.random.uniform(low, high, size)

    def normal(self, loc=0.0, scale=1.0, size=None):
        return np.random.normal(loc, scale, size)

    def permutation(self, x):
        return np.random.permutation(x)

    def integers(self, low, high=None, size=None):
        return np.random.randint(low, high, size)


_LEGACY = _LegacyRandom()

_CV2_MODES = {
    "nearest": cv2.INTER_NEAREST,
    "linear": cv2.INTER_LINEAR,
    "cubic": cv2.INTER_CUBIC,
    "area": cv2.INTER_AREA,
}


class Augment(Collection):
    """Wraps a source Collection and applies an augmentation list.

    ``sync=True`` applies each transform once across the whole pre-batched
    sample (one random draw per batch); ``sync=False`` splits the batch and
    augments each sample independently.

    ``seed`` keys a per-sample ``np.random.Generator`` from
    ``(seed, epoch, sample_id)`` — the same sample in the same epoch draws the
    same augmentation regardless of iteration order, worker assignment, or
    resume point. The epoch is set by ``set_epoch`` before the loader's
    ``__iter__`` forks its worker processes, which inherit it.

    ``seed="legacy"`` restores the historical module-level ``np.random``
    draws. Each worker process has its own copy of that state, which
    ``torch.utils.data`` seeds per worker from the loader's base seed and
    the worker's id, so workers draw distinct sequences; legacy draws
    depend on which worker decodes a sample and are not reproducible
    batch for batch.
    """

    type = "augment"

    @classmethod
    def from_config(cls, path, cfg):
        from . import config as data_config

        cls._typecheck(cfg)

        augs = [build_augmentation(a) for a in (cfg["augmentations"] or [])]
        return cls(augs, data_config.load(path, cfg["source"]), cfg.get("sync", True),
                   cfg.get("seed", 0))

    def __init__(self, augmentations, source, sync=True, seed=0):
        super().__init__()
        self.augmentations = augmentations
        self.source = source
        self.sync = sync
        self.seed = seed
        self.epoch = 0

    def get_config(self):
        return {
            "type": self.type,
            "augmentations": [a.get_config() for a in self.augmentations],
            "source": self.source.get_config(),
            "sync": self.sync,
            "seed": self.seed,
        }

    def set_epoch(self, epoch):
        self.epoch = int(epoch)
        super().set_epoch(epoch)

    def _rng_for(self, meta):
        if self.seed == "legacy":
            return _LEGACY
        sid = hashlib.blake2s(
            f"{meta.dataset_id}/{meta.sample_id}".encode(), digest_size=8
        ).digest()
        return np.random.default_rng(
            (int(self.seed), self.epoch, int.from_bytes(sid, "little"))
        )

    def _apply(self, sample, rng):
        for aug in self.augmentations:
            sample = aug(*sample, rng=rng)
        return sample

    def __getitem__(self, index):
        img1, img2, flow, valid, meta = self.source[index]

        if self.sync:
            img1, img2, flow, valid, meta = self._apply(
                (img1, img2, flow, valid, meta), self._rng_for(meta[0])
            )
        else:
            parts = []
            for i in range(img1.shape[0]):
                f = flow[i : i + 1] if flow is not None else None
                v = valid[i : i + 1] if valid is not None else None
                parts.append(
                    self._apply((img1[i : i + 1], img2[i : i + 1], f, v, [meta[i]]),
                                self._rng_for(meta[i]))
                )

            img1 = np.concatenate([p[0] for p in parts], axis=0)
            img2 = np.concatenate([p[1] for p in parts], axis=0)
            if flow is not None:
                flow = np.concatenate([p[2] for p in parts], axis=0)
                valid = np.concatenate([p[3] for p in parts], axis=0)
            meta = [m for p in parts for m in p[4]]

        img1 = np.ascontiguousarray(img1)
        img2 = np.ascontiguousarray(img2)
        if flow is not None:
            flow = np.ascontiguousarray(flow)
            valid = np.ascontiguousarray(valid)

        return img1, img2, flow, valid, meta

    def __len__(self):
        return len(self.source)

    def description(self):
        return f"{self.source.description()}, augmented"


class Augmentation:
    type = None

    @classmethod
    def _typecheck(cls, cfg):
        if cfg["type"] != cls.type:
            raise ValueError(
                f"invalid augmentation type '{cfg['type']}', expected '{cls.type}'"
            )

    def get_config(self):
        raise NotImplementedError

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        raise NotImplementedError

    def __call__(self, img1, img2, flow, valid, meta, rng=None):
        return self.process(img1, img2, flow, valid, meta,
                            rng if rng is not None else _LEGACY)


# -- color jitter -----------------------------------------------------------


def _rgb_to_gray(img):
    # ITU-R 601 luma weights, as used by torchvision
    return img @ np.array([0.2989, 0.587, 0.114], dtype=img.dtype)


def _adjust_hue(img, shift):
    """Shift hue by ``shift`` (fraction of a full turn) via HSV round-trip."""
    hsv = cv2.cvtColor(np.clip(img, 0.0, 1.0).astype(np.float32), cv2.COLOR_RGB2HSV)
    hsv[..., 0] = (hsv[..., 0] + shift * 360.0) % 360.0
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def _jitter_once(img, params):
    """Apply brightness/contrast/saturation/hue factors in the drawn order."""
    order, b, c, s, h = params

    for op in order:
        if op == 0 and b is not None:
            img = img * b
        elif op == 1 and c is not None:
            mean = _rgb_to_gray(np.clip(img, 0.0, 1.0)).mean()
            img = c * img + (1 - c) * mean
        elif op == 2 and s is not None:
            gray = _rgb_to_gray(np.clip(img, 0.0, 1.0))[..., None]
            img = s * img + (1 - s) * gray
        elif op == 3 and h is not None:
            shape = img.shape
            img = _adjust_hue(img.reshape(-1, shape[-2], 3), h).reshape(shape)

    return np.clip(img, 0.0, 1.0).astype(np.float32)


class ColorJitter(Augmentation):
    """Photometric jitter with torchvision-style factor semantics.

    With probability ``prob-asymmetric`` the two frames get independent
    draws; otherwise one draw is shared (symmetric).
    """

    type = "color-jitter"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(
            cfg["prob-asymmetric"],
            cfg["brightness"],
            cfg["contrast"],
            cfg["saturation"],
            cfg["hue"],
        )

    def __init__(self, prob_asymmetric, brightness, contrast, saturation, hue):
        super().__init__()
        self.prob_asymmetric = prob_asymmetric
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def get_config(self):
        return {
            "type": self.type,
            "prob-asymmetric": self.prob_asymmetric,
            "brightness": self.brightness,
            "contrast": self.contrast,
            "saturation": self.saturation,
            "hue": self.hue,
        }

    @staticmethod
    def _factor_range(value, center=1.0, lower_bound=0.0):
        if value is None or (np.isscalar(value) and value == 0):
            return None
        if isinstance(value, (list, tuple)):
            return float(value[0]), float(value[1])
        return max(lower_bound, center - float(value)), center + float(value)

    def _draw(self, rng):
        b = self._factor_range(self.brightness)
        c = self._factor_range(self.contrast)
        s = self._factor_range(self.saturation)
        h = (
            (-float(self.hue), float(self.hue))
            if np.isscalar(self.hue)
            else tuple(map(float, self.hue))
        ) if self.hue else None

        return (
            rng.permutation(4),
            rng.uniform(*b) if b else None,
            rng.uniform(*c) if c else None,
            rng.uniform(*s) if s else None,
            rng.uniform(*h) if h else None,
        )

    def _transform(self, img, rng):
        return _jitter_once(img, self._draw(rng))

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        if rng.random() < self.prob_asymmetric:
            img1 = self._transform(img1, rng)
            img2 = self._transform(img2, rng)
        else:
            stack = _jitter_once(np.stack((img1, img2)), self._draw(rng))
            img1, img2 = stack[0], stack[1]

        return img1, img2, flow, valid, meta


class ColorJitter8bit(ColorJitter):
    """Color jitter with an 8-bit quantization round-trip (RAFT parity)."""

    type = "color-jitter-8bit"

    @staticmethod
    def _quantize(img):
        return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)

    def _transform(self, img, rng):
        img = self._quantize(img).astype(np.float32) / 255.0
        img = _jitter_once(img, self._draw(rng))
        return self._quantize(img).astype(np.float32) / 255.0

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        if rng.random() < self.prob_asymmetric:
            img1 = self._transform(img1, rng)
            img2 = self._transform(img2, rng)
        else:
            stack = self._transform(np.stack((img1, img2)), rng)
            img1, img2 = stack[0], stack[1]

        return img1, img2, flow, valid, meta


# -- geometric transforms ---------------------------------------------------


def _crop(img1, img2, flow, valid, meta, x0, y0, w, h):
    img1 = img1[:, y0 : y0 + h, x0 : x0 + w]
    img2 = img2[:, y0 : y0 + h, x0 : x0 + w]
    if flow is not None:
        flow = flow[:, y0 : y0 + h, x0 : x0 + w]
        valid = valid[:, y0 : y0 + h, x0 : x0 + w]

    for m in meta:
        m.original_extents = ((0, h), (0, w))

    return img1, img2, flow, valid, meta


class Crop(Augmentation):
    """Random crop to ``size`` = (width, height)."""

    type = "crop"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        size = list(cfg["size"])
        if len(size) != 2:
            raise ValueError("invalid crop size, expected list or tuple with two elements")
        return cls(size)

    def __init__(self, size):
        super().__init__()
        self.size = size

    def get_config(self):
        return {"type": self.type, "size": self.size}

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        assert img1.shape[:3] == img2.shape[:3]

        w, h = self.size
        mx = img1.shape[2] - w
        my = img1.shape[1] - h
        x0 = rng.integers(0, mx) if mx > 0 else 0
        y0 = rng.integers(0, my) if my > 0 else 0

        return _crop(img1, img2, flow, valid, meta, x0, y0, w, h)


class CropCenter(Crop):
    type = "crop-center"

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        assert img1.shape[:3] == img2.shape[:3]

        w, h = self.size
        x0 = (img1.shape[2] - w) // 2
        y0 = (img1.shape[1] - h) // 2

        return _crop(img1, img2, flow, valid, meta, x0, y0, w, h)


class Flip(Augmentation):
    """Independent horizontal/vertical flips; flow components change sign."""

    type = "flip"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        prob = list(cfg["probability"])
        if len(prob) != 2:
            raise ValueError("invalid flip probability, expected two elements")
        return cls(prob)

    def __init__(self, probability):
        super().__init__()
        self.probability = probability

    def get_config(self):
        return {"type": self.type, "probability": self.probability}

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        if rng.random() < self.probability[0]:  # horizontal
            img1, img2 = img1[:, :, ::-1], img2[:, :, ::-1]
            if flow is not None:
                flow = flow[:, :, ::-1] * (-1.0, 1.0)
                valid = valid[:, :, ::-1]

        if rng.random() < self.probability[1]:  # vertical
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            if flow is not None:
                flow = flow[:, ::-1] * (1.0, -1.0)
                valid = valid[:, ::-1]

        return img1, img2, flow, valid, meta


class NoiseNormal(Augmentation):
    type = "noise-normal"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        stddev = cfg["stddev"]
        if isinstance(stddev, list):
            if len(stddev) > 2:
                raise ValueError("invalid stddev, expected float or two floats")
        else:
            stddev = [float(stddev), float(stddev)]
        return cls(stddev)

    def __init__(self, stddev):
        super().__init__()
        self.stddev = stddev

    def get_config(self):
        return {"type": self.type, "stddev": self.stddev}

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        if self.stddev[0] < self.stddev[1]:
            stddev = rng.uniform(self.stddev[0], self.stddev[1])
        else:
            stddev = self.stddev[0]

        img1 = np.clip(img1 + rng.normal(0.0, stddev, img1.shape), 0.0, 1.0)
        img2 = np.clip(img2 + rng.normal(0.0, stddev, img2.shape), 0.0, 1.0)

        return img1, img2, flow, valid, meta


class _Occlusion(Augmentation):
    """Eraser patches filled with the image mean color (RAFT-style).

    With skew correction, patch corners may lie outside the image so the
    occluded-area distribution is uniform near borders.
    """

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        num = cfg["num"]
        if isinstance(num, list):
            if len(num) > 2:
                raise ValueError("invalid num, expected int or two ints")
        else:
            num = [int(num), int(num)]
        if num[0] > num[1]:
            raise ValueError("invalid num, expected num[0] <= num[1]")

        min_size = list(cfg["min-size"])
        max_size = list(cfg["max-size"])
        if len(min_size) != 2 or len(max_size) != 2:
            raise ValueError("invalid min-size/max-size, expected two elements")

        return cls(cfg["probability"], num, min_size, max_size,
                   bool(cfg.get("skew-correction", True)))

    def __init__(self, probability, num, min_size, max_size, skew_correction=True):
        super().__init__()
        self.probability = probability
        self.num = num
        self.min_size = min_size
        self.max_size = max_size
        self.skew_correction = skew_correction

    def get_config(self):
        return {
            "type": self.type,
            "probability": self.probability,
            "num": self.num,
            "min-size": self.min_size,
            "max-size": self.max_size,
            "skew-correction": self.skew_correction,
        }

    def _patch(self, img, rng):
        if rng.random() >= self.probability:
            return img

        img = img.copy()
        h, w = img.shape[1:3]
        num = self.num[0] if self.num[0] == self.num[1] else rng.integers(*self.num)

        for _ in range(num):
            dx, dy = rng.integers(self.min_size, self.max_size)
            if self.skew_correction:
                y0, x0 = rng.integers((-dy + 1, -dx + 1), (h, w))
            else:
                y0, x0 = rng.integers((0, 0), (h, w))

            ys, xs = max(0, y0), max(0, x0)
            ye, xe = min(h, y0 + dy), min(w, x0 + dx)
            for i in range(img.shape[0]):
                img[i, ys:ye, xs:xe, :] = img[i].mean(axis=(0, 1))

        return img


class OcclusionForward(_Occlusion):
    type = "occlusion-forward"

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        return img1, self._patch(img2, rng), flow, valid, meta


class OcclusionBackward(_Occlusion):
    type = "occlusion-backward"

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        return self._patch(img1, rng), img2, flow, valid, meta


class RestrictFlowMagnitude(Augmentation):
    """Invalidates pixels whose flow magnitude exceeds ``maximum``."""

    type = "restrict-flow-magnitude"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(float(cfg["maximum"]))

    def __init__(self, maximum):
        super().__init__()
        self.maximum = maximum

    def get_config(self):
        return {"type": self.type, "maximum": self.maximum}

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        mag = np.linalg.norm(flow, ord=2, axis=-1)
        return img1, img2, flow, valid & (mag < self.maximum), meta


# -- scaling ----------------------------------------------------------------


def _resize_batch(batch, size, mode):
    return np.stack([cv2.resize(x, size, interpolation=mode) for x in batch], axis=0)


def _scale_dense_flow(flow, valid, size, scale, mode, th_valid):
    """Resize flow and rescale vectors; soft-resampled valid mask thresholded."""
    flow_out, valid_out = [], []
    for f, v in zip(flow, valid):
        flow_out.append(cv2.resize(f, size, interpolation=mode) * scale)
        vf = cv2.resize(v.astype(np.float32), size, interpolation=mode)
        valid_out.append(vf >= th_valid)
    return np.stack(flow_out, axis=0), np.stack(valid_out, axis=0)


def _scale_sparse_flow(flow, valid, size, scale):
    """Re-scatter valid flow vectors onto the scaled grid (KITTI-style)."""
    flow_out, valid_out = [], []
    for f, v in zip(flow, valid):
        ys, xs = np.nonzero(v)
        coords = np.stack((xs, ys), axis=-1).astype(np.float32) * scale
        vecs = f[ys, xs] * scale

        coords = np.round(coords).astype(np.int32)
        inb = (
            (coords[:, 0] >= 0) & (coords[:, 0] < size[0])
            & (coords[:, 1] >= 0) & (coords[:, 1] < size[1])
        )
        coords, vecs = coords[inb], vecs[inb]

        new_flow = np.zeros((size[1], size[0], 2), dtype=np.float32)
        new_valid = np.zeros((size[1], size[0]), dtype=bool)
        new_flow[coords[:, 1], coords[:, 0]] = vecs
        new_valid[coords[:, 1], coords[:, 0]] = True

        flow_out.append(new_flow)
        valid_out.append(new_valid)

    return np.stack(flow_out, axis=0), np.stack(valid_out, axis=0)


class _ScaleBase(Augmentation):
    """Shared machinery for the four scale augmentations.

    Subclasses choose the scale-factor distribution (linear vs. exponential)
    and dense vs. sparse flow resampling. ``min_size`` clamps the output so
    downstream crops stay possible.
    """

    sparse = False

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        min_size = list(cfg.get("min-size", [0, 0]))
        if len(min_size) != 2 or min_size[0] < 0 or min_size[1] < 0:
            raise ValueError("invalid min-size, expected two unsigned integers")

        min_scale = float(cfg["min-scale"])
        max_scale = float(cfg["max-scale"])
        if min_scale > max_scale:
            raise ValueError("min-scale must be smaller than or equal to max-scale")

        max_stretch = float(cfg["max-stretch"])
        if max_stretch < 0:
            raise ValueError("stretch must be non-negative")

        prob_stretch = float(cfg.get("prob-stretch", 1.0))
        mode = cfg.get("mode", "linear")
        if mode not in _CV2_MODES:
            raise ValueError(f"invalid scaling mode '{mode}'")

        kwargs = {}
        if not cls.sparse:
            kwargs["th_valid"] = cfg.get("th-valid", 0.99)

        return cls(min_size, min_scale, max_scale, max_stretch, prob_stretch, mode, **kwargs)

    def __init__(self, min_size, min_scale, max_scale, max_stretch, prob_stretch,
                 mode, th_valid=None):
        super().__init__()
        self.min_size = min_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.max_stretch = max_stretch
        self.prob_stretch = prob_stretch
        self.mode = mode
        self.th_valid = th_valid

    def get_config(self):
        cfg = {
            "type": self.type,
            "min-size": self.min_size,
            "min-scale": self.min_scale,
            "max-scale": self.max_scale,
            "max-stretch": self.max_stretch,
            "prob-stretch": self.prob_stretch,
            "mode": self.mode,
        }
        if not self.sparse:
            cfg["th-valid"] = self.th_valid
        return cfg

    def _draw_factors(self, rng):
        raise NotImplementedError

    def _new_size(self, input_size, rng):
        sx, sy = self._draw_factors(rng)
        old = np.array(input_size)[::-1]  # (w, h)
        new = np.clip(np.ceil(old * [sx, sy]).astype(np.int32), self.min_size, None)
        return new, new / old

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        assert img1.shape[:3] == img2.shape[:3]

        size, scale = self._new_size(img1.shape[1:3], rng)
        mode = _CV2_MODES[self.mode]

        img1 = _resize_batch(img1, size, mode)
        img2 = _resize_batch(img2, size, mode)

        if flow is not None:
            if self.sparse:
                flow, valid = _scale_sparse_flow(flow, valid, size, scale)
            else:
                flow, valid = _scale_dense_flow(flow, valid, size, scale, mode, self.th_valid)

        for m in meta:
            m.original_extents = ((0, img1.shape[1]), (0, img1.shape[2]))

        return img1, img2, flow, valid, meta


class Scale(_ScaleBase):
    """Linear scale factor with multiplicative aspect stretch 2^±s."""

    type = "scale"

    def _draw_factors(self, rng):
        scale = rng.uniform(self.min_scale, self.max_scale)
        stretch = 0.0
        if rng.random() < self.prob_stretch:
            stretch = rng.uniform(-self.max_stretch, self.max_stretch)
        return scale * 2 ** (stretch / 2), scale * 2 ** -(stretch / 2)


class ScaleSparse(Scale):
    type = "scale-sparse"
    sparse = True


class ScaleExp(_ScaleBase):
    """RAFT-style 2^s scaling with independent per-axis stretch."""

    type = "scale-exp"

    def _draw_factors(self, rng):
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.prob_stretch:
            sx *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
        return sx, sy


class ScaleSparseExp(ScaleExp):
    type = "scale-sparse-exp"
    sparse = True


class Translate(Augmentation):
    """Shift frames against each other; the shift adds to the flow."""

    type = "translate"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        min_size = list(cfg.get("min-size", [0, 0]))
        if len(min_size) != 2 or min_size[0] < 0 or min_size[1] < 0:
            raise ValueError("invalid min-size, expected two unsigned integers")

        delta = [int(d) for d in cfg.get("delta", [10, 10])]
        if len(delta) != 2 or delta[0] < 0 or delta[1] < 0:
            raise ValueError("invalid delta, expected two unsigned integers")

        return cls(min_size, delta)

    def __init__(self, min_size, delta):
        super().__init__()
        self.min_size = min_size
        self.delta = delta

    def get_config(self):
        return {"type": self.type, "min-size": self.min_size, "delta": self.delta}

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        assert img1.shape[:3] == img2.shape[:3]

        _, h, w, _ = img1.shape
        dx = np.clip(w - self.min_size[0], 0, self.delta[0])
        dy = np.clip(h - self.min_size[1], 0, self.delta[1])
        tx, ty = rng.integers((-dx, -dy), (dx + 1, dy + 1))

        img1 = img1[:, max(0, ty) : min(h, h + ty), max(0, tx) : min(w, w + tx)]
        img2 = img2[:, max(0, -ty) : min(h, h - ty), max(0, -tx) : min(w, w - tx)]

        if flow is not None:
            flow = flow[:, max(0, ty) : min(h, h + ty), max(0, tx) : min(w, w + tx)]
            flow = flow + np.array([tx, ty])
            valid = valid[:, max(0, ty) : min(h, h + ty), max(0, tx) : min(w, w + tx)]

        for m in meta:
            m.original_extents = ((0, img1.shape[1]), (0, img1.shape[2]))

        return img1, img2, flow, valid, meta


class Rotate(Augmentation):
    """Rotate both frames (optionally by slightly different angles).

    Flow vectors are rotated into the new frame; a differential-rotation
    correction field accounts for the angle difference between the frames
    (after DICL-Flow's RandomRotate).
    """

    type = "rotate"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        rng = cfg["range"]
        if isinstance(rng, (int, float)):
            rng = (-rng, rng)

        return cls(rng, cfg.get("deviation", 0), cfg.get("order", 2),
                   cfg.get("reshape", False), cfg.get("th-valid", 0.99))

    def __init__(self, range, deviation, order, reshape, th_valid):
        super().__init__()
        self.range = range
        self.deviation = deviation
        self.order = order
        self.reshape = reshape
        self.th_valid = th_valid

    def get_config(self):
        return {
            "type": self.type,
            "range": self.range,
            "deviation": self.deviation,
            "order": self.order,
            "reshape": self.reshape,
            "th-valid": self.th_valid,
        }

    def process(self, img1, img2, flow, valid, meta, rng=_LEGACY):
        assert img1.shape == img2.shape

        angle = rng.uniform(self.range[0], self.range[1])
        diff = rng.uniform(-self.deviation, self.deviation)
        angle1 = angle - diff / 2
        angle2 = angle + diff / 2

        args = dict(order=self.order, reshape=self.reshape, mode="constant", cval=0.0)

        img1 = np.stack([ndimage.rotate(x, angle=angle1, **args) for x in img1], axis=0)
        img2 = np.stack([ndimage.rotate(x, angle=angle2, **args) for x in img2], axis=0)

        if flow is not None:
            _, h, w, _ = flow.shape
            a = np.deg2rad(angle1)
            drad = np.deg2rad(diff)

            # angular velocity field of the frame-2-relative rotation: a point
            # at (x, y) moves by ~omega x r for small angle differences
            yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            delta = np.stack(
                ((yy - h / 2) * drad, -(xx - w / 2) * drad), axis=-1
            )

            flow_out, valid_out = [], []
            for f, v in zip(flow, valid):
                f = ndimage.rotate(f + delta, angle=angle1, **args)
                u = np.cos(a) * f[:, :, 0] + np.sin(a) * f[:, :, 1]
                w_ = -np.sin(a) * f[:, :, 0] + np.cos(a) * f[:, :, 1]
                flow_out.append(np.stack((u, w_), axis=-1))

                vf = ndimage.rotate(v.astype(np.float32), angle=angle1, **args)
                valid_out.append(vf >= self.th_valid)

            flow = np.stack(flow_out, axis=0)
            valid = np.stack(valid_out, axis=0)

        return img1, img2, flow, valid, meta


_AUGMENTATIONS = {
    cls.type: cls
    for cls in (
        ColorJitter, ColorJitter8bit, Crop, CropCenter, Flip, NoiseNormal,
        OcclusionForward, OcclusionBackward, RestrictFlowMagnitude, Rotate,
        Scale, ScaleExp, ScaleSparse, ScaleSparseExp, Translate,
    )
}


def build_augmentation(cfg):
    ty = cfg["type"]
    if ty not in _AUGMENTATIONS:
        raise ValueError(f"unknown augmentation type '{ty}'")
    return _AUGMENTATIONS[ty].from_config(cfg)
