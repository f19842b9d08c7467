"""Host→device wire format for input batches (counterpart of
``raft_meets_dicl_tpu/models/wire.py``).

A batch crosses the host→device copy in a compact form: images as
``f32`` raw floats, ``bf16`` or quantized ``u8``, flow optionally as f16
and the valid mask optionally bit-packed. The clip/range normalization
that ``models.input.Input`` otherwise does on the host moves onto the
device (:meth:`WireFormat.decode`, plain elementwise torch ops inside the
train, eval and serving steps), so the host never makes a normalized f32
copy.

Wire dtypes per preset (bytes per pixel at the training contract of two
RGB images + 2-channel flow + valid):

    preset   images      flow   valid       B/px    vs f32
    f32      float32×6   f32×2  bool        33.0    1.0×
    bf16     bfloat16×6  f16×2  packed      16.125  2.05×
    u8       uint8×6     f16×2  packed      10.125  3.26×

The host side is numpy, as in JAX. numpy has no bfloat16 dtype here (the
port does not use ``ml_dtypes``), so a bf16 image on the host is a
``uint16`` array of bfloat16 bit patterns, rounded to nearest even as
``ml_dtypes`` rounds; :func:`as_tensor` views it as a ``torch.bfloat16``
tensor without a copy. Every encode runs on the host: the loader's
workers encode images (and, for training, flow and mask), serving
encodes each request.
"""

import numpy as np
import torch

# f16 finite range is ±65504; flow values beyond it only occur as the
# FLOW_INF clamp markers on invalid pixels: re-clamp so they stay finite
# (inf * 0-mask would poison the loss with NaNs)
_F16_FLOW_LIMIT = 6.0e4

_IMAGE_DTYPES = ("f32", "bf16", "u8")
_FLOW_DTYPES = ("f32", "f16")

PRESETS = {
    "f32": dict(images="f32", flow="f32", pack_valid=False),
    "bf16": dict(images="bf16", flow="f16", pack_valid=True),
    "u8": dict(images="u8", flow="f16", pack_valid=True),
}

# the host dtype of a bf16 wire image: its bit patterns
BF16_BITS = np.dtype(np.uint16)

_TORCH_IMAGE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                       "u8": torch.uint8}


def bf16_bits(x):
    """float32 array → bfloat16 bit patterns (``uint16``), rounded to
    nearest even; a NaN stays a quiet NaN of its sign (``ml_dtypes``'
    rounding)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) >> 16
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet = (u >> 16) | np.uint32(0x0040)
    return np.where(nan, quiet, rounded).astype(np.uint16)


def as_tensor(x):
    """A host wire array as a CPU tensor, without a copy: bf16 bit
    patterns become a ``torch.bfloat16`` tensor; None stays None."""
    if x is None:
        return None
    if x.dtype == BF16_BITS:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def unpack_bits(packed, count):
    """``np.unpackbits(packed, axis=-1, count=count).astype(bool)`` in
    torch, on the tensor's device: each byte's bits, most significant
    first, cut to ``count`` (widths that are not multiples of 8 too)."""
    shifts = torch.arange(7, -1, -1, device=packed.device, dtype=torch.uint8)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.flatten(-2)[..., :count].bool()


class WireFormat:
    """Encode (host) / decode (device) contract for one batch layout.

    ``clip``/``range`` are the model's input normalization (from
    ``InputSpec``); :meth:`decode` applies them on the device, so sources
    feeding a wire-format adapter must *not* normalize on the host
    (``InputSpec.apply(..., normalize=False)``).
    """

    @classmethod
    def from_config(cls, cfg, clip=(0.0, 1.0), range=(-1.0, 1.0)):
        """Build from a preset name ('f32'/'bf16'/'u8') or a mapping with
        explicit ``images``/``flow``/``pack-valid`` keys; None gives
        None."""
        if cfg is None:
            return None
        if isinstance(cfg, str):
            if cfg not in PRESETS:
                raise ValueError(
                    f"unknown wire-format preset '{cfg}', "
                    f"expected one of {', '.join(PRESETS)}")
            cfg = PRESETS[cfg]
        return cls(
            images=cfg.get("images", "f32"),
            flow=cfg.get("flow", cfg.get("flow-dtype", "f32")),
            pack_valid=bool(cfg.get("pack-valid", cfg.get("pack_valid", False))),
            clip=clip, range=range,
        )

    def __init__(self, images="f32", flow="f32", pack_valid=False,
                 clip=(0.0, 1.0), range=(-1.0, 1.0)):
        if images not in _IMAGE_DTYPES:
            raise ValueError(f"invalid wire image dtype '{images}', "
                             f"expected one of {_IMAGE_DTYPES}")
        if flow not in _FLOW_DTYPES:
            raise ValueError(f"invalid wire flow dtype '{flow}', "
                             f"expected one of {_FLOW_DTYPES}")
        self.images = images
        self.flow = flow
        self.pack_valid = bool(pack_valid)
        self.clip = (float(clip[0]), float(clip[1]))
        self.range = (float(range[0]), float(range[1]))

    def get_config(self):
        return {
            "images": self.images,
            "flow": self.flow,
            "pack-valid": self.pack_valid,
        }

    def bound(self, clip, range):
        """Copy with the normalization parameters of an ``InputSpec``."""
        return WireFormat(self.images, self.flow, self.pack_valid,
                          clip=clip, range=range)

    def describe(self):
        return (f"images={self.images}, flow={self.flow}, "
                f"valid={'packed' if self.pack_valid else 'bool'}")

    def image_dtype(self):
        """The torch dtype image tensors take on the wire (what warm-up
        dummies and serving buffers are created in)."""
        return _TORCH_IMAGE_DTYPES[self.images]

    # -- host side (numpy) --------------------------------------------------

    def encode_image(self, img):
        """One un-normalized image batch → wire dtype (numpy)."""
        if self.images == "bf16":
            return bf16_bits(img)
        if self.images == "u8":
            lo, hi = self.clip
            # JAX's arithmetic, in place: one float32 temporary
            q = np.subtract(img, np.float32(lo), dtype=np.float32)
            q *= np.float32(255.0 / (hi - lo))
            np.rint(q, out=q)
            np.clip(q, 0.0, 255.0, out=q)
            return q.astype(np.uint8)
        return np.ascontiguousarray(img, np.float32)

    def encode_flow(self, flow):
        if flow is None or self.flow == "f32":
            return flow
        return np.clip(flow, -_F16_FLOW_LIMIT, _F16_FLOW_LIMIT).astype(
            np.float16)

    def encode_valid(self, valid):
        if valid is None or not self.pack_valid:
            return valid
        return np.packbits(np.asarray(valid, bool), axis=-1)

    def decode_images_host(self, img):
        """Wire image batch → normalized f32 on the *host* (numpy).

        The numpy mirror of the device-side decode, for consumers that
        need pixel values host-side (image summaries, the references of
        the tests).
        """
        lo, hi = self.clip
        rmin, rmax = self.range
        if self.images == "u8":
            scale = (hi - lo) / 255.0
            x = np.asarray(img, np.float32) * scale + lo
        else:
            if self.images == "bf16" and np.asarray(img).dtype == BF16_BITS:
                img = (np.asarray(img, np.uint32) << 16).view(np.float32)
            x = np.clip(np.asarray(img, np.float32), lo, hi)
        return (rmax - rmin) * x + rmin

    # -- device side --------------------------------------------------------

    def decode_image(self, img):
        lo, hi = self.clip
        rmin, rmax = self.range
        if self.images == "u8":
            x = img.float() * ((hi - lo) / 255.0) + lo
        else:
            x = torch.clamp(img.float(), lo, hi)
        return (rmax - rmin) * x + rmin

    def decode(self, img1, img2, flow=None, valid=None):
        """Wire tuple → (img1, img2, flow, valid) in compute dtypes, on
        the tensors' device: images dequantize and normalize, flow widens
        to float32, packed valid masks unpack to bool at the image width.
        """
        w = img1.shape[2]
        img1 = self.decode_image(img1)
        img2 = self.decode_image(img2)
        if flow is not None and flow.dtype != torch.float32:
            flow = flow.float()
        if valid is not None and self.pack_valid:
            valid = unpack_bits(valid, w)
        return img1, img2, flow, valid
