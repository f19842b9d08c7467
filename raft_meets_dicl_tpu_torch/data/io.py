"""Optical-flow and image file I/O.

Host-side, pure numpy/cv2 (an own copy of the JAX package's
``data/io.py``). Formats and conventions follow the reference framework
(src/data/io.py): images are returned HWC RGB float32 in [0, 1]; flow fields
are HWC float32 (u, v) in pixels.

Supported formats:
- generic images via OpenCV (any depth, grayscale promoted to RGB),
- Middlebury ``.flo`` (magic ``PIEH``, little-endian w/h + interleaved u,v),
- KITTI 16-bit PNG flow (``(value - 2^15) / 64`` with a validity channel),
- Freiburg ``.pfm`` (scale sign encodes endianness, rows stored bottom-up).
"""

from pathlib import Path

import cv2
import numpy as np

_FLO_MAGIC = b"PIEH"


def read_image_generic(file):
    """Read an image as HWC RGB float32 in [0, 1] (grayscale → RGB)."""
    file = Path(file)
    if not file.exists():
        raise FileNotFoundError(f"File '{file}' does not exist")

    raw = cv2.imread(str(file), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    if raw is None:
        raise ValueError(f"could not decode image file: {file}")

    scale = np.iinfo(raw.dtype).max
    return raw[:, :, ::-1].astype(np.float32) / scale  # BGR → RGB


def read_flow_kitti(file):
    """Read KITTI-format 16-bit PNG flow; returns (flow, valid)."""
    file = Path(file)
    if not file.exists():
        raise FileNotFoundError(f"File '{file}' does not exist")

    raw = cv2.imread(str(file), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    if raw is None:
        raise ValueError(f"could not decode flow file: {file}")

    raw = raw[:, :, ::-1]  # BGR → RGB: (u, v, valid)
    flow = (raw[:, :, :2].astype(np.float32) - 2.0**15) / 64.0
    return flow, raw[:, :, 2].astype(bool)


def write_flow_kitti(file, uv, valid=None):
    """Write flow as KITTI-format 16-bit PNG: ``64 * uv + 2^15`` in the
    first two channels, ``valid`` (all ones by default) in the third."""
    file = Path(file)
    if not file.parent.exists():
        raise FileNotFoundError(f"Directory '{file.parent}' does not exist")

    encoded = 64.0 * np.asarray(uv) + 2.0**15
    if valid is None:
        valid = np.ones(encoded.shape[:2])

    data = np.dstack((encoded, valid)).astype(np.uint16)
    cv2.imwrite(str(file), data[:, :, ::-1])


def read_flow_mb(file):
    """Read Middlebury ``.flo`` flow; returns (H, W, 2) float32."""
    data = Path(file).read_bytes()
    if data[:4] != _FLO_MAGIC:
        raise ValueError(f"Invalid flow file: {file}")

    w, h = np.frombuffer(data, dtype="<i4", count=2, offset=4)
    uv = np.frombuffer(data, dtype="<f4", count=int(w) * int(h) * 2, offset=12)
    return uv.reshape(int(h), int(w), 2).copy()


def write_flow_mb(file, uv):
    """Write Middlebury ``.flo`` flow."""
    uv = np.asarray(uv)
    h, w, _ = uv.shape
    with open(file, "wb") as fd:
        fd.write(_FLO_MAGIC)
        np.array([w, h], dtype="<i4").tofile(fd)
        uv.astype("<f4").tofile(fd)


def read_pfm(file):
    """Read a Freiburg ``.pfm`` image; returns (H, W, C) float, C in {1, 3}."""
    with open(file, "rb") as fd:
        header = fd.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"Not a PFM file: {file}")

        dims = fd.readline().decode("ascii").split()
        if len(dims) != 2:
            raise ValueError(f"Invalid PFM file: {file}")
        w, h = int(dims[0]), int(dims[1])

        scale = float(fd.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"

        data = np.fromfile(fd, dtype=endian + "f4", count=w * h * channels)

    # PFM rows are stored bottom-to-top
    return data.reshape(h, w, channels)[::-1].copy()


def write_pfm(file, data):
    """Write a (H, W, 3) or (H, W) float array as a little-endian ``.pfm``
    (the Freiburg datasets' flow format, rows bottom-to-top)."""
    data = np.asarray(data, dtype="<f4")
    header = b"PF" if data.ndim == 3 else b"Pf"
    if data.ndim == 3 and data.shape[2] != 3:
        raise ValueError("a color PFM holds 3 channels")
    with open(file, "wb") as fd:
        fd.write(header + f"\n{data.shape[1]} {data.shape[0]}\n-1.0\n".encode())
        data[::-1].tofile(fd)
