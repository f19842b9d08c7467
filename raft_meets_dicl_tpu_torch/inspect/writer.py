"""TensorBoard event files with ``{key}``-templated tags (counterpart of
``raft_meets_dicl_tpu/inspect/writer.py``), written without the
``tensorboard``, protobuf or ``cv2`` packages.

An event file is a sequence of TFRecords: the little-endian uint64 length
of the record, its masked CRC32C, the data and the data's masked CRC32C.
Each record is a serialized ``Event`` protobuf (``wall_time`` = 1, double;
``step`` = 2, varint; ``file_version`` = 3 or ``summary`` = 5, bytes),
whose ``Summary`` holds ``Value``\\ s (``tag`` = 1, ``simple_value`` = 2,
float; ``image`` = 4: ``height``, ``width``, ``colorspace``,
``encoded_image_string``, fields 1-4). Images are PNGs encoded here with
``zlib``. :func:`read_events` parses such a file back (those fields only).
"""

import socket
import struct
import time
import zlib
from pathlib import Path

import numpy as np

# -- CRC32C (Castagnoli), reflected, as TFRecord uses it -------------------------

_POLY = 0x82F63B78
_TABLE = np.zeros(256, np.uint32)
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (_POLY if _c & 1 else 0)
    _TABLE[_i] = _c

_TABLE_LIST = _TABLE.tolist()

# chunk length of the vectorized CRC: the data is cut into chunks of this
# many bytes whose register states advance together; shorter data (a
# scalar's record) takes the byte loop, which costs microseconds where the
# chunked form's shift operators cost milliseconds
_CHUNK = 1024


def _gf2_times(mat, vec):
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat):
    return [_gf2_times(mat, mat[n]) for n in range(32)]


def _shift_operator(nbytes):
    """The linear map of a CRC register over ``nbytes`` zero bytes (as 32
    columns), by squaring the one-zero-bit operator (zlib's
    ``crc32_combine``)."""
    op = [_POLY] + [1 << (n - 1) for n in range(1, 32)]   # one zero bit
    for _ in range(3):
        op = _gf2_square(op)                               # one zero byte
    result = None
    while nbytes:
        if nbytes & 1:
            result = op if result is None else [
                _gf2_times(op, c) for c in result]
        nbytes >>= 1
        if nbytes:
            op = _gf2_square(op)
    return result


_CHUNK_SHIFT = _shift_operator(_CHUNK)


def _raw_crc(data):
    """The CRC register after ``data`` from a zero register (a linear
    function of ``data``: leading zero bytes leave it at 0)."""
    buf = np.frombuffer(data, np.uint8)
    pad = (-len(buf)) % _CHUNK
    chunks = np.concatenate([np.zeros(pad, np.uint8), buf]).reshape(
        -1, _CHUNK)
    state = np.zeros(len(chunks), np.uint32)
    for j in range(_CHUNK):
        state = _TABLE[(state ^ chunks[:, j]) & 0xFF] ^ (state >> 8)
    crc = 0
    for value in state.tolist():
        crc = _gf2_times(_CHUNK_SHIFT, crc) ^ value
    return crc


def crc32c(data):
    """CRC32C of ``data`` (initial register and final xor 0xffffffff)."""
    data = bytes(data)
    if len(data) <= _CHUNK:
        crc = 0xFFFFFFFF
        for byte in data:
            crc = _TABLE_LIST[(crc ^ byte) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF
    init = _gf2_times(_shift_operator(len(data)), 0xFFFFFFFF)
    return (_raw_crc(data) ^ init) ^ 0xFFFFFFFF


def masked_crc32c(data):
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire format ----------------------------------------------------------


def _varint(value):
    out = bytearray()
    value &= (1 << 64) - 1
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field, wire):
    return _varint((field << 3) | wire)


def _bytes_field(field, payload):
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(step, wall_time, *, summary=None, file_version=None):
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _key(2, 0) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def _summary_value(tag, simple_value=None, image=None):
    out = _bytes_field(1, tag.encode())
    if simple_value is not None:
        out += _key(2, 5) + struct.pack("<f", simple_value)
    if image is not None:
        out += _bytes_field(4, image)
    return _bytes_field(1, out)   # Summary.value, repeated


def _image(height, width, colorspace, png):
    return (_key(1, 0) + _varint(height) + _key(2, 0) + _varint(width)
            + _key(3, 0) + _varint(colorspace) + _bytes_field(4, png))


def _record(data):
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


# -- PNG ---------------------------------------------------------------------------


def encode_png(img):
    """PNG bytes of a (H, W, C) uint8 image, C in (1, 3, 4)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


# -- the writer ----------------------------------------------------------------------


class KvFormatter:
    """format_map with late-bound arguments."""

    def __init__(self, fmtargs={}):
        self.fmtargs = dict(fmtargs)

    def set_fmtargs(self, fmtargs):
        self.fmtargs = dict(fmtargs)

    def __call__(self, string):
        return string.format_map(self.fmtargs)


class SummaryWriter:
    """Writes one TB event file under ``log_dir``; tags are formatted
    through a KvFormatter whose ``{n_stage}``/``{id_stage}``/``{n_epoch}``/
    ``{n_step}``/``{id_val}``/``{img_idx}`` arguments are bound by
    ``set_fmtargs`` before each write."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        self.path = self.log_dir / (
            f"events.out.tfevents.{int(now):010d}.{socket.gethostname()}")
        self._file = open(self.path, "ab")
        self._file.write(_record(_event(None, now,
                                        file_version="brain.Event:2")))
        self.fmt = KvFormatter()

    def set_fmtargs(self, fmtargs):
        self.fmt.set_fmtargs(fmtargs)

    def _add(self, value, step):
        self._file.write(_record(_event(step, time.time(), summary=value)))

    def add_scalar(self, key, value, step=None):
        self._add(_summary_value(self.fmt(key), simple_value=float(value)),
                  step)

    def add_image(self, key, img, step=None, dataformats="HWC"):
        """``img``: float [0, 1] or uint8; HWC with 1/3/4 channels (or CHW
        when ``dataformats='CHW'``)."""
        img = np.asarray(img)
        if dataformats == "CHW":
            img = np.transpose(img, (1, 2, 0))
        elif dataformats != "HWC":
            raise ValueError(f"unsupported dataformats '{dataformats}'")
        if img.ndim == 2:
            img = img[..., None]
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)

        h, w, c = img.shape
        self._add(_summary_value(self.fmt(key),
                                 image=_image(h, w, c, encode_png(img))),
                  step)

    def flush(self):
        self._file.flush()

    def close(self):
        if not self._file.closed:
            self._file.close()


# -- the reader ----------------------------------------------------------------------


def _read_varint(buf, pos):
    value, shift = 0, 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, pos


def _fields(buf):
    """(field, wire type, value) of a protobuf message; length-delimited
    values as bytes, fixed ones as raw bytes."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def read_events(path):
    """Parse an event file into dicts ``{wall_time, step, file_version |
    values: [{tag, simple_value | image: {height, width, colorspace,
    png}}]}``, checking both CRCs of every record."""
    raw = Path(path).read_bytes()
    events, pos = [], 0
    while pos < len(raw):
        header = raw[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", raw[pos + 8:pos + 12])
        data = raw[pos + 12:pos + 12 + n]
        (dcrc,) = struct.unpack("<I", raw[pos + 12 + n:pos + 16 + n])
        if crc != masked_crc32c(header) or dcrc != masked_crc32c(data):
            raise ValueError(f"record CRC mismatch at byte {pos} of {path}")
        pos += 16 + n

        event = {"step": 0}
        for field, _, value in _fields(data):
            if field == 1:
                event["wall_time"] = struct.unpack("<d", value)[0]
            elif field == 2:
                event["step"] = value
            elif field == 3:
                event["file_version"] = value.decode()
            elif field == 5:
                event["values"] = [_read_value(v) for f, _, v in
                                   _fields(value) if f == 1]
        events.append(event)
    return events


def _read_value(buf):
    out = {}
    for field, _, value in _fields(buf):
        if field == 1:
            out["tag"] = value.decode()
        elif field == 2:
            out["simple_value"] = struct.unpack("<f", value)[0]
        elif field == 4:
            names = {1: "height", 2: "width", 3: "colorspace", 4: "png"}
            out["image"] = {names[f]: v for f, _, v in _fields(value)}
    return out
