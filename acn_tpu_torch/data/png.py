"""A small PNG codec in numpy and ``zlib``.

The dataset loaders and the eval's frame dumps read and write PNG through
this module, so the port needs no imaging library for them. It handles
8-bit RGB and RGBA images (colour types 2 and 6), not interlaced, and on read
all five row filters (None, Sub, Up, Average, Paeth) of the PNG standard;
ancillary chunks are skipped. ``read_png`` gives the pixels that PIL's
``Image.open(path).convert("RGB")`` gives for such a file (alpha dropped,
not composited). Anything else (palette, grey, 16-bit, interlaced) raises.

``write_png`` filters the rows with one filter type (None by default) or
with one type per row.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type → samples per pixel


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG: truncated chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        yield kind, body
        pos += 12 + length


def _unfilter(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Undo the row filters: ``filt`` (H, W, C) uint8, ``types`` (H,) the
    filter of each row → the pixels (H, W, C) uint8.

    A pixel's predictor reads its left, upper and upper-left neighbours, all
    decoded before it, so the image is undone one anti-diagonal r + c = d at
    a time: H + W − 1 numpy steps, each over the diagonal's pixels, for any
    mix of filters. The diagonals are stored skewed, ``sk[d + 2, r + 1]`` =
    pixel (r, d − r), so that a step reads and writes contiguous slices:
    the left neighbours are diagonal d − 1 at row r, the upper ones
    diagonal d − 1 at row r − 1, the upper-left ones diagonal d − 2 at row
    r − 1. Whatever lies outside the image stays 0, as the standard asks."""
    h, w, ch = filt.shape
    n = h + w - 1
    r, c = np.indices((h, w))
    f = np.zeros((n, h + 1, ch), np.int16)
    f[r + c, r + 1] = filt
    sk = np.zeros((n + 2, h + 1, ch), np.int16)
    types = types.astype(np.int16)[:, None]
    paeth_rows = bool((types == 4).any())
    for d in range(n):
        r0, r1 = max(0, d - w + 1), min(h, d + 1)  # the rows of diagonal d
        a, b, ul = sk[d + 1, r0 + 1:r1 + 1], sk[d + 1, r0:r1], sk[d, r0:r1]
        t = types[r0:r1]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(t == 3, (a + b) >> 1, 0)))
        if paeth_rows:
            p = a + b - ul
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
            pred = np.where(t == 4, np.where((pa <= pb) & (pa <= pc), a,
                                             np.where(pb <= pc, b, ul)), pred)
        sk[d + 2, r0 + 1:r1 + 1] = (f[d, r0 + 1:r1 + 1] + pred) & 0xFF
    return sk[r + c + 2, r + 1].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 (H, W, C), C = 3 (RGB) or 4 (RGBA)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"PNG: only 8-bit RGB/RGBA without interlacing is supported (bit depth "
            f"{depth}, colour type {ctype}, interlace {interlace}); convert the file "
            "or decode it with PIL")
    bpp = _CHANNELS[ctype]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG: image data of the wrong size")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    types, filt = rows[:, 0], rows[:, 1:]
    top = int(types.max()) if height else 0
    if top > 4:
        raise ValueError(f"PNG: unknown row filter {top}")
    if top > 2:  # Average or Paeth rows: sequential along the row
        return _unfilter(filt.reshape(height, width, bpp), types)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):  # None, Sub and Up rows are whole-row numpy
        if types[r] == 0:
            out[r] = filt[r]
        elif types[r] == 1:  # a running sum per channel, mod 256
            out[r] = np.cumsum(filt[r].reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            out[r] = filt[r] + prior
        prior = out[r]
    return out.reshape(height, width, bpp)


def read_png(path) -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of an 8-bit RGB or RGBA PNG file."""
    return decode_png(Path(path).read_bytes())[..., :3]


def _filtered(x: np.ndarray, up: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """Rows x (H, stride) int16, each filtered against ``up`` (the row above)
    with ``ftype``: (H, stride + 1) uint8, the type byte first."""
    h, stride = x.shape
    left = np.hstack([np.zeros((h, bpp), np.int16), x[:, :-bpp]])
    ul = np.hstack([np.zeros((h, bpp), np.int16), up[:, :-bpp]])
    if ftype == 0:
        f = x
    elif ftype == 1:
        f = x - left
    elif ftype == 2:
        f = x - up
    elif ftype == 3:
        f = x - (left + up) // 2
    elif ftype == 4:
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        f = x - pred
    else:
        raise ValueError(f"PNG: unknown row filter {ftype}")
    f = (f & 0xFF).astype(np.uint8)
    return np.hstack([np.full((h, 1), ftype, np.uint8), f])


def encode_png(img: np.ndarray, filter_type=0, level: int = 6) -> bytes:
    """uint8 (H, W, 3) or (H, W, 4) → PNG bytes, the rows filtered with
    ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth): one type for
    every row, or a sequence of H types, one per row."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"PNG: need uint8 (H, W, 3|4), got {img.dtype} {img.shape}")
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), x[:-1]])
    types = np.broadcast_to(np.asarray(filter_type), (h,))
    raw = np.empty((h, w * c + 1), np.uint8)
    for t in np.unique(types):
        rows = types == t
        raw[rows] = _filtered(x[rows], up[rows], int(t), c)
    raw = raw.tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ctype = 2 if c == 3 else 6
    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, filter_type=0) -> None:
    Path(path).write_bytes(encode_png(img, filter_type))
