"""PNG decoding for EuRoC images, without OpenCV.

The JAX package reads EuRoC frames with `cv2.imread(path,
IMREAD_GRAYSCALE)` and equalizes them with `cv2.equalizeHist`
(kimera_vio_tpu/dataprovider/euroc.py:204-213); the card's machine has no
OpenCV. EuRoC ships 8-bit grayscale, non-interlaced PNGs, and this module
decodes exactly that: it walks the chunks (checking each CRC), inflates
the concatenated IDAT stream with `zlib` and undoes the five row filters.
Any other PNG (colour, palette, 16-bit, interlaced) raises, naming the
file.

The unfilter runs in C++ (`native/png_unfilter.cpp`): the Average and
Paeth filters chain each pixel to the one decoded left of it, which numpy
cannot vectorise. `unfilter_plain` is its plain version for the tests.
`equalize_hist` is `cv2.equalizeHist` as a numpy look-up table, bit for
bit.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

from kimera_vio_tpu_torch import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class PngFormatError(ValueError):
    """The file is not an 8-bit grayscale, non-interlaced PNG."""


def read_png_stream(path: str) -> tuple[int, int, bytes]:
    """(H, W, inflated IDAT bytes) of an 8-bit grayscale PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise PngFormatError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while True:
        if pos + 12 > len(data):
            raise PngFormatError(f"{path}: truncated before IEND")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise PngFormatError(f"{path}: truncated {ctype!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise PngFormatError(f"{path}: CRC mismatch in {ctype!r} chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        elif ctype == b"PLTE" or not (ctype[0] & 0x20):
            # PLTE, or an unknown critical chunk (lower-case first letter
            # marks an ancillary chunk that a decoder may skip).
            raise PngFormatError(f"{path}: unsupported critical chunk {ctype!r}")
    if ihdr is None:
        raise PngFormatError(f"{path}: no IHDR chunk")
    W, H, depth, color, comp, filt, interlace = ihdr
    if (depth, color, comp, filt, interlace) != (8, 0, 0, 0, 0) or W == 0 or H == 0:
        raise PngFormatError(
            f"{path}: only 8-bit grayscale non-interlaced PNGs are read (bit depth "
            f"{depth}, colour type {color}, interlace {interlace})")
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != H * (W + 1):
        raise PngFormatError(f"{path}: image data holds {len(raw)} bytes, not {H * (W + 1)}")
    return H, W, raw


def unfilter_plain(raw: bytes, H: int, W: int) -> np.ndarray:
    """Plain version of native/png_unfilter.cpp: None, Sub and Up in numpy,
    Average and Paeth pixel by pixel. Returns (H, W) uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(H, W + 1)
    out = np.zeros((H, W), np.uint8)
    zero = np.zeros(W, np.int32)
    for y in range(H):
        ft, src = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        up = out[y - 1].astype(np.int32) if y else zero
        if ft == 0:
            out[y] = src
        elif ft == 1:
            out[y] = np.cumsum(src) & 0xFF
        elif ft == 2:
            out[y] = (src + up) & 0xFF
        elif ft in (3, 4):
            a = 0
            for x in range(W):
                b = int(up[x])
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(up[x - 1]) if x else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                a = (int(src[x]) + pred) & 0xFF
                out[y, x] = a
        else:
            raise PngFormatError(f"row {y}: filter type {ft} is not 0..4")
    return out


@functools.lru_cache(maxsize=None)
def _unfilter_fn():
    fn = native.load("png_unfilter").png_unfilter_gray8
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    return fn


def _unfilter_native(raw: bytes, H: int, W: int, path: str) -> np.ndarray:
    fn = _unfilter_fn()
    out = np.empty((H, W), np.uint8)
    bad = fn(raw, out.ctypes.data, H, W)
    if bad:
        raise PngFormatError(f"{path}: row {bad - 1} has a filter type outside 0..4")
    return out


def decode_png_gray8(path: str) -> np.ndarray:
    """Decode an 8-bit grayscale PNG into an (H, W) uint8 array, as
    `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` does for such a file."""
    H, W, raw = read_png_stream(path)
    return _unfilter_native(raw, H, W, path)


def equalize_hist(img: np.ndarray) -> np.ndarray:
    """`cv2.equalizeHist` of a uint8 image: the cumulative histogram from
    the first non-empty bin, scaled in float32 by 255 / (N - that bin's
    count) and rounded half to even (OpenCV's saturate_cast)."""
    if img.dtype != np.uint8:
        raise TypeError(f"equalize_hist takes uint8, not {img.dtype}")
    hist = np.bincount(img.reshape(-1), minlength=256)
    first = int(np.flatnonzero(hist)[0]) if img.size else 0
    total = img.size
    if total == 0 or hist[first] == total:
        return np.full_like(img, first)
    scale = np.float32(255.0) / np.float32(total - int(hist[first]))
    cum = np.cumsum(hist).astype(np.int64) - int(hist[first])
    lut = np.rint(cum.astype(np.float32) * scale)
    lut = np.clip(lut, 0, 255).astype(np.uint8)
    lut[:first + 1] = 0
    return lut[img]
