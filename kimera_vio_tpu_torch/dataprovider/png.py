"""PNG decoding for EuRoC images and RGB-D depth images, without OpenCV.

The JAX package reads EuRoC frames with `cv2.imread(path,
IMREAD_GRAYSCALE)`, RGB-D depth images with `cv2.imread(path,
IMREAD_UNCHANGED)`, and equalizes with `cv2.equalizeHist`
(kimera_vio_tpu/dataprovider/euroc.py:204-213, rgbd.py:58-80); the card's
machine has no OpenCV. EuRoC ships 8-bit grayscale, non-interlaced PNGs
and depth streams 16-bit grayscale ones (big-endian samples), and this
module decodes exactly those: it walks the chunks (checking each CRC),
inflates the concatenated IDAT stream with `zlib` and undoes the five
row filters. Any other PNG (colour, palette, other bit depths,
interlaced) raises, naming the file.

The unfilter runs in C++ (`native/png_unfilter.cpp`): the Average and
Paeth filters chain each byte to the one decoded a pixel to its left,
which numpy cannot vectorise. `unfilter_plain` is its plain version for
the tests.
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
    """The file is not a grayscale, non-interlaced PNG of the bit depth
    asked for."""


def read_png_stream(path: str, bit_depths: tuple = (8,)) -> tuple[int, int, bytes]:
    """(H, W, inflated IDAT bytes) of a grayscale PNG whose bit depth is
    one of `bit_depths` (8 or 16); a 16-bit image holds 2 W bytes a row."""
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
    if depth not in bit_depths or (color, comp, filt, interlace) != (0, 0, 0, 0) or W == 0 or H == 0:
        wanted = " or ".join(f"{d}-bit" for d in bit_depths)
        raise PngFormatError(
            f"{path}: only {wanted} grayscale non-interlaced PNGs are read here (bit depth "
            f"{depth}, colour type {color}, interlace {interlace})")
    raw = zlib.decompress(b"".join(idat))
    row = W * depth // 8 + 1
    if len(raw) != H * row:
        raise PngFormatError(f"{path}: image data holds {len(raw)} bytes, not {H * row}")
    return H, W, raw


def unfilter_plain(raw: bytes, H: int, W: int, bpp: int = 1) -> np.ndarray:
    """Plain version of native/png_unfilter.cpp for W pixels of `bpp`
    bytes a row: None, Sub and Up in numpy, Average and Paeth byte by
    byte. Returns the (H, W * bpp) uint8 bytes."""
    Wb = W * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(H, Wb + 1)
    out = np.zeros((H, Wb), np.uint8)
    zero = np.zeros(Wb, np.int32)
    for y in range(H):
        ft, src = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        up = out[y - 1].astype(np.int32) if y else zero
        if ft == 0:
            out[y] = src
        elif ft == 1:
            for k in range(bpp):  # each byte lane is its own running sum
                out[y, k::bpp] = np.cumsum(src[k::bpp]) & 0xFF
        elif ft == 2:
            out[y] = (src + up) & 0xFF
        elif ft in (3, 4):
            for x in range(Wb):
                a = int(out[y, x - bpp]) if x >= bpp else 0
                b = int(up[x])
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(up[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                out[y, x] = (int(src[x]) + pred) & 0xFF
        else:
            raise PngFormatError(f"row {y}: filter type {ft} is not 0..4")
    return out


@functools.lru_cache(maxsize=None)
def _unfilter_fn():
    fn = native.load("png_unfilter").png_unfilter
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    return fn


def _unfilter_native(raw: bytes, H: int, W: int, path: str, bpp: int = 1) -> np.ndarray:
    fn = _unfilter_fn()
    out = np.empty((H, W * bpp), np.uint8)
    bad = fn(raw, out.ctypes.data, H, W * bpp, bpp)
    if bad:
        raise PngFormatError(f"{path}: row {bad - 1} has a filter type outside 0..4")
    return out


def decode_png_gray8(path: str) -> np.ndarray:
    """Decode an 8-bit grayscale PNG into an (H, W) uint8 array, as
    `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` does for such a file."""
    H, W, raw = read_png_stream(path)
    return _unfilter_native(raw, H, W, path)


def decode_png_gray(path: str) -> np.ndarray:
    """Decode an 8- or 16-bit grayscale PNG into an (H, W) uint8 or uint16
    array, as `cv2.imread(path, cv2.IMREAD_UNCHANGED)` does for such a
    file (16-bit samples are big-endian in the file)."""
    H, W, raw = read_png_stream(path, bit_depths=(8, 16))
    if len(raw) == H * (W + 1):
        return _unfilter_native(raw, H, W, path)
    return _unfilter_native(raw, H, W, path, bpp=2).view(">u2").astype(np.uint16)


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
