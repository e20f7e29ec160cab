"""PNG reading and writing for EuRoC images, RGB-D depth images and the
debug overlays, without OpenCV.

The JAX package reads EuRoC frames with `cv2.imread(path,
IMREAD_GRAYSCALE)`, RGB-D depth images with `cv2.imread(path,
IMREAD_UNCHANGED)`, and equalizes with `cv2.equalizeHist`
(kimera_vio_tpu/dataprovider/euroc.py:204-213, rgbd.py:58-80); the card's
machine has no OpenCV. EuRoC ships 8-bit grayscale, non-interlaced PNGs
and depth streams 16-bit grayscale ones (big-endian samples), and this
module decodes exactly those: it walks the chunks (checking each CRC),
inflates the concatenated IDAT stream with `zlib` and undoes the five
row filters; the 8-bit RGB images this package writes itself (the
feature-track overlays, the visualizer's plots) decode too. Any other PNG
(palette, alpha, other bit depths, interlaced) raises, naming the file.

`encode_png` / `write_png` write 8-bit gray, 16-bit gray and 8-bit RGB
(colour type 2) PNGs: what `cv2.imwrite` stores for a uint8 (H, W), a
uint16 (H, W) or a uint8 (H, W, 3) array given in RGB order (OpenCV takes
BGR and stores RGB).

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
    """The file is not a non-interlaced PNG of the bit depth and colour
    type asked for."""


#: PNG colour types read and written here, and their samples per pixel
GRAY, RGB = 0, 2
_CHANNELS = {GRAY: 1, RGB: 3}


def read_png_stream(path: str, bit_depths: tuple = (8,),
                    color_type: int = GRAY) -> tuple[int, int, bytes]:
    """(H, W, inflated IDAT bytes) of a non-interlaced PNG of colour type
    `color_type` (gray or RGB) whose bit depth is one of `bit_depths` (8
    or 16); a row holds W * channels * depth / 8 bytes after its filter
    byte."""
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
    if (depth not in bit_depths or (color, comp, filt, interlace) != (color_type, 0, 0, 0)
            or W == 0 or H == 0):
        wanted = " or ".join(f"{d}-bit" for d in bit_depths)
        kind = "grayscale" if color_type == GRAY else "RGB"
        raise PngFormatError(
            f"{path}: only {wanted} {kind} non-interlaced PNGs are read here (bit depth "
            f"{depth}, colour type {color}, interlace {interlace})")
    raw = zlib.decompress(b"".join(idat))
    row = W * _CHANNELS[color_type] * depth // 8 + 1
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


def decode_png_rgb8(path: str) -> np.ndarray:
    """Decode an 8-bit RGB PNG into an (H, W, 3) uint8 array in RGB order
    (`cv2.imread(path)[..., ::-1]` for such a file)."""
    H, W, raw = read_png_stream(path, color_type=RGB)
    return _unfilter_native(raw, H, W, path, bpp=3).reshape(H, W, 3)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray, filter_type: int | None = None) -> bytes:
    """The PNG of a uint8 (H, W) gray, uint16 (H, W) gray (big-endian
    samples) or uint8 (H, W, 3) RGB `img`. Row y is filtered with
    `filter_type` (0-4: None, Sub, Up, Average, Paeth), or, when it is
    None, with type y % 5, so a decoder meets every filter in turn. The
    data is deflated at zlib level 1, `cv2.imwrite`'s default: higher
    levels take several times as long for slightly smaller files."""
    img = np.asarray(img)
    rgb = img.ndim == 3
    if not ((img.ndim == 2 and img.dtype in (np.uint8, np.uint16))
            or (rgb and img.shape[2] == 3 and img.dtype == np.uint8)):
        raise TypeError(f"encode_png takes uint8 or uint16 (H, W) or uint8 (H, W, 3), "
                        f"not {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    bpp = img.dtype.itemsize * (3 if rgb else 1)
    x = np.ascontiguousarray(img.astype(">u2") if img.dtype == np.uint16 else img).view(np.uint8)
    x = x.reshape(H, W * bpp).astype(np.int16)
    a = np.zeros_like(x)  # the byte one pixel to the left
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)  # the byte above
    b[1:] = x[:-1]

    def paeth():
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))

    preds = (lambda: 0, lambda: a, lambda: b, lambda: (a + b) >> 1, paeth)
    ft = np.arange(H) % 5 if filter_type is None else np.full(H, filter_type)
    rows = np.empty((H, W * bpp + 1), np.uint8)
    rows[:, 0] = ft
    for f in np.unique(ft):
        sel = ft == f
        pred = preds[f]()
        rows[sel, 1:] = ((x[sel] - (pred[sel] if f else 0)) & 0xFF).astype(np.uint8)
    ihdr = struct.pack(">IIBBBBB", W, H, 8 * img.dtype.itemsize, RGB if rgb else GRAY, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int | None = None) -> None:
    """Write `encode_png(img, filter_type)` to `path`; an I/O error raises."""
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))


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
