"""Oriented binary (ORB-class) descriptors and Hamming matching.

Port of kimera_vio_tpu/loopclosure/orb.py: oriented BRIEF over a smoothed
31x31 patch — intensity-centroid orientation, a fixed 256-pair comparison
pattern rotated per keypoint, bits packed into 8 32-bit words. The
reference's `vmap` over keypoints is a leading keypoint axis here.

Words: torch has no unsigned 32-bit arithmetic to speak of and no
popcount, so a descriptor is (N, 8) int32 holding the uint32 bit
patterns (`.view(np.uint32)` on the host gives the reference's words),
and Hamming distances count bits with a SWAR sequence in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from kimera_vio_tpu_torch.ops.corner_detection import _conv2d

PATCH = 31  # descriptor patch (cv::ORB patchSize)
HALF = PATCH // 2
N_BITS = 256
N_WORDS = N_BITS // 32


def _brief_pattern(seed: int = 11) -> np.ndarray:
    """(256, 4) sampling-pair coordinates in [-13, 13]^2 (Gaussian, like
    the BRIEF-32 construction ORB's learned pattern approximates)."""
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(0, PATCH / 5.0, (N_BITS, 4)), -HALF + 2, HALF - 2)
    return pts.astype(np.float32)


_PATTERN = _brief_pattern()


def _gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
    return _conv2d(_conv2d(img, k[:, None]), k[None, :])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32k) bool/{0,1} -> (..., k) int32 words (bit i of word w is
    bit 32w + i), the uint32 bit patterns stored as int32."""
    b = bits.to(torch.int64).unflatten(-1, (-1, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., k) int32 words -> (..., 32k) int64 bits in {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.flatten(-2)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an integer tensor (int64 result)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def centroid_moments(patch: torch.Tensor):
    """Intensity-centroid moments (m10, m01) of (N, 31, 31) patches over
    the inscribed disc, accumulated in float32 in row-major order as the
    reference's reduction does: the moments nearly cancel, and another
    order (a float64 sum included) moves the angle by up to ~3e-5 rad.
    One add per patch pixel, each over all keypoints."""
    ar = torch.arange(-HALF, HALF + 1, dtype=torch.float32, device=patch.device)
    ys, xs = torch.meshgrid(ar, ar, indexing="ij")
    pm = (patch * ((xs**2 + ys**2) <= HALF**2)).flatten(1)
    terms = torch.stack([pm * xs.flatten(), pm * ys.flatten()]).permute(2, 0, 1).contiguous()
    acc = terms[0]
    for row in terms[1:]:
        acc = acc + row
    return acc[0], acc[1]


def patches(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(N, 31, 31) smoothed patches around the keypoints, their origins
    clamped into the image."""
    H, W = img.shape
    blurred = _gaussian_blur(img.to(torch.float32))
    x0 = torch.clamp(uv[:, 0].to(torch.int64) - HALF, 0, W - PATCH - 1)
    y0 = torch.clamp(uv[:, 1].to(torch.int64) - HALF, 0, H - PATCH - 1)
    offs = torch.arange(PATCH, device=img.device)
    rows = y0[:, None] + offs
    cols = x0[:, None] + offs
    return blurred[rows[:, :, None], cols[:, None, :]]


def orb_samples(img: torch.Tensor, uv: torch.Tensor):
    """The two bilinear samples of every comparison pair and the
    orientation of every keypoint: (a (N, 256), b (N, 256), angles (N,)).
    Bit i of a descriptor is a[i] < b[i]."""
    pat = torch.from_numpy(_PATTERN).to(img.device)
    patch = patches(img, uv)
    m10, m01 = centroid_moments(patch)
    angle = torch.atan2(m01, m10)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    flat = patch.reshape(patch.shape[0], -1)

    def sample(px, py):
        fx = torch.clamp(px + HALF, 0.0, PATCH - 1.001)
        fy = torch.clamp(py + HALF, 0.0, PATCH - 1.001)
        x0i = torch.floor(fx).to(torch.int64)
        y0i = torch.floor(fy).to(torch.int64)
        wx = fx - x0i
        wy = fy - y0i

        def at(yi, xi):
            return torch.gather(flat, 1, yi * PATCH + xi)

        return (
            at(y0i, x0i) * (1 - wx) * (1 - wy)
            + at(y0i, x0i + 1) * wx * (1 - wy)
            + at(y0i + 1, x0i) * (1 - wx) * wy
            + at(y0i + 1, x0i + 1) * wx * wy
        )

    a = sample(pat[:, 0] * ca - pat[:, 1] * sa, pat[:, 0] * sa + pat[:, 1] * ca)
    b = sample(pat[:, 2] * ca - pat[:, 3] * sa, pat[:, 2] * sa + pat[:, 3] * ca)
    return a, b, angle


def orb_descriptors(img: torch.Tensor, uv: torch.Tensor, mask: torch.Tensor):
    """Returns (desc (N, 8) int32 words, angles (N,), ok (N,)); `ok` drops
    keypoints whose patch leaves the image."""
    H, W = img.shape
    a, b, angle = orb_samples(img, uv)
    desc = pack_bits(a < b)
    inb = (uv[:, 0] >= HALF) & (uv[:, 0] < W - HALF) & (uv[:, 1] >= HALF) & (uv[:, 1] < H - HALF)
    return desc, angle, mask & inb


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances between packed descriptors
    (N, k) x (M, k) -> (N, M) int32."""
    x = a[:, None, :] ^ b[None, :, :]
    return torch.sum(popcount(x), dim=-1).to(torch.int32)


def match_descriptors(desc_a, mask_a, desc_b, mask_b, *, lowe_ratio: float = 0.7,
                      max_distance: int = 64):
    """Lowe-ratio nearest-neighbour matching. Returns (idx_b (N,), ok (N,)):
    for each masked descriptor of A its best match in B, kept when it
    passes the ratio and absolute-distance tests."""
    d = hamming_matrix(desc_a, desc_b)
    big = torch.full_like(d, 512)
    d = torch.where(mask_b[None, :], d, big)
    best = torch.argmin(d, dim=1)
    d1 = torch.gather(d, 1, best[:, None])[:, 0]
    d_no_best = d.scatter(1, best[:, None], big[:, :1])
    d2 = torch.amin(d_no_best, dim=1)
    ok = (
        mask_a
        & (d1 <= max_distance)
        & (d1.to(torch.float32) < lowe_ratio * d2.to(torch.float32))
    )
    return best, ok
