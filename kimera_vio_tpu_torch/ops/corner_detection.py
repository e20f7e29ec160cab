"""Corner detection: GFTT / Harris / FAST / ORB responses, binned top-k
selection (ANMS type 6) or a candidate pool for ANMS types 0-5.

Port of kimera_vio_tpu/ops/corner_detection.py: the dense responses
(GFTT's min eigenvalue, Harris, the approximate FAST score, ORB = the FAST
mask ranked by Harris), the binning ANMS (the reference's FrontendParams
default), the explicit ANMS algorithms over the strongest candidates
(ops/anms.py) and the sub-pixel refinement. AGAST raises, as in the JAX
package.

Selection ties: `jax.lax.top_k` returns the lower index first among equal
scores, `torch.topk` makes no such promise, so `_stable_topk` sorts stably
instead — the same keypoints in the same order as the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _conv2d(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Same-padding 2D correlation of a single-channel image (H, W), or of
    a stack of them (..., H, W), with zero padding, as shifted adds in the
    reference's order."""
    k = np.asarray(kernel, np.float32)
    kh, kw = k.shape
    H, W = img.shape[-2:]
    ph, pw = kh // 2, kw // 2
    if kh * kw > 32:
        kt = torch.as_tensor(k, dtype=img.dtype, device=img.device)
        padded = F.pad(img.reshape(-1, 1, H, W), (pw, kw - 1 - pw, ph, kh - 1 - ph))
        return F.conv2d(padded, kt[None, None]).reshape(img.shape)
    padded = F.pad(img, (pw, kw - 1 - pw, ph, kh - 1 - ph))
    out = None
    for dy in range(kh):
        for dx in range(kw):
            c = float(k[dy, dx])
            if c == 0.0:
                continue
            term = c * padded[..., dy : dy + H, dx : dx + W]
            out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(img)


_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0
_SOBEL_Y = _SOBEL_X.T
_SCHARR_X = np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], np.float32) / 32.0
_SCHARR_Y = _SCHARR_X.T


def image_gradients(img: torch.Tensor, scharr: bool = True):
    """(Ix, Iy) via Scharr (LK's gradient) or Sobel, of an (H, W) image or
    a (..., H, W) stack."""
    kx, ky = (_SCHARR_X, _SCHARR_Y) if scharr else (_SOBEL_X, _SOBEL_Y)
    return _conv2d(img, kx), _conv2d(img, ky)


def _box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """Separable box sum over a size x size window (same padding)."""
    k1 = np.ones((size, 1), np.float32)
    return _conv2d(_conv2d(img, k1), k1.T)


def gftt_response(img: torch.Tensor, block_size: int = 3, use_harris: bool = False,
                  k: float = 0.04) -> torch.Tensor:
    """Dense GFTT response, the min eigenvalue of the structure tensor
    (cv::cornerMinEigenVal behind cv::goodFeaturesToTrack), or the Harris
    response det - k tr^2 (cv::cornerHarris)."""
    Ix, Iy = image_gradients(img, scharr=False)
    a = _box_filter(Ix * Ix, block_size)
    b = _box_filter(Ix * Iy, block_size)
    c = _box_filter(Iy * Iy, block_size)
    if use_harris:
        det = a * c - b * b
        tr = a + c
        return det - k * tr * tr
    half_tr = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    return half_tr - disc


# The 16-pixel Bresenham circle of radius 3, as (dy, dx).
_FAST_RING = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


def fast_score(img: torch.Tensor, thresh: float = 10.0) -> torch.Tensor:
    """Approximate FAST response (detector type 0): over the ring's 16
    pixels (wrapping at the image edge, as jnp.roll does), the larger of
    the summed brighter-than-thresh and darker-than-thresh differences. A
    dense stand-in for cv::FastFeatureDetector's segment test, as in the
    JAX package."""
    d = torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1)) - img for dy, dx in _FAST_RING])
    bright = torch.clamp(d - thresh, min=0.0)
    dark = torch.clamp(-d - thresh, min=0.0)
    return torch.maximum(bright.sum(0), dark.sum(0))


def local_max_mask(resp: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """True where resp is the maximum of its (2r+1)^2 neighbourhood
    (separable max-pooling, -inf padding)."""
    size = 2 * radius + 1
    m = F.max_pool2d(resp[None, None], (size, 1), stride=1, padding=(radius, 0))
    m = F.max_pool2d(m, (1, size), stride=1, padding=(0, radius))
    return resp >= m[0, 0]


def occupancy_suppression(
    resp: torch.Tensor,
    existing_uv: torch.Tensor,
    existing_mask: torch.Tensor,
    min_distance: float,
) -> torch.Tensor:
    """Set the response to -inf in grid cells (cell = min_distance) whose
    3x3 cell neighbourhood holds an existing feature (the reference's
    mask-out-circles step, FeatureDetector.cpp:185-203)."""
    H, W = resp.shape
    cell = max(int(min_distance), 1)
    gh = (H + cell - 1) // cell
    gw = (W + cell - 1) // cell
    gx = torch.clamp((existing_uv[:, 0] / cell).to(torch.int64), 0, gw - 1)
    gy = torch.clamp((existing_uv[:, 1] / cell).to(torch.int64), 0, gh - 1)
    grid = torch.zeros(gh * gw, dtype=torch.float32, device=resp.device)
    grid = grid.scatter_reduce(
        0, gy * gw + gx, existing_mask.to(torch.float32), reduce="amax"
    ).reshape(gh, gw)
    grid_d = F.max_pool2d(grid[None, None], 3, stride=1, padding=1)[0, 0]
    up = grid_d.repeat_interleave(cell, dim=0).repeat_interleave(cell, dim=1)
    occupied = up[:H, :W] > 0
    return torch.where(occupied, torch.full_like(resp, -torch.inf), resp)


def _stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken by lower index first
    (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def binned_topk_select(
    resp: torch.Tensor,
    k_total: int,
    nr_horizontal_bins: int = 7,
    nr_vertical_bins: int = 5,
    border: int = 4,
):
    """Up to `k_total` keypoints spread by per-bin top-k quotas, then a
    global top-k (binning ANMS). Returns (uv (k,2), score (k,), valid (k,))."""
    H, W = resp.shape
    dev = resp.device
    nb = nr_horizontal_bins * nr_vertical_bins
    quota = -(-k_total // nb) + 2
    bh = -(-H // nr_vertical_bins)
    bw = -(-W // nr_horizontal_bins)
    Hp, Wp = bh * nr_vertical_bins, bw * nr_horizontal_bins
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    border_ok = (
        (ys[:, None] >= border)
        & (ys[:, None] < H - border)
        & (xs[None, :] >= border)
        & (xs[None, :] < W - border)
    )
    r = torch.where(border_ok, resp, torch.full_like(resp, -torch.inf))
    r = F.pad(r, (0, Wp - W, 0, Hp - H), value=-torch.inf)
    tiles = r.reshape(nr_vertical_bins, bh, nr_horizontal_bins, bw)
    tiles = tiles.permute(0, 2, 1, 3).reshape(nb, bh * bw)
    scores, flat_idx = _stable_topk(tiles, quota)
    in_y = flat_idx // bw
    in_x = flat_idx % bw
    bin_ids = torch.arange(nb, device=dev)
    by = (bin_ids // nr_horizontal_bins)[:, None] * bh
    bx = (bin_ids % nr_horizontal_bins)[:, None] * bw
    abs_y = by + in_y
    abs_x = bx + in_x
    pool_scores = scores.reshape(-1)
    pool_xy = torch.stack([abs_x.reshape(-1), abs_y.reshape(-1)], dim=-1)
    top_scores, top_idx = _stable_topk(pool_scores, k_total)
    uv = pool_xy[top_idx].to(torch.float32)
    valid = torch.isfinite(top_scores) & (top_scores > 0)
    return uv, top_scores, valid


def subpixel_refine(
    img: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    window: int = 10,
    iters: int = 5,
) -> torch.Tensor:
    """Batched corner sub-pixel refinement (cv::cornerSubPix's normal
    equations over a (2*window+1)^2 window), gradients cut once per
    keypoint as an (S,S) patch and re-windowed with one-hot matrices each
    iteration, as in the reference."""
    Ix, Iy = image_gradients(img, scharr=False)
    H, W = img.shape
    dev = img.device
    size = 2 * window + 1
    slack = 2
    S = size + 2 * slack
    pad = S
    duo = torch.stack([Ix, Iy])
    duo_p = F.pad(duo, (pad, pad, pad, pad))
    o = torch.round(uv).to(torch.int64) - window - slack
    oy = o[:, 1] + pad
    ox = o[:, 0] + pad
    ar = torch.arange(S, device=dev)
    rows = oy[:, None] + ar[None, :]
    cols = ox[:, None] + ar[None, :]
    patches = duo_p[:, rows[:, :, None], cols[:, None, :]]  # (2,N,S,S)
    Pgx, Pgy = patches[0], patches[1]

    i = torch.arange(size, dtype=torch.float32, device=dev)
    j = torch.arange(S, dtype=torch.float32, device=dev)
    ps = torch.arange(size, dtype=torch.float32, device=dev) - window
    py, px = torch.meshgrid(ps, ps, indexing="ij")
    of = o.to(torch.float32)

    uv_c = uv
    for _ in range(iters):
        x0 = torch.clamp(torch.round(uv_c[:, 0]) - window - of[:, 0], 0.0, 2.0 * slack)
        y0 = torch.clamp(torch.round(uv_c[:, 1]) - window - of[:, 1], 0.0, 2.0 * slack)
        Wy = (torch.abs(y0[:, None, None] + i[None, :, None] - j[None, None, :]) < 0.5).to(torch.float32)
        Wx = (torch.abs(x0[:, None, None] + i[None, :, None] - j[None, None, :]) < 0.5).to(torch.float32)
        gx = torch.einsum("nis,nst,njt->nij", Wy, Pgx, Wx)
        gy = torch.einsum("nis,nst,njt->nij", Wy, Pgy, Wx)
        axx = px[None] + (x0 + of[:, 0] + window)[:, None, None]
        ayy = py[None] + (y0 + of[:, 1] + window)[:, None, None]
        gxx = gx * gx
        gxy = gx * gy
        gyy = gy * gy
        a = gxx.sum((-2, -1))
        b = gxy.sum((-2, -1))
        c = gyy.sum((-2, -1))
        b0 = (gxx * axx + gxy * ayy).sum((-2, -1))
        b1 = (gxy * axx + gyy * ayy).sum((-2, -1))
        det = a * c - b * b
        good = torch.abs(det) > 1e-8
        safe_det = torch.where(good, det, torch.ones_like(det))
        sol = torch.stack(
            [(c * b0 - b * b1) / safe_det, (-b * b0 + a * b1) / safe_det], -1
        )
        delta = torch.clamp(sol - uv_c, -float(window), float(window))
        uv_c = torch.where(good[:, None], uv_c + delta, uv_c)
    return torch.where(valid[:, None], uv_c, uv)


def detect_features(
    img: torch.Tensor,
    existing_uv: torch.Tensor,
    existing_mask: torch.Tensor,
    k_new: int,
    *,
    detector_type: int = 3,
    quality_level: float = 0.001,
    min_distance: float = 20.0,
    block_size: int = 3,
    use_harris: bool = False,
    harris_k: float = 0.04,
    fast_thresh: float = 10.0,
    nr_horizontal_bins: int = 7,
    nr_vertical_bins: int = 5,
    do_subpixel: bool = True,
    subpix_window: int = 10,
    anms_type: int = 6,
    max_nr_keypoints_before_anms: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Response -> NMS -> quality threshold -> existing-feature suppression
    -> ANMS -> subpixel refinement (FeatureDetector::featureDetection,
    FeatureDetector.cpp:94-163). Returns (uv (k_new,2), valid (k_new,)).

    detector_type: 0 FAST, 1 ORB (FAST-gated, Harris-ranked), 3 GFTT
    (Harris with `use_harris`); 2, AGAST, raises. anms_type 6 is the
    binning top-k on the dense response; 0-5 pick from the
    `max_nr_keypoints_before_anms` strongest candidates (ops/anms.py)."""
    img = img.to(torch.float32)
    if detector_type == 0:
        resp = fast_score(img, fast_thresh)
    elif detector_type == 1:
        fs = fast_score(img, fast_thresh)
        hr = gftt_response(img, block_size, use_harris=True, k=harris_k)
        resp = torch.where(fs > 0, hr, torch.full_like(hr, -torch.inf))
    elif detector_type == 2:
        raise NotImplementedError("AGAST detector is not supported")
    else:
        resp = gftt_response(img, block_size, use_harris, harris_k)
    # Binning enforces spacing with a min_distance/2 local max; the
    # explicit ANMS types do their own and get a radius-1 local max.
    nms_radius = max(1, int(min_distance) // 2) if anms_type == 6 else 1
    neg_inf = torch.full_like(resp, -torch.inf)
    resp = torch.where(local_max_mask(resp, radius=nms_radius), resp, neg_inf)
    resp = torch.where(resp >= quality_level * resp.max(), resp, neg_inf)
    resp = occupancy_suppression(resp, existing_uv, existing_mask, min_distance)
    if anms_type == 6:
        uv, _, valid = binned_topk_select(resp, k_new, nr_horizontal_bins, nr_vertical_bins)
    else:
        from kimera_vio_tpu_torch.ops import anms  # it imports this module

        H, W = resp.shape
        m = min(max_nr_keypoints_before_anms, H * W)
        cand_scores, flat = _stable_topk(resp.reshape(-1), m)
        cand_uv = torch.stack([(flat % W).to(torch.float32), (flat // W).to(torch.float32)], -1)
        cand_ok = torch.isfinite(cand_scores) & (cand_scores > 0)
        keep = anms.suppress_non_max(cand_uv, cand_scores, cand_ok, k_new, anms_type, W, H)
        top_scores, sel = _stable_topk(
            torch.where(keep, cand_scores, torch.full_like(cand_scores, -torch.inf)), k_new)
        uv = cand_uv[sel]
        valid = torch.isfinite(top_scores) & (top_scores > 0)
    if do_subpixel:
        uv = subpixel_refine(img, uv, valid, window=subpix_window)
    return uv, valid
