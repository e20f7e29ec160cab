"""Sparse epipolar stereo matching as a batched template match.

Port of kimera_vio_tpu/ops/stereo_matching.py::match_stereo
(StereoMatcher::searchRightKeypointEpipolar, StereoMatcher.cpp:283-423):
per left keypoint an 11x101 template slides along a disparity-bounded
stripe of the rectified right image; the SSD minimum (parabola-refined)
gives the right keypoint; depth gates follow. All keypoints' sliding
correlations run as one grouped convolution (keypoints = groups), with
cuDNN's TF32 off (package __init__).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _cut(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, h, w) windows img[y0:y0+h, x0:x0+w] (origins already in range)."""
    dev = img.device
    rows = y0[:, None] + torch.arange(h, device=dev)[None, :]
    cols = x0[:, None] + torch.arange(w, device=dev)[None, :]
    return img[rows[:, :, None], cols[:, None, :]]


def match_stereo(
    left_rect: torch.Tensor,
    right_rect: torch.Tensor,
    uv_rect: torch.Tensor,
    valid: torch.Tensor,
    *,
    fx,
    baseline,
    templ_cols: int = 101,
    templ_rows: int = 11,
    stripe_extra_rows: int = 0,
    max_disparity: int = 128,
    min_point_dist: float = 0.5,
    max_point_dist: float = 10.0,
    tolerance: float = 0.15,
):
    """Returns (uv_right (N,2), depth (N,), ok (N,))."""
    H, W = left_rect.shape
    N = uv_rect.shape[0]
    dev = left_rect.device
    left = left_rect.to(torch.float32)
    right = right_rect.to(torch.float32)
    tc = min(templ_cols, W)
    tr = min(templ_rows, H)
    max_disparity = min(max_disparity, W - tc)
    sr = min(tr + stripe_extra_rows, H)
    n_disp = max_disparity + 1
    stripe_cols = tc + max_disparity

    xi = torch.round(uv_rect[:, 0]).to(torch.int64)
    yi = torch.round(uv_rect[:, 1]).to(torch.int64)
    tx0 = torch.clamp(xi - (tc - 1) // 2, 0, W - tc)
    ty0 = torch.clamp(yi - (tr - 1) // 2, 0, H - tr)
    sx0 = torch.clamp(tx0 - max_disparity, 0, W - stripe_cols)
    sy0 = torch.clamp(yi - (sr - 1) // 2, 0, H - sr)

    T = _cut(left, ty0, tx0, tr, tc)  # (N, tr, tc)
    S = _cut(right, sy0, sx0, sr, stripe_cols)  # (N, sr, stripe_cols)

    def gconv(x, k):
        return F.conv2d(x[None], k[:, None], groups=N)[0]

    corr = gconv(S, T)  # (N, sv, n_disp)
    s2 = gconv(S * S, torch.ones_like(T))
    t2 = torch.sum(T * T, dim=(-2, -1))[:, None, None]
    ssd = t2 - 2.0 * corr + s2
    ssd = torch.amin(ssd, dim=1)  # (N, n_disp)

    d_idx = torch.arange(n_disp, device=dev)[None, :]
    disparity_at = (tx0[:, None] - (sx0[:, None] + d_idx)).to(torch.float32)
    feasible = disparity_at >= 0.0
    ssd = torch.where(feasible, ssd, torch.full_like(ssd, 3.4e38))

    best = torch.argmin(ssd, dim=1)

    def take(arr, idx):
        return torch.gather(arr, 1, idx[:, None])[:, 0]

    best_ssd = take(ssd, best)
    bm1 = torch.clamp(best - 1, 0, n_disp - 1)
    bp1 = torch.clamp(best + 1, 0, n_disp - 1)
    c0 = take(ssd, bm1)
    c1 = best_ssd
    c2 = take(ssd, bp1)
    denom = c0 - 2 * c1 + c2
    big = torch.abs(denom) > 1e-6
    delta = torch.where(
        big, 0.5 * (c0 - c2) / torch.where(big, denom, torch.ones_like(denom)),
        torch.zeros_like(denom),
    )
    delta = torch.clamp(delta, -0.5, 0.5)

    disp_int = take(disparity_at, best)
    disparity = disp_int - delta
    uR = uv_rect[:, 0] - disparity
    vR = uv_rect[:, 1]

    s2_best = take(torch.amin(s2, dim=1), best)
    norm = torch.sqrt(torch.clamp(t2[:, 0, 0] * s2_best, min=1e-12))
    score = best_ssd / norm

    t_mean = torch.mean(T, dim=(-2, -1), keepdim=True)
    t_var = torch.mean((T - t_mean) ** 2, dim=(-2, -1))
    textured = t_var > 1.0

    safe_disp = torch.clamp(disparity, min=1e-3)
    depth = fx * baseline / safe_disp
    ok = (
        valid
        & (disparity > 0.5)
        & (depth >= min_point_dist)
        & (depth <= max_point_dist)
        & (score < tolerance)
        & textured
        & (yi >= (tr - 1) // 2)
        & (yi < H - (tr - 1) // 2)
        & torch.isfinite(score)
    )
    uv_right = torch.stack([uR, vR], dim=-1)
    return uv_right, depth, ok
