"""Stereo matching: sparse epipolar matching and dense block matching.

Port of kimera_vio_tpu/ops/stereo_matching.py.

`match_stereo` (StereoMatcher::searchRightKeypointEpipolar,
StereoMatcher.cpp:283-423): per left keypoint an 11x101 template slides
along a disparity-bounded stripe of the rectified right image; the SSD
minimum (parabola-refined) gives the right keypoint; depth gates follow.
All keypoints' sliding correlations run as one grouped convolution
(keypoints = groups), with cuDNN's TF32 off (package __init__).

`dense_stereo` / `dense_depth` (the role of StereoMatcher::
denseStereoReconstruction, StereoMatcher.cpp:32-121): one SAD cost volume
over every disparity at once, box-filtered with the JAX package's
zero-padded shifted adds in its order, then the winner, OpenCV-style
uniqueness, parabola sub-pixel refinement and an optional left-right
check on the same volume.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from kimera_vio_tpu_torch.ops.corner_detection import _conv2d


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


def _box_sum(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Zero-padded running sum of `size` taps along `dim` (-2 or -1) of a
    batch of images, the terms added in the order of the JAX package's
    shifted-add `_conv2d` with a ones kernel."""
    lo = size // 2
    n = x.shape[dim]
    pad = (0, 0, lo, size - 1 - lo) if dim == -2 else (lo, size - 1 - lo)
    padded = F.pad(x, pad)
    out = padded.narrow(dim, 0, n)
    for k in range(1, size):
        out = out + padded.narrow(dim, k, n)
    return out


def dense_stereo(
    left_rect: torch.Tensor,  # (H, W) rectified left
    right_rect: torch.Tensor,  # (H, W) rectified right
    *,
    min_disparity: int = 0,
    num_disparities: int = 64,
    block_size: int = 9,
    uniqueness_ratio: float = 1.05,
    subpixel: bool = True,
    lr_check: bool = False,
    lr_max_diff: float = 1.0,
    prefilter_xsobel: bool = False,
    prefilter_cap: float = 31.0,
):
    """Dense block-matching disparity map. The SAD cost of every pixel
    and disparity (box-filtered absolute differences against the right
    image shifted by the disparity) is one (D, H, W) volume; the winner
    is its arg-min, kept where the second best outside the winner's +-1
    neighbourhood is `uniqueness_ratio` worse, refined by a 3-tap parabola.
    `prefilter_xsobel` matches the clamped horizontal Sobel response
    (cv::StereoBM's PREFILTER_XSOBEL). `lr_check` runs the right view's
    winner on the same volume (costR[d, y, xr] = costL[d, y, xr + d]) and
    drops pixels whose two disparities differ by more than `lr_max_diff`.

    Returns (disparity (H, W) float32, valid (H, W) bool)."""
    H, W = left_rect.shape
    dev = left_rect.device
    L = left_rect.to(torch.float32)
    R = right_rect.to(torch.float32)
    if prefilter_xsobel:
        kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0
        L = torch.clamp(_conv2d(L, kx), -prefilter_cap, prefilter_cap) + prefilter_cap
        R = torch.clamp(_conv2d(R, kx), -prefilter_cap, prefilter_cap) + prefilter_cap
    r = block_size // 2
    big = 1e30
    x = torch.arange(W, device=dev)
    ds = torch.arange(min_disparity, min_disparity + num_disparities, device=dev)
    # Rs[d, y, x] = R[y, x - d] (a roll, as jnp.roll).
    Rs = R[:, (x[None, :] - ds[:, None]) % W].permute(1, 0, 2)
    costs = _box_sum(_box_sum(torch.abs(L[None] - Rs), block_size, -2), block_size, -1)
    costs = torch.where((x[None, None, :] >= ds[:, None, None] + r) & (x[None, None, :] < W - r),
                        costs, torch.full_like(costs, big))

    best = torch.amin(costs, dim=0)
    best_i = torch.argmin(costs, dim=0)
    di = torch.arange(num_disparities, device=dev)
    near = torch.abs(di[:, None, None] - best_i[None]) <= 1
    second = torch.amin(torch.where(near, torch.full_like(costs, big), costs), dim=0)

    disparity = (best_i + min_disparity).to(torch.float32)
    if subpixel:
        cm1 = torch.gather(costs, 0, torch.clamp(best_i - 1, 0, num_disparities - 1)[None])[0]
        cp1 = torch.gather(costs, 0, torch.clamp(best_i + 1, 0, num_disparities - 1)[None])[0]
        denom = cm1 + cp1 - 2.0 * best
        delta = torch.where(denom > 1e-6, 0.5 * (cm1 - cp1) / torch.clamp(denom, min=1e-6),
                            torch.zeros_like(denom))
        disparity = disparity + torch.clamp(delta, -0.5, 0.5)

    valid = ((best < big * 0.5) & (second >= best * uniqueness_ratio)
             & (best_i > 0) & (best_i < num_disparities - 1))
    if lr_check:
        # The right view's cost at right pixel xr is the left cost at xr + d.
        costs_r = torch.gather(costs, 2, ((x[None, :] + ds[:, None]) % W)[:, None, :].expand(-1, H, -1))
        costs_r = torch.where((x[None, None, :] >= r) & (x[None, None, :] < W - ds[:, None, None] - r),
                              costs_r, torch.full_like(costs_r, big))
        best_r = (torch.argmin(costs_r, dim=0) + min_disparity).to(torch.float32)
        xr = torch.clamp(x[None, :] - torch.round(disparity).to(torch.int64), 0, W - 1)
        valid = valid & (torch.abs(torch.gather(best_r, 1, xr) - disparity) <= lr_max_diff)
    return disparity, valid


def dense_depth(
    left_rect: torch.Tensor,
    right_rect: torch.Tensor,
    *,
    fx: float,
    baseline: float,
    min_depth: float = 0.1,
    max_depth: float = 15.0,
    num_disparities: int = 64,
    block_size: int = 9,
) -> torch.Tensor:
    """Dense metric depth image (H, W) of a rectified stereo pair, with the
    left-right check and the Sobel prefilter: the depth the mesh
    refinement takes on stereo sequences. Invalid or out-of-range pixels
    are 0 (the RGB-D convention)."""
    disparity, valid = dense_stereo(left_rect, right_rect, num_disparities=num_disparities,
                                    block_size=block_size, lr_check=True, prefilter_xsobel=True)
    depth = fx * baseline / torch.clamp(disparity, min=1e-3)
    ok = valid & (depth >= min_depth) & (depth <= max_depth)
    return torch.where(ok, depth, torch.zeros_like(depth))
