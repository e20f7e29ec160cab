"""The yardstick's peaks and the operations and bytes of the port's LK
kernels, from each launch's own data.

Frozen copies of `chip_smoke.py`'s `bound_ms`, `cached_work`,
`cached_build_work` and their pixel counts, with two changes: a launch is
recorded from the arguments and results of the launcher call itself (the
benchmark runs no plain tracker beside the program), so each level's
search patches are counted at the seeds the level's steps start from as
the results give them (the coarsest level at the prediction, a finer one
at the final point scaled to it), and only keypoints the launch flags
valid add template or patch bytes.
"""

from __future__ import annotations

import torch

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth and
# the float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SLACK = 8  # px of drift a search patch of lk_cached_kernel allows around a level's seed


def bound_s(nbytes: float, flops: float) -> float:
    """Least time the card could take: bytes over HBM bandwidth or float32
    operations over the float32 peak, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def _distinct(shape, origins: torch.Tensor, side: int) -> int:
    """Distinct pixels of an (H, W) plane under side x side squares at
    integer `origins` (x, y), clipped to the plane."""
    H, W = shape
    if origins.shape[0] == 0:
        return 0
    a = torch.arange(side, device=origins.device)
    rows = (origins[:, 1:2] + a).clamp(0, H - 1)
    cols = (origins[:, 0:1] + a).clamp(0, W - 1)
    mask = torch.zeros(H * W, dtype=torch.bool, device=origins.device)
    mask[(rows[:, :, None] * W + cols[:, None, :]).flatten()] = True
    return int(mask.sum())


def cached_work(shapes, tracked, init_pts, pts, valid, iters, win: int) -> tuple[int, float]:
    """(bytes, float32 operations) of one `lk_cached_kernel` launch.

    shapes: each pyramid level's (H, W), level 0 first; tracked: per level
    whether the cache has a template there; init_pts, pts: (..., N, 2)
    predicted and tracked points; valid (..., N); iters (..., N, levels)
    Gauss-Newton steps per level. Bytes, each read once: the keypoints in
    (seed, flag) and out (point, flag, steps per level); per tracked level
    each keypoint's template gate, and for each keypoint taking a step
    there its template, gx and gy windows and inverse gradient matrix, and
    the distinct current-level pixels under those keypoints' search
    patches of side win + 2 slack + 2. Operations: 17 per step and window
    pixel."""
    npx = win * win
    n_lv = len(shapes)
    init_pts, pts = init_pts.reshape(-1, 2), pts.reshape(-1, 2)
    valid, iters = valid.reshape(-1), iters.reshape(-1, n_lv)
    n_kpts = valid.numel()
    nbytes = n_kpts * (8 + 1) + n_kpts * (8 + 1 + 4 * n_lv)
    flops = 0.0
    S = win + 2 * SLACK + 2
    levels = [lvl for lvl in range(n_lv) if tracked[lvl]]
    for lvl in levels:
        H, W = shapes[lvl]
        stepped = valid & (iters[:, lvl] > 0)
        nbytes += n_kpts + int(stepped.sum()) * (12 * npx + 12)
        seeds = (init_pts if lvl == levels[-1] else pts)[stepped] / 2.0 ** lvl
        o = torch.floor(seeds - (win - 1) * 0.5).long() - (SLACK + 1)
        o = torch.stack([o[:, 0].clamp(-S, W), o[:, 1].clamp(-S, H)], -1)
        nbytes += 4 * _distinct((H, W), o, S)
        flops += int(iters[:, lvl][valid].sum()) * npx * 17
    return nbytes, flops


def cached_build_work(shapes, pts, valid, win: int, grads: bool = False) -> tuple[int, float]:
    """(bytes, float32 operations) of one `lk_cache_build_kernel` launch.

    shapes: each pyramid level's (H, W), level 0 first; pts (..., N, 2)
    keyframe keypoints, valid (..., N). Bytes, each once: the keypoints and
    flags in; per level a window fits in, the distinct keyframe pixels
    under the valid keypoints' (win + 4)^2 patches (with `grads`, those of
    the image, gx and gy planes under the (win + 1)^2 cells each window
    blends), and out the template, gx and gy windows, the inverse matrix
    and the gate of every keypoint. Operations per valid keypoint and
    level: the Scharr x and y correlations on the (win + 2)^2 cells (11
    each; none with `grads`), and per window pixel three y-then-x blends
    (9 each) and the three gradient products and sums (6)."""
    npx = win * win
    pts = pts.reshape(-1, pts.shape[-2], 2) if pts.dim() == 3 else pts[None]
    valid = valid.reshape(pts.shape[0], pts.shape[1])
    B, N = pts.shape[0], pts.shape[1]
    nbytes, flops = B * N * (8 + 1), 0.0
    side, St, pad = (win + 1, win + 2, win + 4) if grads else (win + 4, win + 4, win + 6)
    n_valid = int(valid.sum())
    for lvl, (H, W) in enumerate(shapes):
        if min(H, W) < win + 2:
            continue
        for b in range(B):
            corners = pts[b][valid[b]] / 2.0 ** lvl
            t = torch.floor(corners - (win - 1) * 0.5).long() - (0 if grads else 1)
            o = torch.stack([t[:, 0].clamp(-pad, W + pad - St), t[:, 1].clamp(-pad, H + pad - St)], -1)
            nbytes += (3 if grads else 1) * 4 * _distinct((H, W), o, side)
        nbytes += B * N * (4 * 3 * npx + 4 * 3 + 1)
        flops += n_valid * ((0 if grads else 2 * 11 * (win + 2) ** 2) + npx * (3 * 9 + 6))
    return nbytes, flops
