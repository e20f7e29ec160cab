"""Adaptive non-maximum suppression, types 0-5 (AnmsAlgorithmType,
NonMaximumSuppression.h:52-60), over a fixed-size candidate set.

Port of kimera_vio_tpu/ops/anms.py. Every function takes candidates
uv (M,2), score (M,) and ok (M,) and returns a keep mask (M,):

  type | algorithm  | here
  -----+------------+---------------------------------------------------
   0   | TopN       | the k strongest (torch, on the candidates' device)
   1   | BrownANMS  | each point's radius = distance to the nearest
       |            | stronger point, one (M,M) matrix; the k largest
       |            | radii (torch, on the candidates' device)
  2-4  | SDC, KdTree| a binary search on the suppression radius around a
       | RangeTree  | strongest-first greedy pass with exact disks (the
       |            | JAX package maps all three to one program)
   5   | SSC        | the same search around a greedy pass with SSC's
       |            | square-grid covering
   6   | binning    | not here: corner_detection.binned_topk_select

The greedy passes are sequential by nature: each keep decision depends on
what the stronger candidates covered. The JAX package runs them as a
`lax.scan` on the device. Run eagerly on a card, a scan over M <= 1024
candidates, 15 times per keyframe, would be tens of thousands of tiny
launches. Here the candidates are read back once, the 14-step radius
search and its greedy passes run on the host in numpy, and the keep mask
goes back to the device: two copies per keyframe. The arithmetic is the
JAX package's float32 (radius midpoints, squared distances, cell indices),
so the decisions are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from kimera_vio_tpu_torch.ops.corner_detection import _stable_topk

# Binary-search iterations of the radius search: the interval halves each
# step, so 14 localize the radius to ~diag/16384 px.
_SEARCH_ITERS = 14
# SSC coverage grid edge (cells); radii whose grid would be larger clamp
# to its last cell, as in the JAX package.
_SSC_GRID = 96


def _mask_of(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    keep = torch.zeros_like(like)
    keep[idx] = True
    return keep


def top_n(score: torch.Tensor, ok: torch.Tensor, k: int) -> torch.Tensor:
    """TopN: the k strongest, no spatial term."""
    s = torch.where(ok, score, torch.full_like(score, -torch.inf))
    return _mask_of(_stable_topk(s, k)[1], ok) & ok


def brown_anms(uv: torch.Tensor, score: torch.Tensor, ok: torch.Tensor, k: int) -> torch.Tensor:
    """BrownANMS: a point's suppression radius is its distance to the
    nearest point with a higher score (an equal score with a lower index
    counts as higher); keep the k largest radii."""
    d2 = torch.sum((uv[:, None, :] - uv[None, :, :]) ** 2, dim=-1)
    ids = torch.arange(score.shape[0], device=score.device)
    stronger = (score[None, :] > score[:, None]) | (
        (score[None, :] == score[:, None]) & (ids[None, :] < ids[:, None])
    )
    stronger = stronger & ok[None, :]
    d2 = torch.where(stronger, d2, torch.full_like(d2, torch.inf))
    radius = torch.sqrt(d2.min(dim=1).values)  # inf for the strongest point
    radius = torch.where(ok, radius, torch.full_like(radius, -torch.inf))
    return _mask_of(_stable_topk(radius, k)[1], ok) & ok


def _greedy_disk(uv_s: np.ndarray, ok_s: np.ndarray):
    """Strongest-first greedy with exact disk suppression over
    score-sorted candidates, as a function of the radius returning (keep
    (M,), count). The pairwise squared distances are computed once: row i
    is the JAX package's per-step `sum((uv_s - uv_s[i])**2)`."""
    d = uv_s[None, :, :] - uv_s[:, None, :]
    d2 = np.sum(d * d, axis=-1)
    cand = np.flatnonzero(ok_s)

    def run(radius: np.float32):
        r2 = np.float32(radius * radius)
        covered = np.zeros(uv_s.shape[0], bool)
        keep = np.zeros(uv_s.shape[0], bool)
        for i in cand:
            if not covered[i]:
                keep[i] = True
                covered |= d2[i] < r2
        return keep, int(keep.sum())

    return run


def _greedy_ssc(uv_s: np.ndarray, ok_s: np.ndarray):
    """Strongest-first greedy with SSC's square covering, as a function of
    the width: cells of width/2, keeping a point covers the +-2-cell
    square around its cell."""
    cand = np.flatnonzero(ok_s)

    def run(width: np.float32):
        c = np.maximum(np.float32(width / np.float32(2.0)), np.float32(1.0))
        G = _SSC_GRID
        gx_all = np.clip((uv_s[:, 0] / c).astype(np.int32), 0, G - 1)
        gy_all = np.clip((uv_s[:, 1] / c).astype(np.int32), 0, G - 1)
        covered = np.zeros((G, G), bool)
        keep = np.zeros(uv_s.shape[0], bool)
        for i in cand:
            gx, gy = gx_all[i], gy_all[i]
            if not covered[gy, gx]:
                keep[i] = True
                covered[max(gy - 2, 0) : gy + 3, max(gx - 2, 0) : gx + 3] = True
        return keep, int(keep.sum())

    return run


def _radius_search(uv, score, ok, k, cols, rows, make_greedy, tolerance=0.1):
    """Binary search for the suppression radius whose greedy keep count
    lands on k (within +tolerance), then the selection at the conservative
    end, capped at the k strongest kept (anms.h:39-120). Runs on the host;
    returns the keep mask on the candidates' device."""
    dev = ok.device
    uv_h = uv.detach().cpu().numpy().astype(np.float32)
    score_h = score.detach().cpu().numpy().astype(np.float32)
    ok_h = ok.detach().cpu().numpy()
    s = np.where(ok_h, score_h, np.float32(-np.inf))
    order = np.argsort(-s, kind="stable")
    uv_s = uv_h[order]
    ok_s = ok_h[order] & np.isfinite(s[order])
    greedy = make_greedy(uv_s, ok_s)
    lo = np.float32(1.0)
    hi = np.float32(float((cols**2 + rows**2) ** 0.5))
    hi_target = round(k * (1.0 + tolerance))
    for _ in range(_SEARCH_ITERS):
        mid = np.float32(np.float32(0.5) * (lo + hi))
        _, count = greedy(mid)
        if count > hi_target:  # too many kept: the radius is too small
            lo = mid
        else:
            hi = mid
    keep_s, _ = greedy(hi)
    keep = np.zeros_like(ok_h)
    keep[order] = keep_s
    s_kept = np.where(keep & ok_h, score_h, np.float32(-np.inf))
    final = np.zeros_like(ok_h)
    final[np.argsort(-s_kept, kind="stable")[:k]] = True
    return torch.from_numpy(final & keep & ok_h).to(dev)


def sdc(uv, score, ok, k, cols, rows, tolerance=0.1):
    """SDC / KdTree / RangeTree: the radius search with exact disks."""
    return _radius_search(uv, score, ok, k, cols, rows, _greedy_disk, tolerance)


def ssc(uv, score, ok, k, cols, rows, tolerance=0.1):
    """SSC: the radius search with square-grid covering."""
    return _radius_search(uv, score, ok, k, cols, rows, _greedy_ssc, tolerance)


def suppress_non_max(uv, score, ok, k: int, anms_type: int, cols: int, rows: int,
                     tolerance: float = 0.1) -> torch.Tensor:
    """AdaptiveNonMaximumSuppression::suppressNonMax for types 0-5 (type 6,
    binning, is corner_detection.binned_topk_select)."""
    if anms_type == 0:
        return top_n(score, ok, k)
    if anms_type == 1:
        return brown_anms(uv, score, ok, k)
    if anms_type in (2, 3, 4):
        return sdc(uv, score, ok, k, cols, rows, tolerance)
    if anms_type == 5:
        return ssc(uv, score, ok, k, cols, rows, tolerance)
    raise ValueError(f"unknown ANMS algorithm type {anms_type}")
