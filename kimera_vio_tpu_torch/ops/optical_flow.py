"""Image pyramids, LK gradients, rotational flow prediction, plain LK.

Port of the main-path parts of kimera_vio_tpu/ops/optical_flow.py:
`pyr_down`, `build_pyramid`, `_grad`, `predict_flow_rotational`, and the
plain pyramidal tracker `klt_track` (the reference's gather tracker, whose
level `_track_level` is the XLA level that `klt_track_pallas` hands its
coarse levels to). The level arithmetic and the coarse-to-fine loop live
in ops/lk_kernel.py (`lk_level_plain` with the window rule off,
`track_pyramid`), beside the CUDA kernel that replaces the Pallas tracker; the matmul-form tracker
(`klt_track_matmul` / `klt_track_cached`) is TPU-specific and not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from kimera_vio_tpu_torch.ops.corner_detection import _conv2d, image_gradients
from kimera_vio_tpu_torch.ops.lk_kernel import lk_level_plain, track_pyramid

# 5-tap binomial kernel used by cv::pyrDown.
_PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Gaussian blur + 2x decimation (cv::pyrDown) of an (H, W) image or a
    (..., H, W) stack; rows are decimated between the separable passes, as
    in the reference."""
    k = _PYR_K
    v = _conv2d(img, k[:, None])[..., ::2, :]
    return _conv2d(v, k[None, :])[..., ::2].contiguous()


def build_pyramid(img: torch.Tensor, max_level: int) -> list[torch.Tensor]:
    """Level 0 = full resolution ... max_level = coarsest; (B, H, W)
    stacks give (B, H_l, W_l) levels."""
    levels = [img.to(torch.float32)]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1]))
    return levels


def _grad(img: torch.Tensor):
    """3-tap Scharr / 32 gradients (cv::calcOpticalFlowPyrLK's pass), of
    an image or a stack."""
    gx, gy = image_gradients(img, scharr=True)
    return gx.contiguous(), gy.contiguous()


def klt_track(
    prev_pyr, cur_pyr, prev_pts, init_pts, valid, *,
    win: int = 24, max_iter: int = 30, eps: float = 0.1,
    min_eig_thresh: float = 1e-4, prev_grads=None,
):
    """Plain pyramidal LK (the reference's gather tracker): track
    `prev_pts` from prev to cur, seeded at `init_pts`, with the
    edge-replicated level of `_track_level` on every level. Returns
    (tracked_pts (N,2), ok (N,))."""
    if prev_grads is None:
        prev_grads = [_grad(p) for p in prev_pyr]
    pts, ok, _ = track_pyramid(
        lk_level_plain, prev_pyr, cur_pyr, prev_pts, init_pts, valid, prev_grads,
        win=win, max_iter=max_iter, eps=eps, min_eig_thresh=min_eig_thresh,
        search_rows=None,
    )
    return pts, ok


def predict_flow_rotational(uv, valid, R_cur_prev, K, K_inv, width: int, height: int):
    """Rotation-only flow prediction: warp keypoints by the infinite-depth
    homography K R K^-1 (RotationalOpticalFlowPredictor,
    OpticalFlowPredictor.cpp:70-126); out-of-image predictions keep the
    source position. uv (..., N, 2) with R_cur_prev (..., 1, 3, 3) (or
    (3, 3)) warps each stream's keypoints by its own rotation."""
    ones = torch.ones_like(uv[..., :1])
    h = torch.cat([uv, ones], dim=-1)
    rays = (K_inv @ h[..., None])[..., 0]
    rays = (R_cur_prev @ rays[..., None])[..., 0]
    proj = (K @ rays[..., None])[..., 0]
    z = proj[..., 2:3]
    good_z = z[..., 0] > 1e-6
    warped = proj[..., 0:2] / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    inb = (
        (warped[..., 0] >= 0)
        & (warped[..., 0] < width)
        & (warped[..., 1] >= 0)
        & (warped[..., 1] < height)
        & good_z
        & valid
    )
    return torch.where(inb[..., None], warped, uv)
