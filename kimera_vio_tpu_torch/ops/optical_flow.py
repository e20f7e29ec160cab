"""Image pyramids, LK gradients, rotational flow prediction, plain LK.

Port of kimera_vio_tpu/ops/optical_flow.py: `pyr_down`, `build_pyramid`,
`_grad`, `predict_flow_rotational`, the plain pyramidal tracker
`klt_track` (the reference's gather tracker, whose level `_track_level` is
the XLA level that `klt_track_pallas` hands its coarse levels to; its
level arithmetic and coarse-to-fine loop live in ops/lk_kernel.py,
`lk_level_plain` with the window rule off and `track_pyramid`), and the
JAX package's default tracker, `lk_impl="matmul"`: `build_lk_templates`
(the per-keyframe template cache) and `klt_track_cached` /
`klt_track_matmul` over `_iterate_level_cached`. The plain versions here
run on the CPU; on the card `build_lk_templates_lk` and
`klt_track_cached_lk` (ops/lk_kernel.py) launch the CUDA kernels that
compute `build_lk_templates` and `klt_track_cached`.

The matmul tracker resamples its windows as two matmuls against two-hot
bilinear weight rows (rows first, then columns). Each row has two
nonzeros, (1 - f) and f, so here it is the 4-tap blend in that order: a
y-lerp of two rows, then an x-lerp of two columns.
"""

from __future__ import annotations

import numpy as np
import torch

from kimera_vio_tpu_torch.ops.corner_detection import _conv2d, image_gradients
from kimera_vio_tpu_torch.ops.lk_kernel import _read, lk_level_plain, track_pyramid

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


# ---------------------------------------------------------------------------
# The JAX package's default tracker (lk_impl="matmul"): a template cache
# built on keyframes, and per-frame iterations inside one search patch a
# level.
# ---------------------------------------------------------------------------

_DERIV_X = np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], np.float32) / 32.0
_DERIV_Y = _DERIV_X.T
SLACK = 8  # px of drift a search patch allows around a level's seed


def _flat(img: torch.Tensor, pts: torch.Tensor):
    """(B, H, W) planes, (B*N, 2) points and the stream of each point, from
    an (H, W) plane with (N, 2) points or a (B, H, W) stack with (B, N, 2)."""
    planes = img if img.dim() == 3 else img[None]
    n_per = pts.shape[-2]
    s = torch.arange(planes.shape[0], device=img.device).repeat_interleave(n_per)
    return planes, pts.reshape(-1, 2), s


def _patches(img: torch.Tensor, s: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
             size: int) -> torch.Tensor:
    """(M, size, size) patches of the (B, H, W) planes, stream s, origin
    (oy, ox), edge-clamped: `jnp.pad(mode="edge")` then a dynamic slice."""
    a = torch.arange(size, device=img.device)
    return _read(img, s, oy[:, None] + a, ox[:, None] + a)


def _lerp_rows_cols(P: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """(M, w, w) bilinear windows from (M, w+1, w+1) raw windows with
    per-keypoint fractions: rows first, then columns (the order of the
    reference's two resampling matmuls)."""
    fy = fy[:, None, None]
    fx = fx[:, None, None]
    ya = (1.0 - fy) * P[:, :-1, :] + fy * P[:, 1:, :]
    return (1.0 - fx) * ya[:, :, :-1] + fx * ya[:, :, 1:]


def _scharr_on_patch(raw: torch.Tensor, deriv: np.ndarray, St: int) -> torch.Tensor:
    """3x3 correlation of (M, St+2, St+2) patches, valid part (M, St, St),
    summed over the nonzero taps in row-major order as the reference does."""
    out = None
    for dy in range(3):
        for dx in range(3):
            c = float(deriv[dy, dx])
            if c == 0.0:
                continue
            term = c * raw[:, dy : dy + St, dx : dx + St]
            out = term if out is None else out + term
    return out


def _build_level_template(prev_img, prev_Ix, prev_Iy, prev_pts, valid, win: int,
                          min_eig_thresh: float) -> dict:
    """Template data of one LK level: the template window, its gradients,
    the inverse 2x2 gradient matrix and the min-eigenvalue gate, at the
    keyframe's keypoints. With prev_Ix None the Scharr gradients are taken
    on each keypoint's edge-padded patch (what the frontend uses), else
    resampled from the given full-image gradients. Planes (H, W) with
    points (N, 2), or a stream axis: (B, H, W) with (B, N, 2)."""
    lead = prev_pts.shape[:-1]
    planes, pts, s = _flat(prev_img, prev_pts)
    _, H, W = planes.shape
    St = win + 2
    half = (win - 1) * 0.5
    t_corner = torch.floor(pts - half)
    t_origin = t_corner.to(torch.int64)
    t_off = pts - half - t_corner  # in [0, 1)
    if prev_Ix is None:
        Sg = St + 2  # a 1 px ring for the 3x3 Scharr on the patch
        pad = Sg + 2
        # The reference slices the image padded by `pad`; the slice start
        # is clamped to stay inside it.
        oy = torch.clamp(t_origin[:, 1] - 1, -pad, H + pad - Sg)
        ox = torch.clamp(t_origin[:, 0] - 1, -pad, W + pad - Sg)
        raw = _patches(planes, s, oy, ox, Sg)
        trio = (raw[:, 1 : 1 + St, 1 : 1 + St], _scharr_on_patch(raw, _DERIV_X, St),
                _scharr_on_patch(raw, _DERIV_Y, St))
    else:
        pad = St + 2
        oy = torch.clamp(t_origin[:, 1], -pad, H + pad - St)
        ox = torch.clamp(t_origin[:, 0], -pad, W + pad - St)
        trio = tuple(_patches(p if p.dim() == 3 else p[None], s, oy, ox, St)
                     for p in (prev_img, prev_Ix, prev_Iy))
    # The fraction is in [0, 1): each window reads the patch's first win + 1
    # rows and columns.
    tmpl, gx, gy = (_lerp_rows_cols(p[:, : win + 1, : win + 1], t_off[:, 1], t_off[:, 0])
                    for p in trio)

    gxx = torch.sum(gx * gx, dim=(-2, -1))
    gxy = torch.sum(gx * gy, dim=(-2, -1))
    gyy = torch.sum(gy * gy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    half_tr = 0.5 * (gxx + gyy)
    min_eig = (half_tr - torch.sqrt(torch.clamp(half_tr**2 - det, min=0.0))) / (win * win)
    good_g = (min_eig > min_eig_thresh) & valid.reshape(-1)
    safe_det = torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))
    out = {"tmpl": tmpl, "gx": gx, "gy": gy, "inv00": gyy / safe_det,
           "inv01": -gxy / safe_det, "inv11": gxx / safe_det, "good_g": good_g}
    return {k: v.reshape(*lead, *v.shape[1:]).contiguous() for k, v in out.items()}


def build_lk_templates(prev_pyr, prev_pts, valid, *, win: int = 24,
                       min_eig_thresh: float = 1e-4, prev_grads=None) -> tuple:
    """Per-level LK template cache for `klt_track_cached` (level 0 first,
    as prev_pyr; None for a level too small for a window). Without
    prev_grads the gradients are taken on the extracted patches."""
    out = []
    for lvl, img in enumerate(prev_pyr):
        if min(img.shape[-2:]) < win + 2:
            out.append(None)
            continue
        Ix, Iy = prev_grads[lvl] if prev_grads is not None else (None, None)
        out.append(_build_level_template(img, Ix, Iy, prev_pts / (2.0**lvl), valid, win,
                                         min_eig_thresh))
    return tuple(out)


def _iterate_level_cached(T: dict, cur_img, cur_pts, valid, win: int, max_iter: int,
                          eps: float, is_level0: bool, slack: int = SLACK):
    """One LK level against cached template data: one (S, S) search patch
    of the current level per keypoint, S = win + 2 slack + 2, around the
    seed, and up to max_iter Gauss-Newton steps inside it. A window offset
    leaving the patch is clipped, and by more than 0.5 px marks the
    keypoint diverged. Each keypoint stops at its own convergence and is
    checked before each of its own steps (the reference checks every
    keypoint while any moves; the positions are the same). Returns (pts,
    ok, diverged, iters) with the inputs' leading axes."""
    lead = cur_pts.shape[:-1]
    planes, pts, s = _flat(cur_img, cur_pts)
    _, H, W = planes.shape
    dev = pts.device
    S = win + 2 * slack + 2
    half = (win - 1) * 0.5
    flat = {k: v.reshape(-1, *v.shape[len(lead):]) for k, v in T.items()}
    tmpl, gx, gy = flat["tmpl"], flat["gx"], flat["gy"]
    inv00, inv01, inv11, good = flat["inv00"], flat["inv01"], flat["inv11"], flat["good_g"]
    # The initial offset lands at slack + 1 + frac; the patch start is
    # clamped as the reference's slice of the S-padded level clamps it.
    c_origin = torch.floor(pts - half).to(torch.int64) - (slack + 1)
    P = _patches(planes, s, torch.clamp(c_origin[:, 1], -S, H),
                 torch.clamp(c_origin[:, 0], -S, W), S)
    c_f = c_origin.to(torch.float32)
    rel = pts - c_f
    hi = float(S - win - 1)
    M = pts.shape[0]
    n_idx = torch.arange(M, device=dev)[:, None, None]
    a1 = torch.arange(win + 1, device=dev)
    moving = good.clone()
    diverged = torch.zeros(M, dtype=torch.bool, device=dev)
    iters = torch.zeros(M, dtype=torch.int32, device=dev)
    for _ in range(max_iter):
        act = moving
        if not bool(act.any()):
            break
        off = rel - half
        off_c = torch.clamp(off, 0.0, hi)
        diverged = diverged | (act & (torch.abs(off - off_c) > 0.5).any(-1))
        k = torch.floor(off_c)
        f = off_c - k
        ki = k.to(torch.int64)
        raw = P[n_idx, (ki[:, 1:2] + a1)[:, :, None], (ki[:, 0:1] + a1)[:, None, :]]
        dI = _lerp_rows_cols(raw, f[:, 1], f[:, 0]) - tmpl
        bx = torch.sum(dI * gx, dim=(-2, -1))
        by = torch.sum(dI * gy, dim=(-2, -1))
        dx = -(inv00 * bx + inv01 * by)
        dy = -(inv01 * bx + inv11 * by)
        rel = torch.where(act[:, None], rel + torch.stack([dx, dy], -1), rel)
        moving = moving & ~(act & (dx * dx + dy * dy < eps * eps))
        iters = iters + act.to(torch.int32)
    pts = rel + c_f
    if is_level0:
        halfw = win * 0.5
        inb = ((pts[:, 0] >= halfw) & (pts[:, 0] < W - halfw)
               & (pts[:, 1] >= halfw) & (pts[:, 1] < H - halfw))
        ok = good & inb
    else:
        ok = valid.reshape(-1)
    return (pts.reshape(*lead, 2), ok.reshape(lead), diverged.reshape(lead),
            iters.reshape(lead))


def track_cached(templates, cur_pyr, init_pts, valid, *, win: int = 24, max_iter: int = 30,
                 eps: float = 0.1, slack: int = SLACK):
    """`klt_track_cached` with the Gauss-Newton steps each keypoint took on
    each level: returns (pts, ok, iters (..., N, n_levels) int32, indexed
    by level number, 0 on skipped levels)."""
    n = len(cur_pyr)
    pts = init_pts / 2.0 ** (n - 1)
    ok = valid
    diverged = torch.zeros_like(valid)
    iters = torch.zeros((*valid.shape, n), dtype=torch.int32, device=valid.device)
    for lvl in range(n - 1, -1, -1):
        if lvl != n - 1:
            pts = pts * 2.0
        if templates[lvl] is None:
            continue
        pts, ok_lvl, div, it = _iterate_level_cached(
            templates[lvl], cur_pyr[lvl], pts, valid, win, max_iter, eps, lvl == 0, slack)
        ok = ok & ok_lvl
        diverged = diverged | div
        iters[..., lvl] = it
    return pts, ok & ~diverged, iters


def klt_track_cached(templates, cur_pyr, init_pts, valid, *, win: int = 24,
                     max_iter: int = 30, eps: float = 0.1):
    """Pyramidal LK against a cached template set (`build_lk_templates`),
    plain PyTorch: coarse to fine, one search patch a level per keypoint,
    the in-image gate at level 0, and tracks that drift out of a level's
    patch failed. Points (N, 2) with (H, W) levels, or (B, N, 2) with (B,
    H, W) levels and (B, N) flags and templates. Returns (pts, ok)."""
    pts, ok, _ = track_cached(templates, cur_pyr, init_pts, valid, win=win,
                              max_iter=max_iter, eps=eps)
    return pts, ok


def klt_track_matmul(prev_pyr, cur_pyr, prev_pts, init_pts, valid, *, win: int = 24,
                     max_iter: int = 30, eps: float = 0.1, min_eig_thresh: float = 1e-4,
                     prev_grads=None):
    """The JAX package's matmul tracker: `build_lk_templates` on prev, then
    `klt_track_cached` on cur. Same contract as `klt_track`."""
    templates = build_lk_templates(prev_pyr, prev_pts, valid, win=win,
                                   min_eig_thresh=min_eig_thresh, prev_grads=prev_grads)
    return klt_track_cached(templates, cur_pyr, init_pts, valid, win=win, max_iter=max_iter,
                            eps=eps)
