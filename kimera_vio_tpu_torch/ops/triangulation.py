"""Multi-view stereo triangulation of smart landmarks, batched.

Port of kimera_vio_tpu/ops/triangulation.py (`triangulate_stereo_landmarks`
with its closed-form symmetric 3x3 helpers, and the generic ray
least-squares `triangulate_rays`): every landmark is triangulated
from all its masked stereo rays across the window (ray least squares),
polished with Gauss-Newton on the stereo reprojection error, then gated
by the reference's rankTolerance / landmarkDistanceThreshold /
outlierRejection / cheirality checks. Intermediates keep (K, L) as their
trailing axes, as in the reference, so sums run in the same order.
"""

from __future__ import annotations

import math

import torch


def _sym3_inv_apply(a, b, c, d, e, f, g0, g1, g2, jitter=0.0):
    """x = A^{-1} g for symmetric A = [[a,b,c],[b,d,e],[c,e,f]] (+ jitter*I),
    elementwise over arbitrary batch shapes (adjugate form; the reference
    hand-unrolls its 3x3 inverses the same way, Tracker.cpp:497-542)."""
    a = a + jitter
    d = d + jitter
    f = f + jitter
    # Trace-normalize so f32 cofactors stay near unit magnitude.
    s = torch.clamp((a + d + f) / 3.0, min=1e-12)
    a, b, c, d, e, f = a / s, b / s, c / s, d / s, e / s, f / s
    c00 = d * f - e * e
    c01 = c * e - b * f
    c02 = b * e - c * d
    c11 = a * f - c * c
    c12 = b * c - a * e
    c22 = a * d - b * b
    det = a * c00 + b * c01 + c * c02
    k = 1.0 / (det * s)
    x0 = (c00 * g0 + c01 * g1 + c02 * g2) * k
    x1 = (c01 * g0 + c11 * g1 + c12 * g2) * k
    x2 = (c02 * g0 + c12 * g1 + c22 * g2) * k
    return x0, x1, x2


def _sym3_min_eig(a, b, c, d, e, f):
    """Smallest eigenvalue of symmetric [[a,b,c],[b,d,e],[c,e,f]],
    elementwise (trigonometric/Cardano method for 3x3 symmetric, scale-
    normalized, plus one Newton step on the characteristic polynomial --
    raw f32 Cardano loses up to ~1e-4 * tr under high anisotropy)."""
    # Normalize scale so the cubic's coefficients are O(1) in f32.
    sc = torch.clamp((torch.abs(a) + torch.abs(d) + torch.abs(f)) / 3.0, min=1e-30)
    a, b, c, d, e, f = a / sc, b / sc, c / sc, d / sc, e / sc, f / sc
    p1 = b * b + c * c + e * e
    q = (a + d + f) / 3.0
    p2 = (a - q) ** 2 + (d - q) ** 2 + (f - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    ps = torch.where(p < 1e-12, 1.0, p)  # A ~ q*I: all eigs = q
    b00 = (a - q) / ps
    b11 = (d - q) / ps
    b22 = (f - q) / ps
    b01, b02, b12 = b / ps, c / ps, e / ps
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    # Smallest eigenvalue: q + 2 p cos(phi + 2*pi/3).
    lam = torch.where(p < 1e-12, q, q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0))
    # One Newton step on det(A - lam I) = -lam^3 + tr lam^2 - m2 lam + det.
    tr = a + d + f
    m2 = (d * f - e * e) + (a * f - c * c) + (a * d - b * b)
    det = (
        a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d)
    )
    fv = -lam * lam * lam + tr * lam * lam - m2 * lam + det
    fp = -3.0 * lam * lam + 2.0 * tr * lam - m2
    # Clamp to the scale of Cardano's f32 error: near a double eigenvalue
    # f' ~ 0 and an unclamped step diverges.
    step = torch.clamp(fv / torch.where(torch.abs(fp) < 1e-12, torch.ones_like(fp), fp), -1e-3, 1e-3)
    lam = lam - step
    return lam * sc


def triangulate_rays(
    origins: torch.Tensor,  # (..., M, 3) ray origins (world)
    dirs: torch.Tensor,  # (..., M, 3) unit ray directions (world)
    mask: torch.Tensor,  # (..., M)
):
    """Least-squares point minimizing the sum of squared distances to rays:
    [sum_m (I - d d^T)] p = sum_m (I - d d^T) o. Returns (point (...,3),
    ok (...,): two rays or more, min_eig (...,): the smallest eigenvalue
    of the normal matrix over the ray count, the rankTolerance measure)."""
    w = mask.to(origins.dtype)[..., None, None]
    eye = torch.eye(3, dtype=origins.dtype, device=origins.device)
    P = eye - dirs[..., :, None] * dirs[..., None, :]  # (..., M, 3, 3)
    A = torch.sum(P * w, dim=-3)
    b = torch.sum((P @ origins[..., None]) * w, dim=-3)[..., 0]
    n_obs = mask.sum(-1)
    # Regularized for the unobserved case; the gates drop those anyway.
    A_reg = A + 1e-9 * eye
    p = torch.linalg.solve(A_reg, b[..., None])[..., 0]
    eigs = torch.linalg.eigvalsh(A_reg)
    min_eig = eigs[..., 0] / torch.clamp(n_obs, min=1)
    return p, n_obs >= 2, min_eig


def triangulate_stereo_landmarks(
    R_w_cam: torch.Tensor,  # (K,3,3) world-from-rect-cam rotations per state
    t_w_cam: torch.Tensor,  # (K,3) camera centers (world)
    obs_uvd: torch.Tensor,  # (L,K,3) [uL,uR,v] rectified stereo measurements
    obs_mask: torch.Tensor,  # (L,K)
    *,
    fx,
    fy,
    cx,
    cy,
    baseline,
    refine_iters: int = 2,
    rank_tolerance: float = 1.0,
    landmark_distance_threshold: float = 10.0,
    outlier_rejection_px: float = 3.0,
    newest_idx: int | torch.Tensor = -1,
):
    """Triangulate L landmarks from stereo observations across K states.

    Returns (points_w (L,3), valid (L,), mean_reproj_err (L,)).

    Each stereo observation contributes two rays (left pinhole at the
    camera center, right pinhole at center + baseline * cam_x_axis).
    """
    L, K, _ = obs_uvd.shape
    dt = R_w_cam.dtype
    obs = obs_uvd.permute(2, 1, 0)  # (3,K,L)
    uL, uR, v = obs[0], obs[1], obs[2]
    # Mono measurements carry uR = NaN (reference convention,
    # MonoVisionImuFrontend.cpp:230-340): their right ray is masked out and
    # the NaN replaced to keep arithmetic clean.
    stereo_ok = torch.isfinite(uR)  # (K,L)
    uR = torch.where(stereo_ok, uR, uL)
    m_kl = obs_mask.T  # (K,L)
    wL = m_kl.to(dt)
    wR = (m_kl & stereo_ok).to(dt)

    # Ray directions in the rectified camera frame -> world, (3,K,L).
    def world_ray(u, vv):
        x = (u - cx) / fx
        y = (vv - cy) / fy
        d = torch.stack([x, y, torch.ones_like(x)])  # (3,K,L)
        d = d / torch.linalg.norm(d, dim=0)
        return torch.einsum("kij,jkl->ikl", R_w_cam, d)

    dL = world_ray(uL, v)
    dR = world_ray(uR, v)
    oL = t_w_cam.T  # (3,K)
    oR = (t_w_cam + baseline * R_w_cam[:, :, 0]).T  # right center, (3,K)

    # Normal equations sum_rays w (I - d d^T) p = sum_rays w (I - d d^T) o,
    # accumulated as six symmetric components (L,) + rhs (3,L) -- all
    # reductions over elementwise (K,L) planes.
    def accumulate(d, o, w):
        d0, d1, d2 = d[0], d[1], d[2]
        a = (w * (1.0 - d0 * d0)).sum(0)
        b = (w * (-d0 * d1)).sum(0)
        c = (w * (-d0 * d2)).sum(0)
        dd = (w * (1.0 - d1 * d1)).sum(0)
        e = (w * (-d1 * d2)).sum(0)
        f = (w * (1.0 - d2 * d2)).sum(0)
        dot = d0 * o[0][:, None] + d1 * o[1][:, None] + d2 * o[2][:, None]
        g0 = (w * (o[0][:, None] - d0 * dot)).sum(0)
        g1 = (w * (o[1][:, None] - d1 * dot)).sum(0)
        g2 = (w * (o[2][:, None] - d2 * dot)).sum(0)
        return torch.stack([a, b, c, dd, e, f]), torch.stack([g0, g1, g2])

    AL, gLh = accumulate(dL, oL, wL)
    AR, gRh = accumulate(dR, oR, wR)
    A = AL + AR  # (6,L) symmetric components [a,b,c,d,e,f]
    gh = gLh + gRh  # (3,L)
    n_obs2 = wL.sum(0) + wR.sum(0)
    p0, p1, p2 = _sym3_inv_apply(
        A[0], A[1], A[2], A[3], A[4], A[5], gh[0], gh[1], gh[2], jitter=1e-9
    )
    p = torch.stack([p0, p1, p2])  # (3,L) world points
    min_eig = _sym3_min_eig(
        A[0] + 1e-9, A[1], A[2], A[3] + 1e-9, A[4], A[5] + 1e-9
    ) / torch.clamp(n_obs2, min=1.0)
    ok = n_obs2 >= 2  # ray count: one stereo obs (2 rays) suffices

    # Reprojection in trailing-(K,L) layout: returns pred (3,K,L), depth and
    # the camera-frame point (3,K,L) for the Jacobian.
    def reproject(pts):  # pts (3,L)
        pc = torch.einsum(
            "kji,jkl->ikl", R_w_cam, pts[:, None, :] - t_w_cam.T[:, :, None]
        )
        z = pc[2]
        safe_z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
        iz = 1.0 / safe_z
        pred = torch.stack(
            [
                fx * pc[0] * iz + cx,
                fx * (pc[0] - baseline) * iz + cx,
                fy * pc[1] * iz + cy,
            ]
        )
        return pred, z, pc, iz

    meas = torch.stack([obs[0], uR, obs[2]])  # (3,K,L), mono uR replaced by uL

    # --- Gauss-Newton polish on stereo reprojection error ------------------
    # Analytic point Jacobian: dr[a]/dp_w = Jproj[a,b] (R_w_cam^T)[b,m]
    # (the E-matrix of the smart-factor linearization, unscaled).
    R_wc_T = R_w_cam.transpose(-1, -2)
    row_w = torch.stack([wL, wR * stereo_ok.to(dt), wL])  # (3,K,L)

    for _ in range(refine_iters):
        pred, _, pc, iz = reproject(p)
        r = (pred - meas) * row_w  # (3,K,L)
        zeros = torch.zeros_like(iz)
        Jproj = torch.stack(
            [
                torch.stack([fx * iz, zeros, -fx * pc[0] * iz * iz]),
                torch.stack([fx * iz, zeros, -fx * (pc[0] - baseline) * iz * iz]),
                torch.stack([zeros, fy * iz, -fy * pc[1] * iz * iz]),
            ]
        )  # (3,3,K,L)
        E = torch.einsum("abkl,kbm->amkl", Jproj, R_wc_T) * row_w[:, None]
        # H = sum_{a,k} E E^T (six components), g = sum E r.
        Ha = (E[:, 0] * E[:, 0]).sum((0, 1))
        Hb = (E[:, 0] * E[:, 1]).sum((0, 1))
        Hc = (E[:, 0] * E[:, 2]).sum((0, 1))
        Hd = (E[:, 1] * E[:, 1]).sum((0, 1))
        He = (E[:, 1] * E[:, 2]).sum((0, 1))
        Hf = (E[:, 2] * E[:, 2]).sum((0, 1))
        g0 = (E[:, 0] * r).sum((0, 1))
        g1 = (E[:, 1] * r).sum((0, 1))
        g2 = (E[:, 2] * r).sum((0, 1))
        s0, s1, s2 = _sym3_inv_apply(
            Ha, Hb, Hc, Hd, He, Hf, g0, g1, g2, jitter=1e-6
        )
        p = p - torch.stack([s0, s1, s2])

    # --- degeneracy / outlier gates ----------------------------------------
    pred, depth, _, _ = reproject(p)
    diff = pred - meas
    diff = torch.stack([diff[0], torch.where(stereo_ok, diff[1], torch.zeros_like(diff[1])), diff[2]])
    err = torch.linalg.norm(diff, dim=0)  # (K,L)
    err = torch.where(m_kl, err, torch.zeros_like(err))
    n_obs = torch.clamp(m_kl.sum(0), min=1)
    mean_err = err.sum(0) / n_obs  # (L,)
    cheirality_ok = torch.all(torch.where(m_kl, depth > 0.05, torch.ones_like(m_kl)), dim=0)
    # Distance from the newest observing camera.
    t_new = t_w_cam[newest_idx]
    dist = torch.linalg.norm(p - t_new[:, None], dim=0)
    pT = p.T  # (L,3)
    valid = (
        ok
        & cheirality_ok
        & (mean_err < outlier_rejection_px)
        & (dist < landmark_distance_threshold)
        & (min_eig > 1e-5 * rank_tolerance)
        & torch.all(torch.isfinite(pT), dim=-1)
    )
    return pT, valid, mean_err
