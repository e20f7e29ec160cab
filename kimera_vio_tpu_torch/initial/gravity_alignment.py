"""Online gravity alignment (VINS-Mono-style linear initialization).

Port of kimera_vio_tpu/initial/gravity_alignment.py (the reference's
OnlineGravityAlignment, src/initial/OnlineGravityAlignment.cpp, after Qin
& Shen, IROS'17): from visual relative poses over an initialization
window and the matching PIMs, estimate

  1. the gyroscope bias (least squares on the preintegrated-rotation
     error),
  2. per-frame velocities and the gravity vector in the visual frame (one
     linear system from the Delta-v / Delta-p preintegration equations),
  3. gravity refined on its magnitude sphere (2-DoF tangent updates).

Float32, as the reference; the normal equations are accumulated block by
block in the reference's scatter order (interval after interval), so both
sides round alike. The tensors' device is the caller's.
"""

from __future__ import annotations

import torch

from kimera_vio_tpu_torch.common import geometry as geo


def estimate_gyro_bias(R_vis, pim_delta_R, pim_dR_dbg, mask) -> torch.Tensor:
    """Least-squares gyro bias: per interval Log(DeltaR_pim^T R_i^T R_j)
    ~ dR_dbg @ bg (OnlineGravityAlignment::estimateGyroscopeBias).
    R_vis (F,3,3), pim_delta_R and pim_dR_dbg (F-1,3,3), mask (F-1,)."""
    R_rel = torch.einsum("fji,fjk->fik", R_vis[:-1], R_vis[1:])
    err = geo.so3_log(torch.einsum("fji,fjk->fik", pim_delta_R, R_rel))
    J = pim_dR_dbg
    w = mask.to(err.dtype)
    eye = torch.eye(3, dtype=err.dtype, device=err.device)
    H = torch.einsum("f,fij,fik->jk", w, J, J) + 1e-8 * eye
    g = torch.einsum("f,fij,fi->j", w, J, err)
    return torch.linalg.solve(H, g)


def _add_blocks(H, b, w, rows_J, rhs):
    """Add one equation's normal-equation blocks: rows_J is a list of
    (column starts (F-1,), Jacobian blocks (F-1, 3, d)); rhs (F-1, 3).
    Interval by interval, as the reference's scatter-add."""
    for ci, Ji in rows_J:
        for cj, Jj in rows_J:
            blk = torch.einsum("f,fri,frj->fij", w, Ji, Jj)
            di, dj = Ji.shape[-1], Jj.shape[-1]
            for f in range(blk.shape[0]):
                H[ci[f]:ci[f] + di, cj[f]:cj[f] + dj] += blk[f]
        rhs_i = torch.einsum("f,fri,fr->fi", w, Ji, rhs)
        for f in range(rhs_i.shape[0]):
            b[ci[f]:ci[f] + Ji.shape[-1]] += rhs_i[f]


def align_velocities_and_gravity(R_vis, p_vis, delta_t, delta_v, delta_p, mask,
                                 gravity_norm: float = 9.81, refine_iters: int = 2):
    """Per-frame velocities and gravity from the preintegration equations

        R_i^T (p_j - p_i - v_i dt - 0.5 g dt^2) = delta_p
        R_i^T (v_j - v_i - g dt) = delta_v

    with unknowns [v_0 .. v_{F-1}, g]; then `refine_iters` re-solves with g
    on the sphere of radius `gravity_norm`. Returns (velocities (F,3),
    gravity (3,))."""
    F = R_vis.shape[0]
    n = 3 * F + 3
    dt_, dev = R_vis.dtype, R_vis.device
    RiT = R_vis[:-1].transpose(-1, -2)
    dt = delta_t[:, None]
    w = mask.to(dt_)
    col_vi = [3 * f for f in range(F - 1)]
    col_vj = [3 * (f + 1) for f in range(F - 1)]
    col_g = [3 * F] * (F - 1)

    J_vi_1 = -RiT * dt[..., None]
    J_g_1 = -0.5 * RiT * (dt**2)[..., None]
    rhs_1 = delta_p - torch.einsum("fij,fj->fi", RiT, p_vis[1:] - p_vis[:-1])
    J_vi_2, J_vj_2 = -RiT, RiT
    J_g_2 = -RiT * dt[..., None]
    rhs_2 = delta_v

    H = torch.zeros((n, n), dtype=dt_, device=dev)
    b = torch.zeros(n, dtype=dt_, device=dev)
    _add_blocks(H, b, w, [(col_vi, J_vi_1), (col_g, J_g_1)], rhs_1)
    _add_blocks(H, b, w, [(col_vi, J_vi_2), (col_vj, J_vj_2), (col_g, J_g_2)], rhs_2)
    x = torch.linalg.solve(H + 1e-6 * torch.eye(n, dtype=dt_, device=dev), b)
    vels, gravity = x[:3 * F].reshape(F, 3), x[3 * F:]

    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=dt_, device=dev)
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=dt_, device=dev)
    m = 3 * F + 2
    for _ in range(refine_iters):
        g0 = gravity / torch.linalg.norm(gravity) * gravity_norm
        tmp = torch.where(torch.abs(g0[0]) < 0.9 * gravity_norm, e_x, e_y)
        b1 = torch.linalg.cross(g0, tmp)
        b1 = b1 / torch.linalg.norm(b1)
        b2 = torch.linalg.cross(g0, b1)
        b2 = b2 / torch.linalg.norm(b2)
        B = torch.stack([b1, b2], dim=1)
        H2 = torch.zeros((m, m), dtype=dt_, device=dev)
        bb = torch.zeros(m, dtype=dt_, device=dev)
        rhs_1b = rhs_1 - torch.einsum("fij,j->fi", J_g_1, g0)
        rhs_2b = rhs_2 - torch.einsum("fij,j->fi", J_g_2, g0)
        Jg1B = torch.einsum("fij,jk->fik", J_g_1, B)
        Jg2B = torch.einsum("fij,jk->fik", J_g_2, B)
        _add_blocks(H2, bb, w, [(col_vi, J_vi_1), (col_g, Jg1B)], rhs_1b)
        _add_blocks(H2, bb, w, [(col_vi, J_vi_2), (col_vj, J_vj_2), (col_g, Jg2B)], rhs_2b)
        x2 = torch.linalg.solve(H2 + 1e-6 * torch.eye(m, dtype=dt_, device=dev), bb)
        vels = x2[:3 * F].reshape(F, 3)
        gravity = g0 + B @ x2[3 * F:]
    gravity = gravity / torch.linalg.norm(gravity) * gravity_norm
    return vels, gravity
