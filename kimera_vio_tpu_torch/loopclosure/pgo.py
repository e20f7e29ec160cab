"""Robust SE(3) pose-graph optimization (the KimeraRPGO replacement).

Port of kimera_vio_tpu/loopclosure/pgo.py:

  * PCM: the pairwise consistency of loop candidates as one batched
    [C, C] test, the consistent set by a greedy max-clique;
  * Gauss-Newton over the full pose graph: batched edge residuals
    Log(T_meas^-1 T_i^-1 T_j) with Jacobians by forward-mode autodiff,
    dense normal equations over all 6K pose DoF, Cholesky solve, gauge
    fixed by a prior on the anchor node.

The reference's `lax.scan` / `lax.while_loop` are Python loops of a fixed
length on the device: the Gauss-Newton loop runs `iters` steps and the
clique loop C steps (the most it can take), with no host read inside.
"""

from __future__ import annotations

import torch

from kimera_vio_tpu_torch.common import geometry as geo


def se3_edge_residual(Ri, ti, Rj, tj, R_meas, t_meas):
    """6-dim between-factor residual Log(T_meas^-1 (T_i^-1 T_j))."""
    RiT = Ri.transpose(-1, -2)
    R_ij = RiT @ Rj
    t_ij = (RiT @ (tj - ti)[..., None])[..., 0]
    dR = R_meas.transpose(-1, -2) @ R_ij
    dt = (R_meas.transpose(-1, -2) @ (t_ij - t_meas)[..., None])[..., 0]
    return torch.cat([geo.so3_log(dR), dt], dim=-1)


def _edge_blocks(rot, pos, edges_i, edges_j, R_meas, t_meas, w):
    """Linearize all edges at (rot, pos). Returns (Ji (E,6,6), Jj, r (E,6))
    whitened by the sqrt-weights w (E,)."""

    def one(Ri, pi, Rj, pj, Rm, tm, wk):
        def res(di, dj):
            return se3_edge_residual(Ri @ geo.so3_exp(di[0:3]), pi + di[3:6],
                                     Rj @ geo.so3_exp(dj[0:3]), pj + dj[3:6], Rm, tm)

        z = torch.zeros(6, dtype=pi.dtype, device=pi.device)
        r = res(z, z)
        Ji = torch.func.jacfwd(lambda d: res(d, z))(z)
        Jj = torch.func.jacfwd(lambda d: res(z, d))(z)
        return Ji * wk, Jj * wk, r * wk

    return torch.func.vmap(one)(rot[edges_i], pos[edges_i], rot[edges_j], pos[edges_j],
                                R_meas, t_meas, w)


def optimize_pose_graph(rot, pos, edges_i, edges_j, R_meas, t_meas, edge_weight, *,
                        iters: int = 10, anchor: int = 0):
    """Gauss-Newton over the full pose graph with node `anchor` held.
    Returns (rot (K,3,3), pos (K,3), costs (iters,)); a step whose normal
    matrix is not positive definite is NaN (as the reference's Cholesky)."""
    K = rot.shape[0]
    D = K * 6
    dev, dt = pos.device, pos.dtype
    eye_d = torch.eye(D, dtype=dt, device=dev)
    sw = torch.sqrt(torch.clamp(edge_weight, min=0.0))
    costs = []
    for _ in range(iters):
        Ji, Jj, r = _edge_blocks(rot, pos, edges_i, edges_j, R_meas, t_meas, sw)
        Hij = torch.einsum("eri,erj->eij", Ji, Jj)
        # Blocks in a (K, K, 6, 6) layout: block (a, b) is H[a, :, b, :] of
        # the reference's (K, 6, K, 6) matrix; repeated edges accumulate.
        H = torch.zeros((K, K, 6, 6), dtype=dt, device=dev)
        H.index_put_((edges_i, edges_i), torch.einsum("eri,erj->eij", Ji, Ji), accumulate=True)
        H.index_put_((edges_j, edges_j), torch.einsum("eri,erj->eij", Jj, Jj), accumulate=True)
        H.index_put_((edges_i, edges_j), Hij, accumulate=True)
        H.index_put_((edges_j, edges_i), Hij.transpose(-1, -2), accumulate=True)
        g = torch.zeros((K, 6), dtype=dt, device=dev)
        g.index_add_(0, edges_i, torch.einsum("eri,er->ei", Ji, r))
        g.index_add_(0, edges_j, torch.einsum("eri,er->ei", Jj, r))
        H[anchor, anchor] += 1e6 * torch.eye(6, dtype=dt, device=dev)
        Hf = H.permute(0, 2, 1, 3).reshape(D, D) + 1e-6 * eye_d
        L, info = torch.linalg.cholesky_ex(Hf)
        L = torch.where(info != 0, torch.full_like(L, torch.nan), L)
        delta = -torch.cholesky_solve(g.reshape(D, 1), L).reshape(K, 6)
        rot = rot @ geo.so3_exp(delta[:, 0:3])
        pos = pos + delta[:, 3:6]
        costs.append(torch.sum(r * r))
    return rot, pos, torch.stack(costs)


def edge_chi2(rot, pos, edges_i, edges_j, R_meas, t_meas):
    """Unweighted squared residual norm per edge at the given poses (the
    chi2 of the GNC weight update)."""
    r = se3_edge_residual(rot[edges_i], pos[edges_i], rot[edges_j], pos[edges_j], R_meas, t_meas)
    return torch.sum(r * r, dim=-1)


def pcm_consistency(odo_rot, odo_pos, loops_i, loops_j, R_loop, t_loop, mask, *,
                    rot_threshold: float = 0.01, trans_threshold: float = 0.1):
    """Pairwise consistency maximization over loop candidates, batched.

    For loops a = (i, j) and b = (k, l) the cycle
    T_loop_a^-1 odo(i->k) T_loop_b odo(l->j) must be ~identity. Returns
    the consistent-set mask (C,) of a greedy max-clique on the [C, C]
    consistency matrix."""
    C = loops_i.shape[0]

    def rel(ka, kb):
        RaT = odo_rot[ka].transpose(-1, -2)
        return RaT @ odo_rot[kb], torch.einsum("cij,cj->ci", RaT, odo_pos[kb] - odo_pos[ka])

    ii = loops_i[:, None].expand(C, C).reshape(-1)
    jj = loops_j[:, None].expand(C, C).reshape(-1)
    kk = loops_i[None, :].expand(C, C).reshape(-1)
    ll = loops_j[None, :].expand(C, C).reshape(-1)
    R_ik, t_ik = rel(ii, kk)
    R_lj, t_lj = rel(ll, jj)
    Ra = R_loop[:, None].expand(C, C, 3, 3).reshape(-1, 3, 3)
    ta = t_loop[:, None].expand(C, C, 3).reshape(-1, 3)
    Rb = R_loop[None, :].expand(C, C, 3, 3).reshape(-1, 3, 3)
    tb = t_loop[None, :].expand(C, C, 3).reshape(-1, 3)

    def compose(R1, t1, R2, t2):
        return R1 @ R2, torch.einsum("cij,cj->ci", R1, t2) + t1

    Rc, tc = compose(R_ik, t_ik, Rb, tb)
    Rc, tc = compose(Rc, tc, R_lj, t_lj)
    RaT = Ra.transpose(-1, -2)
    rot_err = torch.linalg.norm(geo.so3_log(RaT @ Rc), dim=-1).reshape(C, C)
    trans_err = torch.linalg.norm(torch.einsum("cij,cj->ci", RaT, tc - ta), dim=-1).reshape(C, C)
    consistent = (rot_err < rot_threshold) & (trans_err < trans_threshold)
    consistent = consistent & mask[:, None] & mask[None, :]

    # Greedy clique: keep the highest-degree active candidate, drop the
    # candidates inconsistent with it; each step retires one candidate, so
    # C steps finish (a step with nothing active changes nothing).
    active = mask.clone()
    clique = torch.zeros_like(mask)
    rows = torch.arange(C, device=mask.device)
    none = torch.full((C,), -1, device=mask.device)
    for _ in range(C):
        deg = torch.where(active, (consistent & active[None, :]).sum(-1), none)
        best = torch.argmax(deg)
        has = deg[best] >= 0
        clique = clique | ((rows == best) & has)
        active = torch.where(has, consistent[best] & active & (rows != best), active)
    member_ok = torch.where(clique[None, :], consistent, torch.ones_like(consistent)).all(-1)
    return clique & (member_ok | (clique.sum() <= 1))
