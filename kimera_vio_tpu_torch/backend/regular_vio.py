"""RegularVIO backend: structural-regularity (point-on-plane) factors.

Port of kimera_vio_tpu/backend/regular_vio.py (the reference
RegularVioBackend, Rosinol ICRA'19; src/backend/RegularVioBackend.cpp):
landmarks associated with a mesher plane get a point-on-plane residual
(n . p - d) / sigma (src/factors/PointPlaneFactor.cpp), and planes are
states of the solve.

  * Plane states: P slots of [unit normal, d], with a 3-DoF tangent
    [2 normal-tangent, 1 distance] (the reference's OrientedPlane3).
  * Landmarks stay eliminated: the plane rows join each landmark's 3x3
    block before the Schur complement, which yields the pose-plane
    couplings an explicit-landmark formulation would.
  * The system is D = K*15 + P*3; it holds the IMU, no-motion, prior and
    smart-plus-regularity blocks (no between, odometry or
    constant-velocity factors, as in the JAX package), with optional
    parallel-plane regularities between slot pairs.

The projection residuals and their Jacobians are the smoother's
closed-form ones (`smoother._projection_blocks`, held against
`torch.func.jacfwd` in tests/test_torch_regular_vio.py), where the JAX
package takes them by `jax.jacfwd`; the landmark blocks are inverted in
closed form (`smoother._inv3_sym`), where the JAX package calls
`jnp.linalg.inv`; the parallel-plane Jacobian through the retraction is
closed form too. `plane_assoc` (L,) holds the plane slot of each landmark
(-1 for none); the pipeline derives it from the mesher's segmentation and
the PlaneTracker's association (mesher/).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.backend import smoother as sm
from kimera_vio_tpu_torch.common.geometry import hat
from kimera_vio_tpu_torch.common.types import replace


@dataclass
class PlaneStates:
    """P plane slots: unit normal and signed distance (n . p = d)."""

    normal: torch.Tensor  # (P,3)
    d: torch.Tensor  # (P,)
    mask: torch.Tensor  # (P,)

    @classmethod
    def empty(cls, P: int, device="cuda", dtype=torch.float32) -> "PlaneStates":
        device = resolve_device(device)
        n = torch.zeros((P, 3), dtype=dtype, device=device)
        n[:, 2] = 1.0
        return cls(normal=n, d=torch.zeros(P, dtype=dtype, device=device),
                   mask=torch.zeros(P, dtype=torch.bool, device=device))


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)


def _basis_aux(n: torch.Tensor):
    """The tangent basis' helper axis t and c = n x t."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device).expand(n.shape)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device).expand(n.shape)
    t = torch.where(torch.abs(n[..., 0:1]) < 0.9, ex, ey)
    return t, torch.linalg.cross(n, t, dim=-1)


def plane_tangent_basis(normal: torch.Tensor) -> torch.Tensor:
    """(...,3) unit normal -> (...,3,2) tangent basis of the unit sphere."""
    _, c = _basis_aux(normal)
    b1 = _normalize(c)
    b2 = torch.linalg.cross(normal, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)


def retract_planes(planes: PlaneStates, delta: torch.Tensor) -> PlaneStates:
    """delta (P,3): [2 normal-tangent, 1 distance]."""
    B = plane_tangent_basis(planes.normal)
    n_new = _normalize(planes.normal + torch.einsum("pij,pj->pi", B, delta[:, 0:2]))
    return replace(planes, normal=n_new, d=planes.d + delta[:, 2])


def point_plane_blocks(planes: PlaneStates, pts, lmk_ok, plane_assoc, sigma):
    """Per-landmark point-on-plane residual r = (n . p - d) / sigma with its
    Jacobians with respect to the point (L,3) and the plane tangent (L,3).
    Returns (r (L,), J_pt, J_plane, w (L,)); `w` masks landmarks without
    a valid plane."""
    idx = torch.clamp(plane_assoc, 0, planes.normal.shape[0] - 1).long()
    n = planes.normal[idx]
    d = planes.d[idx]
    B = plane_tangent_basis(planes.normal)[idx]
    r = (torch.einsum("li,li->l", n, pts) - d) / sigma
    J_pt = n / sigma
    J_n = torch.einsum("li,lij->lj", pts, B) / sigma
    J_plane = torch.cat([J_n, -torch.ones_like(d[:, None]) / sigma], -1)
    w = ((plane_assoc >= 0) & lmk_ok & planes.mask[idx]).to(pts.dtype)
    return r, J_pt, J_plane, w


def _parallel_J1_n(n1: torch.Tensor, n2: torch.Tensor, sigma_n) -> torch.Tensor:
    """d/d(dl) of B(normalize(n1 + B(n1) dl))^T n2 / sigma_n at dl = 0,
    batched (...,3) -> (...,2,2): the derivative that the JAX package
    takes by `jax.jacfwd` through the retraction, in closed form (the
    basis' helper axis is piecewise constant)."""
    B1 = plane_tangent_basis(n1)
    v_norm = torch.clamp(torch.linalg.norm(n1, dim=-1, keepdim=True), min=1e-9)
    u = n1 / v_norm
    t, c = _basis_aux(u)
    c_norm = torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True), min=1e-9)
    b1 = c / c_norm
    eye = torch.eye(3, dtype=n1.dtype, device=n1.device)
    # b1 = c / |c|, c = u x t = -hat(t) u; b2 = u x b1.
    db1 = -((eye - b1[..., :, None] * b1[..., None, :]) @ hat(t)) / c_norm[..., None]
    db2 = -hat(b1) + hat(u) @ db1
    du_dv = (eye - u[..., :, None] * u[..., None, :]) / v_norm[..., None]
    de_du = torch.stack([torch.einsum("...i,...ij->...j", n2, db1),
                         torch.einsum("...i,...ij->...j", n2, db2)], dim=-2)
    return de_du @ du_dv @ B1 / sigma_n


def parallel_plane_residual(n1, d1, n2, d2, measured_dist=None, sigma_n=1.0, sigma_d=1.0):
    """ParallelPlaneRegularFactor residuals (factors/ParallelPlaneRegularFactor.h),
    batched over leading axes: without `measured_dist` the 2-dim tangent
    parallelism error e = B(n1)^T n2 / sigma_n; with it also the distance
    row (d2 - d1 - measured_dist) / sigma_d. Returns (r, J1, J2) in each
    plane's [2 normal-tangent, 1 distance] coordinates."""
    B1 = plane_tangent_basis(n1)
    e_n = torch.einsum("...ij,...i->...j", B1, n2) / sigma_n
    # d e / d delta2_n = B1^T B2 (B2's columns are orthogonal to n2, where
    # the normalization's projector is the identity).
    J2_n = torch.einsum("...ij,...ik->...jk", B1, plane_tangent_basis(n2)) / sigma_n
    J1_n = _parallel_J1_n(n1, n2, sigma_n)
    zc = torch.zeros(J1_n.shape[:-1] + (1,), dtype=n1.dtype, device=n1.device)
    if measured_dist is None:
        return e_n, torch.cat([J1_n, zc], -1), torch.cat([J2_n, zc], -1)
    e_d = (d2 - d1 - measured_dist) / sigma_d
    zr = torch.zeros(J1_n.shape[:-2] + (1, 2), dtype=n1.dtype, device=n1.device)
    one = torch.ones(J1_n.shape[:-2] + (1, 1), dtype=n1.dtype, device=n1.device) / sigma_d
    J1 = torch.cat([torch.cat([J1_n, zc], -1), torch.cat([zr, -one], -1)], -2)
    J2 = torch.cat([torch.cat([J2_n, zc], -1), torch.cat([zr, one], -1)], -2)
    return torch.cat([e_n, e_d[..., None]], -1), J1, J2


def parallel_plane_blocks(planes: PlaneStates, pairs, pair_mask, measured_dists=None,
                          sigma_n: float = 0.1, sigma_d: float = 0.1):
    """Parallel-plane regularities between plane pairs (Q,2). Returns
    (r (Q,rd), J1 (Q,rd,3), J2 (Q,rd,3), w (Q,))."""
    i, j = pairs[:, 0], pairs[:, 1]
    P = planes.normal.shape[0]
    ic = torch.clamp(i, 0, P - 1).long()
    jc = torch.clamp(j, 0, P - 1).long()
    r, J1, J2 = parallel_plane_residual(planes.normal[ic], planes.d[ic], planes.normal[jc],
                                        planes.d[jc], measured_dist=measured_dists,
                                        sigma_n=sigma_n, sigma_d=sigma_d)
    w = (pair_mask & (i >= 0) & (j >= 0) & planes.mask[ic] & planes.mask[jc]).to(r.dtype)
    return r * w[:, None], J1 * w[:, None, None], J2 * w[:, None, None], w


def regular_smart_factor_blocks(cfg: sm.BackendConfig, win: sm.Window, lmk: sm.LandmarkTable,
                                planes: PlaneStates, plane_assoc, regularity_sigma):
    """Smart-factor linearization with the point-plane rows folded into
    each landmark's block before the Schur elimination (the information of
    the reference's projection factors + PointPlaneFactor,
    RegularVioBackend.cpp:635-803, 1008-1140). Returns (H_pose (K,6,K,6),
    g_pose (K,6), H_plane (P,3,P,3), g_plane (P,3), H_cross (K,6,P,3), pts,
    lmk_ok)."""
    P = planes.normal.shape[0]
    pts, ok, obs_mask = sm._smart_points(cfg, win, lmk)
    r, F, E = sm._smart_obs_blocks(cfg, win, lmk.obs_uvd, pts, ok, obs_mask)

    rp, Jp_pt, Jp_plane, wp = point_plane_blocks(planes, pts, ok, plane_assoc, regularity_sigma)
    rp = rp * wp
    Jp_pt = Jp_pt * wp[:, None]
    Jp_plane = Jp_plane * wp[:, None]

    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    Hll = (torch.einsum("aikl,ajkl->ijl", E, E)
           + torch.einsum("li,lj->ijl", Jp_pt, Jp_pt) + 1e-6 * eye3[:, :, None])
    Hll_inv = sm._inv3_sym(Hll)  # (3,3,L)
    Hpl = torch.einsum("aikl,ajkl->ijkl", F, E)  # (6,3,K,L) pose-point
    Hql = torch.einsum("li,lj->lij", Jp_plane, Jp_pt)  # (L,3,3) plane-point
    gl = torch.einsum("aikl,akl->il", E, r) + (Jp_pt * rp[:, None]).T  # (3,L)
    gq = Jp_plane * rp[:, None]  # (L,3)

    T = torch.einsum("ijkl,jml->imkl", Hpl, Hll_inv)  # (6,3,K,L)
    Tq = torch.einsum("lij,jml->lim", Hql, Hll_inv)  # (L,3,3)
    H_pose = -torch.einsum("imkl,jmql->kiqj", T, Hpl)
    H_diag = torch.einsum("aikl,ajkl->kij", F, F)
    torch.diagonal(H_pose, dim1=0, dim2=2).add_(H_diag.permute(1, 2, 0))
    g_pose = torch.einsum("aikl,akl->ki", F, r) - torch.einsum("imkl,ml->ki", T, gl)

    # Plane blocks: each landmark's own plane rows minus their eliminated
    # part, summed into its plane's slot (a one-hot contraction).
    onehot = torch.nn.functional.one_hot(
        torch.clamp(plane_assoc, 0, P - 1).long(), P).to(r.dtype)  # (L,P)
    Hqq_l = (torch.einsum("li,lj->lij", Jp_plane, Jp_plane)
             - torch.einsum("lim,ljm->lij", Tq, Hql))
    gq_l = gq - torch.einsum("lim,ml->li", Tq, gl)
    H_plane = torch.zeros((P, 3, P, 3), dtype=r.dtype, device=r.device)
    torch.diagonal(H_plane, dim1=0, dim2=2).add_(torch.einsum("lp,lij->ijp", onehot, Hqq_l))
    g_plane = torch.einsum("lp,li->pi", onehot, gq_l)
    # Pose-plane cross terms -T_l Hql_l^T, into (state, plane slot).
    H_cross = -torch.einsum("imkl,ljm,lp->kipj", T, Hql, onehot)
    return H_pose, g_pose, H_plane, g_plane, H_cross, pts, ok


def regular_backend_solve(cfg: sm.BackendConfig, win: sm.Window, lmk: sm.LandmarkTable,
                          planes: PlaneStates, plane_assoc, regularity_sigma, gn_iters: int = 2,
                          parallel_pairs=None, parallel_pair_mask=None):
    """Joint Gauss-Newton over the window's states and the plane states,
    one solve per iteration (RegularVIO's optimize()). The IMU, no-motion
    and prior blocks come from the smoother; the smart + regularity blocks
    replace the plain smart-factor blocks; `parallel_pairs` (Q,2) adds
    parallel-plane rows between slot pairs. A Cholesky failure gives a
    non-finite step, as in the JAX package. Returns (win, planes,
    (pts, lmk_ok))."""
    K = cfg.nr_states
    P = planes.normal.shape[0]
    D = K * sm.S_DOF
    Dp = D + P * 3
    dev, dt = win.pos.device, win.pos.dtype
    for _ in range(gn_iters):
        Hp, gp, Hq, gq, Hx, pts, ok = regular_smart_factor_blocks(
            cfg, win, lmk, planes, plane_assoc, regularity_sigma)
        if parallel_pairs is not None and parallel_pairs.shape[0] > 0:
            mask = (parallel_pair_mask if parallel_pair_mask is not None
                    else torch.ones(parallel_pairs.shape[0], dtype=torch.bool, device=dev))
            rq, J1q, J2q, _ = parallel_plane_blocks(planes, parallel_pairs, mask)
            oh_i = torch.nn.functional.one_hot(
                torch.clamp(parallel_pairs[:, 0], 0, P - 1).long(), P).to(dt)  # (Q,P)
            oh_j = torch.nn.functional.one_hot(
                torch.clamp(parallel_pairs[:, 1], 0, P - 1).long(), P).to(dt)
            Hii = torch.einsum("qri,qrj->qij", J1q, J1q)
            Hjj = torch.einsum("qri,qrj->qij", J2q, J2q)
            Hij = torch.einsum("qri,qrj->qij", J1q, J2q)
            Hq = (Hq + torch.einsum("qp,qij,qs->pisj", oh_i, Hii, oh_i)
                  + torch.einsum("qp,qij,qs->pisj", oh_j, Hjj, oh_j)
                  + torch.einsum("qp,qij,qs->pisj", oh_i, Hij, oh_j)
                  + torch.einsum("qp,qji,qs->pisj", oh_j, Hij, oh_i))
            gq = (gq + torch.einsum("qp,qri,qr->pi", oh_i, J1q, rq)
                  + torch.einsum("qp,qri,qr->pi", oh_j, J2q, rq))
        # Base assembly without smart factors: IMU + no-motion, then the
        # smart + regularity blocks, the prior and the inactive-state pins.
        H = torch.zeros((K, sm.S_DOF, K, sm.S_DOF), dtype=dt, device=dev)
        g = torch.zeros((K, sm.S_DOF), dtype=dt, device=dev)
        for Ji, Jj, r in (sm._imu_factor_blocks(cfg, win), sm._no_motion_blocks(cfg, win)):
            sm._add_pair_blocks(H, g, Ji, Jj, r)
        H[:, 0:6, :, 0:6] += Hp
        g[:, 0:6] += gp
        H = H.reshape(D, D)
        g = g.reshape(D)
        Hprior, gprior = sm._prior_blocks(cfg, win)
        H = H + Hprior + torch.diag((~win.mask).to(dt).repeat_interleave(sm.S_DOF))
        g = g + gprior

        Hfull = torch.zeros((Dp, Dp), dtype=dt, device=dev)
        Hfull[:D, :D] = H
        Hfull[D:, D:] = Hq.reshape(P * 3, P * 3) + torch.diag(
            ((~planes.mask).to(dt) + 1e-4).repeat_interleave(3))
        Hx_f = torch.zeros((K, sm.S_DOF, P, 3), dtype=dt, device=dev)
        Hx_f[:, 0:6] = Hx
        Hx_f = Hx_f.reshape(D, P * 3)
        Hfull[:D, D:] = Hx_f
        Hfull[D:, :D] = Hx_f.T
        gfull = torch.cat([g, gq.reshape(-1)])

        Hfull = 0.5 * (Hfull + Hfull.T)
        dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hfull), min=1e-12))
        Hs = Hfull * dinv[:, None] * dinv[None, :] + 1e-5 * torch.eye(Dp, dtype=dt, device=dev)
        delta = sm._cho_step(Hs, gfull * dinv) * dinv
        dwin = delta[:D].reshape(K, sm.S_DOF) * win.mask[:, None]
        rot, pos, vel, bias = sm.retract_states(win.rot, win.pos, win.vel, win.bias, dwin)
        win = replace(win, rot=rot, pos=pos, vel=vel, bias=bias)
        planes = retract_planes(planes, delta[D:].reshape(P, 3) * planes.mask[:, None])
    return win, planes, (pts, ok)
