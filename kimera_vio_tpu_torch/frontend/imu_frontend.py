"""On-manifold IMU preintegration (Forster et al., TRO 2017) in torch.

Port of kimera_vio_tpu/frontend/imu_frontend.py. The reference integrates
with a `lax.scan` (sequential oracle) and a log-depth parallel form that the
pipeline uses; both are here. The parallel form's `associative_scan` of
matrix products becomes a Hillis-Steele prefix product (`_prefix_matmul`),
log2(n) batched matmuls. Padded samples carry dt=0 / mask=False and are
exact no-ops.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.common import geometry as geo
from kimera_vio_tpu_torch.common.types import ImuBias, ImuBlock, NavState


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclass
class PimParams:
    """Preintegration noise parameters (0-d / (3,) float32 tensors)."""

    gyro_noise_density: torch.Tensor
    acc_noise_density: torch.Tensor
    integration_sigma: torch.Tensor
    gyro_random_walk: torch.Tensor
    acc_random_walk: torch.Tensor
    n_gravity: torch.Tensor  # (3,)

    @classmethod
    def from_params(cls, imu_params, device="cuda") -> "PimParams":
        device = resolve_device(device)
        return cls(
            gyro_noise_density=_f32(imu_params.gyro_noise_density, device),
            acc_noise_density=_f32(imu_params.acc_noise_density, device),
            integration_sigma=_f32(imu_params.imu_integration_sigma, device),
            gyro_random_walk=_f32(imu_params.gyro_random_walk, device),
            acc_random_walk=_f32(imu_params.acc_random_walk, device),
            n_gravity=_f32(imu_params.n_gravity, device),
        )


@dataclass
class Pim:
    """Preintegrated IMU measurements between two (key)frames."""

    delta_R: torch.Tensor  # (3,3)
    delta_v: torch.Tensor  # (3,)
    delta_p: torch.Tensor  # (3,)
    delta_t: torch.Tensor  # ()
    cov: torch.Tensor  # (9,9) [dtheta, dv, dp]
    dR_dbg: torch.Tensor  # (3,3)
    dv_dba: torch.Tensor
    dv_dbg: torch.Tensor
    dp_dba: torch.Tensor
    dp_dbg: torch.Tensor
    bias_hat: ImuBias

    @classmethod
    def zero(cls, bias: ImuBias | None = None, device=None, dtype=torch.float32) -> "Pim":
        if device is None:
            device = bias.accel.device if bias is not None else "cuda"
        device = resolve_device(device)
        z33 = torch.zeros((3, 3), dtype=dtype, device=device)
        return cls(
            delta_R=torch.eye(3, dtype=dtype, device=device),
            delta_v=torch.zeros(3, dtype=dtype, device=device),
            delta_p=torch.zeros(3, dtype=dtype, device=device),
            delta_t=torch.zeros((), dtype=dtype, device=device),
            cov=torch.zeros((9, 9), dtype=dtype, device=device),
            dR_dbg=z33,
            dv_dba=z33.clone(),
            dv_dbg=z33.clone(),
            dp_dba=z33.clone(),
            dp_dbg=z33.clone(),
            bias_hat=bias if bias is not None else ImuBias.zero(device, dtype),
        )


def _integrate_step(params: PimParams, pim: Pim, acc, gyr, dt) -> Pim:
    """One Forster preintegration step (corrected measurement, dt)."""
    a = acc - pim.bias_hat.accel
    w = gyr - pim.bias_hat.gyro
    dev, dtp = a.device, a.dtype
    eye3 = torch.eye(3, dtype=dtp, device=dev)

    dR_inc = geo.so3_exp(w * dt)
    Jr = geo.so3_right_jacobian(w * dt)
    R_k = pim.delta_R
    Ra = (R_k @ a[..., None])[..., 0]

    new_delta_p = pim.delta_p + pim.delta_v * dt + 0.5 * Ra * dt * dt
    new_delta_v = pim.delta_v + Ra * dt
    new_delta_R = R_k @ dR_inc

    A = torch.zeros((9, 9), dtype=dtp, device=dev)
    A[0:3, 0:3] = dR_inc.T
    Rhat_a = R_k @ geo.hat(a)
    A[3:6, 0:3] = -Rhat_a * dt
    A[6:9, 0:3] = -0.5 * Rhat_a * dt * dt
    A[3:6, 3:6] = eye3
    A[6:9, 3:6] = eye3 * dt
    A[6:9, 6:9] = eye3

    safe_dt = torch.clamp(dt, min=1e-12)
    gyro_cov = (params.gyro_noise_density**2 / safe_dt) * eye3
    acc_cov = (params.acc_noise_density**2 / safe_dt) * eye3
    int_cov = (params.integration_sigma**2 * safe_dt) * eye3

    Bg = torch.zeros((9, 3), dtype=dtp, device=dev)
    Bg[0:3, :] = Jr * dt
    Ba = torch.zeros((9, 3), dtype=dtp, device=dev)
    Ba[3:6, :] = R_k * dt
    Ba[6:9, :] = 0.5 * R_k * dt * dt
    new_cov = A @ pim.cov @ A.T + Bg @ gyro_cov @ Bg.T + Ba @ acc_cov @ Ba.T
    new_cov = new_cov.clone()
    new_cov[6:9, 6:9] += int_cov

    new_dp_dba = pim.dp_dba + pim.dv_dba * dt - 0.5 * R_k * dt * dt
    new_dp_dbg = pim.dp_dbg + pim.dv_dbg * dt - 0.5 * Rhat_a @ pim.dR_dbg * dt * dt
    new_dv_dba = pim.dv_dba - R_k * dt
    new_dv_dbg = pim.dv_dbg - Rhat_a @ pim.dR_dbg * dt
    new_dR_dbg = dR_inc.T @ pim.dR_dbg - Jr * dt

    valid = dt > 0.0

    def sel(new, old):
        return torch.where(valid, new, old)

    return Pim(
        delta_R=sel(new_delta_R, pim.delta_R),
        delta_v=sel(new_delta_v, pim.delta_v),
        delta_p=sel(new_delta_p, pim.delta_p),
        delta_t=sel(pim.delta_t + dt, pim.delta_t),
        cov=sel(new_cov, pim.cov),
        dR_dbg=sel(new_dR_dbg, pim.dR_dbg),
        dv_dba=sel(new_dv_dba, pim.dv_dba),
        dv_dbg=sel(new_dv_dbg, pim.dv_dbg),
        dp_dba=sel(new_dp_dba, pim.dp_dba),
        dp_dbg=sel(new_dp_dbg, pim.dp_dbg),
        bias_hat=pim.bias_hat,
    )


def preintegrate_sequential(
    params: PimParams, block: ImuBlock, bias: ImuBias, init: Pim | None = None
) -> Pim:
    """Reference-shaped sequential preintegration (loop over samples); the
    semantic oracle for `preintegrate`."""
    pim = init if init is not None else Pim.zero(bias)
    dt = torch.where(block.mask, block.dt, torch.zeros_like(block.dt))
    for k in range(block.acc.shape[0]):
        pim = _integrate_step(params, pim, block.acc[k], block.gyr[k], dt[k])
    return pim


def _compose_pim(params: PimParams, p1: Pim, p2: Pim) -> Pim:
    """Compose two consecutive preintegrations (same bias_hat); leaves may
    carry leading batch axes."""
    R1, v1, pp1, t1 = p1.delta_R, p1.delta_v, p1.delta_p, p1.delta_t
    R2, v2, pp2, t2 = p2.delta_R, p2.delta_v, p2.delta_p, p2.delta_t
    batch = R1.shape[:-2]
    delta_R = R1 @ R2
    delta_v = v1 + (R1 @ v2[..., None])[..., 0]
    delta_p = pp1 + v1 * t2[..., None] + (R1 @ pp2[..., None])[..., 0]
    eye3 = torch.eye(3, dtype=R1.dtype, device=R1.device)
    A = torch.zeros((*batch, 9, 9), dtype=R1.dtype, device=R1.device)
    A[..., 0:3, 0:3] = R2.mT
    A[..., 3:6, 0:3] = -R1 @ geo.hat(v2)
    A[..., 3:6, 3:6] = eye3
    A[..., 6:9, 0:3] = -R1 @ geo.hat(pp2)
    A[..., 6:9, 3:6] = eye3 * t2[..., None, None]
    A[..., 6:9, 6:9] = eye3
    B1 = torch.zeros((*batch, 9, 9), dtype=R1.dtype, device=R1.device)
    B1[..., 0:3, 0:3] = eye3
    B1[..., 3:6, 3:6] = R1
    B1[..., 6:9, 6:9] = R1
    cov = A @ p1.cov @ A.mT + B1 @ p2.cov @ B1.mT
    dR_dbg = R2.mT @ p1.dR_dbg + p2.dR_dbg
    dv_dba = p1.dv_dba + R1 @ p2.dv_dba
    dv_dbg = p1.dv_dbg - R1 @ geo.hat(v2) @ p1.dR_dbg + R1 @ p2.dv_dbg
    dp_dba = p1.dp_dba + p1.dv_dba * t2[..., None, None] + R1 @ p2.dp_dba
    dp_dbg = (
        p1.dp_dbg
        + p1.dv_dbg * t2[..., None, None]
        - R1 @ geo.hat(pp2) @ p1.dR_dbg
        + R1 @ p2.dp_dbg
    )
    return Pim(
        delta_R=delta_R,
        delta_v=delta_v,
        delta_p=delta_p,
        delta_t=t1 + t2,
        cov=cov,
        dR_dbg=dR_dbg,
        dv_dba=dv_dba,
        dv_dbg=dv_dbg,
        dp_dba=dp_dba,
        dp_dbg=dp_dbg,
        bias_hat=p1.bias_hat,
    )


def _prefix_matmul(M: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products S_k = M_0 @ ... @ M_k over axis -3
    (Hillis-Steele doubling: log2(n) batched matmuls)."""
    S = M
    n = M.shape[-3]
    off = 1
    while off < n:
        S = torch.cat([S[..., :off, :, :], S[..., :-off, :, :] @ S[..., off:, :, :]], dim=-3)
        off *= 2
    return S


def preintegrate_parallel(params: PimParams, block: ImuBlock, bias: ImuBias) -> Pim:
    """Log-depth preintegration of one block (the reference's
    `preintegrate_parallel`): prefix rotation products, closed-form
    reordered sums for the deltas and bias Jacobians, and suffix products
    of the 9x9 error-state transitions for the covariance. A block with
    leading batch axes ((B, n, 3) samples, (B, 3) biases) preintegrates
    B streams at once."""
    dt = torch.where(block.mask, block.dt, torch.zeros_like(block.dt))
    a = block.acc - bias.accel[..., None, :]
    w = block.gyr - bias.gyro[..., None, :]
    dev, dtp = a.device, a.dtype
    batch, n = a.shape[:-2], a.shape[-2]

    dR_inc = geo.so3_exp(w * dt[..., None])
    Jr = geo.so3_right_jacobian(w * dt[..., None])

    S = _prefix_matmul(dR_inc)
    eye = torch.eye(3, dtype=dtp, device=dev)
    R = torch.cat([eye.expand(*batch, 1, 3, 3), S[..., :-1, :, :]], dim=-3)

    t = torch.cat([torch.zeros((*batch, 1), dtype=dt.dtype, device=dev),
                   torch.cumsum(dt, -1)[..., :-1]], dim=-1)
    T = torch.sum(dt, -1)
    Ra = torch.einsum("...kij,...kj->...ki", R, a)
    tail = dt * (T[..., None] - t - 0.5 * dt)

    delta_R = S[..., -1, :, :]
    delta_v = torch.einsum("...ki,...k->...i", Ra, dt)
    delta_p = torch.einsum("...ki,...k->...i", Ra, tail)

    SJr = torch.einsum("...kij,...kjl->...kil", S, Jr)
    dR_dbg = -delta_R.mT @ torch.einsum("...kil,...k->...il", SJr, dt)
    dv_dba = -torch.einsum("...kij,...k->...ij", R, dt)
    dp_dba = -torch.einsum("...kij,...k->...ij", R, tail)
    P_incl = torch.cumsum(SJr * dt[..., None, None], dim=-3)
    P_excl = torch.cat([torch.zeros((*batch, 1, 3, 3), dtype=dtp, device=dev),
                        P_incl[..., :-1, :, :]], dim=-3)
    dR_dbg_k = -torch.einsum("...kji,...kjl->...kil", R, P_excl)
    Rhat_a = torch.einsum("...kij,...kjl->...kil", R, geo.hat(a))
    HdR = torch.einsum("...kij,...kjl->...kil", Rhat_a, dR_dbg_k)
    dv_dbg = -torch.einsum("...kil,...k->...il", HdR, dt)
    dp_dbg = -torch.einsum("...kil,...k->...il", HdR, tail)

    dt3 = dt[..., None, None]
    A = torch.zeros((*batch, n, 9, 9), dtype=dtp, device=dev)
    A[..., 0:3, 0:3] = dR_inc.mT
    A[..., 3:6, 0:3] = -Rhat_a * dt3
    A[..., 6:9, 0:3] = -0.5 * Rhat_a * dt3**2
    A[..., 3:6, 3:6] = eye
    A[..., 6:9, 3:6] = eye * dt3
    A[..., 6:9, 6:9] = eye
    eye9 = torch.eye(9, dtype=dtp, device=dev)
    A = torch.where(block.mask[..., None, None], A, eye9)

    safe_dt = torch.clamp(dt, min=1e-12)
    gyro_cov = params.gyro_noise_density**2 / safe_dt
    acc_cov = params.acc_noise_density**2 / safe_dt
    int_cov = params.integration_sigma**2 * safe_dt
    Bg = torch.zeros((*batch, n, 9, 3), dtype=dtp, device=dev)
    Bg[..., 0:3, :] = Jr * dt3
    Ba = torch.zeros((*batch, n, 9, 3), dtype=dtp, device=dev)
    Ba[..., 3:6, :] = R * dt3
    Ba[..., 6:9, :] = 0.5 * R * dt3**2
    Q = gyro_cov[..., None, None] * torch.einsum(
        "...kij,...klj->...kil", Bg, Bg
    ) + acc_cov[..., None, None] * torch.einsum("...kij,...klj->...kil", Ba, Ba)
    Q[..., 6:9, 6:9] += int_cov[..., None, None] * eye
    Q = torch.where(block.mask[..., None, None], Q, torch.zeros_like(Q))

    A_rev = torch.flip(A, dims=(-3,))
    S9 = _prefix_matmul(A_rev)
    M_incl = torch.flip(S9, dims=(-3,))
    M = torch.cat([M_incl[..., 1:, :, :], eye9.expand(*batch, 1, 9, 9)], dim=-3)
    cov = torch.einsum("...kij,...kjl,...kml->...im", M, Q, M)

    return Pim(
        delta_R=delta_R,
        delta_v=delta_v,
        delta_p=delta_p,
        delta_t=T,
        cov=cov,
        dR_dbg=dR_dbg,
        dv_dba=dv_dba,
        dv_dbg=dv_dbg,
        dp_dba=dp_dba,
        dp_dbg=dp_dbg,
        bias_hat=bias,
    )


def preintegrate(
    params: PimParams, block: ImuBlock, bias: ImuBias, init: Pim | None = None
) -> Pim:
    """Preintegrate a masked IMU block, optionally continuing from `init`
    (the inter-keyframe accumulation, reset on keyframes). Parallel form,
    composed onto `init` in closed form — as the reference pipeline does.
    Leading batch axes on the block, bias and `init` preintegrate that
    many streams at once."""
    pim_block = preintegrate_parallel(params, block, bias)
    if init is None:
        return pim_block
    return _compose_pim(params, init, pim_block)


def preintegrate_gyro(block: ImuBlock, gyro_bias: torch.Tensor) -> torch.Tensor:
    """Gyro-only rotation preintegration (the reference's
    ImuFrontend::preintegrateGyroMeasurements): the product of the masked
    samples' exp((gyr - bias) dt), left to right in sample order. Returns
    DeltaR (3,3). The increments are one batched `so3_exp`; the product
    stays sequential, in the reference's order."""
    dt = torch.where(block.mask, block.dt, torch.zeros_like(block.dt))
    dR = geo.so3_exp((block.gyr - gyro_bias) * dt[:, None])
    R = torch.eye(3, dtype=block.gyr.dtype, device=block.gyr.device)
    for i in range(dR.shape[0]):
        R = R @ dR[i]
    return R


def combined_cov15(pim: Pim, acc_random_walk, gyro_random_walk) -> torch.Tensor:
    """Joint 15x15 covariance of [preintegration error; bias_j - bias_i]
    for the Combined flavour (closed form, first order in the walk).
    Takes a PIM with any leading batch dimensions."""
    dev, dtp = pim.cov.device, pim.cov.dtype
    batch = pim.cov.shape[:-2]
    Jb = torch.zeros((*batch, 9, 6), dtype=dtp, device=dev)
    Jb[..., 0:3, 3:6] = pim.dR_dbg
    Jb[..., 3:6, 0:3] = pim.dv_dba
    Jb[..., 3:6, 3:6] = pim.dv_dbg
    Jb[..., 6:9, 0:3] = pim.dp_dba
    Jb[..., 6:9, 3:6] = pim.dp_dbg
    dt = torch.clamp(pim.delta_t, min=1e-6)
    arw = torch.as_tensor(acc_random_walk, dtype=dtp, device=dev)
    grw = torch.as_tensor(gyro_random_walk, dtype=dtp, device=dev)
    qb = torch.cat([(arw**2).expand(3), (grw**2).expand(3)]) * dt[..., None]
    Qb = torch.diag_embed(qb)
    JQ = Jb @ Qb
    top = pim.cov + JQ @ Jb.transpose(-1, -2) / 3.0
    cross = JQ / 2.0
    return torch.cat(
        [torch.cat([top, cross], dim=-1),
         torch.cat([cross.transpose(-1, -2), Qb], dim=-1)], dim=-2
    )


def pim_with_bias_correction(pim: Pim, bias: ImuBias):
    """First-order bias-corrected (delta_R, delta_v, delta_p) at a new
    bias estimate (Forster eq. 44)."""
    dbg = bias.gyro - pim.bias_hat.gyro
    dba = bias.accel - pim.bias_hat.accel
    dR = pim.delta_R @ geo.so3_exp(pim.dR_dbg @ dbg)
    dv = pim.delta_v + pim.dv_dba @ dba + pim.dv_dbg @ dbg
    dp = pim.delta_p + pim.dp_dba @ dba + pim.dp_dbg @ dbg
    return dR, dv, dp


def pim_predict(pim: Pim, state: NavState, bias: ImuBias, n_gravity) -> NavState:
    """Nav state at the end of the preintegration interval (the backend's
    IMU pose guess)."""
    dR, dv, dp = pim_with_bias_correction(pim, bias)
    dt = pim.delta_t
    R_i, p_i, v_i = state.rot, state.pos, state.vel
    R_j = R_i @ dR
    v_j = v_i + n_gravity * dt + (R_i @ dv[..., None])[..., 0]
    p_j = p_i + v_i * dt + 0.5 * n_gravity * dt * dt + (R_i @ dp[..., None])[..., 0]
    return NavState(rot=R_j, pos=p_j, vel=v_j)


def imu_residual(pim: Pim, state_i: NavState, bias_i: ImuBias, state_j: NavState, n_gravity):
    """9-dim preintegration residual [r_R, r_v, r_p] (Forster eq. 45),
    r_R = Log(dR_corrected^T R_i^T R_j)."""
    dR, dv, dp = pim_with_bias_correction(pim, bias_i)
    dt = pim.delta_t
    R_i, p_i, v_i = state_i.rot, state_i.pos, state_i.vel
    R_j, p_j, v_j = state_j.rot, state_j.pos, state_j.vel
    RiT = R_i.transpose(-1, -2)
    r_R = geo.so3_log(dR.transpose(-1, -2) @ (RiT @ R_j))
    r_v = (RiT @ (v_j - v_i - n_gravity * dt)[..., None])[..., 0] - dv
    r_p = (RiT @ (p_j - p_i - v_i * dt - 0.5 * n_gravity * dt * dt)[..., None])[..., 0] - dp
    return torch.cat([r_R, r_v, r_p], dim=-1)
