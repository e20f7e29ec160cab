"""Fixed-lag smart-factor smoother: the VIO backend, in torch.

Port of kimera_vio_tpu/backend/smoother.py (itself the batched
Gauss-Newton replacement of the reference's GTSAM fixed-lag smoother,
src/backend/VioBackend.cpp:296-428, 1036-1250): a window of K keyframe
states of 15 DoF [dtheta, dp, dv, dba, dbg]; smart stereo landmarks
triangulated in closed form and Schur-eliminated onto the poses; IMU
preintegration + bias random-walk factors, or the Combined IMU factor
(`imu_preintegration_type: 0`: one 15-dim residual whitened jointly),
with Jacobians by forward-mode autodiff (`torch.func.jacfwd` under
`vmap`); zero-velocity / no-motion
factors on LOW_DISPARITY keyframes; relative-pose between factors from
external odometry and from the tracker's stereo RANSAC, and the
constant-velocity factor (analytic Jacobians); a Jacobi-equilibrated
Cholesky solve with the reference's recovery branch; marginalization of
the oldest state into a dense prior. `backend_step` also takes a pose
guess from another source than the IMU (MONO, STEREO, PnP) and absolute
external-odometry poses, which it turns into keyframe-relative ones.

Where the JAX code branches on device values with `lax.cond`, the port
branches on the host (`Window.n` is a Python int). Block additions go
through diagonal views, so every entry receives the same additions in the
same order as the reference's `.at[].add`. `torch.linalg.cholesky` raises
on a matrix that is not positive definite where `jnp.linalg.cholesky`
returns NaN; `cholesky_ex` with `info != 0` maps to the same non-finite
step, so the recovery branch fires where it fires in JAX.
`state_covariance` is the reference's computeStateCovariance: the newest
state's 15x15 marginal, with a health flag.

The landmark table may be split along its landmark axis over devices
(`ShardedLandmarkTable`, the fleet's `model` mesh axis; a plain table is
one shard): new landmarks take the same rows as in the whole table, each
shard linearizes its landmarks on its own device, and the partial
smart-factor systems are summed on the window's device, where the solve
runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.common import geometry as geo
from kimera_vio_tpu_torch.common.types import ImuBias, NavState, replace, tree_map, tree_map2
from kimera_vio_tpu_torch.frontend.imu_frontend import (
    Pim,
    combined_cov15,
    imu_residual,
    pim_predict,
)
from kimera_vio_tpu_torch.ops.triangulation import triangulate_stereo_landmarks
from kimera_vio_tpu_torch.utils.stats import span

S_DOF = 15
_TH = slice(0, 3)
_P = slice(3, 6)
_V = slice(6, 9)
_BA = slice(9, 12)
_BG = slice(12, 15)

STATUS_LOW_DISPARITY = 1  # tracking status of a keyframe with too little parallax


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _sigma(precision: float) -> float:
    """1/sqrt(precision); inf (factor off) for a precision of 0."""
    return 1.0 / np.sqrt(precision) if precision > 0 else np.inf


@dataclass
class BackendConfig:
    """Solver configuration: static ints, float32 0-d tensors for the
    noise and gate parameters."""

    nr_states: int
    max_landmarks: int
    gn_iters: int
    min_obs_for_triangulation: int
    smart_noise_sigma: torch.Tensor
    mono_norm_type: int
    mono_norm_param: torch.Tensor
    stereo_norm_type: int
    stereo_norm_param: torch.Tensor
    rank_tolerance: torch.Tensor
    landmark_distance_threshold: torch.Tensor
    outlier_rejection_px: torch.Tensor
    acc_random_walk: torch.Tensor
    gyro_random_walk: torch.Tensor
    zero_velocity_sigma: torch.Tensor
    no_motion_pos_sigma: torch.Tensor
    no_motion_rot_sigma: torch.Tensor
    # Between factors: an infinite sigma switches that residual class off
    # (the reference's precision 0).
    ext_odom_rot_sigma: torch.Tensor
    ext_odom_pos_sigma: torch.Tensor
    between_rot_sigma: torch.Tensor
    between_pos_sigma: torch.Tensor
    constant_vel_sigma: torch.Tensor  # inf = no constant-velocity factor
    init_pos_sigma: torch.Tensor
    init_rp_sigma: torch.Tensor
    init_yaw_sigma: torch.Tensor
    init_vel_sigma: torch.Tensor
    init_ba_sigma: torch.Tensor
    init_bg_sigma: torch.Tensor
    n_gravity: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    baseline: torch.Tensor
    R_b_cam: torch.Tensor
    t_b_cam: torch.Tensor
    # imu_preintegration_type 0: the Combined IMU factor (joint 15x15
    # whitening, no separate bias between factor).
    combined_pim: bool = False

    @classmethod
    def from_params(cls, backend_params, imu_params, stereo_cam, *, max_landmarks=512,
                    gn_iters=2, device="cuda"):
        device = resolve_device(device)
        bp = backend_params
        f = lambda x: _f32(x, device)  # noqa: E731
        return cls(
            nr_states=bp.nr_states,
            max_landmarks=max_landmarks,
            gn_iters=max(gn_iters, 1 + int(getattr(bp, "num_optimize", 1))),
            min_obs_for_triangulation=2,
            smart_noise_sigma=f(bp.smart_noise_sigma),
            mono_norm_type=int(bp.mono_norm_type),
            mono_norm_param=f(bp.mono_norm_param),
            stereo_norm_type=int(bp.stereo_norm_type),
            stereo_norm_param=f(bp.stereo_norm_param),
            rank_tolerance=f(bp.rank_tolerance),
            landmark_distance_threshold=f(bp.landmark_distance_threshold),
            outlier_rejection_px=f(bp.outlier_rejection),
            acc_random_walk=f(imu_params.acc_random_walk),
            gyro_random_walk=f(imu_params.gyro_random_walk),
            zero_velocity_sigma=f(1.0 / np.sqrt(bp.zero_velocity_precision)),
            no_motion_pos_sigma=f(1.0 / np.sqrt(bp.no_motion_position_precision)),
            no_motion_rot_sigma=f(1.0 / np.sqrt(bp.no_motion_rotation_precision)),
            ext_odom_rot_sigma=f(0.05),
            ext_odom_pos_sigma=f(0.1),
            between_rot_sigma=f(_sigma(bp.between_rotation_precision)),
            between_pos_sigma=f(_sigma(bp.between_translation_precision)),
            constant_vel_sigma=f(_sigma(bp.constant_vel_precision)
                                 if getattr(bp, "use_constant_velocity_factor", False)
                                 else np.inf),
            init_pos_sigma=f(bp.initial_position_sigma),
            init_rp_sigma=f(bp.initial_roll_pitch_sigma),
            init_yaw_sigma=f(bp.initial_yaw_sigma),
            init_vel_sigma=f(bp.initial_velocity_sigma),
            init_ba_sigma=f(bp.initial_acc_bias_sigma),
            init_bg_sigma=f(bp.initial_gyro_bias_sigma),
            n_gravity=f(imu_params.n_gravity),
            fx=stereo_cam.fx,
            fy=stereo_cam.fy,
            cx=stereo_cam.cx,
            cy=stereo_cam.cy,
            baseline=stereo_cam.baseline,
            R_b_cam=stereo_cam.R_b_rect,
            t_b_cam=stereo_cam.t_b_rect,
            combined_pim=int(getattr(imu_params, "preintegration_type", 1)) == 0,
        )


@dataclass
class Window:
    """The sliding window of keyframe states, factor data and marginal
    prior. `n` (active states) is a host int."""

    rot: torch.Tensor  # (K,3,3)
    pos: torch.Tensor  # (K,3)
    vel: torch.Tensor  # (K,3)
    bias: torch.Tensor  # (K,6) [ba, bg]
    stamp: torch.Tensor  # (K,) float32 seconds (relative)
    mask: torch.Tensor  # (K,)
    n: int
    pim: Pim  # stacked (K, ...); pim[i] connects state i-1 -> i
    pim_valid: torch.Tensor  # (K,)
    status: torch.Tensor  # (K,) int32
    # External-odometry relative poses (slot k: k-1 -> k, body frame).
    ext_R: torch.Tensor  # (K,3,3)
    ext_t: torch.Tensor  # (K,3)
    ext_valid: torch.Tensor  # (K,)
    # Stereo-RANSAC between measurements (slot k: k-1 -> k, body frame).
    btw_R: torch.Tensor  # (K,3,3)
    btw_t: torch.Tensor  # (K,3)
    btw_valid: torch.Tensor  # (K,)
    out_rot: torch.Tensor  # (3,3) increment-chained published pose
    out_pos: torch.Tensor  # (3,)
    # Last keyframe's absolute external-odometry pose, from which the next
    # keyframe's relative one is formed (VisionImuFrontend.cpp:240-302).
    odom_R: torch.Tensor  # (3,3)
    odom_t: torch.Tensor  # (3,)
    odom_valid: torch.Tensor  # () bool
    prior_H: torch.Tensor  # (D,D)
    prior_g: torch.Tensor  # (D,)
    prior_rot: torch.Tensor  # (K,3,3) prior linearization point
    prior_pos: torch.Tensor
    prior_vel: torch.Tensor
    prior_bias: torch.Tensor

    @classmethod
    def empty(cls, K: int, device="cuda", dtype=torch.float32) -> "Window":
        device = resolve_device(device)
        D = K * S_DOF
        eye = torch.eye(3, dtype=dtype, device=device).expand(K, 3, 3).contiguous()
        z3 = torch.zeros((K, 3), dtype=dtype, device=device)
        pim = tree_map(
            lambda x: x.expand((K,) + tuple(x.shape)).contiguous(),
            Pim.zero(device=device, dtype=dtype),
        )
        return cls(
            rot=eye,
            pos=z3,
            vel=z3.clone(),
            bias=torch.zeros((K, 6), dtype=dtype, device=device),
            stamp=torch.zeros((K,), dtype=dtype, device=device),
            mask=torch.zeros((K,), dtype=torch.bool, device=device),
            n=0,
            pim=pim,
            pim_valid=torch.zeros((K,), dtype=torch.bool, device=device),
            status=torch.zeros((K,), dtype=torch.int32, device=device),
            ext_R=eye.clone(),
            ext_t=z3.clone(),
            ext_valid=torch.zeros((K,), dtype=torch.bool, device=device),
            btw_R=eye.clone(),
            btw_t=z3.clone(),
            btw_valid=torch.zeros((K,), dtype=torch.bool, device=device),
            out_rot=torch.eye(3, dtype=dtype, device=device),
            out_pos=torch.zeros(3, dtype=dtype, device=device),
            odom_R=torch.eye(3, dtype=dtype, device=device),
            odom_t=torch.zeros(3, dtype=dtype, device=device),
            odom_valid=torch.zeros((), dtype=torch.bool, device=device),
            prior_H=torch.zeros((D, D), dtype=dtype, device=device),
            prior_g=torch.zeros((D,), dtype=dtype, device=device),
            prior_rot=eye.clone(),
            prior_pos=z3.clone(),
            prior_vel=z3.clone(),
            prior_bias=torch.zeros((K, 6), dtype=dtype, device=device),
        )


@dataclass
class LandmarkTable:
    """Fixed-capacity smart-landmark table (the reference backend's feature
    tracks, VioBackend.cpp:731-793) as one SoA."""

    ids: torch.Tensor  # (L,) int32, -1 = free
    obs_uvd: torch.Tensor  # (L, K, 3)
    obs_mask: torch.Tensor  # (L, K)
    pts: torch.Tensor  # (L, 3) last solve's triangulation
    pts_ok: torch.Tensor  # (L,)

    @classmethod
    def empty(cls, L: int, K: int, device="cuda", dtype=torch.float32) -> "LandmarkTable":
        device = resolve_device(device)
        return cls(
            ids=torch.full((L,), -1, dtype=torch.int32, device=device),
            obs_uvd=torch.zeros((L, K, 3), dtype=dtype, device=device),
            obs_mask=torch.zeros((L, K), dtype=torch.bool, device=device),
            pts=torch.zeros((L, 3), dtype=dtype, device=device),
            pts_ok=torch.zeros((L,), dtype=torch.bool, device=device),
        )

    @property
    def shards(self) -> tuple["LandmarkTable", ...]:
        """A plain table is a table of one shard (`ShardedLandmarkTable`)."""
        return (self,)

    def with_shards(self, shards) -> "LandmarkTable":
        (table,) = shards
        return table


# Each LandmarkTable field's landmark axis, counted from the end (a stacked
# table has a leading stream axis).
_LMK_AXIS = {"ids": -1, "obs_uvd": -3, "obs_mask": -2, "pts": -2, "pts_ok": -1}


@dataclass
class ShardedLandmarkTable:
    """A LandmarkTable split along its landmark axis: shard m holds rows
    [m L/M, (m+1) L/M) on its own device (the JAX fleet's `model` mesh
    axis). The smoother's landmark functions work shard by shard; reading
    a field (`ids`, `obs_uvd`, `obs_mask`, `pts`, `pts_ok`) concatenates
    the shards on the first shard's device."""

    shards: list  # of LandmarkTable, in row order

    def with_shards(self, shards) -> "ShardedLandmarkTable":
        return ShardedLandmarkTable(list(shards))

    def _cat(self, name: str) -> torch.Tensor:
        dev = self.shards[0].ids.device
        return torch.cat([getattr(s, name).to(dev) for s in self.shards], dim=_LMK_AXIS[name])

    ids = property(lambda self: self._cat("ids"))
    obs_uvd = property(lambda self: self._cat("obs_uvd"))
    obs_mask = property(lambda self: self._cat("obs_mask"))
    pts = property(lambda self: self._cat("pts"))
    pts_ok = property(lambda self: self._cat("pts_ok"))


def shard_landmarks(lmk: LandmarkTable, devices) -> LandmarkTable | ShardedLandmarkTable:
    """A table (one stream's, or stacked) split along its landmark axis
    into len(devices) equal shards, shard m copied to devices[m]. With one
    device, or a landmark count that len(devices) does not divide (the
    JAX fleet then leaves the axis unsplit, `_shard`), the plain table on
    devices[0]."""
    M = len(devices)
    L = lmk.ids.shape[-1]
    if M == 1 or L % M:
        return tree_map(lambda x: x.to(devices[0]), lmk)
    n = L // M
    return ShardedLandmarkTable([
        LandmarkTable(**{k: getattr(lmk, k).narrow(d, m * n, n).to(
            dev, copy=True, memory_format=torch.contiguous_format) for k, d in _LMK_AXIS.items()})
        for m, dev in enumerate(devices)])


# ---------------------------------------------------------------------------
# State retraction & tangent difference
# ---------------------------------------------------------------------------


def retract_states(rot, pos, vel, bias, delta):
    """Apply per-state tangent updates delta (K, 15)."""
    R_new = rot @ geo.so3_exp(delta[:, _TH])
    return (
        R_new,
        pos + delta[:, _P],
        vel + delta[:, _V],
        bias + torch.cat([delta[:, _BA], delta[:, _BG]], dim=-1),
    )


def local_coords(rot, pos, vel, bias, rot0, pos0, vel0, bias0):
    """Per-state tangent of (state) relative to (state0)."""
    dth = geo.so3_log(rot0.transpose(-1, -2) @ rot)
    return torch.cat([dth, pos - pos0, vel - vel0, bias - bias0], dim=-1)


# ---------------------------------------------------------------------------
# Factor linearization
# ---------------------------------------------------------------------------


def robust_weight(rn, norm_type: torch.Tensor, param: torch.Tensor):
    """IRLS weight for 0 = L2, 1 = Huber, 2 = Tukey (per element)."""
    safe = torch.clamp(rn, min=1e-9)
    w_huber = torch.clamp(param / safe, max=1.0)
    u = torch.clamp(1.0 - (rn / param) ** 2, 0.0, 1.0)
    w_tukey = u * u
    return torch.where(
        norm_type == 1, w_huber, torch.where(norm_type == 2, w_tukey, torch.ones_like(rn))
    )


def _whiten_from_cov(cov, jitter=1e-12):
    """W with W r of identity covariance (inverse Cholesky factor), batched;
    NaN where the covariance is not positive definite (as in JAX)."""
    d = cov.shape[-1]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    L, info = torch.linalg.cholesky_ex(cov + jitter * eye)
    L = torch.where((info != 0)[..., None, None], torch.full_like(L, torch.nan), L)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


_PIM_FIELDS = ("delta_R", "delta_v", "delta_p", "delta_t", "cov",
               "dR_dbg", "dv_dba", "dv_dbg", "dp_dba", "dp_dbg")


def _retract_one(R, p, v, b, d):
    return (
        R @ geo.so3_exp(d[_TH]),
        p + d[_P],
        v + d[_V],
        b + torch.cat([d[_BA], d[_BG]]),
    )


def _imu_pair(Ri, pi, vi, bi, Rj, pj, vj, bj, pim_vals, bias_hat, n_gravity):
    """Residuals and autodiff Jacobians of one IMU + bias pair factor."""
    pim = Pim(
        **dict(zip(_PIM_FIELDS, pim_vals)),
        bias_hat=ImuBias(accel=bias_hat[0:3], gyro=bias_hat[3:6]),
    )

    def residual(di, dj):
        Ri_, pi_, vi_, bi_ = _retract_one(Ri, pi, vi, bi, di)
        Rj_, pj_, vj_, bj_ = _retract_one(Rj, pj, vj, bj, dj)
        r_pim = imu_residual(
            pim,
            NavState(rot=Ri_, pos=pi_, vel=vi_),
            ImuBias(accel=bi_[0:3], gyro=bi_[3:6]),
            NavState(rot=Rj_, pos=pj_, vel=vj_),
            n_gravity,
        )
        return r_pim, bj_ - bi_

    z = torch.zeros(S_DOF, dtype=pi.dtype, device=pi.device)
    r_pim, r_bias = residual(z, z)
    Jp_i, Jb_i = torch.func.jacfwd(lambda d: residual(d, z))(z)
    Jp_j, Jb_j = torch.func.jacfwd(lambda d: residual(z, d))(z)
    return r_pim, r_bias, Jp_i, Jb_i, Jp_j, Jb_j


def _imu_factor_blocks(cfg: BackendConfig, win: Window, ks=None):
    """Whitened IMU + bias-random-walk factors for pairs (k-1, k), k in
    `ks` (default 1..K-1). Returns (Ji, Jj, r) stacked over the pairs,
    zeroed where the factor is inactive."""
    K = cfg.nr_states
    dev = win.pos.device
    ks = torch.arange(1, K, device=dev) if ks is None else torch.as_tensor(ks, device=dev)
    km = ks - 1
    pim_vals = tuple(getattr(win.pim, f)[ks] for f in _PIM_FIELDS)
    bias_hat = torch.cat([win.pim.bias_hat.accel[ks], win.pim.bias_hat.gyro[ks]], dim=-1)
    r_pim, r_bias, Jp_i, Jb_i, Jp_j, Jb_j = torch.func.vmap(
        _imu_pair, in_dims=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None)
    )(
        win.rot[km], win.pos[km], win.vel[km], win.bias[km],
        win.rot[ks], win.pos[ks], win.vel[ks], win.bias[ks],
        pim_vals, bias_hat, cfg.n_gravity,
    )
    if cfg.combined_pim:
        # The Combined flavour: one 15-dim residual whitened by the joint
        # covariance of [preintegration error; bias_j - bias_i].
        pim_ks = tree_map(lambda x: x[ks], win.pim)
        W15 = _whiten_from_cov(
            combined_cov15(pim_ks, cfg.acc_random_walk, cfg.gyro_random_walk), jitter=1e-10)
        r = (W15 @ torch.cat([r_pim, r_bias], dim=-1)[..., None])[..., 0]
        Ji = W15 @ torch.cat([Jp_i, Jb_i], dim=-2)
        Jj = W15 @ torch.cat([Jp_j, Jb_j], dim=-2)
    else:
        # The plain flavour: the PIM residual whitened by its 9x9
        # covariance, and a bias random-walk between factor (sigma^2 dt).
        dt_k = torch.clamp(win.stamp[ks] - win.stamp[km], min=1e-3)
        Wp = _whiten_from_cov(win.pim.cov[ks], jitter=1e-10)
        r_pim_w = (Wp @ r_pim[..., None])[..., 0]
        Jp_i_w = Wp @ Jp_i
        Jp_j_w = Wp @ Jp_j
        sig = torch.cat(
            [cfg.acc_random_walk.expand(3), cfg.gyro_random_walk.expand(3)]
        )[None, :] * torch.sqrt(dt_k)[:, None]
        r = torch.cat([r_pim_w, r_bias / sig], dim=-1)
        Ji = torch.cat([Jp_i_w, Jb_i / sig[:, :, None]], dim=-2)
        Jj = torch.cat([Jp_j_w, Jb_j / sig[:, :, None]], dim=-2)
    ok = (win.pim_valid[ks] & win.mask[ks] & win.mask[km]).to(win.pos.dtype)
    return Ji * ok[:, None, None], Jj * ok[:, None, None], r * ok[:, None]


def _no_motion_blocks(cfg: BackendConfig, win: Window, ks=None):
    """Zero-velocity prior + no-motion between factor at LOW_DISPARITY
    keyframes (VioBackend.cpp:363-399), on the consecutive-pair layout."""
    K = cfg.nr_states
    dev, dt = win.pos.device, win.pos.dtype
    ks = torch.arange(1, K, device=dev) if ks is None else torch.as_tensor(ks, device=dev)
    km = ks - 1
    active = (
        (win.status[ks] == STATUS_LOW_DISPARITY) & win.mask[ks] & win.mask[km]
    ).to(dt)
    eye = torch.eye(3, dtype=dt, device=dev)
    Ri, Rj = win.rot[km], win.rot[ks]
    dR = Ri.transpose(-1, -2) @ Rj
    r_rot = geo.so3_log(dR) / cfg.no_motion_rot_sigma
    r_pos = (win.pos[ks] - win.pos[km]) / cfg.no_motion_pos_sigma
    r_vel = win.vel[ks] / cfg.zero_velocity_sigma
    Jr = geo.so3_right_jacobian_inv(geo.so3_log(dR))
    n = ks.shape[0]
    Ji = torch.zeros((n, 9, S_DOF), dtype=dt, device=dev)
    Jj = torch.zeros((n, 9, S_DOF), dtype=dt, device=dev)
    Ji[:, 0:3, _TH] = -(Jr @ dR.transpose(-1, -2)) / cfg.no_motion_rot_sigma
    Jj[:, 0:3, _TH] = Jr / cfg.no_motion_rot_sigma
    Ji[:, 3:6, _P] = -eye / cfg.no_motion_pos_sigma
    Jj[:, 3:6, _P] = eye / cfg.no_motion_pos_sigma
    Jj[:, 6:9, _V] = eye / cfg.zero_velocity_sigma
    r = torch.cat([r_rot, r_pos, r_vel], dim=-1)
    return Ji * active[:, None, None], Jj * active[:, None, None], r * active[:, None]


def _pair_ks(cfg: BackendConfig, win: Window, ks):
    dev = win.pos.device
    ks = torch.arange(1, cfg.nr_states, device=dev) if ks is None else torch.as_tensor(ks, device=dev)
    return ks, ks - 1


def _between_blocks(cfg: BackendConfig, win: Window, mR, mt, mvalid, rot_sigma, pos_sigma,
                    ks=None):
    """Relative-pose between factors on consecutive keyframes: a 6-dim
    residual [Log(mR^T Ri^T Rj), Ri^T (pj - pi) - mt], each class whitened
    by its sigma (inf switches it off). Shared by the external-odometry
    factors (VioBackend.cpp:402-420) and the stereo-RANSAC between factors
    (addBetweenStereoFactors, :324-336). Analytic Jacobians under the
    retraction R <- R Exp(dth), p <- p + dp."""
    ks, km = _pair_ks(cfg, win, ks)
    dt = win.pos.dtype
    active = (mvalid[ks] & win.mask[ks] & win.mask[km]).to(dt)
    zero = torch.zeros((), dtype=dt, device=win.pos.device)
    w_rot = torch.where(torch.isfinite(rot_sigma), 1.0 / rot_sigma, zero)
    w_pos = torch.where(torch.isfinite(pos_sigma), 1.0 / pos_sigma, zero)
    Ri, Rj = win.rot[km], win.rot[ks]
    dR = Ri.transpose(-1, -2) @ Rj
    xi = geo.so3_log(mR[ks].transpose(-1, -2) @ dR)
    r_rot = xi * w_rot
    t_rel = torch.einsum("kji,kj->ki", Ri, win.pos[ks] - win.pos[km])
    r_pos = (t_rel - mt[ks]) * w_pos
    Jr = geo.so3_right_jacobian_inv(xi)
    RiT = Ri.transpose(-1, -2)
    n = ks.shape[0]
    Ji = torch.zeros((n, 6, S_DOF), dtype=dt, device=win.pos.device)
    Jj = torch.zeros((n, 6, S_DOF), dtype=dt, device=win.pos.device)
    Ji[:, 0:3, _TH] = -(Jr @ dR.transpose(-1, -2)) * w_rot
    Jj[:, 0:3, _TH] = Jr * w_rot
    Ji[:, 3:6, _TH] = geo.hat(t_rel) * w_pos
    Ji[:, 3:6, _P] = -RiT * w_pos
    Jj[:, 3:6, _P] = RiT * w_pos
    r = torch.cat([r_rot, r_pos], dim=-1)
    return Ji * active[:, None, None], Jj * active[:, None, None], r * active[:, None]


def _ext_odom_blocks(cfg: BackendConfig, win: Window, ks=None):
    return _between_blocks(cfg, win, win.ext_R, win.ext_t, win.ext_valid,
                           cfg.ext_odom_rot_sigma, cfg.ext_odom_pos_sigma, ks=ks)


def _between_stereo_blocks(cfg: BackendConfig, win: Window, ks=None):
    return _between_blocks(cfg, win, win.btw_R, win.btw_t, win.btw_valid,
                           cfg.between_rot_sigma, cfg.between_pos_sigma, ks=ks)


def _const_vel_blocks(cfg: BackendConfig, win: Window, ks=None):
    """Constant-velocity factor v_k ~ v_{k-1}
    (VioBackend::addConstantVelocityFactor, :1322-1330); off when
    constant_vel_sigma is inf."""
    ks, km = _pair_ks(cfg, win, ks)
    dt = win.pos.dtype
    zero = torch.zeros((), dtype=dt, device=win.pos.device)
    w = torch.where(torch.isfinite(cfg.constant_vel_sigma), 1.0 / cfg.constant_vel_sigma, zero)
    active = (win.mask[ks] & win.mask[km]).to(dt) * w
    n = ks.shape[0]
    eye = torch.eye(3, dtype=dt, device=win.pos.device)
    Ji = torch.zeros((n, 3, S_DOF), dtype=dt, device=win.pos.device)
    Jj = torch.zeros((n, 3, S_DOF), dtype=dt, device=win.pos.device)
    Ji[:, :, _V] = -eye
    Jj[:, :, _V] = eye
    r = win.vel[ks] - win.vel[km]
    return Ji * active[:, None, None], Jj * active[:, None, None], r * active[:, None]


def _pair_factor_blocks(cfg: BackendConfig, win: Window, ks=None):
    """Every factor on the consecutive-pair layout, in the reference's
    order: IMU + bias, no-motion, external odometry, between-stereo,
    constant velocity."""
    with span("backend.imu_factors"):
        imu = _imu_factor_blocks(cfg, win, ks)
    return (
        imu,
        _no_motion_blocks(cfg, win, ks),
        _ext_odom_blocks(cfg, win, ks),
        _between_stereo_blocks(cfg, win, ks),
        _const_vel_blocks(cfg, win, ks),
    )


def _projection_blocks(cfg: BackendConfig, win: Window, pts, obs_uvd):
    """Whitened stereo reprojection residuals of every landmark in every
    window state, with their closed-form Jacobians in the layout the
    smart factors use: r (3,K,L) [uL, uR, v], F (3,6,K,L) with respect to
    the state's [dtheta, dp] (R <- R Exp(dtheta), p <- p + dp), E (3,3,K,L)
    with respect to the point, and stereo_ok (K,L). A mono observation
    (NaN uR) has its uR row zeroed."""
    R_w_cam = win.rot @ cfg.R_b_cam
    t_w_cam = win.pos + torch.einsum("kij,j->ki", win.rot, cfg.t_b_cam)
    obs = obs_uvd.permute(2, 1, 0)  # (3,K,L)
    stereo_ok = torch.isfinite(obs[1])
    obs_safe = torch.stack([obs[0], torch.where(stereo_ok, obs[1], obs[0]), obs[2]])
    ptsT = pts.T
    q = torch.einsum("kji,jkl->ikl", win.rot, ptsT[:, None, :] - win.pos.T[:, :, None])
    pc = torch.einsum("kji,jkl->ikl", R_w_cam, ptsT[:, None, :] - t_w_cam.T[:, :, None])
    x, y, z = pc[0], pc[1], pc[2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / safe_z
    fx, fy, cx, cy, b = cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.baseline
    pred = torch.stack([fx * x * iz + cx, fx * (x - b) * iz + cx, fy * y * iz + cy])
    r = (pred - obs_safe) / cfg.smart_noise_sigma
    zeros = torch.zeros_like(z)
    Jproj = torch.stack(
        [
            torch.stack([fx * iz, zeros, -fx * x * iz * iz]),
            torch.stack([fx * iz, zeros, -fx * (x - b) * iz * iz]),
            torch.stack([zeros, fy * iz, -fy * y * iz * iz]),
        ]
    ) / cfg.smart_noise_sigma
    q0, q1, q2 = q[0], q[1], q[2]
    hatq = torch.stack(
        [
            torch.stack([zeros, -q2, q1]),
            torch.stack([q2, zeros, -q0]),
            torch.stack([-q1, q0, zeros]),
        ]
    )
    dpc_dth = torch.einsum("jb,jmkl->bmkl", cfg.R_b_cam, hatq)
    J_th = torch.einsum("abkl,bmkl->amkl", Jproj, dpc_dth)
    E = torch.einsum("abkl,kbm->amkl", Jproj, R_w_cam.transpose(-1, -2))
    F = torch.cat([J_th, -E], dim=1)  # (3,6,K,L)
    row_ok = torch.stack(
        [torch.ones_like(stereo_ok), stereo_ok, torch.ones_like(stereo_ok)]
    ).to(r.dtype)
    return r * row_ok, F * row_ok[:, None], E * row_ok[:, None], stereo_ok


def _smart_obs_blocks(cfg: BackendConfig, win: Window, obs_uvd, pts, ok, obs_mask):
    """`_projection_blocks` with the robust (Huber / Tukey) weights of each
    observation applied and masked to the valid observations of
    triangulated landmarks: (r, F, E)."""
    r, F, E, stereo_ok = _projection_blocks(cfg, win, pts, obs_uvd)
    rn = torch.linalg.norm(r, dim=0)
    dev = r.device
    ntype = torch.where(
        stereo_ok,
        torch.tensor(cfg.stereo_norm_type, device=dev),
        torch.tensor(cfg.mono_norm_type, device=dev),
    )
    nparam = torch.where(stereo_ok, cfg.stereo_norm_param, cfg.mono_norm_param)
    hw = robust_weight(rn, ntype, nparam)
    w = obs_mask.T & ok[None, :]
    sw = torch.sqrt(hw) * w.to(r.dtype)
    return r * sw, F * sw, E * sw


def _inv3_sym(A):
    """Closed-form inverse of symmetric 3x3 matrices (3,3,L), scaled by
    their mean diagonal first (adjugate over determinant)."""
    s_ = torch.clamp((A[0, 0] + A[1, 1] + A[2, 2]) / 3.0, min=1e-9)
    An = A / s_
    a_, b_, c_ = An[0, 0], An[0, 1], An[0, 2]
    d_, e_, f_ = An[1, 1], An[1, 2], An[2, 2]
    c00 = d_ * f_ - e_ * e_
    c01 = c_ * e_ - b_ * f_
    c02 = b_ * e_ - c_ * d_
    c11 = a_ * f_ - c_ * c_
    c12 = b_ * c_ - a_ * e_
    c22 = a_ * d_ - b_ * b_
    det = a_ * c00 + b_ * c01 + c_ * c02
    idet = 1.0 / det
    return torch.stack(
        [
            torch.stack([c00, c01, c02]),
            torch.stack([c01, c11, c12]),
            torch.stack([c02, c12, c22]),
        ]
    ) * (idet / s_)


def _smart_points(cfg: BackendConfig, win: Window, lmk: LandmarkTable, pts_fixed=None):
    """The landmarks' points for linearization: triangulated (or
    `pts_fixed`), invalid ones parked in front of the newest camera.
    Returns (pts (L,3), ok (L,), obs_mask (L,K))."""
    R_w_cam = win.rot @ cfg.R_b_cam
    t_w_cam = win.pos + torch.einsum("kij,j->ki", win.rot, cfg.t_b_cam)
    obs_mask = lmk.obs_mask & win.mask[None, :] & (lmk.ids >= 0)[:, None]
    newest = max(win.n - 1, 0)
    if pts_fixed is not None:
        pts, ok = pts_fixed
    else:
        pts, ok, _ = triangulate_stereo_landmarks(
            R_w_cam, t_w_cam, lmk.obs_uvd, obs_mask,
            fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, baseline=cfg.baseline,
            rank_tolerance=cfg.rank_tolerance,
            landmark_distance_threshold=cfg.landmark_distance_threshold,
            outlier_rejection_px=cfg.outlier_rejection_px,
            newest_idx=newest,
        )
        ok = ok & (obs_mask.sum(-1) >= cfg.min_obs_for_triangulation)
    # Invalid landmarks may triangulate to NaN and 0 * NaN = NaN: park them
    # 5 m in front of the newest camera before linearizing.
    fallback = t_w_cam[newest] + 5.0 * R_w_cam[newest][:, 2]
    safe = ok & torch.all(torch.isfinite(pts), dim=-1)
    return torch.where(safe[:, None], pts, fallback[None]), safe, obs_mask


def _smart_factor_blocks(cfg: BackendConfig, win: Window, lmk: LandmarkTable, pts_fixed=None):
    """Linearize + Schur-eliminate all smart stereo landmarks. Returns
    (H_pose (K,6,K,6), g_pose (K,6), lmk_points (L,3), lmk_ok (L,))."""
    pts, ok, obs_mask = _smart_points(cfg, win, lmk, pts_fixed)
    r, F, E = _smart_obs_blocks(cfg, win, lmk.obs_uvd, pts, ok, obs_mask)
    Hll = torch.einsum("aikl,ajkl->ijl", E, E) + 1e-6 * torch.eye(
        3, dtype=r.dtype, device=r.device
    ).reshape(3, 3, 1)
    Hll_inv = _inv3_sym(Hll)
    Hpl = torch.einsum("aikl,ajkl->ijkl", F, E)
    gl = torch.einsum("aikl,akl->il", E, r)

    H_diag = torch.einsum("aikl,ajkl->kij", F, F)
    T = torch.einsum("ijkl,jml->imkl", Hpl, Hll_inv)
    H_schur = torch.einsum("imkl,jmql->kiqj", T, Hpl)
    H_pose = -H_schur
    torch.diagonal(H_pose, dim1=0, dim2=2).add_(H_diag.permute(1, 2, 0))
    g_pose = torch.einsum("aikl,akl->ki", F, r) - torch.einsum("imkl,ml->ki", T, gl)
    return H_pose, g_pose, pts, ok


def _shard_inputs(cfg: BackendConfig, win: Window, dev: torch.device):
    """The configuration and window on a shard's device: copies, made for
    each Gauss-Newton iteration, where the shard lies on another device
    than the window."""
    if win.pos.device == dev:
        return cfg, win
    return tree_map(lambda x: x.to(dev), cfg), tree_map(lambda x: x.to(dev), win)


def _sum_partials(parts: list, dev: torch.device):
    """The shards' (H_pose, g_pose) partials copied to `dev` and summed in
    shard order: the counterpart of the JAX fleet's psum over `model`."""
    H_pose, g_pose = (x.to(dev) for x in parts[0])
    for H, g in parts[1:]:
        H_pose = H_pose + H.to(dev)
        g_pose = g_pose + g.to(dev)
    return H_pose, g_pose


def _smart_factor_system(cfg: BackendConfig, win: Window, lmk, pts_fixed=None):
    """`_smart_factor_blocks` on each shard of the table (a plain table is
    one shard), on the shard's device; the partial systems summed on the
    window's device. `pts_fixed` and the returned points are one (pts, ok)
    per shard, left on the shard. Returns (H_pose, g_pose, points)."""
    parts, points = [], []
    for m, shard in enumerate(lmk.shards):
        c, w = _shard_inputs(cfg, win, shard.ids.device)
        H, g, pts, ok = _smart_factor_blocks(c, w, shard,
                                             None if pts_fixed is None else pts_fixed[m])
        parts.append((H, g))
        points.append((pts, ok))
    return (*_sum_partials(parts, win.pos.device), points)


def _prior_blocks(cfg: BackendConfig, win: Window):
    """Marginal-prior contribution: H += Lambda, grad += Lambda dx - g."""
    dx = local_coords(
        win.rot, win.pos, win.vel, win.bias,
        win.prior_rot, win.prior_pos, win.prior_vel, win.prior_bias,
    ).reshape(-1)
    return win.prior_H, win.prior_H @ dx - win.prior_g


# ---------------------------------------------------------------------------
# Assembly + solve
# ---------------------------------------------------------------------------


def _add_pair_blocks(H, g, Ji, Jj, r):
    """Add stacked pair factors (pair p joins states p and p+1) to the
    (K,15,K,15) system through diagonal views: (i,i), (j,j), (i,j), (j,i)."""
    n = Ji.shape[0]
    Hii = torch.einsum("kri,krj->kij", Ji, Ji)
    Hjj = torch.einsum("kri,krj->kij", Jj, Jj)
    Hij = torch.einsum("kri,krj->kij", Ji, Jj)
    torch.diagonal(H, 0, 0, 2)[..., :n].add_(Hii.permute(1, 2, 0))
    torch.diagonal(H, 0, 0, 2)[..., 1 : n + 1].add_(Hjj.permute(1, 2, 0))
    torch.diagonal(H, 1, 0, 2)[..., :n].add_(Hij.permute(1, 2, 0))
    torch.diagonal(H, -1, 0, 2)[..., :n].add_(Hij.transpose(-1, -2).permute(1, 2, 0))
    g[:n] += torch.einsum("kri,kr->ki", Ji, r)
    g[1 : n + 1] += torch.einsum("kri,kr->ki", Jj, r)


def _assemble(cfg: BackendConfig, win: Window, lmk, pts_fixed=None):
    """The full (D,D) Gauss-Newton system at the current estimates, on
    the window's device. Returns (H, g, points: (pts, ok) per landmark
    shard)."""
    K = cfg.nr_states
    D = K * S_DOF
    dev, dt = win.pos.device, win.pos.dtype
    H = torch.zeros((K, S_DOF, K, S_DOF), dtype=dt, device=dev)
    g = torch.zeros((K, S_DOF), dtype=dt, device=dev)
    with span("backend.smart_factors"):
        H_pose, g_pose, points = _smart_factor_system(cfg, win, lmk, pts_fixed)
    H[:, 0:6, :, 0:6] += H_pose
    g[:, 0:6] += g_pose
    for Ji, Jj, r in _pair_factor_blocks(cfg, win):
        _add_pair_blocks(H, g, Ji, Jj, r)
    H = H.reshape(D, D)
    g = g.reshape(D)
    Hp, gp = _prior_blocks(cfg, win)
    H = H + Hp
    g = g + gp
    pin = (~win.mask).to(dt).repeat_interleave(S_DOF)
    H = H + torch.diag(pin)
    return H, g, points


def _cho_step(A, rhs):
    """-A^{-1} rhs by Cholesky; NaN when A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    if int(info) != 0:
        return torch.full_like(rhs, torch.nan)
    return -torch.cholesky_solve(rhs[:, None], L)[:, 0]


def _gn_solve(cfg: BackendConfig, win: Window, lmk):
    """cfg.gn_iters Gauss-Newton iterations with the reference's failure
    recovery (VioBackend::updateSmoother backup-and-recover): non-finite
    blocks are zeroed; a non-finite step is re-solved with heavy damping
    plus a prior pinning the newest state; a still-bad step is rejected.
    Iterations after the first reuse the first triangulation. Returns
    (win, points: (pts, lmk_ok) per landmark shard, n_recovered)."""
    K = cfg.nr_states
    n_recovered = 0
    pts_fixed = None
    for _ in range(cfg.gn_iters):
        with span("backend.gn_iter"):
            H, g, points = _assemble(cfg, win, lmk, pts_fixed)
            with span("backend.solve"):
                D = H.shape[0]
                eye = torch.eye(D, dtype=H.dtype, device=H.device)
                finite_in = bool(torch.all(torch.isfinite(H)) & torch.all(torch.isfinite(g)))
                H = torch.where(torch.isfinite(H), H, torch.zeros_like(H))
                g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                H = 0.5 * (H + H.T)
                d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
                dinv = 1.0 / d
                Hs = H * dinv[:, None] * dinv[None, :]
                delta = _cho_step(Hs + 1e-5 * eye, g * dinv) * dinv
                bad = not (finite_in and bool(torch.all(torch.isfinite(delta))))
                if bad:
                    newest = max(win.n - 1, 0)
                    extra = torch.zeros(D, dtype=H.dtype, device=H.device)
                    extra[newest * S_DOF : (newest + 1) * S_DOF] = 1.0
                    delta = _cho_step(Hs + 1e-2 * eye + torch.diag(extra), g * dinv) * dinv
                delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
                delta = delta.reshape(K, S_DOF) * win.mask[:, None]
                rot, pos, vel, bias = retract_states(win.rot, win.pos, win.vel, win.bias, delta)
                win = replace(win, rot=rot, pos=pos, vel=vel, bias=bias)
        n_recovered += int(bad)
        pts_fixed = points
    return win, pts_fixed, n_recovered


def state_covariance(cfg: BackendConfig, win: Window, lmk, return_ok: bool = False):
    """Marginal covariance (15x15) of the newest state: the window's
    information inverted onto the newest block (the reference's
    VioBackend::computeStateCovariance). Jacobi equilibration, a 1e-6
    ridge, non-finite entries zeroed, a Cholesky and a solve for the
    newest 15 columns; the block is symmetrised.

    `return_ok=True` also returns a health flag (a 0-d bool tensor): the
    assembly reuses the robust weights at the current estimate without
    the solver's recovery path, so on a sick window (non-finite rows, a
    Hessian not positive definite after equilibration, a non-finite or
    non-positive variance) the numbers mean nothing."""
    D = cfg.nr_states * S_DOF
    H, _, _ = _assemble(cfg, win, lmk)
    eye = torch.eye(D, dtype=H.dtype, device=H.device)
    H = 0.5 * (H + H.T)
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    dinv = 1.0 / d
    Hs = H * dinv[:, None] * dinv[None, :] + 1e-6 * eye
    newest = max(win.n - 1, 0)
    rows = slice(newest * S_DOF, (newest + 1) * S_DOF)
    E = torch.zeros((D, S_DOF), dtype=H.dtype, device=H.device)
    E[rows] = eye[:S_DOF, :S_DOF]
    Hs = torch.where(torch.isfinite(Hs), Hs, torch.zeros_like(Hs))
    Lc, info = torch.linalg.cholesky_ex(Hs)
    # jnp.linalg.cholesky returns NaN where this reports info != 0.
    Lc = torch.where(info != 0, torch.full_like(Lc, torch.nan), Lc)
    X = torch.cholesky_solve(E * dinv[:, None], Lc)
    cov = (X * dinv[:, None])[rows]
    cov = 0.5 * (cov + cov.T)
    if not return_ok:
        return cov
    ok = (torch.isfinite(H).all() & torch.isfinite(Lc).all() & torch.isfinite(cov).all()
          & (torch.diagonal(cov) > 0).all())
    return cov, ok


# ---------------------------------------------------------------------------
# Marginalization & shift
# ---------------------------------------------------------------------------


def _marginalize_oldest(cfg: BackendConfig, win: Window) -> Window:
    """Schur-eliminate state 0 (prior + the factors of pair (0,1)) into a
    new prior on the remaining states, and shift the window left."""
    K = cfg.nr_states
    D = K * S_DOF
    dev, dt = win.pos.device, win.pos.dtype
    H = torch.zeros((K, S_DOF, K, S_DOF), dtype=dt, device=dev)
    g = torch.zeros((K, S_DOF), dtype=dt, device=dev)
    for Ji, Jj, r in _pair_factor_blocks(cfg, win, ks=[1]):
        Ji0, Jj0, r0 = Ji[0], Jj[0], r[0]
        H[0, :, 0, :] += Ji0.T @ Ji0
        H[1, :, 1, :] += Jj0.T @ Jj0
        H01 = Ji0.T @ Jj0
        H[0, :, 1, :] += H01
        H[1, :, 0, :] += H01.T
        g[0] += Ji0.T @ r0
        g[1] += Jj0.T @ r0
    H = H.reshape(D, D)
    g = g.reshape(D)
    Hp, gp = _prior_blocks(cfg, win)
    H = H + Hp
    g = g + gp

    d = S_DOF
    H00 = H[:d, :d] + 1e-8 * torch.eye(d, dtype=dt, device=dev)
    H01 = H[:d, d:]
    H11 = H[d:, d:]
    sol = torch.linalg.solve(H00, torch.cat([H01, g[:d, None]], dim=1))
    X = sol[:, :-1]
    y = sol[:, -1]
    Lam = H11 - H01.T @ X
    Lam = 0.5 * (Lam + Lam.T)
    eta = g[d:] - H01.T @ y

    newH = torch.zeros((D, D), dtype=dt, device=dev)
    newH[: D - d, : D - d] = Lam
    newg = torch.zeros((D,), dtype=dt, device=dev)
    newg[: D - d] = -eta

    def shift(a):
        return torch.roll(a, -1, dims=0)

    def shift_clear(a):
        a = shift(a)
        a[K - 1] = False
        return a

    return replace(
        win,
        rot=shift(win.rot),
        pos=shift(win.pos),
        vel=shift(win.vel),
        bias=shift(win.bias),
        stamp=shift(win.stamp),
        mask=shift_clear(win.mask),
        status=shift(win.status),
        ext_R=shift(win.ext_R),
        ext_t=shift(win.ext_t),
        ext_valid=shift_clear(win.ext_valid),
        btw_R=shift(win.btw_R),
        btw_t=shift(win.btw_t),
        btw_valid=shift_clear(win.btw_valid),
        pim=tree_map(shift, win.pim),
        pim_valid=shift_clear(win.pim_valid),
        n=win.n - 1,
        prior_H=newH,
        prior_g=newg,
        prior_rot=shift(win.rot),
        prior_pos=shift(win.pos),
        prior_vel=shift(win.vel),
        prior_bias=shift(win.bias),
    )


# ---------------------------------------------------------------------------
# Landmark table maintenance
# ---------------------------------------------------------------------------


def update_landmarks(lmk, meas_ids, meas_uvd, meas_mask, slot: int):
    """Insert this keyframe's stereo measurements into the track table:
    known ids update their row, new ids take free rows oldest-first,
    measurements beyond capacity are dropped. The rows are chosen over
    the whole table (a sharded one's ids gathered on its first shard's
    device), and each shard writes the rows in its range."""
    shards = lmk.shards
    dev = shards[0].ids.device
    ids_all = shards[0].ids if len(shards) == 1 else torch.cat([s.ids.to(dev) for s in shards])
    L = ids_all.shape[0]
    eq = (ids_all[:, None] == meas_ids[None, :]) & meas_mask[None, :] & (ids_all >= 0)[:, None]
    row_of_meas = torch.argmax(eq.to(torch.uint8), dim=0)
    found = eq.any(dim=0)
    free = ids_all < 0
    new_meas = meas_mask & ~found
    free_rows = torch.argsort((~free).to(torch.uint8), stable=True)
    new_rank = torch.cumsum(new_meas.to(torch.int64), 0) - 1
    target_row = free_rows[torch.clamp(new_rank, 0, L - 1)]
    new_meas = new_meas & (new_rank < free.sum())
    rows = torch.where(new_meas, target_row, row_of_meas)
    write = meas_mask & (found | new_meas)
    # Non-writes go to a scratch row that is cut off afterwards (the
    # reference parks them out of bounds, where JAX drops the update).
    rows_safe = torch.where(write, rows, torch.full_like(rows, L))
    out, lo = [], 0
    for s in shards:
        n, sdev = s.ids.shape[0], s.ids.device
        local = rows_safe - lo
        local = torch.where((local >= 0) & (local < n), local, torch.full_like(local, n)).to(sdev)
        slots = torch.full_like(local, slot)

        def scatter(table, values, extra_index=()):
            padded = torch.cat([table, table[:1]], dim=0)
            padded[(local, *extra_index)] = values.to(sdev)
            return padded[:n]

        out.append(replace(
            s, ids=scatter(s.ids, meas_ids), obs_uvd=scatter(s.obs_uvd, meas_uvd, (slots,)),
            obs_mask=scatter(s.obs_mask, torch.ones_like(meas_mask), (slots,))))
        lo += n
    return lmk.with_shards(out)


def shift_landmarks(lmk):
    """Drop observations of the state leaving the window; free dead rows
    (shard by shard)."""
    def shift(s: LandmarkTable) -> LandmarkTable:
        obs_uvd = torch.roll(s.obs_uvd, -1, dims=1)
        obs_mask = torch.roll(s.obs_mask, -1, dims=1)
        obs_mask[:, -1] = False
        alive = obs_mask.any(dim=1)
        ids = torch.where(alive, s.ids, torch.full_like(s.ids, -1))
        return replace(s, ids=ids, obs_uvd=obs_uvd, obs_mask=obs_mask, pts_ok=s.pts_ok & alive)

    return lmk.with_shards([shift(s) for s in lmk.shards])


# ---------------------------------------------------------------------------
# Public stepping API
# ---------------------------------------------------------------------------


def bootstrap(cfg: BackendConfig, win: Window, nav: NavState, bias, stamp: float,
              vel_sigma: float | None = None) -> Window:
    """Install the first keyframe state with its initial priors
    (initStateAndSetPriors, VioBackend.h:143-194); sigmas clamped to 1e-3
    as in the reference (f32 normal equations)."""
    dev, dt = win.pos.device, win.pos.dtype
    rot = win.rot.clone()
    rot[0] = nav.rot
    pos = win.pos.clone()
    pos[0] = nav.pos
    vel = win.vel.clone()
    vel[0] = nav.vel
    b = win.bias.clone()
    b[0] = bias
    st = win.stamp.clone()
    st[0] = stamp
    mask = win.mask.clone()
    mask[0] = True
    win = replace(win, rot=rot, pos=pos, vel=vel, bias=b, stamp=st, mask=mask,
                  out_rot=nav.rot.clone(), out_pos=nav.pos.clone(), n=1)

    def clamp(s):
        return torch.clamp(s, min=1e-3)

    rp = 1.0 / clamp(cfg.init_rp_sigma) ** 2
    Info_rot_w = torch.diag(torch.stack([rp, rp, 1.0 / clamp(cfg.init_yaw_sigma) ** 2]))
    R0 = nav.rot
    Info_rot_b = R0.T @ Info_rot_w @ R0
    eye = torch.eye(3, dtype=dt, device=dev)
    vs = cfg.init_vel_sigma if vel_sigma is None else _f32(vel_sigma, dev)
    P0 = torch.block_diag(
        Info_rot_b,
        eye / clamp(cfg.init_pos_sigma) ** 2,
        eye / clamp(vs) ** 2,
        eye / clamp(cfg.init_ba_sigma) ** 2,
        eye / clamp(cfg.init_bg_sigma) ** 2,
    )
    prior_H = win.prior_H.clone()
    prior_H[:S_DOF, :S_DOF] = P0.to(dt)
    return replace(
        win,
        prior_H=prior_H,
        prior_g=torch.zeros_like(win.prior_g),
        prior_rot=win.rot,
        prior_pos=win.pos,
        prior_vel=win.vel,
        prior_bias=win.bias,
    )


def backend_step(cfg: BackendConfig, win: Window, lmk: LandmarkTable | ShardedLandmarkTable,
                 *, pim: Pim, stamp: float, meas_ids, meas_uvd, meas_mask, status: int,
                 ext_R_rel=None, ext_t_rel=None, ext_valid=None,
                 btw_R_rel=None, btw_t_rel=None, btw_valid=None,
                 guess_R=None, guess_t=None, guess_valid=None,
                 odom_R_abs=None, odom_t_abs=None, odom_valid_abs=None):
    """One keyframe update: marginalize if the window is full, insert the
    predicted state, add the measurements, optimize. Returns (win, lmk,
    outputs).

    Optional inputs, each a relative pose from the last keyframe to this
    one or an absolute pose, with a validity flag (a 0-d bool tensor or a
    Python bool): `ext_*` an external-odometry relative pose, `btw_*` the
    tracker's stereo-RANSAC relative pose (between-stereo factor),
    `guess_*` a pose guess that replaces the IMU-predicted pose where
    valid (pose_guess_source MONO / STEREO / PnP, VioBackend.cpp:797-891;
    the velocity stays IMU-predicted), `odom_*` an absolute
    external-odometry pose, turned into the relative one against the
    previous keyframe's (VisionImuFrontend.cpp:240-302)."""
    K = cfg.nr_states
    dev = win.pos.device
    if win.n >= K:
        with span("backend.marginalize"):
            win = _marginalize_oldest(cfg, win)
            lmk = shift_landmarks(lmk)
    slot = min(win.n, K - 1)
    prev = max(slot - 1, 0)
    prev_nav = NavState(rot=win.rot[prev], pos=win.pos[prev], vel=win.vel[prev])
    prev_bias = ImuBias(accel=win.bias[prev, 0:3], gyro=win.bias[prev, 3:6])
    guess = pim_predict(pim, prev_nav, prev_bias, cfg.n_gravity)

    def flag(v):
        return torch.as_tensor(True if v is None else v, dtype=torch.bool, device=dev)

    if guess_R is not None:
        use = flag(guess_valid)
        guess = replace(guess, rot=torch.where(use, guess_R, guess.rot),
                        pos=torch.where(use, guess_t, guess.pos))
    if odom_R_abs is not None:
        ov = flag(odom_valid_abs)
        ext_R_rel = win.odom_R.T @ odom_R_abs
        ext_t_rel = win.odom_R.T @ (odom_t_abs - win.odom_t)
        ext_valid = win.odom_valid & ov
        win = replace(win, odom_R=torch.where(ov, odom_R_abs, win.odom_R),
                      odom_t=torch.where(ov, odom_t_abs, win.odom_t),
                      odom_valid=win.odom_valid | ov)

    def put(table, value):
        out = table.clone()
        out[slot] = value
        return out

    def put_valid(table, value):
        return put(table, flag(value) & (slot > 0) if value is not None else False)

    win = replace(
        win,
        rot=put(win.rot, guess.rot),
        pos=put(win.pos, guess.pos),
        vel=put(win.vel, guess.vel),
        bias=put(win.bias, win.bias[prev]),
        stamp=put(win.stamp, stamp),
        mask=put(win.mask, True),
        status=put(win.status, status),
        pim=tree_map2(put, win.pim, pim),
        pim_valid=put(win.pim_valid, slot > 0),
        ext_R=win.ext_R if ext_R_rel is None else put(win.ext_R, ext_R_rel),
        ext_t=win.ext_t if ext_t_rel is None else put(win.ext_t, ext_t_rel),
        ext_valid=put_valid(win.ext_valid, ext_valid),
        btw_R=win.btw_R if btw_R_rel is None else put(win.btw_R, btw_R_rel),
        btw_t=win.btw_t if btw_t_rel is None else put(win.btw_t, btw_t_rel),
        btw_valid=put_valid(win.btw_valid, btw_valid),
        n=min(win.n + 1, K),
    )
    with span("backend.landmarks"):
        lmk = update_landmarks(lmk, meas_ids, meas_uvd, meas_mask, slot)
    win, points, n_recovered = _gn_solve(cfg, win, lmk)
    lmk = lmk.with_shards([replace(s, pts=pts, pts_ok=ok)
                           for s, (pts, ok) in zip(lmk.shards, points)])

    # Increment-chained pose (VioBackend.cpp:1348-1373).
    if slot > 0:
        rel_R = win.rot[prev].T @ win.rot[slot]
        rel_t = torch.einsum("ji,j->i", win.rot[prev], win.pos[slot] - win.pos[prev])
        inc_rot = win.out_rot @ rel_R
        inc_pos = win.out_pos + win.out_rot @ rel_t
    else:
        inc_rot, inc_pos = win.rot[slot], win.pos[slot]
    win = replace(win, out_rot=inc_rot, out_pos=inc_pos)
    outputs = {
        "rot": win.rot[slot],
        "pos": win.pos[slot],
        "vel": win.vel[slot],
        "bias": win.bias[slot],
        "rot_inc": inc_rot,
        "pos_inc": inc_pos,
        "stamp": stamp,
        "slot": slot,
        "lmk_points": lmk.pts,
        "lmk_valid": lmk.pts_ok,
        "lmk_ids": lmk.ids,
        "n_recovered": n_recovered,
    }
    return win, lmk, outputs
