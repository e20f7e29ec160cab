"""Online initialization: visual-inertial alignment at mission start.

Port of kimera_vio_tpu/initial/initializer.py (the reference's
InitializationBackend::bundleAdjustmentAndGravityAlignment feeding
OnlineGravityAlignment, selected by `autoInitialize: 2`). The stereo
tracker gives metric keyframe-relative poses, so the window collects them
with the keyframe PIMs and runs the linear alignment of
initial/gravity_alignment.py directly (no visual bundle adjustment).

Flow (host-paced, init window only):
  1. The pipeline bootstraps with the crude IMU-attitude guess and runs;
     this collector gathers per keyframe the visual relative pose (body
     frame), the PIM (delta_R/v/p, dR/dbg) and dt.
  2. After `n_kf` keyframes: the gyro bias, then per-keyframe velocities
     and the gravity direction in the crude world frame.
  3. The pipeline re-bootstraps: attitude turned so that gravity matches
     `n_gravity`, velocity from the alignment, gyro bias installed.

The chain is kept in float64 on the host; the solves run in float32 on
`device`, as the reference's do.
"""

from __future__ import annotations

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.common import geometry as geo
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.initial.gravity_alignment import (
    align_velocities_and_gravity,
    estimate_gyro_bias,
)


class OnlineInitializer:
    def __init__(self, n_gravity, R0: np.ndarray, n_kf: int | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.n_gravity = np.asarray(n_gravity, np.float64)
        # Window size from the flag tier (reference num_frames_vio_init).
        self.n_kf = int(flags.get_flag("num_frames_vio_init")) if n_kf is None else n_kf
        self._refine_iters = int(flags.get_flag("num_iterations_gravity_refinement"))
        self._max_gyro_residual = float(flags.get_flag("gyroscope_residuals"))
        self.done = False
        # Visual pose chain in the crude world frame, from the bootstrap
        # attitude.
        self.R_chain = [np.asarray(R0, np.float64)]
        self.p_chain = [np.zeros(3)]
        self.rel = []  # per keyframe interval

    def add_keyframe(self, fo: dict, stamp_s: float) -> bool:
        """`fo`: a keyframe's init inputs on the host (init_R_rel_body,
        init_t_rel_body, init_pim_delta_R/v/p, init_pim_dR_dbg). The first
        keyframe anchors the chain. True when the window is full (call
        `solve`)."""
        if self.done:
            return False
        if not self.rel:
            self._last_stamp = stamp_s
            self.rel.append(None)
            return False
        R_rel = np.asarray(fo["init_R_rel_body"], np.float64)
        t_rel = np.asarray(fo["init_t_rel_body"], np.float64)
        self.R_chain.append(self.R_chain[-1] @ R_rel)
        self.p_chain.append(self.p_chain[-1] + self.R_chain[-2] @ t_rel)
        self.rel.append({
            "dt": stamp_s - self._last_stamp,
            "delta_R": np.asarray(fo["init_pim_delta_R"], np.float64),
            "delta_v": np.asarray(fo["init_pim_delta_v"], np.float64),
            "delta_p": np.asarray(fo["init_pim_delta_p"], np.float64),
            "dR_dbg": np.asarray(fo["init_pim_dR_dbg"], np.float64),
        })
        self._last_stamp = stamp_s
        return len(self.R_chain) >= self.n_kf

    def solve(self) -> dict:
        """{"R0": aligned attitude of the last keyframe, "pos0", "vel": its
        world velocity, "gyro_bias", "gravity_crude_frame", "ok": the gyro
        residual passed gyroscope_residuals, "gyro_residual"}."""
        rel = self.rel[1:]
        F = len(self.R_chain)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        R_vis = t(np.stack(self.R_chain))
        p_vis = t(np.stack(self.p_chain))
        mask = torch.ones(F - 1, dtype=torch.bool, device=self.device)
        pim_dR = t(np.stack([r["delta_R"] for r in rel]))
        dR_dbg = t(np.stack([r["dR_dbg"] for r in rel]))
        bg = estimate_gyro_bias(R_vis, pim_dR, dR_dbg, mask)
        # Post-correction rotation residual gate (gyroscope_residuals): a
        # window whose bias-corrected preintegrated rotations still
        # disagree with vision is rejected.
        R_rel = torch.einsum("fji,fjk->fik", R_vis[:-1], R_vis[1:])
        err = geo.so3_log(torch.einsum("fji,fjk->fik", pim_dR, R_rel)) - torch.einsum(
            "fij,j->fi", dR_dbg, bg)
        gyro_residual = float(torch.linalg.norm(err, dim=-1).mean())
        vels, gravity = align_velocities_and_gravity(
            R_vis, p_vis, t([r["dt"] for r in rel]),
            t(np.stack([r["delta_v"] for r in rel])), t(np.stack([r["delta_p"] for r in rel])),
            mask, gravity_norm=float(np.linalg.norm(self.n_gravity)),
            refine_iters=self._refine_iters,
        )
        g_est = gravity.cpu().numpy().astype(np.float64)
        # The rotation taking the estimated gravity (crude world) onto
        # n_gravity.
        a = g_est / np.linalg.norm(g_est)
        b = self.n_gravity / np.linalg.norm(self.n_gravity)
        v = np.cross(a, b)
        c = float(a @ b)
        s = np.linalg.norm(v)
        if s < 1e-9:
            if c > 0:
                R_fix = np.eye(3)
            else:
                # Antiparallel: a half turn about an axis perpendicular to a.
                perp = np.cross(a, [1.0, 0.0, 0.0])
                if np.linalg.norm(perp) < 1e-6:
                    perp = np.cross(a, [0.0, 1.0, 0.0])
                perp /= np.linalg.norm(perp)
                R_fix = 2.0 * np.outer(perp, perp) - np.eye(3)
        else:
            vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
            R_fix = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))
        self.done = True
        return {
            "R0": (R_fix @ self.R_chain[-1]).astype(np.float32),
            "pos0": (R_fix @ self.p_chain[-1]).astype(np.float32),
            "vel": (R_fix @ vels[-1].cpu().numpy().astype(np.float64)).astype(np.float32),
            "gyro_bias": bg.cpu().numpy().astype(np.float32),
            "gravity_crude_frame": g_est.astype(np.float32),
            "ok": gyro_residual <= self._max_gyro_residual,
            "gyro_residual": gyro_residual,
        }
