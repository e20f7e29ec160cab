"""CSV output loggers in the reference schema.

Port of the main-path loggers of kimera_vio_tpu/utils/logger.py: the key
artifact is `traj_vio.csv` with the reference's 17-column header
(src/logging/Logger.cpp:148-151), so evo / kimera_eval read the port's
output unchanged; with loop closure, `traj_pgo.csv` and
`output_lcd_result.csv`; with the mesher, one ASCII PLY per keyframe
under `mesh/`. Numpy and file IO.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from kimera_vio_tpu_torch.common.geometry import rot_to_quat


class BackendLogger:
    """Writes traj_vio.csv (+ timing CSV) in the reference schema."""

    HEADER = "#timestamp,x,y,z,qw,qx,qy,qz,vx,vy,vz,bgx,bgy,bgz,bax,bay,baz"

    def __init__(self, output_path: str):
        os.makedirs(output_path, exist_ok=True)
        self._traj = open(os.path.join(output_path, "traj_vio.csv"), "w")
        self._traj.write(self.HEADER + "\n")
        self._timing = open(
            os.path.join(output_path, "output_backendTiming.csv"), "w"
        )
        self._timing.write("#timestamp,backend_spin_ms\n")

    def log_state(self, stamp_ns: int, pos, quat_wxyz, vel, gyro_bias, accel_bias):
        row = [stamp_ns, *pos, *quat_wxyz, *vel, *gyro_bias, *accel_bias]
        self._traj.write(",".join(f"{x:.9g}" if i else str(x) for i, x in enumerate(row)) + "\n")

    def log_timing(self, stamp_ns: int, spin_ms: float):
        self._timing.write(f"{stamp_ns},{spin_ms:.3f}\n")

    def close(self):
        self._traj.close()
        self._timing.close()


class FrontendLogger:
    """Tracker/RANSAC statistics CSV (reference FrontendLogger)."""

    def __init__(self, output_path: str):
        os.makedirs(output_path, exist_ok=True)
        self._f = open(os.path.join(output_path, "output_frontend_stats.csv"), "w")
        self._f.write(
            "#timestamp,is_keyframe,n_tracked,median_disparity,"
            "n_mono_inliers,n_stereo_inliers,frontend_spin_ms\n"
        )

    def log(self, stamp_ns, is_kf, n_tracked, med_disp, n_mono, n_stereo, ms):
        self._f.write(
            f"{stamp_ns},{int(is_kf)},{n_tracked},{med_disp:.3f},"
            f"{n_mono},{n_stereo},{ms:.3f}\n"
        )

    def close(self):
        self._f.close()


class LcdLogger:
    """Loop-closure / PGO CSVs (reference LoopClosureDetectorLogger,
    src/logging/Logger.cpp:589-595): `traj_pgo.csv`, the PGO-optimized
    keyframe trajectory in the schema evo reads, and
    `output_lcd_result.csv`, one row per accepted loop."""

    TRAJ_HEADER = "#timestamp,x,y,z,qw,qx,qy,qz"

    def __init__(self, output_path: str):
        os.makedirs(output_path, exist_ok=True)
        self._traj = open(os.path.join(output_path, "traj_pgo.csv"), "w")
        self._traj.write(self.TRAJ_HEADER + "\n")
        self._result = open(os.path.join(output_path, "output_lcd_result.csv"), "w")
        self._result.write("#query_kf,match_kf,isLoop\n")

    def log_pgo_trajectory(self, stamps_ns, rots, positions):
        quats = rot_to_quat(torch.as_tensor(np.asarray(rots, np.float32))).numpy()
        for s, p, q in zip(stamps_ns, np.asarray(positions), quats):
            row = [int(s), *p, *q]
            self._traj.write(",".join(f"{x:.9g}" if i else str(x) for i, x in enumerate(row)) + "\n")

    def log_loop(self, query_kf: int, match_kf: int, is_loop: bool = True):
        self._result.write(f"{query_kf},{match_kf},{int(is_loop)}\n")

    def close(self):
        self._traj.close()
        self._result.close()


class MesherLogger:
    """Per-keyframe mesh serialization (reference MesherLogger /
    Mesher::serializeMeshes, Mesher.cpp:1658-1669): ASCII PLY files
    `<output>/mesh/mesh_00000.ply`, ... in the JAX package's bytes."""

    def __init__(self, output_path: str):
        self.dir = os.path.join(output_path, "mesh")
        os.makedirs(self.dir, exist_ok=True)
        self.count = 0

    def log(self, vertices: np.ndarray, triangles: np.ndarray):
        path = os.path.join(self.dir, f"mesh_{self.count:05d}.ply")
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n"
                    f"element vertex {len(vertices)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    f"element face {len(triangles)}\n"
                    "property list uchar int vertex_indices\nend_header\n")
            for v in vertices:
                f.write(f"{v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
            for t in triangles:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
        self.count += 1

    def close(self):
        """Nothing stays open: each PLY is written and closed in `log`."""


class PipelineLogger:
    """Overall timing CSV (reference PipelineLogger,
    output_timingOverall.csv — the Jenkins CI timing-trend artifact,
    Jenkinsfile:89-95)."""

    def __init__(self, output_path: str):
        os.makedirs(output_path, exist_ok=True)
        self._f = open(
            os.path.join(output_path, "output_timingOverall.csv"), "w"
        )
        self._f.write("#n_frames,wall_s,fps,n_keyframes\n")

    def log(self, n_frames: int, wall_s: float, n_keyframes: int):
        fps = n_frames / wall_s if wall_s > 0 else 0.0
        self._f.write(f"{n_frames},{wall_s:.3f},{fps:.2f},{n_keyframes}\n")

    def close(self):
        self._f.close()


def compute_ate(
    est_stamps_ns: np.ndarray,
    est_pos: np.ndarray,
    gt_stamps_ns: np.ndarray,
    gt_pos: np.ndarray,
    align: bool = True,
) -> dict:
    """Absolute trajectory error (RMSE and friends) with SE(3) (Umeyama,
    no scale) alignment — the metric kimera_eval computes via `evo`
    (reference Jenkinsfile:70-87). GT is interpolated to estimate stamps."""
    gt_interp = np.stack(
        [
            np.interp(est_stamps_ns.astype(np.float64), gt_stamps_ns.astype(np.float64), gt_pos[:, i])
            for i in range(3)
        ],
        axis=-1,
    )
    est = est_pos.astype(np.float64)
    if align and len(est) >= 3:
        mu_e = est.mean(0)
        mu_g = gt_interp.mean(0)
        X = est - mu_e
        Y = gt_interp - mu_g
        H = X.T @ Y
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        D = np.diag([1.0, 1.0, d])
        R = Vt.T @ D @ U.T
        t = mu_g - R @ mu_e
        est = est @ R.T + t
    err = np.linalg.norm(est - gt_interp, axis=-1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "n": len(err),
    }
