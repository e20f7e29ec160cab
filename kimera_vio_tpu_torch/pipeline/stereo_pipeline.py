"""StereoImuPipeline: data provider -> frontend -> backend, sequential.

Port of the sequential `run()` of
kimera_vio_tpu/pipeline/stereo_pipeline.py (the reference
StereoImuPipeline, src/pipeline/StereoImuPipeline.cpp:39-254, with
parallel_run=0): per frame the frontend tracks; on keyframes the backend
solves and its IMU bias is fed back to the frontend
(imu_bias_update_callback). Bootstrap from ground truth
(autoInitialize: 0) or IMU attitude. Outputs the keyframe trajectory and,
with an output path, the reference's CSV logs (traj_vio.csv, ...).

Not ported yet: `run_chunked` and its staging codec, the mesher, loop
closure, visualizer, time alignment, online initialization, external
odometry and the parallel mode; the constructor refuses configurations
that need them.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.backend import smoother as sm
from kimera_vio_tpu_torch.common import geometry as geo
from kimera_vio_tpu_torch.common.types import ImuBias, NavState, replace, tree_map
from kimera_vio_tpu_torch.config.params import VioParams
from kimera_vio_tpu_torch.frontend import imu_frontend as imu
from kimera_vio_tpu_torch.frontend.camera import StereoCamera
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendConfig, StereoFrontend
from kimera_vio_tpu_torch.utils.logger import BackendLogger, FrontendLogger, PipelineLogger
from kimera_vio_tpu_torch.utils.stats import StatsCollector


@dataclass
class PipelineOutput:
    stamps_ns: list = field(default_factory=list)
    positions: list = field(default_factory=list)
    quats_wxyz: list = field(default_factory=list)
    velocities: list = field(default_factory=list)
    biases: list = field(default_factory=list)
    n_keyframes: int = 0
    n_frames: int = 0


def _check_supported(params: VioParams):
    bp = params.backend
    unsupported = {
        "autoInitialize != 0": bp.auto_initialize != 0,
        "add_between_stereo_factors": bool(bp.add_between_stereo_factors),
        "pose_guess_source != IMU": bp.pose_guess_source != 0,
        "external odometry": params.odometry is not None,
        "mono / RGB-D frontend": params.pipeline.frontend_type != 1,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class StereoImuPipeline:
    """End-to-end stereo-inertial VIO on one device (CUDA by default)."""

    def __init__(self, params: VioParams, output_path: str | None = None,
                 device: str | torch.device = "cuda"):
        _check_supported(params)
        self.device = resolve_device(device)
        self.params = params
        dev = self.device
        self.stereo = StereoCamera.from_params(params.left_cam, params.right_cam, dev)
        self.frontend_cfg = FrontendConfig.from_params(params.frontend, max_features=params.max_features)
        self.pim_params = imu.PimParams.from_params(params.imu, dev)
        self.frontend = StereoFrontend(self.frontend_cfg, self.stereo, self.pim_params, dev)
        self.backend_cfg = sm.BackendConfig.from_params(
            params.backend, params.imu, self.stereo, max_landmarks=params.max_landmarks, device=dev,
        )
        # f32 time-origin rebase for long missions (as the reference): stamps
        # in the state are f32 seconds after a host-owned t0 that advances by
        # whole intervals, keeping their resolution bounded.
        span = float(params.backend.nr_states) * float(
            getattr(params.frontend, "max_intra_keyframe_time_s", 5.0))
        self._rebase_margin_s = max(128.0, span + 8.0)
        self._rebase_interval_s = float(
            max(256.0, 2.0 ** np.ceil(np.log2(2.0 * self._rebase_margin_s))))
        self.output_path = output_path
        self.stats = StatsCollector()

    # ------------------------------------------------------------------
    def _rebase_delta_s(self, rel_s: float) -> float:
        if rel_s < self._rebase_margin_s + self._rebase_interval_s:
            return 0.0
        return self._rebase_interval_s * math.floor(
            (rel_s - self._rebase_margin_s) / self._rebase_interval_s)

    def _bootstrap_state(self, provider, stamp_ns: int, first_imu):
        """Initial nav state + bias: ground truth when available
        (autoInitialize: 0), else the IMU attitude."""
        dev = self.device
        if provider.ground_truth is not None:
            gt = provider.ground_truth.state_at(stamp_ns)
            R = geo.quat_to_rot(torch.as_tensor(np.asarray(gt["quat_wxyz"], np.float32)))
            nav = NavState(
                rot=R.to(dev),
                pos=torch.as_tensor(np.asarray(gt["position"], np.float32), device=dev),
                vel=torch.as_tensor(np.asarray(gt["velocity"], np.float32), device=dev),
            )
            bias = np.concatenate([gt["accel_bias"], gt["gyro_bias"]]).astype(np.float32)
            return nav, torch.as_tensor(bias, device=dev)
        if first_imu is not None:
            acc = first_imu.acc.numpy()[first_imu.mask.numpy()]
        else:
            acc = provider.imu_sync.acc[:50]
        g_body = acc.mean(0)
        g_body = g_body / np.linalg.norm(g_body)
        g_world = -np.asarray(self.params.imu.n_gravity)
        g_world = g_world / np.linalg.norm(g_world)
        v = np.cross(g_body, g_world)
        c = float(np.dot(g_body, g_world))
        s = np.linalg.norm(v)
        if s < 1e-8:
            R = torch.eye(3)
        else:
            R = geo.so3_exp(torch.as_tensor((v / s) * np.arctan2(s, c), dtype=torch.float32))
        z = torch.zeros(3, device=dev)
        return NavState(rot=R.to(dev), pos=z, vel=z.clone()), torch.zeros(6, device=dev)

    @staticmethod
    def _np_rot_to_quat(R):
        """Host rotation -> quaternion (wxyz), as the reference records."""
        R = np.asarray(R, np.float64)
        t = np.trace(R)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                          (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
        else:
            i = int(np.argmax(np.diag(R)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
            q = np.empty(4)
            q[0] = (R[k, j] - R[j, k]) / s
            q[1 + i] = 0.25 * s
            q[1 + j] = (R[j, i] + R[i, j]) / s
            q[1 + k] = (R[k, i] + R[i, k]) / s
        return (q / np.linalg.norm(q)).astype(np.float32)

    def _record(self, out: PipelineOutput, stamp_ns: int, rot, pos, vel, bias, logger):
        rot, pos, vel, bias = (t.cpu().numpy() for t in (rot, pos, vel, bias))
        quat = self._np_rot_to_quat(rot)
        out.stamps_ns.append(stamp_ns)
        out.positions.append(pos)
        out.quats_wxyz.append(quat)
        out.velocities.append(vel)
        out.biases.append(bias)
        if logger:
            logger.log_state(stamp_ns, pos, quat, vel, bias[3:6], bias[0:3])

    # ------------------------------------------------------------------
    def _step(self, fe_state, win, lmk, left, right, imu_block, stamp_s):
        """One frame: frontend, then on keyframes the backend and the bias
        feedback."""
        fe_state, fe_out = self.frontend.process_frame(fe_state, left, right, imu_block, stamp_s)
        if not fe_out["is_keyframe"]:
            return fe_state, win, lmk, fe_out, None
        meas = fe_out["measurements"]
        win, lmk, bout = sm.backend_step(
            self.backend_cfg, win, lmk, pim=fe_out["pim"], stamp=stamp_s,
            meas_ids=meas.ids, meas_uvd=meas.uvs, meas_mask=meas.mask,
            status=fe_out["status"],
        )
        new_bias = ImuBias(accel=bout["bias"][0:3], gyro=bout["bias"][3:6])
        fe_state = replace(fe_state, imu_bias=new_bias, pim=imu.Pim.zero(new_bias))
        return fe_state, win, lmk, fe_out, bout

    def run(self, provider, verbose: bool = False) -> PipelineOutput:
        """Run the whole provider sequence; returns the keyframe trajectory."""
        dev = self.device
        out = PipelineOutput()
        K = self.backend_cfg.nr_states
        L = self.backend_cfg.max_landmarks
        win = sm.Window.empty(K, dev)
        lmk = sm.LandmarkTable.empty(L, K, dev)
        fe_state = None
        t0_ns = None
        logger = BackendLogger(self.output_path) if self.output_path else None
        fe_logger = FrontendLogger(self.output_path) if self.output_path else None
        try:
            for packet in provider.frames():
                stamp_ns = packet["stamp_ns"]
                if t0_ns is None:
                    t0_ns = stamp_ns
                stamp_s = (stamp_ns - t0_ns) * 1e-9
                if fe_state is not None:
                    d = self._rebase_delta_s(stamp_s)
                    if d > 0.0:
                        t0_ns += int(round(d * 1e9))
                        stamp_s = (stamp_ns - t0_ns) * 1e-9
                        win = replace(win, stamp=win.stamp - np.float32(d))
                        fe_state = replace(
                            fe_state, lkf_stamp=float(np.float32(fe_state.lkf_stamp) - np.float32(d)))
                left = torch.from_numpy(np.asarray(provider.load_image(packet["left_path"]))).to(dev)
                right = torch.from_numpy(np.asarray(provider.load_image(packet["right_path"]))).to(dev)

                if fe_state is None:
                    tic = time.perf_counter()
                    fe_state, meas0 = self.frontend.init_state(left, right, stamp_s)
                    nav0, bias0 = self._bootstrap_state(provider, stamp_ns, packet["imu"])
                    fe_state = replace(fe_state, imu_bias=ImuBias(accel=bias0[0:3], gyro=bias0[3:6]))
                    win = sm.bootstrap(self.backend_cfg, win, nav0, bias0, stamp_s)
                    lmk = sm.update_landmarks(lmk, meas0.ids, meas0.uvs, meas0.mask, 0)
                    self._record(out, stamp_ns, win.rot[0], win.pos[0], win.vel[0], win.bias[0], logger)
                    out.n_keyframes += 1
                    out.n_frames += 1
                    self.stats.add("bootstrap [ms]", (time.perf_counter() - tic) * 1e3)
                    continue
                if packet["imu"] is None:
                    continue
                imu_block = tree_map(lambda t: t.to(dev), packet["imu"])

                tic = time.perf_counter()
                fe_state, win, lmk, fe_out, bout = self._step(
                    fe_state, win, lmk, left, right, imu_block, stamp_s)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                step_ms = (time.perf_counter() - tic) * 1e3
                self.stats.add("vio_step [ms]", step_ms)
                self.stats.add(
                    "VioFrontend Keyframe Rate [ms]" if bout is not None
                    else "VioFrontend Frame Rate [ms]", step_ms)
                out.n_frames += 1
                if fe_logger:
                    fe_logger.log(stamp_ns, bout is not None, fe_out["n_tracked"],
                                  fe_out["median_disparity"], fe_out["n_mono_inliers"],
                                  fe_out["n_stereo_inliers"], 0.0)
                if bout is not None:
                    out.n_keyframes += 1
                    self._record(out, stamp_ns, bout["rot"], bout["pos"], bout["vel"],
                                 bout["bias"], logger)
                    if bout["n_recovered"] > 0:
                        self.stats.add("backend_recoveries [#]", float(bout["n_recovered"]))
                    if logger:
                        logger.log_timing(stamp_ns, 0.0)
                if verbose and out.n_frames % 50 == 0:
                    print(f"frame {out.n_frames} pos {out.positions[-1]}")
        finally:
            if logger:
                logger.close()
            if fe_logger:
                fe_logger.close()
        self._last_win, self._last_lmk = win, lmk
        if self.output_path:
            plog = PipelineLogger(self.output_path)
            wall = self.stats.get("vio_step [ms]").total / 1e3
            plog.log(out.n_frames, max(wall, 1e-9), out.n_keyframes)
            plog.close()
        if verbose:
            print(self.stats.print_table())
        return out
