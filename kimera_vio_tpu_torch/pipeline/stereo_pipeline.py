"""StereoImuPipeline: data provider -> frontend -> backend.

Port of kimera_vio_tpu/pipeline/stereo_pipeline.py (the reference
StereoImuPipeline, src/pipeline/StereoImuPipeline.cpp:39-254): per frame
the frontend tracks; on keyframes the backend solves and its IMU bias is
fed back to the frontend (imu_bias_update_callback). Bootstrap from
ground truth (autoInitialize: 0) or IMU attitude. Outputs the keyframe
trajectory and, with an output path, the reference's CSV logs
(traj_vio.csv, ...).

Both entry points drive one loop (`_drive`) over a frame source; they
differ only in where the frames come from and when the keyframe states
are read back:

  * `run()`: frame by frame. Sequential (`parallel_run=False`) it
    synchronizes the card after every frame and records the frame and
    keyframe step times; parallel (the params default) it decodes images
    on a worker thread four frames ahead and does not synchronize.
  * `run_chunked()`: the offline mode. A stager thread decodes super-
    batches of frames and their IMU blocks, packs them into one pinned
    buffer and copies it to the card on a side stream; the frames are
    then stepped on the card one by one and the keyframe states read back
    once at the end. Same trajectory as `run()`.

Both stop when the backend needed its recovery path on
`max_consecutive_backend_failures` keyframes in a row (config/flags.py;
reference Pipeline.cpp:253-269).

Loop closure (`enable_lcd` or the `use_lcd` flag; reference LcdModule):
the keyframe branch extracts the LCD features on the device; each
keyframe's features and pose are packed into one int32 row there and
read back behind the frame loop — `run()` one keyframe at a time, 8
frames late; `run_chunked(collect_aux=True)` one transfer per chunk, a
chunk late — into the host `LcdModule`, which detects and verifies
loops. At the end it runs PCM (+ GNC) pose-graph optimization:
`lcd_result`, and with an output path traj_pgo.csv and
output_lcd_result.csv.

Not ported yet: the mesher, visualizer, time alignment, online
initialization and external odometry; the constructor refuses
configurations that need them. `run_chunked` stages raw frames only (the
JAX package's KIMERA_STAGE_CODEC codecs are not ported).
"""

from __future__ import annotations

import logging
import math
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.backend import smoother as sm
from kimera_vio_tpu_torch.common import geometry as geo
from kimera_vio_tpu_torch.common.types import ImuBias, ImuBlock, NavState, replace, tree_map
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.config.params import VioParams
from kimera_vio_tpu_torch.frontend import imu_frontend as imu
from kimera_vio_tpu_torch.frontend.camera import StereoCamera
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendConfig, StereoFrontend
from kimera_vio_tpu_torch.pipeline.lcd_module import LcdModule
from kimera_vio_tpu_torch.utils.logger import BackendLogger, FrontendLogger, LcdLogger, PipelineLogger
from kimera_vio_tpu_torch.utils.prefetch import PrefetchIterator
from kimera_vio_tpu_torch.utils.stats import StatsCollector


class Staged(NamedTuple):
    """One staged super-batch of `run_chunked`: frames then IMU blocks in
    one buffer."""

    shape: tuple  # frames (F, 2, H, W)
    aux_shape: tuple  # IMU blocks (F, B*8): acc, gyr, dt, mask
    aux_offset: int  # byte offset of the IMU blocks (16-byte aligned)
    dtype: torch.dtype  # of the frames
    buf: torch.Tensor  # the buffer on the pipeline's device
    host: torch.Tensor  # its host copy (pinned on CUDA)
    copy: tuple | None  # CUDA events (start, done) around the copy
    encode_ms: float  # decode + pack on the stager thread


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
        "visualize": bool(flags.get_flag("visualize")),
        "do_fine_imu_camera_temporal_sync": bool(flags.get_flag("do_fine_imu_camera_temporal_sync")),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


#: frames between a keyframe and the feed of its LCD row in `run()`
AUX_LAG = 8


class StereoImuPipeline:
    """End-to-end stereo-inertial VIO on one device (CUDA by default)."""

    def __init__(self, params: VioParams, output_path: str | None = None,
                 parallel_run: bool | None = None, device: str | torch.device = "cuda",
                 enable_lcd: bool = False):
        _check_supported(params)
        self.device = resolve_device(device)
        self.params = params
        self.parallel_run = params.pipeline.parallel_run if parallel_run is None else parallel_run
        self.enable_lcd = enable_lcd or bool(flags.get_flag("use_lcd"))
        if output_path is None and flags.get_flag("log_output"):
            output_path = flags.get_flag("output_path")
        dev = self.device
        self.stereo = StereoCamera.from_params(params.left_cam, params.right_cam, dev)
        self.frontend_cfg = FrontendConfig.from_params(params.frontend, max_features=params.max_features)
        if self.enable_lcd:
            # The keyframe branch extracts the LCD features with LcdParams'
            # budget and spacing, LcdModule's own, in the runs that feed
            # the LCD (`_drive` turns it off for the others).
            self.frontend_cfg.lcd_features = int(params.lcd.nfeatures or 256)
            self.frontend_cfg.lcd_min_distance = float(params.lcd.min_distance or 12.0)
        self._lcd_features = self.frontend_cfg.lcd_features
        self.lcd_result = None
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
        self._n_rebases = 0
        self.output_path = output_path
        self.stats = StatsCollector()
        # Module-failure propagation state (reference is_backend_ok_).
        self.backend_healthy = True
        self._consecutive_recoveries = 0

    def _build_lcd(self):
        """LcdModule with the packaged vocabulary, LcdParams from the YAML
        tier, the pipeline's statistics, and its disk frame cache under
        the output path when logging."""
        cache_dir = os.path.join(self.output_path, "lcd_cache") if self.output_path else None
        return LcdModule(self.stereo, lcd_params=self.params.lcd, cache_dir=cache_dir,
                         device=self.device, stats=self.stats)

    def _pack_lcd_row(self, bout, fe_out) -> torch.Tensor:
        """One keyframe's LCD input as one int32 row on the device: pose
        (rot, pos), uv, versors, pts3 as float32 bits, then ok and the
        descriptor words."""
        f = torch.cat([bout["rot"].reshape(-1), bout["pos"], fe_out["lcd_uv"].reshape(-1),
                       fe_out["lcd_versors"].reshape(-1), fe_out["lcd_pts3"].reshape(-1)])
        return torch.cat([f.view(torch.int32), fe_out["lcd_ok"].to(torch.int32),
                          fe_out["lcd_desc"].reshape(-1)])

    def _unpack_lcd_rows(self, rows: np.ndarray) -> list:
        """Host inverse of `_pack_lcd_row` for (n, P) rows: per row the
        keyword arguments of `LcdModule.add_keyframe_packed` but the stamp."""
        M = self.frontend_cfg.lcd_features
        f = rows[:, :12 + 8 * M].view(np.float32)
        i = rows[:, 12 + 8 * M:]
        return [dict(pose_R=f[k, 0:9].reshape(3, 3), pose_t=f[k, 9:12],
                     uv=f[k, 12:12 + 2 * M].reshape(M, 2),
                     versors=f[k, 12 + 2 * M:12 + 5 * M].reshape(M, 3),
                     pts3=f[k, 12 + 5 * M:12 + 8 * M].reshape(M, 3),
                     ok=i[k, :M] > 0, desc=i[k, M:].reshape(M, 8).view(np.uint32))
                for k in range(rows.shape[0])]

    def _drain_lcd(self, lcd_module, pending: list, upto: int) -> list:
        """Feed the pending keyframes (frame number, stamp, row) of frames
        up to `upto` to the LCD, their rows read back in one transfer;
        returns the keyframes still pending."""
        n = 0
        while n < len(pending) and pending[n][0] <= upto:
            n += 1
        if n:
            rows = torch.stack([row for _, _, row in pending[:n]]).cpu().numpy()
            for (_, stamp_ns, _), fields in zip(pending[:n], self._unpack_lcd_rows(rows)):
                lcd_module.add_keyframe_packed(stamp_ns=stamp_ns, **fields)
        return pending[n:]

    # ------------------------------------------------------------------
    def _rebase_delta_s(self, rel_s: float) -> float:
        if rel_s < self._rebase_margin_s + self._rebase_interval_s:
            return 0.0
        return self._rebase_interval_s * math.floor(
            (rel_s - self._rebase_margin_s) / self._rebase_interval_s)

    def _apply_rebase(self, delta_s: float, win, fe_state):
        """Shift every stamp of the state by -delta_s (the window's keyframe
        stamps and the frontend's last-keyframe stamp; both are only used
        as differences, so the shift leaves the output unchanged)."""
        win = replace(win, stamp=win.stamp - np.float32(delta_s))
        fe_state = replace(
            fe_state, lkf_stamp=float(np.float32(fe_state.lkf_stamp) - np.float32(delta_s)))
        self._n_rebases += 1
        return win, fe_state

    def _note_backend_health(self, n_recovered: int):
        """Module-failure propagation (reference Pipeline.cpp:253-269 /
        is_backend_ok_): count consecutive keyframe solves that needed the
        recovery path; past `max_consecutive_backend_failures` mark the
        backend unhealthy, so the run loop stops instead of publishing a
        sick estimate."""
        if n_recovered > 0:
            self._consecutive_recoveries += 1
            self.stats.add("backend_recoveries [#]", float(n_recovered))
        else:
            self._consecutive_recoveries = 0
        limit = flags.get_flag("max_consecutive_backend_failures")
        if limit > 0 and self._consecutive_recoveries >= limit:
            if self.backend_healthy:
                logging.getLogger(__name__).error(
                    "Backend needed solver recovery on %d consecutive keyframes - "
                    "stopping pipeline", self._consecutive_recoveries)
            self.backend_healthy = False

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

    @staticmethod
    def _host_rows(keyframes: list) -> np.ndarray:
        """Keyframes, each (stamp_ns, its state row [rot (9), pos, vel,
        bias] on the device) -> their rows on the host, in one transfer."""
        return torch.stack([row for _, row in keyframes]).cpu().numpy()

    def _publish(self, out: PipelineOutput, keyframes: list, rows, logger):
        """Append keyframes and their host rows to the output and the
        trajectory log."""
        for (stamp_ns, _), row in zip(keyframes, rows):
            pos, vel, bias = row[9:12], row[12:15], row[15:21]
            quat = self._np_rot_to_quat(row[0:9].reshape(3, 3))
            out.stamps_ns.append(stamp_ns)
            out.positions.append(pos)
            out.quats_wxyz.append(quat)
            out.velocities.append(vel)
            out.biases.append(bias)
            if logger:
                logger.log_state(stamp_ns, pos, quat, vel, bias[3:6], bias[0:3])
                if len(out.stamps_ns) > 1:  # every keyframe after the bootstrap
                    logger.log_timing(stamp_ns, 0.0)

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

    def _bootstrap(self, provider, packet, left, right, stamp_s):
        """First frame: frontend state, window and landmark table from
        ground truth or the IMU. Returns (fe_state, win, lmk)."""
        K, L = self.backend_cfg.nr_states, self.backend_cfg.max_landmarks
        fe_state, meas0 = self.frontend.init_state(left, right, stamp_s)
        nav0, bias0 = self._bootstrap_state(provider, packet["stamp_ns"], packet["imu"])
        fe_state = replace(fe_state, imu_bias=ImuBias(accel=bias0[0:3], gyro=bias0[3:6]))
        win = sm.bootstrap(self.backend_cfg, sm.Window.empty(K, self.device), nav0, bias0, stamp_s)
        lmk = sm.update_landmarks(sm.LandmarkTable.empty(L, K, self.device),
                                  meas0.ids, meas0.uvs, meas0.mask, 0)
        return fe_state, win, lmk

    def _open_loggers(self, provider):
        if not self.output_path:
            return None, None
        self._gt_to_log = (provider.ground_truth if flags.get_flag("log_euroc_gt_data")
                           else None)
        return BackendLogger(self.output_path), FrontendLogger(self.output_path)

    def _write_final_logs(self, out: PipelineOutput):
        """Overall pipeline row; the PGO trajectory and the loops when loop
        closure ran (reference LoopClosureDetectorLogger); traj_gt.csv
        behind log_euroc_gt_data (reference EurocGtLogger, Logger.cpp:66-85)."""
        if not self.output_path:
            return
        if self.lcd_result:
            lcd_log = LcdLogger(self.output_path)
            lcd_log.log_pgo_trajectory(self.lcd_result["stamps"], self.lcd_result["rot"],
                                       self.lcd_result["pos"])
            for lp in self.lcd_result["loops"]:
                lcd_log.log_loop(lp.query_id, lp.match_id)
            lcd_log.close()
        plog = PipelineLogger(self.output_path)
        steps = "vio_step [ms]"
        wall = self.stats.get(steps).total / 1e3 if steps in self.stats.tags() else 0.0
        plog.log(out.n_frames, max(wall, 1e-9), out.n_keyframes)
        plog.close()
        gt = getattr(self, "_gt_to_log", None)
        if gt is not None:
            with open(os.path.join(self.output_path, "traj_gt.csv"), "w") as f:
                f.write(BackendLogger.HEADER + "\n")
                for i in range(len(gt.stamps_ns)):
                    row = [int(gt.stamps_ns[i]), *gt.positions[i], *gt.quats_wxyz[i],
                           *gt.velocities[i], *gt.gyro_bias[i], *gt.accel_bias[i]]
                    f.write(",".join(f"{x:.9g}" if j else str(x) for j, x in enumerate(row)) + "\n")

    def _drive(self, provider, frames, verbose: bool, sync_each: bool = False,
               defer_readback: bool = False, lcd_drain: tuple | None = None) -> PipelineOutput:
        """The run loop of both entry points. `frames` yields (packet,
        left, right, imu_block, origin_ns): images and IMU block on the
        device (no IMU block for the first frame, which bootstraps) and
        the float32 time origin, which advances by whole rebase intervals.
        `sync_each` blocks on the card after every frame and records the
        frame and keyframe step times; `defer_readback` reads the keyframe
        states back once at the end instead of at each keyframe.

        With loop closure and `lcd_drain = (every, lag)`, every keyframe
        after the bootstrap leaves its LCD row on the device; every
        `every` frames the rows of keyframes at least `lag` frames old are
        read back in one transfer and fed to the LCD; PGO runs at the end."""
        out = PipelineOutput()
        self.backend_healthy = True
        self._consecutive_recoveries = 0
        self.lcd_result = None
        fe_state = win = lmk = None
        keyframes = []  # (stamp_ns, state row) not yet published
        lcd_module = self._build_lcd() if self.enable_lcd and lcd_drain else None
        self.frontend_cfg.lcd_features = self._lcd_features if lcd_module is not None else 0
        lcd_pending = []  # (frame number, stamp_ns, LCD row) not yet fed
        logger, fe_logger = self._open_loggers(provider)
        try:
            for packet, left, right, imu_block, origin_ns in frames:
                stamp_ns = packet["stamp_ns"]
                if fe_state is None:
                    tic = time.perf_counter()
                    fe_state, win, lmk = self._bootstrap(provider, packet, left, right, 0.0)
                    keyframes.append((stamp_ns, torch.cat(
                        [win.rot[0].reshape(-1), win.pos[0], win.vel[0], win.bias[0]])))
                    out.n_keyframes += 1
                    out.n_frames += 1
                    self.stats.add("bootstrap [ms]", (time.perf_counter() - tic) * 1e3)
                    applied_ns = origin_ns
                else:
                    if origin_ns != applied_ns:
                        win, fe_state = self._apply_rebase(
                            (origin_ns - applied_ns) * 1e-9, win, fe_state)
                        applied_ns = origin_ns
                    stamp_s = (stamp_ns - origin_ns) * 1e-9

                    tic = time.perf_counter()
                    fe_state, win, lmk, fe_out, bout = self._step(
                        fe_state, win, lmk, left, right, imu_block, stamp_s)
                    if sync_each and self.device.type == "cuda":
                        # Sequential mode: block every frame (reference
                        # parallel_run=0, Pipeline.cpp:197-215).
                        torch.cuda.synchronize(self.device)
                    step_ms = (time.perf_counter() - tic) * 1e3
                    self.stats.add("vio_step [ms]", step_ms)
                    if sync_each:
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
                        keyframes.append((stamp_ns, torch.cat(
                            [bout["rot"].reshape(-1), bout["pos"], bout["vel"], bout["bias"]])))
                        self._note_backend_health(int(bout["n_recovered"]))
                        if lcd_module is not None:
                            lcd_pending.append((out.n_frames, stamp_ns, self._pack_lcd_row(bout, fe_out)))
                    if lcd_module is not None and (out.n_frames - 1) % lcd_drain[0] == 0:
                        lcd_pending = self._drain_lcd(lcd_module, lcd_pending,
                                                      out.n_frames - lcd_drain[1])
                if not defer_readback and keyframes:
                    self._publish(out, keyframes, self._host_rows(keyframes), logger)
                    keyframes = []
                if verbose and out.n_frames % 50 == 0:
                    print(f"frame {out.n_frames} keyframes {out.n_keyframes}")
                if not self.backend_healthy:
                    break  # graceful stop on persistent backend failure
            if keyframes:
                tic = time.perf_counter()
                rows = self._host_rows(keyframes)
                self.stats.add("readback [ms]", (time.perf_counter() - tic) * 1e3)
                self._publish(out, keyframes, rows, logger)
            if lcd_module is not None:
                self._drain_lcd(lcd_module, lcd_pending, out.n_frames)
                self.lcd_result = lcd_module.finish()
        finally:
            frames.close()  # ends a prefetch or stager thread
            if logger:
                logger.close()
            if fe_logger:
                fe_logger.close()
        self._last_win, self._last_lmk = win, lmk
        self._write_final_logs(out)
        if verbose:
            print(self.stats.print_table())
        return out

    def _direct_frames(self, provider):
        """run()'s frame source: each packet's images decoded (on a worker
        thread four frames ahead in parallel mode) and uploaded on this
        thread with its IMU block; frames without IMU data are skipped
        after the first."""
        def load(packet):
            left = provider.load_image(packet["left_path"])
            right = provider.load_image(packet["right_path"]) if "right_path" in packet else left
            return packet, left, right

        dev = self.device
        if self.parallel_run:
            # Data-provider thread (reference Pipeline.cpp:318).
            stream = PrefetchIterator(provider.frames(), load, depth=4)
        else:
            stream = map(load, provider.frames())
        origin_ns = None
        try:
            for packet, left, right in stream:
                stamp_ns = packet["stamp_ns"]
                first = origin_ns is None
                if first:
                    origin_ns = stamp_ns
                origin_ns += int(round(self._rebase_delta_s((stamp_ns - origin_ns) * 1e-9) * 1e9))
                if not first and packet["imu"] is None:
                    continue
                yield (packet, torch.from_numpy(np.asarray(left)).to(dev),
                       torch.from_numpy(np.asarray(right)).to(dev),
                       None if first else tree_map(lambda t: t.to(dev), packet["imu"]), origin_ns)
        finally:
            if isinstance(stream, PrefetchIterator):
                stream.close()

    def run(self, provider, verbose: bool = False) -> PipelineOutput:
        """Run the whole provider sequence; returns the keyframe trajectory."""
        return self._drive(provider, self._direct_frames(provider), verbose,
                           sync_each=not self.parallel_run, lcd_drain=(1, AUX_LAG))

    # ------------------------------------------------------------------
    def _stage(self, provider, batch, side_stream) -> Staged:
        """Stager thread: decode one super-batch, pack its frames and IMU
        blocks into one host buffer and start its copy to the device.

        The IMU rows are the JAX package's aux layout without its last
        column, the rebased stamp: the step takes the stamp from the
        packet on the host, so the card never reads it."""
        tic = time.perf_counter()
        F = len(batch)
        left_imgs = [provider.load_image(p["left_path"]) for p in batch]
        right_imgs = ([provider.load_image(p["right_path"]) for p in batch]
                      if "right_path" in batch[0] else left_imgs)
        H, W = left_imgs[0].shape[:2]
        shape = (F, 2, H, W)
        dtype = left_imgs[0].dtype
        B = batch[0]["imu"].acc.shape[0]
        # Frames (uint8, or float32 from the synthetic provider), then the
        # IMU rows at a 16-byte aligned offset.
        n_img = F * 2 * H * W * dtype.itemsize
        offset = -(-n_img // 16) * 16
        host = torch.empty(offset + F * B * 8 * 4, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        buf = host.numpy()
        frames = buf[:n_img].view(dtype).reshape(shape)
        aux = buf[offset:].view(np.float32).reshape(F, B * 8)
        for i, p in enumerate(batch):
            frames[i, 0] = left_imgs[i]
            frames[i, 1] = right_imgs[i]
            blk = p["imu"]
            aux[i, :B * 3] = blk.acc.numpy().ravel()
            aux[i, B * 3:B * 6] = blk.gyr.numpy().ravel()
            aux[i, B * 6:B * 7] = blk.dt.numpy()
            aux[i, B * 7:] = blk.mask.numpy()
        staged = Staged(shape, aux.shape, offset, torch.from_numpy(frames[:0]).dtype,
                        host, host, None, (time.perf_counter() - tic) * 1e3)
        if side_stream is None:
            return staged
        # One copy per super-batch on the side stream; events bracket it so
        # the consumer can wait on it and read its time.
        start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side_stream):
            start.record(side_stream)
            dev_buf = host.to(self.device, non_blocking=True)
            done.record(side_stream)
        return staged._replace(buf=dev_buf, copy=(start, done))

    def _materialize(self, staged: Staged):
        """A staged super-batch -> (frames (F, 2, H, W), IMU rows (F, B*8)
        float32) on the device, once its copy has arrived."""
        self.stats.add("stage encode [ms]", staged.encode_ms)
        self.stats.add("stage wire [MB]", staged.host.numel() / 1e6)
        buf = staged.buf
        if staged.copy is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staged.copy[1])
            buf.record_stream(cur)  # allocated on the side stream, used here
        n_img = int(np.prod(staged.shape)) * staged.dtype.itemsize
        return (buf[:n_img].view(staged.dtype).view(staged.shape),
                buf[staged.aux_offset:].view(torch.float32).view(staged.aux_shape))

    def _release(self, staged: Staged):
        """After a super-batch's frames: make sure its copy has completed
        (it has, since the frames used it) before the pinned buffer can
        go, and record the copy's time."""
        if staged.copy is None:
            return
        start, done = staged.copy
        done.synchronize()
        ms = start.elapsed_time(done)
        self.stats.add("stage h2d [ms]", ms)
        if ms > 0:
            self.stats.add("stage h2d [MB/s]", staged.host.numel() / 1e6 / (ms * 1e-3))

    def _staged_frames(self, provider, chunk_size: int, super_batch_bytes: int):
        """run_chunked()'s frame source: the first frame loaded directly,
        the rest in super-batches of whole chunks staged by a background
        thread, each with the rebase origin of its first frame."""
        dev = self.device
        packets = list(provider.frames())
        if not packets:
            return
        first = packets[0]
        t0_ns = first["stamp_ns"]
        rest = [p for p in packets[1:] if p.get("imu") is not None]
        C = chunk_size
        super_frames = C
        if rest:
            frame_bytes = 2 * provider.load_image(rest[0]["left_path"]).nbytes
            super_frames = max(C, super_batch_bytes // frame_bytes // C * C)
        supers = [rest[i:i + super_frames] for i in range(0, len(rest), super_frames)]
        # Rebase origin per super-batch, a function of the stamps alone.
        origins_ns, shift_s = [], 0.0
        for batch in supers:
            shift_s += self._rebase_delta_s((batch[0]["stamp_ns"] - t0_ns) * 1e-9 - shift_s)
            origins_ns.append(t0_ns + int(round(shift_s * 1e9)))

        side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        staged = PrefetchIterator(supers, lambda batch: self._stage(provider, batch, side), depth=2)
        try:
            left = torch.from_numpy(provider.load_image(first["left_path"])).to(dev)
            right = (torch.from_numpy(provider.load_image(first["right_path"])).to(dev)
                     if "right_path" in first else left)
            yield first, left, right, None, t0_ns
            for batch, origin_ns in zip(supers, origins_ns):
                tic = time.perf_counter()
                staged_j = next(staged)
                self.stats.add("dispatch wait-for-stage [ms]", (time.perf_counter() - tic) * 1e3)
                imgs, aux = self._materialize(staged_j)
                B = aux.shape[1] // 8
                for i, p in enumerate(batch):
                    a = aux[i]
                    blk = ImuBlock(acc=a[:B * 3].view(B, 3), gyr=a[B * 3:B * 6].view(B, 3),
                                   dt=a[B * 6:B * 7], mask=a[B * 7:] > 0.5)
                    yield p, imgs[i, 0], imgs[i, 1], blk, origin_ns
                self._release(staged_j)
        finally:
            staged.close()
            if side is not None:
                side.synchronize()  # no pinned buffer goes while its copy runs

    def run_chunked(self, provider, chunk_size: int = 16, verbose: bool = False,
                    collect_aux: bool = False,
                    super_batch_bytes: int = 32 * 1024 * 1024) -> PipelineOutput:
        """Offline mode: stage the sequence in super-batches of whole
        chunks of `chunk_size` frames (at most `super_batch_bytes` of
        frames, at least one chunk), one host-to-device copy each, on a
        background thread; step each frame on the device; read the
        keyframe states back once at the end.

        Stamps enter the step as `run()` gives them, so the trajectory is
        `run()`'s. `collect_aux=True` drives loop closure when it is on,
        its rows read back once per chunk (without it the LCD does not
        run, as in the JAX package). Refused, as in the JAX package: fine
        time alignment, online initialization, external odometry."""
        if self.enable_lcd and not collect_aux:
            warnings.warn("loop closure enabled but collect_aux=False: the LCD will not run "
                          "in chunked mode", stacklevel=2)
        if flags.get_flag("do_fine_imu_camera_temporal_sync"):
            raise NotImplementedError("run_chunked does not support fine IMU-camera time alignment")
        if self.params.backend.auto_initialize == 2:
            raise NotImplementedError("run_chunked does not support online initialization")
        if getattr(provider, "odometry", None) is not None:
            raise NotImplementedError("run_chunked does not support external odometry")
        return self._drive(provider, self._staged_frames(provider, chunk_size, super_batch_bytes),
                           verbose, defer_readback=True,
                           lcd_drain=(chunk_size, chunk_size) if collect_aux else None)
