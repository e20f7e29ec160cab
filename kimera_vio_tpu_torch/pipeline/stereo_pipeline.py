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

Pose sources and extra factors (BackendParams): `pose_guess_source`
IMU (0), MONO (1), STEREO (2) or PnP (3, against the backend's landmark
map); `addBetweenStereoFactors`; and
external odometry from a provider that carries an `OdometryBuffer` as
`.odometry` (EXT_ODOM). Initialization (`autoInitialize`): 0 from ground
truth, 1 from the IMU attitude, 2 online — a crude IMU bootstrap, then a
window of keyframes whose stereo-RANSAC poses and PIMs solve the
visual-inertial alignment (initial/initializer.py), then a re-bootstrap
at the aligned state; nothing is published before. With
`do_fine_imu_camera_temporal_sync` the 3-pt stereo solver's rotations
feed a cross-correlation time aligner (initial/time_alignment.py) until
it finds the IMU-camera offset; the estimator then restarts
(`time_shift_estimate_s`). Both read one keyframe's pose on the host per
keyframe while they collect, and never after. MonoImuPipeline and
RgbdImuPipeline (pipeline/mono_pipeline.py, rgbd_pipeline.py) swap the
rig and the frontend mode.

The mesher and RegularVIO (`enable_mesher`; reference Mesher and
RegularVioBackend): each keyframe's keypoints, pose and landmark map are
packed into one int32 row on the device and read back behind the frame
loop like the LCD's, into the host mesher (mesher/mesher.py: Delaunay,
triangle filter, the time-horizon mesh, one PLY per keyframe under
`<output>/mesh/`), optionally refined against a dense depth image (the
RGB-D sensor's, or dense stereo behind `use_dense_depth_mesh_refinement`).
With `backend_type: 1` the mesh's planes are segmented, associated with
persistent plane slots (mesher/plane_tracker.py) and a joint solve over
window and planes (backend/regular_vio.py) refines the live window, which
replaces the carry. Lags as in the JAX package: `run()` feeds a keyframe
8 frames late against the window of that moment; `run_chunked(
collect_aux=True)` feeds a chunk's keyframes right after the chunk when
RegularVIO refines, else a chunk late (the mesh does not depend on when).
The published keyframe states are those of the keyframe steps, before any
refine.

Debug overlays and the visualizer ride the same per-keyframe readback.
With the `log_frontend_images` flag each keyframe after the bootstrap
writes `<output>/frontend_images/<stamp_ns>.png`: its rectified left
image with the keypoints drawn by class (utils/debug_images.py; tracked
since the previous keyframe, new, dead), in `run()` and in
`run_chunked(collect_aux=True)`. With `enable_visualizer` or the
`visualize` flag, `run()` (only, as in the JAX package) feeds each
keyframe's pose, landmarks and mesh to `Visualizer3D` and the display of
`make_display` (visualizer/visualizer.py), which writes under
`<output>/viz/` (`output_path` or the flag's, where the JAX package falls
back to /tmp/viz_out); `visualize_mesh_2d` adds the mesher's image-plane
mesh over the keyframe's left image. Both write behind the frame loop,
as the mesher reads its rows.

`run_chunked` stages each super-batch in the codec that
`KIMERA_STAGE_CODEC` names when it is called (ops/frame_codec.py): `raw`
(the port's default), `delta4`, `delta4c` or `delta3`; any other value
stages delta4, and a batch a codec declines goes down the JAX package's
chain (delta4c -> delta4 -> raw, delta3 -> delta4 -> raw). The codecs
are lossless, so the trajectory does not depend on the choice.
"""

from __future__ import annotations

import logging
import math
import os
import warnings
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.backend import regular_vio as rv
from kimera_vio_tpu_torch.backend import smoother as sm
from kimera_vio_tpu_torch.common import geometry as geo
from kimera_vio_tpu_torch.common.types import ImuBias, ImuBlock, NavState, replace, tree_map
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.config.params import VioParams
from kimera_vio_tpu_torch.frontend import imu_frontend as imu
from kimera_vio_tpu_torch.frontend.camera import StereoCamera, rectification_map, remap_bilinear
from kimera_vio_tpu_torch.frontend.vision_frontend import (
    LK_IMPLS,
    FrontendConfig,
    StereoFrontend,
)
from kimera_vio_tpu_torch.initial.initializer import OnlineInitializer
from kimera_vio_tpu_torch.initial.time_alignment import CrossCorrTimeAligner
from kimera_vio_tpu_torch.mesher import mesher as mm
from kimera_vio_tpu_torch.mesher.mesh_optimization import optimize_mesh
from kimera_vio_tpu_torch.mesher.plane_tracker import PlaneTracker
from kimera_vio_tpu_torch.ops import frame_codec as fc
from kimera_vio_tpu_torch.ops import ransac
from kimera_vio_tpu_torch.ops.stereo_matching import dense_depth
from kimera_vio_tpu_torch.pipeline.lcd_module import LcdModule
from kimera_vio_tpu_torch.utils.logger import (BackendLogger, FrontendLogger, LcdLogger, MesherLogger,
                                               PipelineLogger)
from kimera_vio_tpu_torch.utils.debug_images import save_feature_track_overlay
from kimera_vio_tpu_torch.utils.prefetch import PrefetchIterator
from kimera_vio_tpu_torch.utils.stats import Span, StatsCollector, span
from kimera_vio_tpu_torch.visualizer.visualizer import Visualizer3D, make_display


#: `KIMERA_STAGE_CODEC` wire factors: a codec's super-batch holds
#: super_batch_bytes of frames at factor[0] / factor[1] of their raw bytes
#: (the JAX package's sizing, so the rebase origins fall where it puts them).
_WIRE_FACTOR = {"raw": (1, 1), "delta3": (9, 20)}
_DELTA_FACTOR = (3, 5)


def super_batch_frames(codec: str, chunk_size: int, super_batch_bytes: int,
                       frame_bytes: int) -> int:
    """Frames in one of `run_chunked`'s super-batches: whole chunks of at
    most `super_batch_bytes` of frames at the codec's wire factor, at
    least one chunk."""
    num, den = _WIRE_FACTOR.get(codec, _DELTA_FACTOR)
    return max(chunk_size,
               super_batch_bytes // max(frame_bytes * num // den, 1) // chunk_size * chunk_size)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class Staged(NamedTuple):
    """One staged super-batch of `run_chunked`: its wire parts in one
    buffer, each at a 16-byte aligned offset. Parts by codec: raw
    `frames`, `aux`; delta4 `base`, `packed`, `esc_idx`, `esc_val`, `aux`;
    delta3 `base`, `t1`, `t2`, `t3`, `aux`; delta4c `wire` (the IMU rows
    ride in it)."""

    codec: str  # "raw", "delta4", "delta4c" or "delta3"
    shape: tuple  # frames (F, 2, H, W)
    dtype: torch.dtype  # of the frames
    aux_shape: tuple  # IMU blocks (F, B*8): acc, gyr, dt, mask
    parts: dict  # name -> (byte offset, numpy dtype, shape)
    n_tok: int  # delta4c: gap tokens on the wire (0 for the others)
    buf: torch.Tensor  # the buffer on the pipeline's device
    host: torch.Tensor  # its host copy (pinned on CUDA)
    copy: tuple | None  # CUDA events (start, done) around the copy
    encode_ms: float  # decode, encode and pack on the stager thread


@dataclass
class PipelineOutput:
    stamps_ns: list = field(default_factory=list)
    positions: list = field(default_factory=list)
    quats_wxyz: list = field(default_factory=list)
    velocities: list = field(default_factory=list)
    biases: list = field(default_factory=list)
    n_keyframes: int = 0
    n_frames: int = 0


class AuxKeyframe(NamedTuple):
    """A keyframe waiting for the aux modules: its rows and images stay on
    the device until `_drain_aux` reads them back."""

    frame: int  # frame number in the run
    stamp_ns: int
    lcd_row: torch.Tensor | None  # `_pack_lcd_row`, with loop closure
    kf_row: torch.Tensor | None  # `_pack_kf_row`, for mesher, overlays, visualizer
    left: torch.Tensor | None  # raw images where the mesher refines against depth
    right: torch.Tensor | None  # or (left only) the 2-D mesh is drawn
    left_rect: torch.Tensor | None  # rectified left, uint8, for the overlay


#: pose_guess_source values (BackendParams poseGuessSource)
GUESS_IMU, GUESS_MONO, GUESS_STEREO, GUESS_PNP = 0, 1, 2, 3


#: frames between a keyframe and the feed of its LCD and mesher rows in `run()`
AUX_LAG = 8

#: plane-pair slots of the RegularVIO solve (its parallel-plane rows)
N_PLANE_PAIRS = 4


class StereoImuPipeline:
    """End-to-end stereo-inertial VIO on one device (CUDA by default)."""

    def __init__(self, params: VioParams, output_path: str | None = None,
                 parallel_run: bool | None = None, device: str | torch.device = "cuda",
                 enable_lcd: bool = False, enable_mesher: bool = False,
                 enable_visualizer: bool = False):
        self.device = resolve_device(device)
        self.params = params
        self.parallel_run = params.pipeline.parallel_run if parallel_run is None else parallel_run
        self.enable_lcd = enable_lcd or bool(flags.get_flag("use_lcd"))
        self.enable_mesher = enable_mesher
        self.enable_visualizer = enable_visualizer or bool(flags.get_flag("visualize"))
        # backend_type 1 (RegularVIO, the EuRoC default) needs the mesher's
        # planes; without the mesher it is the plain backend, as in the
        # reference's shipped default (RegularVioBackend.h:83-87).
        self.use_regular_vio = params.pipeline.backend_type == 1 and enable_mesher
        self._mesher = None
        if output_path is None and flags.get_flag("log_output"):
            output_path = flags.get_flag("output_path")
        dev = self.device
        self.stereo = self._build_rig(params)
        self.frontend_cfg = self._build_frontend_cfg(params)
        # Fine IMU-camera time alignment needs rotations estimated by
        # vision: the 3-pt stereo solver instead of the gyro's.
        self._do_time_align = bool(flags.get_flag("do_fine_imu_camera_temporal_sync"))
        if self._do_time_align:
            self.frontend_cfg.use_1point_stereo = False
        self.time_shift_estimate_s = None
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
        if params.odometry is not None:
            # ExternalOdometryParams precisions -> between-factor sigmas.
            self.backend_cfg.ext_odom_rot_sigma = sm._f32(
                1.0 / np.sqrt(max(params.odometry.rotation_precision, 1e-12)), dev)
            self.backend_cfg.ext_odom_pos_sigma = sm._f32(
                1.0 / np.sqrt(max(params.odometry.position_precision, 1e-12)), dev)
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

    # Construction hooks (MonoImuPipeline and RgbdImuPipeline swap them).
    def _build_rig(self, params) -> StereoCamera:
        return StereoCamera.from_params(params.left_cam, params.right_cam, self.device)

    def _build_frontend_cfg(self, params) -> FrontendConfig:
        """The frontend configuration; KIMERA_LK_IMPL (matmul, gather or
        pallas) chooses the LK tracker, as in the JAX package's stereo
        pipeline; another value, or none, keeps the default (matmul)."""
        cfg = FrontendConfig.from_params(params.frontend, max_features=params.max_features)
        lk_env = os.environ.get("KIMERA_LK_IMPL", "")
        if lk_env in LK_IMPLS:
            cfg.lk_impl = lk_env
        return cfg

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

    def _pack_kf_row(self, bout, fe_out) -> torch.Tensor:
        """One keyframe's input to the mesher, the overlay and the
        visualizer as one int32 row on the device: pose (rot, pos),
        keypoint pixels (uL, v) and landmark points as float32 bits, then
        the keypoint ids, landmark ids, landmark validity and keypoint
        validity."""
        meas = fe_out["measurements"]
        kp_uv = torch.stack([meas.uvs[:, 0], meas.uvs[:, 2]], -1)
        f = torch.cat([bout["rot"].reshape(-1), bout["pos"], kp_uv.reshape(-1),
                       bout["lmk_points"].reshape(-1)])
        return torch.cat([f.view(torch.int32), meas.ids.to(torch.int32),
                          bout["lmk_ids"].to(torch.int32), bout["lmk_valid"].to(torch.int32),
                          meas.mask.to(torch.int32)])

    def _unpack_kf_rows(self, rows: np.ndarray) -> list:
        """Host inverse of `_pack_kf_row` for (n, P) rows."""
        N, L = self.frontend_cfg.max_features, self.backend_cfg.max_landmarks
        nf = 12 + 2 * N + 3 * L
        f = rows[:, :nf].view(np.float32)
        i = rows[:, nf:]
        return [dict(rot=f[k, 0:9].reshape(3, 3), pos=f[k, 9:12],
                     kp_uv=f[k, 12:12 + 2 * N].reshape(N, 2),
                     lmk_points=f[k, 12 + 2 * N:].reshape(L, 3), kp_ids=i[k, :N],
                     lmk_ids=i[k, N:N + L], lmk_valid=i[k, N + L:N + 2 * L] > 0,
                     kp_mask=i[k, N + 2 * L:] > 0)
                for k in range(rows.shape[0])]

    def _setup_mesher(self, on: bool):
        """A run's mesher, plane tracker and PLY logger (or none)."""
        on = on and self.enable_mesher
        self._mesher = mm.Mesher(device=self.device) if on else None
        self._plane_tracker = PlaneTracker() if on and self.use_regular_vio else None
        self._mesher_logger = MesherLogger(self.output_path) if on and self.output_path else None
        # The images ride along only where the mesh is refined against depth.
        self._mesher_images = on and (self.frontend_cfg.rgbd
                                      or bool(flags.get_flag("use_dense_depth_mesh_refinement")))

    def _drain_aux(self, lcd_module, pending: list, upto: int, win, lmk, visualizer=None):
        """Feed the pending keyframes (`AuxKeyframe`) of frames up to
        `upto`, in order, to the overlay writer, the mesher, the LCD and
        the visualizer, each kind of row read back in one transfer. The
        mesher's RegularVIO refine acts on `win` (and reads `lmk`), the
        window as it stands now. Returns (the keyframes still pending, the
        window)."""
        n = 0
        while n < len(pending) and pending[n].frame <= upto:
            n += 1
        if not n:
            return pending, win
        lcd_rows = kf_rows = None
        if lcd_module is not None:
            lcd_rows = self._unpack_lcd_rows(torch.stack([e.lcd_row for e in pending[:n]]).cpu().numpy())
        if pending[0].kf_row is not None:
            kf_rows = self._unpack_kf_rows(torch.stack([e.kf_row for e in pending[:n]]).cpu().numpy())
        for k, e in enumerate(pending[:n]):
            if e.left_rect is not None:
                self._log_frontend_img(e.stamp_ns, kf_rows[k], e.left_rect.cpu().numpy())
            mesh = None
            if self._mesher is not None:
                win, mesh = self._feed_mesher(kf_rows[k], e.left, e.right, win, lmk)
            if lcd_rows is not None:
                lcd_module.add_keyframe_packed(stamp_ns=e.stamp_ns, **lcd_rows[k])
            if visualizer is not None:
                self._feed_visualizer(visualizer, kf_rows[k], mesh, e.left)
        return pending[n:], win

    def _log_frontend_img(self, stamp_ns: int, fo: dict, left_rect: np.ndarray):
        """log_frontend_images: the keyframe's feature-track overlay PNG
        (reference logFrontendImg, StereoVisionImuFrontend.cpp:540,599),
        green tracked since the previous keyframe, blue new, red dead."""
        out_dir = self.output_path or flags.get_flag("output_path")
        ids, mask = fo["kp_ids"], fo["kp_mask"]
        save_feature_track_overlay(left_rect, fo["kp_uv"], ids, mask, self._prev_kf_ids,
                                   os.path.join(out_dir, "frontend_images", f"{stamp_ns}.png"))
        self._prev_kf_ids = [int(i) for i in ids[mask & (ids >= 0)]]

    def _feed_visualizer(self, visualizer, fo: dict, mesh, left):
        """One keyframe's widgets to the display: the pose, the landmark
        cloud, the mesh and, behind visualize_mesh_2d, the mesher's
        image-plane mesh over the raw left image."""
        show_2d = (bool(flags.get_flag("visualize_mesh_2d")) and self._mesher is not None
                   and self._mesher.mesh_2d is not None)
        w = visualizer.spin_once(fo["rot"], fo["pos"], fo["lmk_points"], fo["lmk_valid"],
                                 fo["lmk_ids"], mesh=mesh,
                                 mesh_2d=self._mesher.mesh_2d if show_2d else None,
                                 image=left.cpu().numpy() if show_2d else None)
        self._display.spin_once(w)

    def _feed_mesher(self, fo: dict, left, right, win, lmk):
        """One keyframe through the mesher: mesh, refine against depth
        (RGB-D sensor depth, or dense stereo behind the
        use_dense_depth_mesh_refinement flag), the RegularVIO refine of
        `win`, the PLY. Returns (the window, the mesh)."""
        mesh = self._mesher.spin_once(fo["kp_uv"], fo["kp_ids"], fo["lmk_ids"], fo["lmk_points"],
                                      fo["lmk_valid"],
                                      horizon_ids={int(i) for i in fo["lmk_ids"] if i >= 0})
        if self.frontend_cfg.rgbd:
            mesh = self._refine_mesh(mesh, right, fo["rot"], fo["pos"])
        elif flags.get_flag("use_dense_depth_mesh_refinement"):
            mesh = self._refine_mesh(mesh, self._dense_depth_for_kf(left, right), fo["rot"], fo["pos"])
        if self.use_regular_vio:
            win = self._regular_refine(win, lmk, mesh)
        if self._mesher_logger is not None:
            verts = mesh.vertices.reshape(-1, 3)
            self._mesher_logger.log(verts, np.arange(len(verts)).reshape(-1, 3))
        return win, mesh

    def _regular_refine(self, win, lmk, mesh):
        """One RegularVIO joint solve over the window and the persistent
        plane states: the mesh's horizontal planes and walls are segmented
        and associated with the tracker's slots (Mesher::associatePlanes,
        Mesher.cpp:1316-1420), each landmark takes the slot of the first
        triangle it belongs to, co-tracked near-parallel planes get
        parallel-plane rows, and the solved planes are written back.
        Returns the refined window, or `win` where no plane holds three
        landmarks."""
        if mesh.n_triangles == 0:
            return win
        dev = self.device
        tracker = self._plane_tracker
        verts = torch.as_tensor(mesh.vertices, dtype=torch.float32, device=dev)
        normals = mm.triangle_normals(verts)
        g_axis = torch.tensor([0.0, 0.0, 1.0], device=dev)
        keep = torch.ones(mesh.n_triangles, dtype=torch.bool, device=dev)
        pn, pd, pv, tri_assign = mm.segment_horizontal_planes(verts, keep, normals, g_axis)
        wn, wd, wv, wall_assign = mm.segment_walls(verts, keep, normals, g_axis)
        n_h = pn.shape[0]
        tri_assign = torch.where((tri_assign < 0) & (wall_assign >= 0), wall_assign + n_h, tri_assign)
        S = n_h + wn.shape[0]
        host = torch.cat([torch.cat([pn, wn]).reshape(-1), pd, wd, pv.float(), wv.float(),
                          tri_assign.float()]).cpu().numpy()
        seg_n = host[:3 * S].reshape(S, 3)
        seg_d = host[3 * S:4 * S]
        seg_valid = host[4 * S:5 * S] > 0.5
        assign = host[5 * S:].astype(np.int64)
        if not seg_valid.any():
            return win
        seg_idx = np.flatnonzero(seg_valid)
        slot_of_valid, _ = tracker.associate(seg_n[seg_idx], seg_d[seg_idx])
        seg_to_slot = np.full(S, -1, np.int32)
        seg_to_slot[seg_idx] = slot_of_valid
        id_to_plane: dict[int, int] = {}
        for t_i, ids3 in enumerate(mesh.lmk_ids):
            p = int(assign[t_i])
            if p < 0 or seg_to_slot[p] < 0:
                continue
            for lid in ids3:
                id_to_plane.setdefault(int(lid), int(seg_to_slot[p]))
        lmk_ids = lmk.ids.cpu().numpy()
        plane_assoc = np.array([id_to_plane.get(int(i), -1) if i >= 0 else -1 for i in lmk_ids],
                               np.int32)
        if (plane_assoc >= 0).sum() < 3:
            return win
        pairs = np.full((N_PLANE_PAIRS, 2), -1, np.int32)
        for q, pair in enumerate(tracker.parallel_pairs()[:N_PLANE_PAIRS]):
            pairs[q] = pair
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        planes = rv.PlaneStates(normal=t(tracker.normals), d=t(tracker.ds), mask=t(tracker.active))
        win2, planes2, _ = rv.regular_backend_solve(
            self.backend_cfg, win, lmk, planes, t(plane_assoc),
            torch.tensor(0.1, dtype=torch.float32, device=dev), gn_iters=1,
            parallel_pairs=t(pairs), parallel_pair_mask=t(pairs[:, 0] >= 0))
        solved = torch.cat([planes2.normal.reshape(-1), planes2.d]).cpu().numpy()
        tracker.update_from_solver(solved[:3 * tracker.P].reshape(-1, 3), solved[3 * tracker.P:])
        return win2

    def _dense_depth_for_kf(self, left, right) -> torch.Tensor:
        """Dense metric depth of a stereo keyframe: the raw pair rectified
        (through the rectification maps, as in the JAX package, also where
        the frontend skips an identity rectification) and block-matched
        (ops/stereo_matching.dense_depth).

        The remap here is the 4-tap gather `remap_bilinear`, not the
        frontend's `SeparableRemap`: the JAX package's dense depth gathers
        too (kimera_vio_tpu/pipeline/stereo_pipeline.py, `_dense_depth_for_kf`
        and the chunked aux stage), so this one stays a gather."""
        if getattr(self, "_dense_maps", None) is None:
            fe, st = self.frontend, self.stereo
            self._dense_maps = (
                (fe.map_left, fe.map_right) if not fe.identity_rect else
                tuple(torch.from_numpy(rectification_map(st, cam, R)).to(self.device)
                      for cam, R in ((st.left, st.R_rect_l), (st.right, st.R_rect_r))))
        fp = self.params.frontend
        return dense_depth(
            remap_bilinear(left, self._dense_maps[0]), remap_bilinear(right, self._dense_maps[1]),
            fx=float(self.stereo.fx), baseline=float(self.stereo.baseline),
            min_depth=float(fp.min_point_dist), max_depth=float(fp.max_point_dist),
            num_disparities=int(flags.get_flag("dense_stereo_num_disparities")),
            block_size=int(flags.get_flag("dense_stereo_block_size")))

    def _refine_mesh(self, mesh, depth_img, pose_R, pose_t):
        """Depth-based mesh refinement (reference MeshOptimization.cpp): the
        mesh's distinct vertices, in the keyframe camera's frame, move along
        their rays to follow the depth image (`mesh_optimizer_type`)."""
        if mesh.n_triangles == 0:
            return mesh
        uniq, inv = np.unique(mesh.lmk_ids.reshape(-1), return_inverse=True)
        inv = inv.reshape(-1)
        verts_w = np.zeros((len(uniq), 3), np.float32)
        verts_w[inv] = mesh.vertices.reshape(-1, 3)
        tris = inv.reshape(-1, 3).astype(np.int32)
        C_R = self.stereo.R_b_rect.cpu().numpy()
        C_t = self.stereo.t_b_rect.cpu().numpy()
        R_wc = pose_R @ C_R
        t_wc = pose_t + pose_R @ C_t
        dev = self.device
        refined_c, _ = optimize_mesh(
            torch.as_tensor((verts_w - t_wc) @ R_wc, device=dev), torch.as_tensor(tris, device=dev),
            torch.ones(len(tris), dtype=torch.bool, device=dev),
            torch.as_tensor(depth_img, dtype=torch.float32, device=dev),
            float(self.stereo.fx), float(self.stereo.fy), float(self.stereo.cx), float(self.stereo.cy),
            optimizer_type=int(flags.get_flag("mesh_optimizer_type")))
        refined_w = refined_c.cpu().numpy() @ R_wc.T + t_wc
        return mm.Mesh3D(lmk_ids=mesh.lmk_ids, vertices=refined_w[tris])

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
        """Initial nav state + bias: ground truth when available and
        autoInitialize is 0, else the IMU attitude."""
        dev = self.device
        if provider.ground_truth is not None and not self.params.backend.auto_initialize:
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
    def _body_rel(self, R_cam, t_cam):
        """A keyframe-relative pose in the rectified-camera frame -> the
        body frame (B_T = C_T cam_T C_T^-1)."""
        C_R, C_t = self.stereo.R_b_rect, self.stereo.t_b_rect
        R_b = C_R @ R_cam @ C_R.T
        return R_b, C_R @ t_cam + C_t - R_b @ C_t

    def _pnp_pose(self, fe_state, lmk, meas):
        """PnP of this keyframe's measurements against the backend's
        landmark map (Tracker::pnp, Tracker.cpp:1163-1270): the body pose
        in the world and whether enough inliers support it."""
        st = self.stereo
        eq = (meas.ids[:, None] == lmk.ids[None, :]) & meas.mask[:, None] & (lmk.ids >= 0)[None, :]
        row = torch.argmax(eq.to(torch.uint8), dim=1)
        has3d = eq.any(dim=1) & lmk.pts_ok[row]
        xy = torch.stack([(meas.uvs[:, 0] - st.cx) / st.fx, (meas.uvs[:, 2] - st.cy) / st.fy], -1)
        rays = torch.cat([xy, torch.ones_like(xy[:, :1])], -1)
        bearings = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(7 * 1_000_003 + fe_state.frame_count)
        focal = float(st.fx)
        R_cw, t_cw, _, n_pnp = ransac.ransac_pnp(lmk.pts[row], bearings, has3d, gen, focal=focal)
        # The guess must keep its inliers under the refit pose as well: on
        # a planar map the 6-point DLT refit is degenerate and can leave its
        # best hypothesis far behind, which the hypothesis' count alone (the
        # JAX package's gate) does not see.
        cam = lmk.pts[row] @ R_cw.T + t_cw
        cos = torch.clamp(torch.sum(cam * bearings, -1)
                          / torch.clamp(torch.linalg.norm(cam, dim=-1), min=1e-12), -1.0, 1.0)
        refit_inl = has3d & (cos > 0) & (focal * torch.sqrt(torch.clamp(1.0 - cos**2, min=0.0)) < 1.0)
        n_pnp = torch.minimum(n_pnp, refit_inl.sum())
        R_wc = R_cw.T
        p_wc = -R_wc @ t_cw
        R_wb = R_wc @ st.R_b_rect.T
        return R_wb, p_wc - R_wb @ st.t_b_rect, n_pnp >= self.params.frontend.min_pnp_inliers

    def _step(self, fe_state, win, lmk, left, right, imu_block, stamp_s, ext_odom=None):
        """One frame: frontend, then on keyframes the pose guess, the
        backend and the bias feedback. `ext_odom` is the frame's nearest
        external-odometry pose (R, t, valid) on the host, or None.

        The frontend's outputs gain, on keyframes, `stereo_rel`: the
        stereo-RANSAC relative pose in the body frame (R, t, enough
        inliers), which the between-stereo factor, the STEREO guess and the
        online initializer use (stereo and RGB-D only)."""
        fe_state, fe_out = self.frontend.process_frame(fe_state, left, right, imu_block, stamp_s)
        if not fe_out["is_keyframe"]:
            return fe_state, win, lmk, fe_out, None
        return self._keyframe_half(fe_state, win, lmk, fe_out, stamp_s, ext_odom)

    def _keyframe_half(self, fe_state, win, lmk, fe_out, stamp_s, ext_odom=None):
        """A keyframe's pose guess, backend step and bias feedback, after
        the frontend's keyframe branch: one stream's `_step` past the
        frontend, which `FleetVio` (parallel/fleet.py) runs for each stream
        that keyframes. Returns (fe_state, win, lmk, fe_out, backend
        outputs)."""
        with span("pipeline.keyframe_half"):
            return self._keyframe_half_body(fe_state, win, lmk, fe_out, stamp_s, ext_odom)

    def _keyframe_half_body(self, fe_state, win, lmk, fe_out, stamp_s, ext_odom):
        bp, fp = self.params.backend, self.params.frontend
        dev = self.device
        meas = fe_out["measurements"]
        kw = {}
        if (bp.add_between_stereo_factors or bp.pose_guess_source == GUESS_STEREO
                or bp.auto_initialize == 2) and not self.frontend_cfg.mono:
            R_b, t_b = self._body_rel(fe_out["R_stereo"], fe_out["t_stereo_vote"])
            fe_out["stereo_rel"] = (R_b, t_b, fe_out["n_stereo_inliers"] >= self.frontend_cfg.min_stereo_inliers)
            if bp.add_between_stereo_factors:
                kw.update(btw_R_rel=R_b, btw_t_rel=t_b, btw_valid=fe_out["stereo_rel"][2])
        prev = max(win.n - 1, 0)
        src = bp.pose_guess_source
        if src == GUESS_PNP:
            # PnP tracking against the map. The JAX package also solves it
            # for use_pnp_tracking alone, and drops the pose: nothing else
            # reads it, so the port solves it only for the guess.
            R_wb, p_wb, pnp_ok = self._pnp_pose(fe_state, lmk, meas)
            kw.update(guess_R=R_wb, guess_t=p_wb, guess_valid=pnp_ok)
        if src == GUESS_MONO:
            # The previous smoothed pose composed with the mono-RANSAC
            # relative pose (a unit translation), the world translation
            # then scaled by mono_translation_scale_factor: the reference's
            # literal formula (VioBackend.cpp:817-835).
            R_mb, t_mb = self._body_rel(fe_out["R_mono"], fe_out["t_mono"])
            scale = np.float32(bp.mono_translation_scale_factor)
            kw.update(guess_R=win.rot[prev] @ R_mb,
                      guess_t=(win.pos[prev] + win.rot[prev] @ t_mb) * scale,
                      guess_valid=fe_out["n_mono_inliers"] >= fp.min_nr_mono_inliers)
        if src == GUESS_STEREO and "stereo_rel" in fe_out:
            R_rel, t_rel, rel_ok = fe_out["stereo_rel"]
            kw.update(guess_R=win.rot[prev] @ R_rel,
                      guess_t=win.pos[prev] + win.rot[prev] @ t_rel, guess_valid=rel_ok)
        if ext_odom is not None:
            R_o, t_o, ok_o = ext_odom
            kw.update(odom_R_abs=torch.as_tensor(np.asarray(R_o, np.float32), device=dev),
                      odom_t_abs=torch.as_tensor(np.asarray(t_o, np.float32), device=dev),
                      odom_valid_abs=ok_o)
        with span("backend.step"):
            win, lmk, bout = sm.backend_step(
                self.backend_cfg, win, lmk, pim=fe_out["pim"], stamp=stamp_s,
                meas_ids=meas.ids, meas_uvd=meas.uvs, meas_mask=meas.mask,
                status=fe_out["status"], **kw,
            )
        new_bias = ImuBias(accel=bout["bias"][0:3], gyro=bout["bias"][3:6])
        fe_state = replace(fe_state, imu_bias=new_bias, pim=imu.Pim.zero(new_bias))
        return fe_state, win, lmk, fe_out, bout

    def _bootstrap(self, provider, packet, left, right, stamp_s, vel_sigma=None):
        """First frame (or the first after a time-alignment restart):
        frontend state, window and landmark table from ground truth or the
        IMU. Returns (fe_state, win, lmk, nav0)."""
        nav0, bias0 = self._bootstrap_state(provider, packet["stamp_ns"], packet["imu"])
        return (*self._init_stream(left, right, stamp_s, nav0, bias0, vel_sigma=vel_sigma), nav0)

    def _init_stream(self, left, right, stamp_s, nav0: NavState, bias0: torch.Tensor,
                     vel_sigma=None):
        """A stream's first frame at a given state: frontend state, window
        bootstrapped at `nav0` / `bias0` (6,) and landmark table with the
        first measurements in slot 0. Returns (fe_state, win, lmk)."""
        K, L = self.backend_cfg.nr_states, self.backend_cfg.max_landmarks
        fe_state, meas0 = self.frontend.init_state(left, right, stamp_s)
        fe_state = replace(fe_state, imu_bias=ImuBias(accel=bias0[0:3], gyro=bias0[3:6]))
        win = sm.bootstrap(self.backend_cfg, sm.Window.empty(K, self.device), nav0, bias0, stamp_s,
                           vel_sigma=vel_sigma)
        lmk = sm.update_landmarks(sm.LandmarkTable.empty(L, K, self.device),
                                  meas0.ids, meas0.uvs, meas0.mask, 0)
        return fe_state, win, lmk

    def _reinit_from_alignment(self, sol: dict, stamp_s: float, fe_state):
        """Online initialization solved: a fresh window bootstrapped at the
        aligned state (attitude, position, velocity, gyro bias) and an
        empty landmark table; the frontend keeps its tracks and takes the
        bias. Returns (fe_state, win, lmk)."""
        dev = self.device
        K, L = self.backend_cfg.nr_states, self.backend_cfg.max_landmarks
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
        nav = NavState(rot=t(sol["R0"]), pos=t(sol["pos0"]), vel=t(sol["vel"]))
        bias0 = torch.cat([torch.zeros(3, device=dev), t(sol["gyro_bias"])])
        win = sm.bootstrap(self.backend_cfg, sm.Window.empty(K, dev), nav, bias0, stamp_s)
        b = ImuBias(accel=bias0[0:3], gyro=bias0[3:6])
        fe_state = replace(fe_state, imu_bias=b, pim=imu.Pim.zero(b))
        return fe_state, win, sm.LandmarkTable.empty(L, K, dev)

    def _init_extras(self, fe_out) -> dict:
        """A keyframe's inputs to the online initializer on the host, in
        one transfer: the stereo-RANSAC body-frame relative pose and the
        keyframe PIM's deltas."""
        R, t, _ = fe_out["stereo_rel"]
        p = fe_out["pim"]
        parts = (R, t, p.delta_R, p.delta_v, p.delta_p, p.dR_dbg)
        flat = torch.cat([x.reshape(-1) for x in parts]).cpu().numpy()
        names = ("init_R_rel_body", "init_t_rel_body", "init_pim_delta_R", "init_pim_delta_v",
                 "init_pim_delta_p", "init_pim_dR_dbg")
        out, o = {}, 0
        for name, x in zip(names, parts):
            n = x.numel()
            out[name] = flat[o:o + n].reshape(tuple(x.shape))
            o += n
        return out

    def _feed_aligner(self, aligner, provider, packet, fe_out, bout, stamp_ns) -> bool:
        """Feed the time aligner this frame's gyro samples and, on a
        keyframe, the visual rotation since the last keyframe spread over
        the IMU samples since then. True when an offset estimate landed
        (applied to the provider's IMU stamps when it has them)."""
        blk = packet["imu"]
        gyr, dts, msk = blk.gyr.numpy(), blk.dt.numpy(), blk.mask.numpy()
        self._aligner_imu_since_kf += int(msk.sum())
        for i in range(len(dts)):
            if msk[i]:
                aligner.add_imu(stamp_ns, gyr[i], float(dts[i]))
        if bout is None:
            return False
        n_imu = max(self._aligner_imu_since_kf, 1)
        self._aligner_imu_since_kf = 0
        angle = float(torch.linalg.norm(geo.so3_log(fe_out["R_stereo"])))
        aligner.add_frame_rotation(stamp_ns, angle, n_imu)
        est = aligner.attempt_estimation()
        if est is None:
            return False
        self.time_shift_estimate_s = est
        if hasattr(provider, "imu_time_shift_ns"):
            provider.imu_time_shift_ns = int(est * 1e9)
        return True

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
               defer_readback: bool = False, aux_drain: tuple | None = None,
               visualize: bool = False) -> PipelineOutput:
        """The run loop of both entry points. `frames` yields (packet,
        left, right, imu_block, origin_ns): images and IMU block on the
        device (no IMU block for the first frame, which bootstraps) and
        the float32 time origin, which advances by whole rebase intervals.
        `sync_each` blocks on the card after every frame and records the
        frame and keyframe step times; `defer_readback` reads the keyframe
        states back once at the end instead of at each keyframe.

        With loop closure, the mesher, the overlays or the visualizer
        (`visualize`) and `aux_drain = (every, lag)`, every keyframe after
        the bootstrap leaves its rows (and the images they need) on the
        device; every `every` frames those of keyframes at least `lag`
        frames old are read back, one transfer per kind of row, and fed to
        the overlay writer, the mesher (whose RegularVIO refine replaces
        the window), the LCD and the visualizer; the rest is fed after the
        last frame, then PGO runs.

        Online initialization (autoInitialize: 2, not mono) and fine time
        alignment read each keyframe's inputs on the host while they
        collect and hold the keyframe states unpublished; on success the
        estimator restarts (online init: at the aligned state; time
        alignment: a fresh bootstrap at the next frame) and what was held
        is dropped, as the reference publishes nothing before."""
        out = PipelineOutput()
        self.backend_healthy = True
        self._consecutive_recoveries = 0
        self.lcd_result = None
        self.time_shift_estimate_s = None
        bp = self.params.backend
        fe_state = win = lmk = None
        keyframes = []  # (stamp_ns, state row) not yet published
        lcd_module = self._build_lcd() if self.enable_lcd and aux_drain else None
        self.frontend_cfg.lcd_features = self._lcd_features if lcd_module is not None else 0
        self._setup_mesher(aux_drain is not None)
        log_fe_imgs = aux_drain is not None and bool(flags.get_flag("log_frontend_images"))
        self._prev_kf_ids = None
        visualizer = None
        if visualize:
            visualizer = Visualizer3D()
            self._display = make_display(
                self.params.pipeline.display_type,
                os.path.join(self.output_path or flags.get_flag("output_path"), "viz"))
        keep_left = visualizer is not None and bool(flags.get_flag("visualize_mesh_2d"))
        need_kf_row = self._mesher is not None or log_fe_imgs or visualizer is not None
        feeds_aux = lcd_module is not None or need_kf_row
        aux_pending = []  # AuxKeyframe not yet fed
        use_init = bp.auto_initialize == 2 and not self.frontend_cfg.mono
        initializer = None
        aligner = None
        if self._do_time_align:
            aligner = CrossCorrTimeAligner(
                window_size_s=self.params.imu.time_alignment_window_size_s,
                variance_threshold_scaling=self.params.imu.time_alignment_variance_threshold_scaling,
                device=self.device)
            self._aligner_imu_since_kf = 0
        odom_buf = getattr(provider, "odometry", None)
        logger, fe_logger = self._open_loggers(provider)
        try:
            for packet, left, right, imu_block, origin_ns in frames:
                stamp_ns = packet["stamp_ns"]
                if fe_state is None:
                    with self.stats.span("pipeline.bootstrap", "bootstrap [ms]"):
                        stamp_s = (stamp_ns - origin_ns) * 1e-9
                        fe_state, win, lmk, nav0 = self._bootstrap(
                            provider, packet, left, right, stamp_s,
                            vel_sigma=1.0 if use_init else None)
                        if use_init:
                            # Collection phase: velocity is a zero guess until
                            # the alignment solves for it (loose prior).
                            initializer = OnlineInitializer(self.params.imu.n_gravity,
                                                            nav0.rot.cpu().numpy(),
                                                            device=self.device)
                        keyframes.append((stamp_ns, torch.cat(
                            [win.rot[0].reshape(-1), win.pos[0], win.vel[0], win.bias[0]])))
                        out.n_keyframes += 1
                        out.n_frames += 1
                    applied_ns = origin_ns
                else:
                    if origin_ns != applied_ns:
                        win, fe_state = self._apply_rebase(
                            (origin_ns - applied_ns) * 1e-9, win, fe_state)
                        applied_ns = origin_ns
                    stamp_s = (stamp_ns - origin_ns) * 1e-9
                    ext = None
                    if odom_buf is not None:
                        # Nearest external-odometry pose of this frame
                        # (ThreadsafeOdometryBuffer::getNearest).
                        near = odom_buf.get_nearest(stamp_ns, tolerance_ns=10**8)
                        ext = (np.eye(3), np.zeros(3), False) if near is None else \
                            (near["R"], near["t"], True)

                    with self.stats.span("pipeline.vio_step", "vio_step [ms]",
                                         step=out.n_frames) as step:
                        fe_state, win, lmk, fe_out, bout = self._step(
                            fe_state, win, lmk, left, right, imu_block, stamp_s, ext)
                        if sync_each and self.device.type == "cuda":
                            # Sequential mode: block every frame (reference
                            # parallel_run=0, Pipeline.cpp:197-215).
                            torch.cuda.synchronize(self.device)
                    if sync_each:
                        self.stats.add(
                            "VioFrontend Keyframe Rate [ms]" if bout is not None
                            else "VioFrontend Frame Rate [ms]", step.ms)
                    out.n_frames += 1
                    if fe_logger:
                        fe_logger.log(stamp_ns, bout is not None, fe_out["n_tracked"],
                                      fe_out["median_disparity"], fe_out["n_mono_inliers"],
                                      fe_out["n_stereo_inliers"], 0.0)
                    if aligner is not None and self._feed_aligner(
                            aligner, provider, packet, fe_out, bout, stamp_ns):
                        # Offset found: restart the estimator from the next
                        # frame (TimeAlignment -> Bootstrap).
                        aligner = None
                        fe_state = None
                        keyframes = []
                        out = PipelineOutput()
                        continue
                    if bout is not None and initializer is not None and not initializer.done:
                        if initializer.add_keyframe(self._init_extras(fe_out), stamp_s):
                            sol = initializer.solve()
                            if not sol["ok"]:
                                # Gyro residual above gyroscope_residuals:
                                # re-collect from the current attitude.
                                self.stats.add("init window rejected [resid rad]",
                                               sol["gyro_residual"])
                                initializer = OnlineInitializer(self.params.imu.n_gravity,
                                                                initializer.R_chain[-1],
                                                                device=self.device)
                            else:
                                fe_state, win, lmk = self._reinit_from_alignment(
                                    sol, stamp_s, fe_state)
                                out = PipelineOutput(n_keyframes=1, n_frames=1)
                                keyframes = [(stamp_ns, torch.cat(
                                    [win.rot[0].reshape(-1), win.pos[0], win.vel[0], win.bias[0]]))]
                                continue
                    if bout is not None:
                        out.n_keyframes += 1
                        keyframes.append((stamp_ns, torch.cat(
                            [bout["rot"].reshape(-1), bout["pos"], bout["vel"], bout["bias"]])))
                        self._note_backend_health(int(bout["n_recovered"]))
                        if feeds_aux:
                            aux_pending.append(AuxKeyframe(
                                out.n_frames, stamp_ns,
                                self._pack_lcd_row(bout, fe_out) if lcd_module is not None else None,
                                self._pack_kf_row(bout, fe_out) if need_kf_row else None,
                                left if self._mesher_images or keep_left else None,
                                right if self._mesher_images else None,
                                self._overlay_image(fe_out) if log_fe_imgs else None))
                    if feeds_aux and (out.n_frames - 1) % aux_drain[0] == 0:
                        aux_pending, win = self._drain_aux(lcd_module, aux_pending,
                                                           out.n_frames - aux_drain[1], win, lmk,
                                                           visualizer)
                collecting = aligner is not None or (initializer is not None and not initializer.done)
                if not (defer_readback or collecting) and keyframes:
                    self._publish(out, keyframes, self._host_rows(keyframes), logger)
                    keyframes = []
                if verbose and out.n_frames % 50 == 0:
                    print(f"frame {out.n_frames} keyframes {out.n_keyframes}")
                if not self.backend_healthy:
                    break  # graceful stop on persistent backend failure
            if keyframes:
                with self.stats.span("pipeline.readback", "readback [ms]"):
                    rows = self._host_rows(keyframes)
                self._publish(out, keyframes, rows, logger)
            if feeds_aux:
                _, win = self._drain_aux(lcd_module, aux_pending, out.n_frames, win, lmk,
                                         visualizer)
            if lcd_module is not None:
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

    @staticmethod
    def _overlay_image(fe_out: dict) -> torch.Tensor:
        """The keyframe's rectified left image, as the frontend step made
        it, the way the overlay draws it: clipped to 0..255 and truncated
        to uint8, on the device."""
        return fe_out["left_rect"].clamp(0, 255).to(torch.uint8)

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

    def state_covariance(self, return_ok: bool = False):
        """Marginal 15x15 covariance of the newest state of the last run's
        final window (the reference's computeStateCovariance /
        getStateCovariance, which a ROS odometry publisher consumes); one
        extra solve, on demand. `return_ok=True` adds the health flag
        (False: a sick window, the numbers mean nothing; see
        `smoother.state_covariance`). Returns numpy (and a bool)."""
        if not hasattr(self, "_last_win"):
            raise RuntimeError("state_covariance: no completed run yet")
        out = sm.state_covariance(self.backend_cfg, self._last_win, self._last_lmk,
                                  return_ok=return_ok)
        if return_ok:
            cov, ok = out
            return cov.cpu().numpy(), bool(ok)
        return out.cpu().numpy()

    def run(self, provider, verbose: bool = False) -> PipelineOutput:
        """Run the whole provider sequence; returns the keyframe trajectory."""
        return self._drive(provider, self._direct_frames(provider), verbose,
                           sync_each=not self.parallel_run, aux_drain=(1, AUX_LAG),
                           visualize=self.enable_visualizer)

    # ------------------------------------------------------------------
    def _stage(self, provider, batch, side_stream, codec: str = "raw") -> Staged:
        """Stager thread: decode one super-batch, encode its frames in
        `codec` (or the codec its decline chain lands on), pack the wire
        and the IMU blocks into one host buffer (`_encode`, timed as
        `encode_ms`) and start its copy to the device."""
        with Span("pipeline.stage_encode") as encode:
            staged = self._encode(provider, batch, codec)
        staged = staged._replace(encode_ms=encode.ms)
        if side_stream is None:
            return staged
        # One copy per super-batch on the side stream; events bracket it so
        # the consumer can wait on it and read its time.
        start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side_stream):
            start.record(side_stream)
            dev_buf = staged.host.to(self.device, non_blocking=True)
            done.record(side_stream)
        return staged._replace(buf=dev_buf, copy=(start, done))

    def _encode(self, provider, batch, codec: str) -> Staged:
        """`_stage`'s super-batch in one host buffer, its `buf` that buffer.

        The IMU rows are the JAX package's aux layout without its last
        column, the rebased stamp: the step takes the stamp from the
        packet on the host, so the card never reads it."""
        F = len(batch)
        left_imgs = [provider.load_image(p["left_path"]) for p in batch]
        right_imgs = ([provider.load_image(p["right_path"]) for p in batch]
                      if "right_path" in batch[0] else left_imgs)
        H, W = left_imgs[0].shape[:2]
        shape = (F, 2, H, W)
        # uint8 frames; float32 from the synthetic provider or where the
        # right image is an RGB-D depth image (the left one is widened).
        dtype = np.result_type(left_imgs[0].dtype, right_imgs[0].dtype)
        B = batch[0]["imu"].acc.shape[0]
        aux = np.empty((F, B * 8), np.float32)
        for i, p in enumerate(batch):
            blk = p["imu"]
            aux[i, :B * 3] = blk.acc.numpy().ravel()
            aux[i, B * 3:B * 6] = blk.gyr.numpy().ravel()
            aux[i, B * 6:B * 7] = blk.dt.numpy()
            aux[i, B * 7:] = blk.mask.numpy()

        # The JAX package's decline chain: delta4c needs every plane to be
        # a uint8 array; delta4c and delta3 fall to delta4, delta4 to raw.
        parts, used, n_tok, imgs = None, "raw", 0, None
        if codec == "delta4c":
            planes = [im for pair in zip(left_imgs, right_imgs) for im in pair]
            if all(isinstance(im, np.ndarray) and im.dtype == np.uint8 for im in planes):
                enc = fc.encode_delta4c_planes(planes, 2, shape, aux)
                if enc is not None:
                    parts, used, n_tok = [("wire", enc["buf"])], "delta4c", enc["n_tok"]
        if parts is None and codec != "raw":
            imgs = np.stack([np.stack(left_imgs), np.stack(right_imgs)], axis=1)
            enc = fc.encode_delta3(imgs) if codec == "delta3" else None
            if enc is not None:
                parts, used = [(k, enc[k]) for k in ("base", "t1", "t2", "t3")], "delta3"
            else:
                enc = fc.encode_delta4(imgs)
                if enc is not None:
                    parts = [(k, enc[k]) for k in ("base", "packed", "esc_idx", "esc_val")]
                    used = "delta4"
            if parts is not None:
                parts.append(("aux", aux))
        if parts is None:
            parts = [("frames", imgs), ("aux", aux)]  # imgs None: filled from the images below

        layout, end = {}, 0
        for name, arr in parts:
            part_shape, part_dtype = (shape, dtype) if arr is None else (arr.shape, arr.dtype)
            start = -(-end // 16) * 16
            layout[name] = (start, np.dtype(part_dtype), tuple(part_shape))
            end = start + int(np.prod(part_shape)) * np.dtype(part_dtype).itemsize
        host = torch.empty(end, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        hb = host.numpy()
        for name, arr in parts:
            start, part_dtype, part_shape = layout[name]
            dst = hb[start:start + int(np.prod(part_shape)) * part_dtype.itemsize]
            dst = dst.view(part_dtype).reshape(part_shape)
            if arr is not None:
                dst[...] = arr
            else:  # raw frames straight from the decoded images
                for i in range(F):
                    dst[i, 0] = left_imgs[i]
                    dst[i, 1] = right_imgs[i]
        return Staged(used, shape, _torch_dtype(dtype), aux.shape, layout, n_tok, host, host,
                      None, 0.0)

    def _materialize(self, staged: Staged):
        """A staged super-batch -> (frames (F, 2, H, W), IMU rows (F, B*8)
        float32) on the device, once its copy has arrived: the codec's
        decode runs on the current stream."""
        self.stats.add("stage encode [ms]", staged.encode_ms)
        self.stats.add("stage wire [MB]", staged.host.numel() / 1e6)
        self.stats.add(f"stage codec {staged.codec} [#]", 1.0)  # where the decline chain landed
        buf = staged.buf
        if staged.copy is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staged.copy[1])
            buf.record_stream(cur)  # allocated on the side stream, used here

        def part(name):
            start, dtype, shape = staged.parts[name]
            n = int(np.prod(shape)) * dtype.itemsize
            return buf[start:start + n].view(_torch_dtype(dtype)).view(shape)

        if staged.codec == "delta4c":
            return fc.decode_delta4c(part("wire"), staged.shape, staged.n_tok, staged.aux_shape)
        if staged.codec == "delta4":
            frames = fc.decode_delta4(part("base"), part("packed"), part("esc_idx"),
                                      part("esc_val"), staged.shape)
        elif staged.codec == "delta3":
            frames = fc.decode_delta3(part("base"), part("t1"), part("t2"), part("t3"),
                                      staged.shape)
        else:
            frames = part("frames")
        return frames, part("aux")

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

    def _staged_frames(self, provider, chunk_size: int, super_batch_bytes: int, codec: str):
        """run_chunked()'s frame source: the first frame loaded directly,
        the rest in super-batches of whole chunks staged in `codec` by a
        background thread, each with the rebase origin of its first
        frame."""
        dev = self.device
        packets = list(provider.frames())
        if not packets:
            return
        first = packets[0]
        t0_ns = first["stamp_ns"]
        # Each image is loaded once (a live provider releases it as it is
        # read); the first frame's also sizes the super-batches.
        left0 = provider.load_image(first["left_path"])
        right0 = provider.load_image(first["right_path"]) if "right_path" in first else left0
        rest = [p for p in packets[1:] if p.get("imu") is not None]
        super_frames = chunk_size
        if rest:
            frame_bytes = 2 * left0.size * np.result_type(left0.dtype, right0.dtype).itemsize
            super_frames = super_batch_frames(codec, chunk_size, super_batch_bytes, frame_bytes)
        supers = [rest[i:i + super_frames] for i in range(0, len(rest), super_frames)]
        # Rebase origin per super-batch, a function of the stamps alone.
        origins_ns, shift_s = [], 0.0
        for batch in supers:
            shift_s += self._rebase_delta_s((batch[0]["stamp_ns"] - t0_ns) * 1e-9 - shift_s)
            origins_ns.append(t0_ns + int(round(shift_s * 1e9)))

        side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        staged = PrefetchIterator(supers, lambda batch: self._stage(provider, batch, side, codec),
                                  depth=2)
        try:
            left = torch.from_numpy(left0).to(dev)
            right = torch.from_numpy(right0).to(dev) if "right_path" in first else left
            yield first, left, right, None, t0_ns
            for batch, origin_ns in zip(supers, origins_ns):
                with self.stats.span("pipeline.wait_for_stage", "dispatch wait-for-stage [ms]"):
                    staged_j = next(staged)
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
        frames at the codec's wire factor, at least one chunk), one
        host-to-device copy each, on a background thread; step each frame
        on the device; read the keyframe states back once at the end.
        `KIMERA_STAGE_CODEC`, read at each call, names the staging codec
        (`raw` by default; see the module docstring).

        Stamps enter the step as `run()` gives them, so the trajectory is
        `run()`'s. `collect_aux=True` drives loop closure and the mesher
        when they are on (without it they do not run, as in the JAX
        package): their rows are read back once per chunk, a chunk late,
        or right after their chunk when RegularVIO refines the window,
        which then goes on into the next chunk; so are the overlays of
        `log_frontend_images`. Refused, as in the JAX package: fine time
        alignment, online initialization, external odometry. The
        visualizer runs in `run()` only, as in the JAX package."""
        if (self.enable_lcd or self.enable_mesher or flags.get_flag("log_frontend_images")) \
                and not collect_aux:
            warnings.warn("mesher/LCD/log_frontend_images enabled but collect_aux=False: they "
                          "will not run in chunked mode", stacklevel=2)
        if self.enable_visualizer:
            warnings.warn("the visualizer runs in run() only (as in the JAX package), not in "
                          "run_chunked", stacklevel=2)
        if flags.get_flag("do_fine_imu_camera_temporal_sync"):
            raise NotImplementedError("run_chunked does not support fine IMU-camera time alignment")
        if self.params.backend.auto_initialize == 2:
            raise NotImplementedError("run_chunked does not support online initialization")
        if getattr(provider, "odometry", None) is not None:
            raise NotImplementedError("run_chunked does not support external odometry")
        codec = os.environ.get("KIMERA_STAGE_CODEC", "raw")
        return self._drive(provider, self._staged_frames(provider, chunk_size, super_batch_bytes,
                                                         codec),
                           verbose, defer_readback=True,
                           aux_drain=((chunk_size, 0 if self.use_regular_vio else chunk_size)
                                      if collect_aux else None))
