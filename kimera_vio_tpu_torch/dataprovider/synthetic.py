"""Synthetic stereo-inertial dataset with exact ground truth.

Port of kimera_vio_tpu/dataprovider/synthetic.py (`synthetic_params`,
`SyntheticStereoProvider`, `SyntheticPlanar6DofProvider`); plain numpy +
scipy, identical output.

Role: the *end-to-end accuracy fixture*. The reference validates its
backend on simulated constant-velocity motion (tests/testVioBackend.cpp)
and its pipeline on a mini real dataset; this module provides the
full-pipeline analog with perfect ground truth — a camera translating past
a fronto-parallel textured plane, rendered by exact image-space shifts, plus
consistent IMU — so ATE of the whole detection->LK->stereo->smoother stack
can be asserted in CI (and reported by bench.py when no EuRoC sequence is
on disk).

Geometry: world plane at depth `depth` in front of the camera; camera at
R=I translating with constant velocity v = (vx, 0, 0); pinhole cameras
with cx=W/2, cy=H/2 and no distortion, so raw == rectified and image k is
the texture window starting at fx*t_x/depth px (right eye additionally
shifted by the constant disparity fx*b/depth).
"""

from __future__ import annotations

import numpy as np

from kimera_vio_tpu_torch.config.params import (
    BackendParams,
    CameraParams,
    FrontendParams,
    ImuParams,
    PipelineParams,
    VioParams,
)
from kimera_vio_tpu_torch.dataprovider.euroc import GroundTruth, ImuSynchronizer

GRAVITY = np.array([0.0, 0.0, -9.81])


def synthetic_params(
    width=752, height=480, fx=450.0, baseline=0.11, max_features=256,
    max_landmarks=384, nr_states=10,
) -> VioParams:
    """A VioParams for the synthetic rig (no distortion, identity-ish
    extrinsics, EuRoC-like noise)."""
    left = CameraParams(
        camera_id="synthetic_left",
        T_BS=np.eye(4),
        width=width,
        height=height,
        intrinsics=np.array([fx, fx, width / 2.0, height / 2.0]),
        distortion_model="none",
        distortion_coeffs=np.zeros(4),
    )
    T_right = np.eye(4)
    T_right[0, 3] = baseline
    right = CameraParams(
        camera_id="synthetic_right",
        T_BS=T_right,
        width=width,
        height=height,
        intrinsics=np.array([fx, fx, width / 2.0, height / 2.0]),
        distortion_model="none",
        distortion_coeffs=np.zeros(4),
    )
    v = VioParams(
        pipeline=PipelineParams(parallel_run=False),
        imu=ImuParams(),
        left_cam=left,
        right_cam=right,
        frontend=FrontendParams(min_point_dist=0.5, max_point_dist=20.0),
        backend=BackendParams(nr_states=nr_states),
        max_features=max_features,
        max_landmarks=max_landmarks,
    )
    return v


def _smooth_texture(h, w, seed=0, scale=6):
    rng = np.random.default_rng(seed)
    import scipy.ndimage as ndi

    small = rng.uniform(30, 225, (h // scale + 2, w // scale + 2)).astype(np.float32)
    big = ndi.zoom(small, scale, order=3)
    return big[:h, :w].astype(np.float32)


class _NoiseModel:
    """Shared measurement-corruption recipe for the synthetic providers.

    Mirrors the EuRoC sensor spec (ImuParams defaults): discrete IMU noise
    std = density * sqrt(rate); constant injected biases are ADDED to the
    measurements, so the estimator must recover them (the e2e
    bias-recovery gate, testImuFrontend.cpp class of checks but through
    the whole pipeline)."""

    def __init__(
        self,
        imu_rate: float,
        pixel_noise_std: float = 0.0,
        acc_noise_density: float = 0.0,
        gyro_noise_density: float = 0.0,
        gyro_bias=None,
        accel_bias=None,
        seed: int = 1234,
    ):
        self.pixel_noise_std = pixel_noise_std
        self.acc_std = acc_noise_density * np.sqrt(imu_rate)
        self.gyro_std = gyro_noise_density * np.sqrt(imu_rate)
        self.gyro_bias = (
            np.zeros(3) if gyro_bias is None else np.asarray(gyro_bias, float)
        )
        self.accel_bias = (
            np.zeros(3)
            if accel_bias is None
            else np.asarray(accel_bias, float)
        )
        self.seed = seed

    @property
    def enabled(self):
        return (
            self.pixel_noise_std > 0
            or self.acc_std > 0
            or self.gyro_std > 0
            or self.gyro_bias.any()
            or self.accel_bias.any()
        )

    def corrupt_imu(self, acc, gyr):
        rng = np.random.default_rng(self.seed)
        acc = acc + self.accel_bias + rng.normal(0, self.acc_std or 0.0, acc.shape)
        gyr = gyr + self.gyro_bias + rng.normal(0, self.gyro_std or 0.0, gyr.shape)
        return acc, gyr

    def corrupt_image(self, img, key_id: int):
        if self.pixel_noise_std <= 0:
            return img
        rng = np.random.default_rng(self.seed * 7919 + key_id)
        out = img + rng.normal(0, self.pixel_noise_std, img.shape)
        return np.clip(out, 0.0, 255.0).astype(np.float32)


class SyntheticStereoProvider:
    """Duck-typed like EurocDataProvider (frames(), ground_truth,
    imu_sync, load_image)."""

    def __init__(
        self,
        n_frames: int = 40,
        fps: float = 20.0,
        imu_rate: float = 200.0,
        vx: float = 0.5,
        depth: float = 5.0,
        width: int = 752,
        height: int = 480,
        fx: float = 450.0,
        baseline: float = 0.11,
        seed: int = 0,
        max_imu_per_frame: int = 16,
        noise: "_NoiseModel | None" = None,
    ):
        self.n_frames = n_frames
        self.width, self.height = width, height
        self.fx, self.baseline, self.depth = fx, baseline, depth
        self.vx = vx
        self.noise = noise or _NoiseModel(imu_rate)
        total_shift = int(np.ceil(fx * vx * (n_frames / fps) / depth)) + 4
        disp = int(np.ceil(fx * baseline / depth)) + 2
        self.texture = _smooth_texture(
            height, width + total_shift + disp, seed=seed
        )
        self.fps = fps
        self.ground_truth = self._make_gt(n_frames, fps, vx)

        # IMU: constant velocity -> accelerometer reads -gravity, gyro 0.
        n_imu = int(n_frames / fps * imu_rate) + 20
        t_imu = (np.arange(n_imu) * (1e9 / imu_rate)).astype(np.int64)
        acc = np.tile(-GRAVITY, (n_imu, 1))
        gyr = np.zeros((n_imu, 3))
        acc, gyr = self.noise.corrupt_imu(acc, gyr)
        self.imu_sync = ImuSynchronizer(t_imu, acc, gyr, max_imu_per_frame)
        self.left_stamps = (np.arange(n_frames) * (1e9 / fps)).astype(np.int64)
        # NOTE: GT bias columns stay zero even with injected bias — the
        # bootstrap hands GT bias to the estimator (autoInitialize: 0), so
        # leaving them zero is exactly what makes the e2e bias-RECOVERY
        # assertion meaningful (tests compare against provider.noise.*_bias).

    def _make_gt(self, n, fps, vx):
        stamps = (np.arange(n) * (1e9 / fps)).astype(np.int64)
        t = np.arange(n) / fps
        pos = np.stack([vx * t, np.zeros(n), np.zeros(n)], -1)
        quat = np.tile([1.0, 0, 0, 0], (n, 1))
        vel = np.tile([vx, 0.0, 0.0], (n, 1))
        z = np.zeros((n, 3))
        return GroundTruth(
            stamps_ns=stamps, positions=pos, quats_wxyz=quat,
            velocities=vel, gyro_bias=z, accel_bias=z,
        )

    # -- EurocDataProvider interface ------------------------------------
    def load_image(self, key) -> np.ndarray:
        kind, k = key
        t = k / self.fps
        shift = self.fx * self.vx * t / self.depth
        if kind == "right":
            shift += self.fx * self.baseline / self.depth
        # Subpixel shift via linear interpolation between integer columns.
        i0 = int(np.floor(shift))
        frac = shift - i0
        w = self.width
        a = self.texture[:, i0 : i0 + w]
        b = self.texture[:, i0 + 1 : i0 + 1 + w]
        img = ((1 - frac) * a + frac * b).astype(np.float32)
        return self.noise.corrupt_image(
            img, k * 2 + (1 if kind == "right" else 0)
        )

    def frames(self):
        prev_t = None
        for k in range(self.n_frames):
            t = int(self.left_stamps[k])
            packet = {
                "index": k,
                "stamp_ns": t,
                "left_path": ("left", k),
                "right_path": ("right", k),
            }
            if prev_t is None:
                packet["imu"] = None
            else:
                packet["imu"] = self.imu_sync.block(prev_t, t)
                if packet["imu"] is None:
                    continue
            prev_t = t
            yield packet


class SyntheticPlanar6DofProvider:
    """Full-6DoF synthetic stereo-inertial sequence with exact GT.

    A textured WORLD PLANE at z = `plane_z` (camera initially at the
    origin looking down +z); the camera follows an analytic trajectory
    with sinusoidal translation AND rotation, and every frame is rendered
    by exact ray-plane intersection (a homography of the texture) — so
    rotational tracking, flow prediction and bias estimation are all
    exercised, unlike the shift-only `SyntheticStereoProvider`. IMU is
    derived from the analytic pose by central differences at IMU rate.

    Duck-typed like EurocDataProvider (frames(), ground_truth, imu_sync,
    load_image).
    """

    def __init__(
        self,
        n_frames: int = 60,
        fps: float = 20.0,
        imu_rate: float = 200.0,
        plane_z: float = 5.0,
        trans_amp=(0.6, 0.3, 0.15),
        rot_amp=(0.06, 0.08, 0.1),
        width: int = 752,
        height: int = 480,
        fx: float = 450.0,
        baseline: float = 0.11,
        seed: int = 0,
        max_imu_per_frame: int = 16,
        noise: "_NoiseModel | None" = None,
        trans_freq=(0.9, 0.7, 0.5),
        rot_freq=(0.8, 0.6, 1.1),
        trans_phase=(0.0, 1.0, 0.4),
        rot_phase=(0.3, 0.0, 0.7),
    ):
        self.n_frames = n_frames
        self.width, self.height = width, height
        self.fx, self.baseline = fx, baseline
        self.noise = noise or _NoiseModel(imu_rate)
        self.trans_freq = np.asarray(trans_freq)
        self.rot_freq = np.asarray(rot_freq)
        self.trans_phase = np.asarray(trans_phase)
        self.rot_phase = np.asarray(rot_phase)
        self.cx, self.cy = width / 2.0, height / 2.0
        self.plane_z = plane_z
        self.fps = fps
        self.trans_amp = np.asarray(trans_amp)
        self.rot_amp = np.asarray(rot_amp)
        # Texture spans the visible plane region generously.
        span_x = plane_z * width / fx * 1.6 + 2.0
        span_y = plane_z * height / fx * 1.6 + 2.0
        self.tex_res = 220.0  # texels per meter
        th = int(span_y * self.tex_res)
        tw = int(span_x * self.tex_res)
        self.texture = _smooth_texture(th, tw, seed=seed, scale=5)
        self.tex_origin = np.array([-span_x / 2, -span_y / 2])

        self.left_stamps = (np.arange(n_frames) * (1e9 / fps)).astype(np.int64)
        self.ground_truth = self._make_gt()

        n_imu = int(n_frames / fps * imu_rate) + 20
        t_imu_s = np.arange(n_imu) / imu_rate
        acc = np.zeros((n_imu, 3))
        gyr = np.zeros((n_imu, 3))
        h = 1e-4
        for i, t in enumerate(t_imu_s):
            R = self._rot(t)
            # Body-frame specific force: R^T (a_world - g)
            a_w = (self._pos(t + h) - 2 * self._pos(t) + self._pos(t - h)) / h**2
            acc[i] = R.T @ (a_w - GRAVITY)
            # Gyro: vee(R^T dR/dt)
            dR = (self._rot(t + h) - self._rot(t - h)) / (2 * h)
            Wx = R.T @ dR
            gyr[i] = np.array([Wx[2, 1], Wx[0, 2], Wx[1, 0]])
        acc, gyr = self.noise.corrupt_imu(acc, gyr)
        t_imu = (t_imu_s * 1e9).astype(np.int64)
        self.imu_sync = ImuSynchronizer(t_imu, acc, gyr, max_imu_per_frame)

    # -- analytic trajectory -------------------------------------------
    # Frequencies/phases are configurable: commensurate trans_freq ==
    # rot_freq makes the trajectory exactly periodic — the "orbit" mode
    # the loop-closure e2e test uses for guaranteed revisits.
    def _pos(self, t):
        a, w, ph = self.trans_amp, self.trans_freq, self.trans_phase
        return a * np.sin(w * t + ph)

    def _vel(self, t):
        a, w, ph = self.trans_amp, self.trans_freq, self.trans_phase
        return a * w * np.cos(w * t + ph)

    def _rot(self, t):
        r, w, ph = self.rot_amp, self.rot_freq, self.rot_phase
        ang = r * np.sin(w * t + ph)
        # xyz Euler composition (small angles; exact for GT consistency)
        cx_, sx = np.cos(ang[0]), np.sin(ang[0])
        cy_, sy = np.cos(ang[1]), np.sin(ang[1])
        cz, sz = np.cos(ang[2]), np.sin(ang[2])
        Rx = np.array([[1, 0, 0], [0, cx_, -sx], [0, sx, cx_]])
        Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        Rz = np.array([[cz, -sz, 0], [sz, 0 + cz, 0], [0, 0, 1]])
        return Rz @ Ry @ Rx

    def _make_gt(self):
        n = self.n_frames
        pos = np.zeros((n, 3))
        vel = np.zeros((n, 3))
        quat = np.zeros((n, 4))
        for k in range(n):
            t = k / self.fps
            pos[k] = self._pos(t)
            vel[k] = self._vel(t)
            R = self._rot(t)
            quat[k] = _np_rot_to_quat_wxyz(R)
        z = np.zeros((n, 3))
        return GroundTruth(
            stamps_ns=self.left_stamps.copy(), positions=pos,
            quats_wxyz=quat, velocities=vel, gyro_bias=z, accel_bias=z,
        )

    # -- rendering ------------------------------------------------------
    def load_image(self, key) -> np.ndarray:
        kind, k = key
        t = k / self.fps
        R = self._rot(t)
        p = self._pos(t)
        if kind == "right":
            p = p + R @ np.array([self.baseline, 0.0, 0.0])
        # Rays for all pixels -> plane z = plane_z.
        us, vs = np.meshgrid(
            np.arange(self.width), np.arange(self.height)
        )
        d_cam = np.stack(
            [
                (us - self.cx) / self.fx,
                (vs - self.cy) / self.fx,
                np.ones_like(us, dtype=np.float64),
            ],
            -1,
        )
        d_w = d_cam @ R.T  # (H,W,3) world ray directions
        s = (self.plane_z - p[2]) / d_w[..., 2]
        X = p[0] + s * d_w[..., 0]
        Y = p[1] + s * d_w[..., 1]
        tx = (X - self.tex_origin[0]) * self.tex_res
        ty = (Y - self.tex_origin[1]) * self.tex_res
        th, tw = self.texture.shape
        x0 = np.clip(np.floor(tx).astype(np.int64), 0, tw - 2)
        y0 = np.clip(np.floor(ty).astype(np.int64), 0, th - 2)
        fxw = np.clip(tx - x0, 0, 1)
        fyw = np.clip(ty - y0, 0, 1)
        img = (
            self.texture[y0, x0] * (1 - fxw) * (1 - fyw)
            + self.texture[y0, x0 + 1] * fxw * (1 - fyw)
            + self.texture[y0 + 1, x0] * (1 - fxw) * fyw
            + self.texture[y0 + 1, x0 + 1] * fxw * fyw
        )
        return self.noise.corrupt_image(
            img.astype(np.float32), k * 2 + (1 if kind == "right" else 0)
        )

    def frames(self):
        prev_t = None
        for k in range(self.n_frames):
            t = int(self.left_stamps[k])
            packet = {
                "index": k,
                "stamp_ns": t,
                "left_path": ("left", k),
                "right_path": ("right", k),
            }
            if prev_t is None:
                packet["imu"] = None
            else:
                packet["imu"] = self.imu_sync.block(prev_t, t)
                if packet["imu"] is None:
                    continue
            prev_t = t
            yield packet


def _np_rot_to_quat_wxyz(R):
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)
