"""Synthetic stereo-inertial dataset with exact ground truth.

Port of kimera_vio_tpu/dataprovider/synthetic.py (`synthetic_params`,
`SyntheticStereoProvider`); plain numpy + scipy, identical output.

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
