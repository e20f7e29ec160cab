"""IMU-camera time-offset estimation by cross-correlation.

Port of kimera_vio_tpu/initial/time_alignment.py (the reference's
CrossCorrTimeAligner, src/initial/CrossCorrTimeAligner.cpp:20-140,
attemptEstimation :294): the per-sample gyro rotation magnitude and the
per-keyframe visual rotation magnitude, spread over the keyframe's IMU
samples, are buffered at IMU rate; once the IMU signal's variance clears
its gate, the offset is the argmax of their full cross-correlation (one
`conv1d` on `device`, float32). The result feeds the data provider's
`imu_time_shift_ns` (VisionImuFrontend.cpp:77-83).
"""

from __future__ import annotations

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device


def correlate_full(a: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    """`np.correlate(a, b, "full")` of two float32 signals of one length
    m: out[i] = sum_n a[n + i - (m - 1)] b[n]."""
    m = len(a)
    ta = torch.as_tensor(a, dtype=torch.float32, device=device)
    tb = torch.as_tensor(b, dtype=torch.float32, device=device)
    out = torch.nn.functional.conv1d(ta[None, None], tb[None, None], padding=m - 1)
    return out[0, 0].cpu().numpy()


class CrossCorrTimeAligner:
    def __init__(self, window_size_s: float = 10.0, imu_rate_hz: float = 200.0,
                 variance_threshold_scaling: float = 30.0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.n = int(window_size_s * imu_rate_hz)
        self.dt = 1.0 / imu_rate_hz
        self.variance_threshold_scaling = variance_threshold_scaling
        self.imu_signal: list[float] = []  # |w| dt per IMU sample
        self.imu_stamps: list[int] = []
        self.vis_signal: list[float] = []  # visual rotation, at IMU rate
        self.vis_stamps: list[int] = []
        self.estimate_s: float | None = None

    def add_imu(self, stamp_ns: int, gyro: np.ndarray, dt_s: float):
        self.imu_signal.append(float(np.linalg.norm(gyro) * dt_s))
        self.imu_stamps.append(stamp_ns)
        if len(self.imu_signal) > self.n:
            self.imu_signal.pop(0)
            self.imu_stamps.pop(0)

    def add_frame_rotation(self, stamp_ns: int, angle_rad: float, n_imu: int):
        """Spread the inter-keyframe visual rotation over its IMU samples
        (the reference's IMU-rate mode)."""
        per = angle_rad / max(n_imu, 1)
        for _ in range(max(n_imu, 1)):
            self.vis_signal.append(per)
            self.vis_stamps.append(stamp_ns)
        while len(self.vis_signal) > self.n:
            self.vis_signal.pop(0)
            self.vis_stamps.pop(0)

    def attempt_estimation(self) -> float | None:
        """The IMU-minus-camera offset in seconds, or None while the window
        is under half full or lacks excitation (the variance gate)."""
        m = min(len(self.imu_signal), len(self.vis_signal))
        if m < self.n // 2:
            return None
        a = np.asarray(self.imu_signal[-m:], np.float32)
        b = np.asarray(self.vis_signal[-m:], np.float32)
        var_gate = self.variance_threshold_scaling * np.var(np.diff(a)) if m > 1 else 0
        if np.var(a) < var_gate or np.var(a) < 1e-10:
            return None
        corr = correlate_full(a - a.mean(), b - b.mean(), self.device)
        # A peak at index i means b lags a by (m - 1 - i) samples.
        lag = (m - 1) - int(np.argmax(corr))
        self.estimate_s = lag * self.dt
        return self.estimate_s
