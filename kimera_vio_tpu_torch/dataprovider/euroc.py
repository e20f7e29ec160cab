"""Frame<->IMU time synchronization and ground truth (host side).

Port of the host-side pieces of kimera_vio_tpu/dataprovider/euroc.py that
the synthetic main path needs: `GroundTruth` and `ImuSynchronizer` (the
reference DataProviderModule's frame<->IMU sync,
DataProviderModule.cpp:80-130, ThreadsafeImuBuffer's
getImuDataInterpolatedUpperBorder). Plain numpy; IMU blocks come out as
CPU tensors that the pipeline moves to its device.

`EurocDataProvider` (decodes PNGs with OpenCV) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kimera_vio_tpu_torch.common.types import ImuBlock


@dataclass
class GroundTruth:
    stamps_ns: np.ndarray  # (M,)
    positions: np.ndarray  # (M,3)
    quats_wxyz: np.ndarray  # (M,4)
    velocities: np.ndarray  # (M,3)
    gyro_bias: np.ndarray  # (M,3)
    accel_bias: np.ndarray  # (M,3)

    def state_at(self, stamp_ns: int):
        """Nearest GT state (used for initialization from GT, reference
        autoInitialize=0 path seeding initial_ground_truth_state_)."""
        i = int(np.argmin(np.abs(self.stamps_ns - stamp_ns)))
        return {
            "position": self.positions[i],
            "quat_wxyz": self.quats_wxyz[i],
            "velocity": self.velocities[i],
            "gyro_bias": self.gyro_bias[i],
            "accel_bias": self.accel_bias[i],
        }


class ImuSynchronizer:
    """Vectorized equivalent of ThreadsafeImuBuffer's
    getImuDataInterpolatedUpperBorder (utils/ThreadsafeImuBuffer.h:59-192):
    returns, for a query interval (t0, t1], the raw samples inside plus an
    interpolated sample exactly at t1, as a fixed-capacity masked block."""

    def __init__(self, stamps_ns: np.ndarray, acc: np.ndarray, gyr: np.ndarray, max_per_block: int = 16):
        order = np.argsort(stamps_ns)
        self.t = stamps_ns[order].astype(np.int64)
        self.acc = acc[order].astype(np.float32)
        self.gyr = gyr[order].astype(np.float32)
        self.max_per_block = max_per_block

    def block(self, t0_ns: int, t1_ns: int) -> ImuBlock | None:
        """Samples in (t0, t1] with the last one interpolated at t1.
        Returns None if the IMU stream doesn't cover the interval."""
        if t1_ns > self.t[-1] or t0_ns < self.t[0]:
            return None
        lo = np.searchsorted(self.t, t0_ns, side="right")
        hi = np.searchsorted(self.t, t1_ns, side="right")
        ts = list(self.t[lo:hi])
        accs = list(self.acc[lo:hi])
        gyrs = list(self.gyr[lo:hi])
        if not ts or ts[-1] != t1_ns:
            # Interpolate the upper-border sample at t1.
            j = hi  # first sample strictly after t1
            if j >= len(self.t):
                return None
            ta, tb = self.t[j - 1], self.t[j]
            w = (t1_ns - ta) / max(tb - ta, 1)
            accs.append((1 - w) * self.acc[j - 1] + w * self.acc[j])
            gyrs.append((1 - w) * self.gyr[j - 1] + w * self.gyr[j])
            ts.append(t1_ns)
        n = len(ts)
        cap = self.max_per_block
        dts = np.diff(np.concatenate([[t0_ns], ts])).astype(np.float64) * 1e-9
        while n > cap:
            # Over-long interval (dropped frames / dataset gap): merge
            # adjacent sample pairs (dt-weighted average) — preserves the
            # preintegration integral instead of discarding samples.
            accs_a = np.stack(accs)
            gyrs_a = np.stack(gyrs)
            m = n // 2 * 2
            w = dts[:m].reshape(-1, 2)
            wsum = np.maximum(w.sum(1, keepdims=True), 1e-12)
            acc_m = (accs_a[:m].reshape(-1, 2, 3) * w[..., None]).sum(1) / wsum
            gyr_m = (gyrs_a[:m].reshape(-1, 2, 3) * w[..., None]).sum(1) / wsum
            dts_m = w.sum(1)
            if n % 2:
                acc_m = np.concatenate([acc_m, accs_a[-1:]])
                gyr_m = np.concatenate([gyr_m, gyrs_a[-1:]])
                dts_m = np.concatenate([dts_m, dts[-1:]])
            accs, gyrs, dts = list(acc_m), list(gyr_m), dts_m
            n = len(accs)
        acc = np.zeros((cap, 3), np.float32)
        gyr = np.zeros((cap, 3), np.float32)
        dt = np.zeros((cap,), np.float32)
        mask = np.zeros((cap,), bool)
        acc[:n] = np.stack(accs)
        gyr[:n] = np.stack(gyrs)
        dt[:n] = dts
        mask[:n] = True
        return ImuBlock(
            acc=torch.from_numpy(acc),
            gyr=torch.from_numpy(gyr),
            dt=torch.from_numpy(dt),
            mask=torch.from_numpy(mask),
        )
