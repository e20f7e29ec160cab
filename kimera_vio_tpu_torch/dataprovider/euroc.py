"""EuRoC ASL dataset provider + IMU/frame time synchronization (host side).

Port of kimera_vio_tpu/dataprovider/euroc.py (reference
src/dataprovider/EurocDataProvider.cpp:109-458 and the DataProviderModule's
frame<->IMU sync, DataProviderModule.cpp:80-130, ThreadsafeImuBuffer's
getImuDataInterpolatedUpperBorder):

  * parses mav0/{cam0,cam1}/data.csv image lists, imu0/data.csv, and
    state_groundtruth_estimate0/data.csv,
  * `initial_k` / `final_k` frame windowing (EurocDataProvider.cpp:41-48),
  * per-frame IMU blocks over (t_prev, t_cur] with the boundary sample
    interpolated at t_cur,
  * images decoded lazily to uint8 numpy arrays by `dataprovider/png.py`
    (the JAX package uses OpenCV, which the card's machine lacks).

Plain numpy; IMU blocks come out as CPU tensors that the pipeline moves to
its device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from kimera_vio_tpu_torch.common.types import ImuBlock
from kimera_vio_tpu_torch.dataprovider.png import decode_png_gray8, equalize_hist


def _read_csv(path: str) -> list:
    rows = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(line.split(","))
    return rows


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


class EurocDataProvider:
    """Parses a EuRoC `mav0` folder and yields time-synced stereo frames.

    Iteration yields dicts with int64 ns timestamps, image paths (decoded
    by `load_image` into uint8 arrays) and the per-frame ImuBlock."""

    def __init__(
        self,
        dataset_path: str,
        initial_k: int = 0,
        final_k: int | None = None,
        max_imu_per_frame: int = 16,
        imu_time_shift_ns: int = 0,
        equalize: bool = False,
        do_coarse_imu_camera_temporal_sync: bool = False,
        mono: bool = False,
    ):
        mav0 = dataset_path
        if os.path.isdir(os.path.join(dataset_path, "mav0")):
            mav0 = os.path.join(dataset_path, "mav0")
        self.root = mav0
        self.equalize = equalize
        self.imu_time_shift_ns = imu_time_shift_ns
        self._do_coarse_sync = do_coarse_imu_camera_temporal_sync
        self.imu_timestamp_correction_ns = 0

        arr = np.array(_read_csv(os.path.join(mav0, "imu0", "data.csv")), dtype=np.float64)
        self.imu_stamps_ns = arr[:, 0].astype(np.int64)
        self.imu_sync = ImuSynchronizer(self.imu_stamps_ns, arr[:, 4:7], arr[:, 1:4],
                                        max_imu_per_frame)

        def cam_list(cam):
            rows = _read_csv(os.path.join(mav0, cam, "data.csv"))
            stamps = np.array([int(r[0]) for r in rows], np.int64)
            files = [os.path.join(mav0, cam, "data", r[1].strip()) for r in rows]
            return stamps, files

        self.left_stamps, self.left_files = cam_list("cam0")
        # mono=True feeds cam0 only (the reference MonoDataProviderModule
        # parses the same EuRoC tree).
        self.has_right = (not mono) and os.path.isdir(os.path.join(mav0, "cam1"))
        if self.has_right:
            self.right_stamps, self.right_files = cam_list("cam1")

        gt_csv = os.path.join(mav0, "state_groundtruth_estimate0", "data.csv")
        self.ground_truth: GroundTruth | None = None
        if os.path.exists(gt_csv):
            g = np.array(_read_csv(gt_csv), dtype=np.float64)
            zeros = np.zeros((len(g), 3))
            self.ground_truth = GroundTruth(
                stamps_ns=g[:, 0].astype(np.int64),
                positions=g[:, 1:4],
                quats_wxyz=g[:, 4:8],
                velocities=g[:, 8:11] if g.shape[1] > 10 else zeros,
                gyro_bias=g[:, 11:14] if g.shape[1] > 13 else zeros,
                accel_bias=g[:, 14:17] if g.shape[1] > 16 else zeros,
            )

        self.initial_k = initial_k
        self.final_k = final_k if final_k is not None else len(self.left_stamps)

    def __len__(self):
        return self.final_k - self.initial_k

    def load_image(self, path: str) -> np.ndarray:
        """The frame as an (H, W) uint8 array (equalized if asked)."""
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        img = decode_png_gray8(path)
        return equalize_hist(img) if self.equalize else img

    def frames(self):
        """Generator of synced stereo+IMU packets."""
        prev_t = None
        for k in range(self.initial_k, self.final_k):
            if self._do_coarse_sync:
                # Coarse IMU-camera clock alignment on the first frame
                # (reference DataProviderModule.cpp:110-120): the IMU
                # sample nearest this frame.
                i = int(np.clip(np.searchsorted(self.imu_stamps_ns, self.left_stamps[k]),
                                0, len(self.imu_stamps_ns) - 1))
                self.imu_timestamp_correction_ns = int(self.imu_stamps_ns[i] - self.left_stamps[k])
                self._do_coarse_sync = False
            t = int(self.left_stamps[k]) + self.imu_time_shift_ns + self.imu_timestamp_correction_ns
            packet = {
                "index": k,
                "stamp_ns": int(self.left_stamps[k]),
                "left_path": self.left_files[k],
            }
            if self.has_right:
                # Right frame by nearest stamp (EuRoC is hardware synced).
                j = int(np.argmin(np.abs(self.right_stamps - self.left_stamps[k])))
                packet["right_path"] = self.right_files[j]
            if prev_t is None:
                packet["imu"] = None  # first frame: no preintegration
            else:
                blk = self.imu_sync.block(prev_t, t)
                if blk is None:
                    # IMU not covering (start/end of stream): drop the
                    # frame, like the reference's FrameAction::Drop.
                    continue
                packet["imu"] = blk
            prev_t = t
            yield packet
