"""KITTI raw-dataset provider.

Port of kimera_vio_tpu/dataprovider/kitti.py (the reference
KittiDataProvider, src/dataprovider/KittiDataProvider.cpp): parses a KITTI
raw sequence folder

    <seq>/image_00/{timestamps.txt,data/*.png}   (left gray)
    <seq>/image_01/{...}                         (right gray)
    <seq>/oxts/{timestamps.txt,data/*.txt}       (GPS/IMU @ ~100 Hz)

into the packet stream of the EuRoC provider (stereo frames and
interpolated-upper-border IMU blocks), so every pipeline runs unchanged.
OXTS rows: lat lon alt roll pitch yaw vn ve vf vl vu ax ay az af al au
wx wy wz wf wl wu ... — body-frame accelerations are columns 11..13 (ax,
ay, az) and body rates 17..19 (wx, wy, wz). The right frame is the one
with the nearest stamp. Images decode with `dataprovider/png.py` (the
JAX package reads them with OpenCV). KITTI's poses live in a separate
devkit: `ground_truth` is None until a caller attaches one.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np

from kimera_vio_tpu_torch.dataprovider.euroc import ImuSynchronizer
from kimera_vio_tpu_torch.dataprovider.png import decode_png_gray8


def _parse_timestamps(path: str) -> np.ndarray:
    """KITTI timestamps.txt ("YYYY-MM-DD hh:mm:ss.fffffffff" a line) ->
    int64 ns: the date's local midnight plus the time of day, as the JAX
    package computes it (float seconds of the day times 1e9, truncated)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            date, tm = line.split(" ")
            hh, mm, ss = tm.split(":")
            secs = float(ss) + 60 * int(mm) + 3600 * int(hh)
            d = datetime.strptime(date, "%Y-%m-%d")
            base = int(d.timestamp()) * 1_000_000_000
            out.append(base + int(secs * 1e9))
    return np.asarray(out, np.int64)


class KittiDataProvider:
    def __init__(
        self,
        sequence_path: str,
        initial_k: int = 0,
        final_k: int | None = None,
        max_imu_per_frame: int = 16,
    ):
        self.root = sequence_path
        self.left_stamps = _parse_timestamps(os.path.join(sequence_path, "image_00", "timestamps.txt"))
        left_dir = os.path.join(sequence_path, "image_00", "data")
        self.left_files = sorted(os.path.join(left_dir, f) for f in os.listdir(left_dir))
        right_dir = os.path.join(sequence_path, "image_01", "data")
        self.has_right = os.path.isdir(right_dir)
        if self.has_right:
            self.right_stamps = _parse_timestamps(
                os.path.join(sequence_path, "image_01", "timestamps.txt"))
            self.right_files = sorted(os.path.join(right_dir, f) for f in os.listdir(right_dir))
        # OXTS -> IMU stream.
        oxts_stamps = _parse_timestamps(os.path.join(sequence_path, "oxts", "timestamps.txt"))
        oxts_dir = os.path.join(sequence_path, "oxts", "data")
        oxts = np.stack([np.loadtxt(os.path.join(oxts_dir, f), dtype=np.float64)
                         for f in sorted(os.listdir(oxts_dir))])
        self.imu_sync = ImuSynchronizer(oxts_stamps, oxts[:, 11:14], oxts[:, 17:20],
                                        max_imu_per_frame)
        self.ground_truth = None  # KITTI GT poses live in a separate devkit
        self.initial_k = initial_k
        self.final_k = final_k if final_k is not None else len(self.left_stamps)

    def __len__(self):
        return self.final_k - self.initial_k

    def load_image(self, path: str) -> np.ndarray:
        """The frame as an (H, W) uint8 array."""
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return decode_png_gray8(path)

    def frames(self):
        prev_t = None
        for k in range(self.initial_k, self.final_k):
            t = int(self.left_stamps[k])
            packet = {"index": k, "stamp_ns": t, "left_path": self.left_files[k]}
            if self.has_right:
                j = int(np.argmin(np.abs(self.right_stamps - t)))
                packet["right_path"] = self.right_files[j]
            if prev_t is None:
                packet["imu"] = None
            else:
                blk = self.imu_sync.block(prev_t, t)
                if blk is None:
                    continue
                packet["imu"] = blk
            prev_t = t
            yield packet
