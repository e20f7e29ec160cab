"""RGB-D dataset provider for EuRoC-style trees (uHumans2 / KinectAzure
class).

Port of kimera_vio_tpu/dataprovider/rgbd.py (the reference's
RgbdDataProviderModule): a EuRoC `mav0` folder with a depth stream beside
cam0,

    mav0/
      cam0/data.csv   + cam0/data/<stamp>.png    (8-bit grayscale)
      depth0/data.csv + depth0/data/<stamp>.png  (16-bit depth PNG)
      imu0/data.csv
      state_groundtruth_estimate0/data.csv       (optional)

Each frame packet carries the nearest-stamp depth image as "right_path";
`load_image` decodes it to float32 metres (raw * depth_factor) with depth
outside [min_depth, max_depth] set to 0 (invalid), as RgbdImuPipeline
expects. PNGs are decoded by dataprovider/png.py (no OpenCV).
"""

from __future__ import annotations

import os

import numpy as np

from kimera_vio_tpu_torch.dataprovider.euroc import EurocDataProvider, _read_csv
from kimera_vio_tpu_torch.dataprovider.png import decode_png_gray


class RgbdDataProvider(EurocDataProvider):
    def __init__(self, dataset_path: str, depth_factor: float = 1.0e-3, min_depth: float = 0.0,
                 max_depth: float = 10.0, depth_dir: str = "depth0", **kw):
        """depth_factor: metres per raw depth unit (1e-3 for the usual
        millimetre 16-bit PNGs; the KinectAzure params' depth_to_meters)."""
        super().__init__(dataset_path, mono=True, **kw)
        self.depth_factor = float(depth_factor)
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        ddir = os.path.join(self.root, depth_dir)
        if not os.path.isdir(ddir):
            raise FileNotFoundError(f"no depth stream at {ddir}")
        rows = _read_csv(os.path.join(ddir, "data.csv"))
        self.depth_stamps = np.array([int(r[0]) for r in rows], np.int64)
        self.depth_files = [os.path.join(ddir, "data", r[1].strip()) for r in rows]
        self._depth_prefix = os.path.join(ddir, "data")

    def load_image(self, path: str) -> np.ndarray:
        """cam0 frames as EurocDataProvider gives them; depth images as
        (H, W) float32 metres, out-of-range depth 0."""
        if not path.startswith(self._depth_prefix):
            return super().load_image(path)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        depth = decode_png_gray(path).astype(np.float32) * np.float32(self.depth_factor)
        depth[(depth < self.min_depth) | (depth > self.max_depth)] = 0.0
        return depth

    def frames(self):
        """EuRoC frame packets with the nearest-stamp depth image as
        "right_path"."""
        for packet in super().frames():
            j = int(np.argmin(np.abs(self.depth_stamps - packet["stamp_ns"])))
            packet["right_path"] = self.depth_files[j]
            yield packet
