"""RgbdImuPipeline: RGB + depth + IMU.

Port of kimera_vio_tpu/pipeline/rgbd_pipeline.py (the reference's
RgbdImuPipeline, src/pipeline/RgbdImuPipeline.cpp): each keypoint's depth
becomes a virtual-stereo disparity under a nominal baseline
(RgbdCamera.cpp:92-104), and the backend runs unchanged on the (uL, uR, v)
measurements. The provider's "right_path" loads the metric DEPTH image
(float32 metres; dataprovider/rgbd.py). No mesher, as in the reference.
"""

from __future__ import annotations

import torch

from kimera_vio_tpu_torch.config.params import VioParams
from kimera_vio_tpu_torch.frontend.camera import StereoCamera
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendConfig, _f32
from kimera_vio_tpu_torch.pipeline.mono_pipeline import mono_rig
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline


class RgbdImuPipeline(StereoImuPipeline):
    def __init__(self, params: VioParams, output_path: str | None = None,
                 parallel_run: bool | None = None, virtual_baseline: float | None = None,
                 device: str | torch.device = "cuda", enable_lcd: bool = False):
        self._virtual_baseline = (virtual_baseline if virtual_baseline is not None
                                  else params.frontend.nominal_baseline)
        super().__init__(params, output_path=output_path, parallel_run=parallel_run,
                         device=device, enable_lcd=enable_lcd)

    def _build_rig(self, params) -> StereoCamera:
        # Identity rectification with the virtual baseline: the depth image
        # is metric already and is not remapped.
        return mono_rig(params.left_cam, self._virtual_baseline, self.device)

    def _build_frontend_cfg(self, params) -> FrontendConfig:
        # The default tracker: KIMERA_LK_IMPL is the stereo pipeline's, as in
        # the JAX package.
        cfg = FrontendConfig.from_params(params.frontend, max_features=params.max_features)
        cfg.rgbd = True
        cfg.depth_min = _f32(params.frontend.min_point_dist)
        cfg.depth_max = _f32(params.frontend.max_point_dist)
        return cfg
