"""MonoImuPipeline: monocular + IMU.

Port of kimera_vio_tpu/pipeline/mono_pipeline.py (the reference's
MonoImuPipeline, src/pipeline/MonoImuPipeline.cpp): one camera, mono
(NaN-uR) measurements, mono RANSAC only. The rig is a degenerate
StereoCamera whose rectification is plain undistortion (R_rect = I, the
camera's own intrinsics, left == right), so every stereo-shaped op
downstream runs with uR masked.
"""

from __future__ import annotations

import numpy as np
import torch

from kimera_vio_tpu_torch.config.params import CameraParams, VioParams
from kimera_vio_tpu_torch.frontend.camera import PinholeCamera, StereoCamera, _f32
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendConfig
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline


def mono_rig(cam_params: CameraParams, nominal_baseline: float = 0.11,
             device: str | torch.device = "cuda") -> StereoCamera:
    """The degenerate rig of the mono and RGB-D pipelines: identity
    rectification, the camera's intrinsics, and a virtual baseline (only
    read by paths that mono measurements mask out, and by the RGB-D
    depth-to-disparity conversion)."""
    cam = PinholeCamera.from_params(cam_params, device)
    T = np.asarray(cam_params.T_BS, np.float64)
    eye = torch.eye(3, device=cam.fx.device)
    return StereoCamera(
        left=cam, right=cam, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        baseline=_f32(nominal_baseline, cam.fx.device), R_rect_l=eye, R_rect_r=eye.clone(),
        R_b_rect=_f32(T[:3, :3], cam.fx.device), t_b_rect=_f32(T[:3, 3], cam.fx.device),
    )


class MonoImuPipeline(StereoImuPipeline):
    """Mono + IMU VIO. Without stereo, scale is observable only through the
    IMU, so accuracy depends on accelerometer excitation (as in the
    reference's mono pipeline). Online initialization is a stereo feature
    and does not run here, as in the JAX package."""

    def __init__(self, params: VioParams, output_path: str | None = None,
                 parallel_run: bool | None = None, device: str | torch.device = "cuda",
                 enable_lcd: bool = False):
        super().__init__(params, output_path=output_path, parallel_run=parallel_run,
                         device=device, enable_lcd=enable_lcd)

    def _build_rig(self, params) -> StereoCamera:
        return mono_rig(params.left_cam, params.frontend.nominal_baseline, self.device)

    def _build_frontend_cfg(self, params) -> FrontendConfig:
        # The default tracker: KIMERA_LK_IMPL is the stereo pipeline's, as in
        # the JAX package.
        cfg = FrontendConfig.from_params(params.frontend, max_features=params.max_features)
        cfg.mono = True
        return cfg
