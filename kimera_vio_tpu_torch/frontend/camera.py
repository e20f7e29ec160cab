"""Camera models: distortion, undistortion, stereo rectification, remap.

Port of kimera_vio_tpu/frontend/camera.py for pinhole cameras with
radial-tangential or equidistant distortion (or none): iterative
undistortion, bearing vectors, Bouguet-style stereo
rectification, keypoint rectification, the dense rectification map (numpy,
built once per rig) and the bilinear image remap. The reference runs the
dense remap as a separable shifted-select resample (`SeparableRemap`),
a TPU workaround for slow gathers; on the GPU the remap is the plain
4-tap gather `remap_bilinear`. Omni (OCamCalib) cameras are not ported.

Camera constants are 0-d float32 tensors on the pipeline's device, so the
arithmetic rounds as the reference's float32 scalars do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.config.params import CameraParams

DIST_NONE = 0
DIST_RADTAN = 1
DIST_EQUIDISTANT = 2

_DIST_CODES = {
    "none": DIST_NONE,
    "plumb_bob": DIST_RADTAN,
    "radial-tangential": DIST_RADTAN,
    "radtan": DIST_RADTAN,
    "equidistant": DIST_EQUIDISTANT,
    "kannala_brandt": DIST_EQUIDISTANT,
}


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@dataclass
class PinholeCamera:
    """Intrinsics + distortion + body-from-camera extrinsics."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # (5,)
    R_bc: torch.Tensor  # (3,3)
    t_bc: torch.Tensor  # (3,)
    dist_model: int = DIST_RADTAN
    width: int = 752
    height: int = 480

    @classmethod
    def from_params(cls, p: CameraParams, device="cuda") -> "PinholeCamera":
        device = resolve_device(device)
        if getattr(p, "camera_model", "pinhole") == "omni":
            raise NotImplementedError("omni cameras are not ported")
        d = np.zeros(5)
        d[: min(5, len(p.distortion_coeffs))] = p.distortion_coeffs[:5]
        intr = np.asarray(p.intrinsics, np.float64)
        return cls(
            fx=_f32(intr[0], device),
            fy=_f32(intr[1], device),
            cx=_f32(intr[2], device),
            cy=_f32(intr[3], device),
            dist=_f32(d, device),
            R_bc=_f32(p.T_BS[:3, :3], device),
            t_bc=_f32(p.T_BS[:3, 3], device),
            dist_model=_DIST_CODES[p.distortion_model],
            width=p.width,
            height=p.height,
        )


def distort(cam: PinholeCamera, xy: torch.Tensor) -> torch.Tensor:
    """Apply the distortion model to normalized coords xy (...,2)."""
    if cam.dist_model == DIST_NONE:
        return xy
    x, y = xy[..., 0], xy[..., 1]
    k1, k2, p1, p2 = cam.dist[0], cam.dist[1], cam.dist[2], cam.dist[3]
    if cam.dist_model == DIST_RADTAN:
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return torch.stack([xd, yd], dim=-1)
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1 + k1 * t2 + k2 * t2**2 + p1 * t2**3 + p2 * t2**4)
    scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-8), torch.ones_like(r))
    return xy * scale[..., None]


def undistort_to_normalized(cam: PinholeCamera, uv: torch.Tensor, iters: int = 25) -> torch.Tensor:
    """Pixels (...,2) -> undistorted normalized coords by fixed-point
    iteration (cv::undistortPoints)."""
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    target = torch.stack([xd, yd], dim=-1)
    if cam.dist_model == DIST_NONE:
        return target
    xy = target
    for _ in range(iters):
        xy = xy - (distort(cam, xy) - target)
    return xy


def backproject(cam: PinholeCamera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels + depth (z) -> camera-frame 3D points."""
    xy = undistort_to_normalized(cam, uv)
    ones = torch.ones_like(xy[..., :1])
    return torch.cat([xy, ones], dim=-1) * depth[..., None]


def bearing_vectors(cam: PinholeCamera, uv: torch.Tensor) -> torch.Tensor:
    """Unit bearing vectors in the camera frame for distorted pixels."""
    xy = undistort_to_normalized(cam, uv)
    ones = torch.ones_like(xy[..., :1])
    v = torch.cat([xy, ones], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


@dataclass
class StereoCamera:
    """A rectified stereo rig: shared rectified intrinsics, baseline,
    rectifying rotations, body-from-rectified-left pose."""

    left: PinholeCamera
    right: PinholeCamera
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    baseline: torch.Tensor
    R_rect_l: torch.Tensor
    R_rect_r: torch.Tensor
    R_b_rect: torch.Tensor
    t_b_rect: torch.Tensor

    @classmethod
    def from_params(cls, left_p: CameraParams, right_p: CameraParams, device="cuda") -> "StereoCamera":
        """Bouguet-style rectification computed on the host in float64
        (what cv::stereoRectify does), stored as float32 tensors."""
        device = resolve_device(device)
        from scipy.spatial.transform import Rotation

        left = PinholeCamera.from_params(left_p, device)
        right = PinholeCamera.from_params(right_p, device)
        T_b_l = np.asarray(left_p.T_BS, np.float64)
        T_b_r = np.asarray(right_p.T_BS, np.float64)
        T_r_l = np.linalg.inv(T_b_r) @ T_b_l
        R = T_r_l[:3, :3]
        t = T_r_l[:3, 3]
        om = Rotation.from_matrix(R).as_rotvec()
        r_fwd = Rotation.from_rotvec(0.5 * om).as_matrix()
        r_back = r_fwd.T
        t_rect = r_back @ t
        b = np.linalg.norm(t_rect)
        uu = np.array([1.0 if t_rect[0] > 0 else -1.0, 0.0, 0.0])
        ww = np.cross(t_rect, uu)
        nw = np.linalg.norm(ww)
        angle = np.arccos(np.clip(abs(t_rect[0]) / b, -1.0, 1.0))
        wR = Rotation.from_rotvec(ww / nw * angle).as_matrix() if nw > 1e-12 else np.eye(3)
        R_rect_l = wR @ r_fwd
        R_rect_r = wR @ r_back
        f_new = float(left_p.intrinsics[1])
        cx_new = left_p.width / 2.0
        cy_new = left_p.height / 2.0
        R_b_rect = T_b_l[:3, :3] @ R_rect_l.T
        t_b_rect = T_b_l[:3, 3]
        return cls(
            left=left,
            right=right,
            fx=_f32(f_new, device),
            fy=_f32(f_new, device),
            cx=_f32(cx_new, device),
            cy=_f32(cy_new, device),
            baseline=_f32(b, device),
            R_rect_l=_f32(R_rect_l, device),
            R_rect_r=_f32(R_rect_r, device),
            R_b_rect=_f32(R_b_rect, device),
            t_b_rect=_f32(t_b_rect, device),
        )

    def backproject_rect(self, uLuRv: torch.Tensor) -> torch.Tensor:
        """Stereo measurement -> rectified-left 3D point."""
        uL, uR, v = uLuRv[..., 0], uLuRv[..., 1], uLuRv[..., 2]
        disp = torch.clamp(uL - uR, min=1e-6)
        z = self.fx * self.baseline / disp
        x = (uL - self.cx) * z / self.fx
        y = (v - self.cy) * z / self.fy
        return torch.stack([x, y, z], dim=-1)


def rectify_keypoints(stereo: StereoCamera, cam: PinholeCamera, R_rect, uv):
    """Distorted pixels in `cam` -> rectified pixels (shared intrinsics)."""
    xy = undistort_to_normalized(cam, uv)
    ones = torch.ones_like(xy[..., :1])
    rays = torch.cat([xy, ones], dim=-1)
    rays_rect = (R_rect @ rays[..., None])[..., 0]
    z = torch.clamp(rays_rect[..., 2], min=1e-8)
    u = stereo.fx * rays_rect[..., 0] / z + stereo.cx
    v = stereo.fy * rays_rect[..., 1] / z + stereo.cy
    return torch.stack([u, v], dim=-1)


def _distort_np(dist_model: int, dist: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Numpy mirror of `distort` for construction-time map building."""
    if dist_model == DIST_NONE:
        return xy
    x, y = xy[..., 0], xy[..., 1]
    k1, k2, p1, p2 = (float(v) for v in dist[:4])
    if dist_model == DIST_RADTAN:
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return np.stack([xd, yd], axis=-1)
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + k1 * t2 + k2 * t2**2 + p1 * t2**3 + p2 * t2**4)
    scale = np.where(r > 1e-8, theta_d / np.maximum(r, 1e-8), 1.0)
    return xy * scale[..., None]


def rectification_map(stereo: StereoCamera, cam: PinholeCamera, R_rect) -> np.ndarray:
    """(H, W, 2) float32: for every rectified pixel, the (x, y) source
    position in the distorted image (cv::initUndistortRectifyMap);
    numpy on the host, once per rig."""
    H, W = cam.height, cam.width
    ys = np.arange(H, dtype=np.float64)
    xs = np.arange(W, dtype=np.float64)
    vv, uu = np.meshgrid(ys, xs, indexing="ij")
    x = (uu - float(stereo.cx)) / float(stereo.fx)
    y = (vv - float(stereo.cy)) / float(stereo.fy)
    rays_rect = np.stack([x, y, np.ones_like(x)], axis=-1)
    Rt = np.asarray(R_rect.cpu(), np.float64).T
    rays = rays_rect @ Rt.T
    z = np.maximum(rays[..., 2], 1e-8)
    xy = rays[..., 0:2] / z[..., None]
    xyd = _distort_np(cam.dist_model, cam.dist.cpu().numpy(), xy)
    u = float(cam.fx) * xyd[..., 0] + float(cam.cx)
    v = float(cam.fy) * xyd[..., 1] + float(cam.cy)
    return np.stack([u, v], axis=-1).astype(np.float32)


def remap_bilinear(img: torch.Tensor, mapxy: torch.Tensor) -> torch.Tensor:
    """Bilinear remap of img (H,W) by a map (H,W,2) of source coords;
    out-of-bounds reads clamp to the border."""
    H, W = img.shape[-2], img.shape[-1]
    x = mapxy[..., 0]
    y = mapxy[..., 1]
    x0 = torch.clamp(torch.floor(x), 0, W - 2)
    y0 = torch.clamp(torch.floor(y), 0, H - 2)
    wx = torch.clamp(x - x0, 0.0, 1.0)
    wy = torch.clamp(y - y0, 0.0, 1.0)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    img_f = img.to(torch.float32)
    v00 = img_f[y0i, x0i]
    v01 = img_f[y0i, x0i + 1]
    v10 = img_f[y0i + 1, x0i]
    v11 = img_f[y0i + 1, x0i + 1]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy
