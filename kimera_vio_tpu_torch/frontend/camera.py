"""Camera models: distortion, undistortion, stereo rectification, remap.

Port of kimera_vio_tpu/frontend/camera.py: pinhole cameras with
radial-tangential or equidistant distortion (or none), and OCamCalib omni
cameras (backprojection through the z-polynomial, projection by a Newton
inversion of it); iterative undistortion, bearing vectors, Bouguet-style stereo
rectification, keypoint rectification, the dense rectification map (numpy,
built once per rig) and the two image remaps: `SeparableRemap`, the
fixed-map resample the frontend rectifies keyframes with (a vertical
then a horizontal 2-tap pass, the JAX package's function computed by
gathers instead of its tap loop), and the 4-tap gather `remap_bilinear`
(the mesher's dense depth, as in the JAX package).

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
DIST_OMNI = 3

_DIST_CODES = {
    "none": DIST_NONE,
    "plumb_bob": DIST_RADTAN,
    "radial-tangential": DIST_RADTAN,
    "radtan": DIST_RADTAN,
    "equidistant": DIST_EQUIDISTANT,
    "kannala_brandt": DIST_EQUIDISTANT,
    "omni": DIST_OMNI,
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
    # OCamCalib omni model (CameraParams.cpp:62-95): the distortion centre
    # and the inverse of the pixel -> sensor-plane affine.
    omni_center: torch.Tensor | None = None  # (2,)
    omni_affine_inv: torch.Tensor | None = None  # (2,2)
    dist_model: int = DIST_RADTAN
    width: int = 752
    height: int = 480

    @classmethod
    def from_params(cls, p: CameraParams, device="cuda") -> "PinholeCamera":
        device = resolve_device(device)
        d = np.zeros(5)
        d[: min(5, len(p.distortion_coeffs))] = p.distortion_coeffs[:5]
        model = (DIST_OMNI if getattr(p, "camera_model", "pinhole") == "omni"
                 else _DIST_CODES[p.distortion_model])
        center = np.zeros(2)
        affine = np.eye(2)
        intr = np.asarray(p.intrinsics, np.float64)
        if model == DIST_OMNI:
            center = np.asarray(p.omni_distortion_center, np.float64)
            c_, d_, e_ = p.omni_affine  # A = [[1, c], [d, e]]
            affine = np.linalg.inv(np.array([[1.0, c_], [d_, e_]]))
            if intr.size < 4:
                # Omni params leave the intrinsics empty: pixels map
                # through the affine and the centre instead.
                intr = np.array([1.0, 1.0, float(center[0]), float(center[1])])
        return cls(
            fx=_f32(intr[0], device),
            fy=_f32(intr[1], device),
            cx=_f32(intr[2], device),
            cy=_f32(intr[3], device),
            dist=_f32(d, device),
            R_bc=_f32(p.T_BS[:3, :3], device),
            t_bc=_f32(p.T_BS[:3, 3], device),
            omni_center=_f32(center, device),
            omni_affine_inv=_f32(affine, device),
            dist_model=model,
            width=p.width,
            height=p.height,
        )

    def K(self) -> torch.Tensor:
        """The intrinsics as a 3x3 matrix."""
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack(
            [
                torch.stack([self.fx, z, self.cx], -1),
                torch.stack([z, self.fy, self.cy], -1),
                torch.stack([z, z, o], -1),
            ],
            dim=-2,
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


def _omni_poly(cam: PinholeCamera, rho: torch.Tensor) -> torch.Tensor:
    """OCamCalib z-polynomial f(rho) = a0 + a1 rho + ... + a4 rho^4, by
    Horner (Camera::BackProjectOmni)."""
    d = cam.dist
    z = d[4]
    z = d[3] + z * rho
    z = d[2] + z * rho
    z = d[1] + z * rho
    return d[0] + z * rho


def omni_backproject_normalized(cam: PinholeCamera, uv: torch.Tensor) -> torch.Tensor:
    """Omni pixels (...,2) -> normalized coords (x/z, y/z): the affine
    correction around the distortion centre, then the polynomial for z."""
    rect = torch.einsum("ij,...j->...i", cam.omni_affine_inv, uv - cam.omni_center)
    rho = torch.linalg.norm(rect, dim=-1)
    z = _omni_poly(cam, rho)
    safe_z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return rect / safe_z[..., None]


def omni_project(cam: PinholeCamera, p_cam: torch.Tensor, iters: int = 12):
    """Omni projection of camera-frame points (...,3): `iters` Newton steps
    on m f(rho) - z rho = 0 for the sensor radius rho (m is the point's
    in-plane norm), then the affine and the centre. Returns (uv, valid:
    inside the image)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    m = torch.sqrt(x * x + y * y)
    d = cam.dist
    rho = torch.full_like(m, 100.0)  # a generic fisheye starting radius
    for _ in range(iters):
        f = _omni_poly(cam, rho)
        df = d[1] + rho * (2 * d[2] + rho * (3 * d[3] + rho * 4 * d[4]))
        g = m * f - z * rho
        dg = m * df - z
        rho = rho - g / torch.where(torch.abs(dg) < 1e-9, torch.full_like(dg, 1e-9), dg)
    scale = torch.where(m > 1e-9, rho / torch.clamp(m, min=1e-9), torch.zeros_like(m))
    rect = torch.stack([x * scale, y * scale], -1)
    affine = torch.linalg.inv(cam.omni_affine_inv)
    uv = torch.einsum("ij,...j->...i", affine, rect) + cam.omni_center
    valid = (uv[..., 0] >= 0) & (uv[..., 0] < cam.width) & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height)
    return uv, valid


def project(cam: PinholeCamera, p_cam: torch.Tensor):
    """Camera-frame points (...,3) -> distorted pixels (...,2) and valid
    (in front of the camera and inside the image; Camera::project)."""
    if cam.dist_model == DIST_OMNI:
        return omni_project(cam, p_cam)
    z = p_cam[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    xy = p_cam[..., 0:2] / safe_z[..., None]
    xyd = distort(cam, xy)
    u = cam.fx * xyd[..., 0] + cam.cx
    v = cam.fy * xyd[..., 1] + cam.cy
    valid = (z > 1e-6) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    return torch.stack([u, v], dim=-1), valid


def undistort_to_normalized(cam: PinholeCamera, uv: torch.Tensor, iters: int = 25) -> torch.Tensor:
    """Pixels (...,2) -> undistorted normalized coords by fixed-point
    iteration (cv::undistortPoints); omni pixels backproject in closed
    form."""
    if cam.dist_model == DIST_OMNI:
        return omni_backproject_normalized(cam, uv)
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

    def project_rect(self, p_rect: torch.Tensor):
        """Rectified-left-frame points (...,3) -> (uL, uR, v) stereo pixels
        and valid (in front of the camera); gtsam::StereoCamera::project."""
        z = p_rect[..., 2]
        safe_z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
        uL = self.fx * p_rect[..., 0] / safe_z + self.cx
        uR = self.fx * (p_rect[..., 0] - self.baseline) / safe_z + self.cx
        v = self.fy * p_rect[..., 1] / safe_z + self.cy
        return torch.stack([uL, uR, v], dim=-1), z > 1e-6

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


def unrectify_keypoints(stereo: StereoCamera, cam: PinholeCamera, R_rect, uv_rect):
    """Rectified pixels -> distorted pixels in `cam`
    (UndistorterRectifier::distortUnrectifyKeypoints). As in the JAX
    package, every model but none and radial-tangential goes through the
    equidistant branch of `distort`, omni included."""
    x = (uv_rect[..., 0] - stereo.cx) / stereo.fx
    y = (uv_rect[..., 1] - stereo.cy) / stereo.fy
    rays_rect = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    rays = (R_rect.T @ rays_rect[..., None])[..., 0]
    z = torch.clamp(rays[..., 2], min=1e-8)
    xy = rays[..., 0:2] / z[..., None]
    xyd = distort(cam, xy)
    u = cam.fx * xyd[..., 0] + cam.cx
    v = cam.fy * xyd[..., 1] + cam.cy
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
    numpy on the host, once per rig. An omni camera's map is
    `unrectify_keypoints` of every pixel, in float32 on the camera's
    device, as the JAX package builds it."""
    H, W = cam.height, cam.width
    ys = np.arange(H, dtype=np.float64)
    xs = np.arange(W, dtype=np.float64)
    vv, uu = np.meshgrid(ys, xs, indexing="ij")
    if cam.dist_model == DIST_OMNI:
        grid = torch.from_numpy(np.stack([uu, vv], -1).astype(np.float32)).to(cam.dist.device)
        return unrectify_keypoints(stereo, cam, R_rect, grid).cpu().numpy()
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


class SeparableRemap:
    """Fixed-map bilinear remap as a vertical then a horizontal resampling
    pass: the JAX package's `SeparableRemap`
    (kimera_vio_tpu/frontend/camera.py), which the frontend rectifies
    keyframe images with.

    The constructor is the JAX one's numpy, line for line: the map is
    clipped to [0, W - 1.001] x [0, H - 1.001]; each row's x-map is
    inverted by `np.interp` (a row that is not strictly increasing is made
    so first) to re-parametrise the y-map by source column, Y(i, j');
    then Y = i + dy + fy and x = j + dx + fx, with integer offsets dy, dx
    and fractions fy, fx. So the fields equal the JAX ones bit for bit.

    The JAX call sums, for every offset r of the map's range, a shifted
    image weighted by (1 - fy) where dy == r, plus fy where dy == r - 1,
    and 0 elsewhere (and the same along x): the TPU's way around a
    gather. At a pixel only the taps r = dy and r = dy + 1 have a nonzero
    weight, and the clip keeps i + dy and i + dy + 1 inside the image, so
    the edge padding is never read. The sum is therefore exactly

        tmp(i, j) = (1 - fy) img(i + dy, j) + fy img(i + dy + 1, j)
        out(i, j) = (1 - fx) tmp(i, j + dx) + fx tmp(i, j + dx + 1)

    which `__call__` computes with two 2-tap gathers on index planes made
    here, in that order of products and sums, on the device the fields
    live on.
    """

    def __init__(self, mapxy, device="cuda"):
        device = resolve_device(device)
        mapxy = np.asarray(mapxy, np.float32)
        H, W, _ = mapxy.shape
        x = np.clip(mapxy[..., 0], 0.0, W - 1.001)
        y = np.clip(mapxy[..., 1], 0.0, H - 1.001)
        cols = np.arange(W, dtype=np.float32)
        Y = np.empty_like(y)
        for i in range(H):
            xi = x[i]
            if not np.all(np.diff(xi) > 0):
                # Degenerate map row: enforce monotonicity for the inverse.
                xi = np.maximum.accumulate(xi + np.arange(W) * 1e-6)
            Y[i] = np.interp(cols, xi, y[i])
        Y = np.clip(Y, 0.0, H - 1.001)
        fy = (Y - np.floor(Y)).astype(np.float32)
        dy = np.floor(Y).astype(np.int32) - np.arange(H, dtype=np.int32)[:, None]
        fx = (x - np.floor(x)).astype(np.float32)
        dx = np.floor(x).astype(np.int32) - np.arange(W, dtype=np.int32)[None, :]
        self.r_lo, self.r_hi = int(dy.min()), int(dy.max()) + 1
        self.c_lo, self.c_hi = int(dx.min()), int(dx.max()) + 1
        self.H, self.W = H, W
        self.n_taps = (self.r_hi - self.r_lo + 1) + (self.c_hi - self.c_lo + 1)
        self.dy, self.dx = (torch.from_numpy(a).to(device) for a in (dy, dx))
        # Each pass's two weights, and the flat indices into an (H, W)
        # image of its two taps: one row (+W) or one column (+1) apart.
        ii = np.arange(H, dtype=np.int64)[:, None]
        jj = np.arange(W, dtype=np.int64)[None, :]
        v0 = ((ii + dy) * W + jj).ravel()
        h0 = (ii * W + jj + dx).ravel()
        self._v = torch.from_numpy(np.stack([v0, v0 + W])).to(device)
        self._h = torch.from_numpy(np.stack([h0, h0 + 1])).to(device)
        self._wy = torch.from_numpy(np.stack([1.0 - fy, fy]).reshape(2, -1)).to(device)
        self._wx = torch.from_numpy(np.stack([1.0 - fx, fx]).reshape(2, -1)).to(device)
        self.fy, self.fx = self._wy[1].view(H, W), self._wx[1].view(H, W)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """(..., H, W) float32 or uint8 -> (..., H, W) float32."""
        flat = img.to(torch.float32).flatten(-2)
        tmp = self._wy[0] * flat[..., self._v[0]] + self._wy[1] * flat[..., self._v[1]]
        out = self._wx[0] * tmp[..., self._h[0]] + self._wx[1] * tmp[..., self._h[1]]
        return out.unflatten(-1, (self.H, self.W))


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
