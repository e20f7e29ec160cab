"""The benchmark's synthetic stereo-inertial scene: a textured world plane,
a periodic 6-DoF trajectory, stereo images rendered by ray-plane
intersection on the device, and IMU samples by central differences.

A frozen copy, adapted to torch on the device, of the port's
`dataprovider/synthetic.py::SyntheticPlanar6DofProvider` in its "orbit"
mode: every translation and rotation frequency is a whole multiple of
1 / `period_s`, so the trajectory, the images and the IMU repeat exactly
each period. One period is rendered in set-up and replayed with
advancing stamps for as long as a run needs.

Geometry (as the original): the world plane z = `plane_z`, textured over
x and y; the left camera is the body frame, looking down +z at R = I; the
right camera sits `baseline` metres along the body's x axis; pinhole
cameras without distortion, so raw images are rectified. Gravity is
(0, 0, -9.81) in the world.

What the seed changes: the texture, and the phase at which each stream
enters the period. The trajectory, and so the keyframe cadence and the
work, are the workload's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

GRAVITY = np.array([0.0, 0.0, -9.81])
# Texture blobs (random values upsampled by `TEX_SCALE` texels) and the
# texel size against a pixel's footprint at the plane: the original's
# 5-texel blobs at 2.4 texels a pixel (220 texels/m at 5 m, fx 450).
TEX_SCALE = 5
TEXELS_PER_PIXEL = 2.4


@dataclass(frozen=True)
class Rig:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    fps: float
    imu_rate: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Rig":
        cam = cfg["camera"]
        return cls(width=int(cam["width"]), height=int(cam["height"]),
                   fx=float(cam["fx"]), fy=float(cam["fy"]), cx=float(cam["cx"]),
                   cy=float(cam["cy"]), baseline=float(cam["baseline"]),
                   fps=float(cam["rate_hz"]), imu_rate=float(cfg["imu"]["rate_hz"]))


class Trajectory:
    """The analytic periodic trajectory of a workload's `motion`: position
    a * sin(w t + phase), xyz Euler angles r * sin(w t + phase), with
    w = 2 pi harmonic / period_s. Vectorised over t (seconds); every
    operation in `dtype` (float64 for the scene and the truth; the control
    of `correct` evaluates it in bfloat16)."""

    def __init__(self, motion: dict):
        self.period_s = float(motion["period_s"])
        w0 = 2.0 * math.pi / self.period_s
        self.t_amp = np.asarray(motion["trans_amp"], float)
        self.t_w = w0 * np.asarray(motion["trans_harmonic"], float)
        self.t_ph = np.asarray(motion["trans_phase"], float)
        self.r_amp = np.asarray(motion["rot_amp"], float)
        self.r_w = w0 * np.asarray(motion["rot_harmonic"], float)
        self.r_ph = np.asarray(motion["rot_phase"], float)

    @staticmethod
    def _args(t, amp, w, ph, dtype):
        c = lambda x: torch.as_tensor(x).to(dtype)  # noqa: E731
        t = c(np.asarray(t, float) if not isinstance(t, torch.Tensor) else t)[..., None]
        return t, c(amp), c(w), c(ph)

    def pos(self, t, dtype=torch.float64) -> torch.Tensor:
        t, a, w, ph = self._args(t, self.t_amp, self.t_w, self.t_ph, dtype)
        return a * torch.sin(w * t + ph)

    def vel(self, t, dtype=torch.float64) -> torch.Tensor:
        t, a, w, ph = self._args(t, self.t_amp, self.t_w, self.t_ph, dtype)
        return a * w * torch.cos(w * t + ph)

    def rot(self, t, dtype=torch.float64) -> torch.Tensor:
        """R_wb (..., 3, 3) = Rz Ry Rx of the Euler angles at t."""
        t, r, w, ph = self._args(t, self.r_amp, self.r_w, self.r_ph, dtype)
        ang = r * torch.sin(w * t + ph)
        c, s = torch.cos(ang), torch.sin(ang)
        one, zero = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])
        shape = (*c.shape[:-1], 3, 3)
        Rx = torch.stack([one, zero, zero, zero, c[..., 0], -s[..., 0],
                          zero, s[..., 0], c[..., 0]], -1).reshape(shape)
        Ry = torch.stack([c[..., 1], zero, s[..., 1], zero, one, zero,
                          -s[..., 1], zero, c[..., 1]], -1).reshape(shape)
        Rz = torch.stack([c[..., 2], -s[..., 2], zero, s[..., 2], c[..., 2], zero,
                          zero, zero, one], -1).reshape(shape)
        return Rz @ Ry @ Rx

    def imu(self, t, h: float = 1e-4) -> tuple[np.ndarray, np.ndarray]:
        """(acc, gyr) in the body frame at t (float64): specific force
        R^T (a - g) and vee(R^T dR/dt), both by central differences of
        step h."""
        t = np.asarray(t, float)
        R = self.rot(t)
        a_w = (self.pos(t + h) - 2 * self.pos(t) + self.pos(t - h)) / h**2
        acc = torch.einsum("...ji,...j->...i", R, a_w - torch.as_tensor(GRAVITY))
        W = R.transpose(-1, -2) @ ((self.rot(t + h) - self.rot(t - h)) / (2 * h))
        gyr = torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)
        return acc.numpy(), gyr.numpy()


class Scene:
    """One period of a workload's scene for a rig: the trajectory, the
    plane's texture on the device, and per frame of the period its stereo
    pair (uint8, on the host) and IMU block samples."""

    def __init__(self, rig: Rig, motion: dict, seed: int, device: torch.device):
        self.rig, self.device = rig, device
        self.traj = Trajectory(motion)
        self.plane_z = float(motion["plane_z"])
        n = self.traj.period_s * rig.fps
        r = rig.imu_rate / rig.fps
        if abs(n - round(n)) > 1e-9 or abs(r - round(r)) > 1e-9:
            raise ValueError(f"period {self.traj.period_s} s must hold whole frames ({n}) and "
                             f"IMU samples a frame ({r})")
        self.n_frames, self.imu_per_frame = int(round(n)), int(round(r))
        # Texture over the plane region any camera of the period sees, with
        # the original's margins; texel size from the nearest view.
        pos = self.traj.pos(np.arange(self.n_frames) / rig.fps).numpy()
        depth_min = self.plane_z - pos[:, 2].max()
        depth_max = self.plane_z - pos[:, 2].min()
        if depth_min <= 0.5:
            raise ValueError(f"the camera comes within {depth_min} m of the plane")
        self.tex_res = rig.fx * TEXELS_PER_PIXEL / depth_min  # texels per metre
        span_x = depth_max * rig.width / rig.fx * 1.6 + 2.0 + np.ptp(pos[:, 0])
        span_y = depth_max * rig.height / rig.fy * 1.6 + 2.0 + np.ptp(pos[:, 1])
        self.tex_origin = np.array([pos[:, 0].mean() - span_x / 2, pos[:, 1].mean() - span_y / 2])
        th, tw = int(span_y * self.tex_res), int(span_x * self.tex_res)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (2**63))
        small = torch.empty((1, 1, th // TEX_SCALE + 2, tw // TEX_SCALE + 2), device=device)
        small.uniform_(30.0, 225.0, generator=gen)
        big = F.interpolate(small, scale_factor=TEX_SCALE, mode="bicubic", align_corners=False)
        self.texture = big[0, 0, :th, :tw].contiguous()

    # -- frames --------------------------------------------------------
    def frame_time(self, k) -> np.ndarray:
        """Seconds into the period of period frame k."""
        return np.asarray(k, float) / self.rig.fps

    def render(self, ks, right: bool, dtype=torch.float32) -> torch.Tensor:
        """(len(ks), H, W) images of period frames ks, float32 on the
        device: each pixel's ray meets the plane, the texture is blended
        bilinearly there."""
        rig = self.rig
        t = self.frame_time(ks)
        R64, p = self.traj.rot(t), self.traj.pos(t)
        if right:
            p = p + R64[..., :, 0] * rig.baseline
        R = R64.to(device=self.device, dtype=dtype)
        p = p.to(device=self.device, dtype=dtype)
        v, u = torch.meshgrid(torch.arange(rig.height, device=self.device, dtype=dtype),
                              torch.arange(rig.width, device=self.device, dtype=dtype),
                              indexing="ij")
        d_cam = torch.stack([(u - rig.cx) / rig.fx, (v - rig.cy) / rig.fy, torch.ones_like(u)], -1)
        d_w = torch.einsum("hwj,bij->bhwi", d_cam, R)
        s = (self.plane_z - p[:, None, None, 2]) / d_w[..., 2]
        X = p[:, None, None, 0] + s * d_w[..., 0]
        Y = p[:, None, None, 1] + s * d_w[..., 1]
        tx = (X - float(self.tex_origin[0])) * float(self.tex_res)
        ty = (Y - float(self.tex_origin[1])) * float(self.tex_res)
        th, tw = self.texture.shape
        x0 = torch.clamp(torch.floor(tx), 0, tw - 2)
        y0 = torch.clamp(torch.floor(ty), 0, th - 2)
        fx = torch.clamp(tx - x0, 0, 1).to(self.texture.dtype)
        fy = torch.clamp(ty - y0, 0, 1).to(self.texture.dtype)
        i = y0.long() * tw + x0.long()
        flat = self.texture.reshape(-1)
        return (flat[i] * (1 - fx) * (1 - fy) + flat[i + 1] * fx * (1 - fy)
                + flat[i + tw] * (1 - fx) * fy + flat[i + tw + 1] * fx * fy)

    def render_period(self, chunk: int = 8) -> tuple[np.ndarray, np.ndarray]:
        """Every frame of the period as host uint8 (n, H, W) left and
        right images, rounded as an 8-bit camera records them."""
        H, W = self.rig.height, self.rig.width
        out = [np.empty((self.n_frames, H, W), np.uint8) for _ in range(2)]
        for a in range(0, self.n_frames, chunk):
            ks = np.arange(a, min(a + chunk, self.n_frames))
            for side in (0, 1):
                img = self.render(ks, right=bool(side))
                out[side][a:a + len(ks)] = img.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
        return out[0], out[1]

    def imu_period(self) -> tuple[np.ndarray, np.ndarray]:
        """(acc, gyr) (n * imu_per_frame, 3) float32 of the period: sample
        j at j / imu_rate seconds."""
        t = np.arange(self.n_frames * self.imu_per_frame) / self.rig.imu_rate
        acc, gyr = self.traj.imu(t)
        return acc.astype(np.float32), gyr.astype(np.float32)

    def imu_block_arrays(self, k: int, acc: np.ndarray, gyr: np.ndarray, capacity: int):
        """The IMU block of period frame k: the samples in (t_{k-1}, t_k],
        the last one exactly at t_k, as fixed-capacity arrays (acc, gyr,
        dt, mask), as a EuRoC provider's synchroniser gives them."""
        r = self.imu_per_frame
        if r > capacity:
            raise ValueError(f"{r} IMU samples a frame exceed the block capacity {capacity}")
        n = self.n_frames * r
        idx = (np.arange(k * r - r + 1, k * r + 1)) % n
        a = np.zeros((capacity, 3), np.float32)
        g = np.zeros((capacity, 3), np.float32)
        dt = np.zeros(capacity, np.float32)
        mask = np.zeros(capacity, bool)
        a[:r], g[:r] = acc[idx], gyr[idx]
        dt[:r] = 1.0 / self.rig.imu_rate
        mask[:r] = True
        return a, g, dt, mask

    def state(self, t, dtype=torch.float64) -> dict:
        """The state at t seconds into the period (R_wb, p, v; the IMU
        carries no bias), computed in `dtype`: float64 gives the exact
        state as numpy arrays, another dtype tensors of that dtype."""
        out = {"rot": self.traj.rot(t, dtype), "pos": self.traj.pos(t, dtype),
               "vel": self.traj.vel(t, dtype)}
        return {k: v.numpy() for k, v in out.items()} if dtype == torch.float64 else out
