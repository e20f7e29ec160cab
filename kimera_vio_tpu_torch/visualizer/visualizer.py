"""3D visualization layer: widget construction and a headless display.

Port of kimera_vio_tpu/visualizer/visualizer.py (the reference's
OpenCvVisualizer3D.cpp:101-380, 1188-1767 and DisplayModule /
OpenCvDisplay): `Visualizer3D.spin_once` turns one keyframe's pipeline
outputs into a widget map (the trajectory, the camera pose, the landmark
point cloud, the time-horizon mesh, the image-plane mesh); a display
renders it. `FileDisplay` writes every `save_every`-th map to disk: PLY
point clouds and meshes, a top-down trajectory image and, where the map
carries the 2-D mesh and its keyframe image, the mesh drawn over the
image. `visualization_type` mirrors the reference enum (kMesh2dTo3dSparse
/ kPointcloud / kNone, OpenCvVisualizer3D.cpp:101-140).

Images are drawn in numpy (utils/raster.py) and written by
dataprovider/png.py; nothing is skipped. Where the JAX package skips the
trajectory plot without matplotlib and the 2-D mesh overlay without
OpenCV, this module draws both itself:

  * `mesh2d_*.png`: the keyframe image in gray with each triangle's
    closed outline in green, the pixels of `cv2.polylines`;
  * `trajectory_*.png`: not matplotlib's figure. A 480x480 white image
    (the JAX figure's 6 x 6 in at 80 dpi) with the plot area's frame in
    black, the x-y trajectory as an 8-connected polyline in blue and the
    last pose as a red disk; equal scales on both axes, the data centred
    (`trajectory_pixels`). No axis labels or ticks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.dataprovider.png import write_png
from kimera_vio_tpu_torch.utils import raster

VIZ_NONE = 0
VIZ_POINTCLOUD = 1
VIZ_MESH = 2

#: trajectory image: side, plot-area margin (px) and colours (RGB)
PLOT_SIZE = 480
PLOT_MARGIN = 40
PLOT_LINE = (31, 119, 180)
PLOT_MARKER = (214, 39, 40)
PLOT_MARKER_RADIUS = 3
MESH_2D_COLOR = (0, 255, 0)


@dataclass
class WidgetMap:
    """The per-keyframe widget payload handed to a display (the
    reference's map<string, cv::viz::Widget>)."""

    trajectory: np.ndarray | None = None  # (T,3)
    frustum_pose: tuple | None = None  # (R (3,3), t (3,))
    pointcloud: np.ndarray | None = None  # (N,3)
    pointcloud_ids: np.ndarray | None = None
    mesh_vertices: np.ndarray | None = None  # (T,3,3)
    # 2D image-plane mesh + keyframe image for overlay rendering
    # (reference visualize_mesh_2d / Visualizer3D::visualizeMesh2D).
    mesh_2d: tuple | None = None  # (uv (N,2), tris (T,3))
    image: np.ndarray | None = None  # (H,W) uint8/float


class Visualizer3D:
    def __init__(self, visualization_type: int = VIZ_MESH):
        self.visualization_type = visualization_type
        self._traj: list[np.ndarray] = []
        # Reference gflag displayed_trajectory_length: keep only the last
        # N poses in the trajectory widget (-1 = all).
        self.displayed_trajectory_length = int(flags.get_flag("displayed_trajectory_length"))

    def spin_once(
        self,
        pose_R: np.ndarray,
        pose_t: np.ndarray,
        lmk_points: np.ndarray | None = None,
        lmk_valid: np.ndarray | None = None,
        lmk_ids: np.ndarray | None = None,
        mesh=None,
        mesh_2d: tuple | None = None,
        image: np.ndarray | None = None,
    ) -> WidgetMap:
        self._traj.append(np.asarray(pose_t, np.float64))
        n = self.displayed_trajectory_length
        if n > 0 and len(self._traj) > n:
            self._traj = self._traj[-n:]
        w = WidgetMap(
            trajectory=np.stack(self._traj),
            frustum_pose=(np.asarray(pose_R), np.asarray(pose_t)),
            mesh_2d=mesh_2d,
            image=image,
        )
        if self.visualization_type == VIZ_NONE:
            return w
        if lmk_points is not None and lmk_valid is not None:
            m = np.asarray(lmk_valid)
            w.pointcloud = np.asarray(lmk_points)[m]
            if lmk_ids is not None:
                w.pointcloud_ids = np.asarray(lmk_ids)[m]
        if self.visualization_type == VIZ_MESH and mesh is not None:
            w.mesh_vertices = mesh.vertices
        return w


def trajectory_pixels(traj: np.ndarray, size: int = PLOT_SIZE,
                      margin: int = PLOT_MARGIN) -> np.ndarray:
    """(T, 2) integer (column, row) pixels of a trajectory's x-y points in
    the trajectory image: one scale for both axes, the larger extent
    filling the plot area (size - 2 margin px), the data centred, +y up;
    rounded half to even."""
    xy = np.asarray(traj, np.float64)[:, :2]
    lo, hi = xy.min(0), xy.max(0)
    extent = float((hi - lo).max())
    scale = (size - 2 * margin) / extent if extent > 0 else 1.0
    mid = 0.5 * (lo + hi)
    col = size / 2 + (xy[:, 0] - mid[0]) * scale
    row = size / 2 - (xy[:, 1] - mid[1]) * scale
    return np.rint(np.stack([col, row], -1)).astype(np.int64)


def _disk(radius: int) -> np.ndarray:
    d = np.arange(-radius, radius + 1)
    dx, dy = np.meshgrid(d, d)
    inside = dx * dx + dy * dy <= radius * radius
    return np.stack([dx[inside], dy[inside]], -1)


class FileDisplay:
    """Headless display: PLY / PNG artifacts on disk (the OpenCvDisplay
    role without a GUI). `save_every` throttles the writes: the maps whose
    running count is a multiple of it are written."""

    def __init__(self, output_path: str, save_every: int = 10):
        self.dir = output_path
        os.makedirs(output_path, exist_ok=True)
        self.save_every = save_every
        self._count = 0

    def spin_once(self, widgets: WidgetMap):
        self._count += 1
        if self._count % self.save_every:
            return
        k = self._count
        if widgets.pointcloud is not None and len(widgets.pointcloud):
            write_ply_points(os.path.join(self.dir, f"pointcloud_{k:06d}.ply"), widgets.pointcloud)
        if widgets.mesh_vertices is not None and len(widgets.mesh_vertices):
            write_ply_mesh(os.path.join(self.dir, f"mesh_{k:06d}.ply"), widgets.mesh_vertices)
        if widgets.trajectory is not None and len(widgets.trajectory) > 1:
            write_png(os.path.join(self.dir, f"trajectory_{k:06d}.png"),
                      plot_trajectory(widgets.trajectory), filter_type=1)
        if widgets.mesh_2d is not None and widgets.image is not None:
            write_png(os.path.join(self.dir, f"mesh2d_{k:06d}.png"),
                      draw_mesh_2d(widgets.image, widgets.mesh_2d), filter_type=1)


def draw_mesh_2d(image: np.ndarray, mesh_2d: tuple) -> np.ndarray:
    """The keyframe image (clipped and truncated to uint8 when it is not)
    as RGB with each triangle's closed outline in green, as the JAX
    package's `cv2.polylines` at the rounded keypoints (reference
    Visualizer3D::visualizeMesh2DStereo)."""
    uv, tris = mesh_2d
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    rgb = np.repeat(img[..., None], 3, axis=2)
    pts = np.round(np.asarray(uv)).astype(np.int32)
    for t in np.asarray(tris):
        raster.draw_polyline(rgb, pts[t], True, MESH_2D_COLOR)
    return rgb


def plot_trajectory(traj: np.ndarray) -> np.ndarray:
    """The top-down trajectory image (see the module docstring)."""
    img = np.full((PLOT_SIZE, PLOT_SIZE, 3), 255, np.uint8)
    lo, hi = PLOT_MARGIN, PLOT_SIZE - PLOT_MARGIN
    raster.draw_polyline(img, [(lo, lo), (hi, lo), (hi, hi), (lo, hi)], True, (0, 0, 0))
    px = trajectory_pixels(traj)
    raster.draw_polyline(img, px, False, PLOT_LINE)
    raster.stamp(img, px[-1], _disk(PLOT_MARKER_RADIUS), PLOT_MARKER)
    return img


def write_ply_points(path: str, pts: np.ndarray):
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        for p in pts:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")


def write_ply_mesh(path: str, tri_vertices: np.ndarray):
    """tri_vertices: (T,3,3)."""
    T = len(tri_vertices)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {3*T}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {T}\n"
            "property list uchar int vertex_indices\n"
            "end_header\n"
        )
        for tri in tri_vertices:
            for p in tri:
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
        for t in range(T):
            f.write(f"3 {3*t} {3*t+1} {3*t+2}\n")


def make_display(display_type: int, output_path: str | None):
    """Display factory (reference DisplayFactory.cpp:19): 0 = OpenCV window
    where a GUI is reachable, 1 = Pangolin in the reference; both are the
    file display on a headless machine, as in the JAX package."""
    if output_path is None:
        output_path = "./viz_out"
    return FileDisplay(output_path)
