"""Per-keyframe 3D mesher and plane segmentation.

Port of kimera_vio_tpu/mesher/mesher.py (the reference Mesher,
src/mesh/Mesher.cpp, and its Mesh containers, mesh/Mesh.h:34-381):

  * a 2D Delaunay triangulation of the keyframe keypoints whose landmarks
    the backend triangulated, on the host with scipy.spatial.Delaunay (a
    few hundred points), as in the JAX package;
  * the 3D lift from the backend's landmark positions and the batched
    bad-triangle predicate (filterOutBadTriangles, Mesher.cpp:375) as
    torch ops on the mesher's device;
  * the time-horizon mesh keyed by landmark ids
    (updatePolygonMeshToTimeHorizon, Mesher.cpp:592);
  * plane segmentation for RegularVIO: triangle normals
    (calculateNormals :657), gravity-axis clustering (:736), a height
    histogram for horizontal planes (segmentHorizontalPlanes :1198) and a
    (theta, distance) histogram for walls (segmentWalls :1132). The
    histograms are integer scatter-adds with the JAX bin formula
    (truncation toward zero, then the clip); their top bins come from a
    stable descending sort, so ties go to the lower bin as in
    `jax.lax.top_k`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.config import flags


@dataclass
class Mesh3D:
    """Triangle mesh over landmarks on the host (the reference's
    Mesh<Vertex3D> keyed by landmark id)."""

    lmk_ids: np.ndarray  # (T, 3) landmark ids per triangle corner
    vertices: np.ndarray  # (T, 3, 3) float32 positions

    @property
    def n_triangles(self):
        return len(self.lmk_ids)


def delaunay_2d(uv: np.ndarray) -> np.ndarray:
    """Host 2D Delaunay: (N, 2) -> (T, 3) vertex indices."""
    from scipy.spatial import Delaunay

    if len(uv) < 3:
        return np.zeros((0, 3), np.int32)
    try:
        tri = Delaunay(uv)
    except Exception:  # degenerate input (collinear points): no mesh
        return np.zeros((0, 3), np.int32)
    return tri.simplices.astype(np.int32)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def filter_triangles(
    verts: torch.Tensor,  # (T, 3, 3)
    *,
    min_ratio_btw_largest_smallest_side: float = 0.5,
    min_elongation_ratio: float = 0.5,
    max_triangle_side: float = 0.5,
) -> torch.Tensor:
    """Keep-mask (T,) of the bad-triangle filter: smallest/largest side
    ratio, largest side, and height over largest side (needles)."""
    a, b, c = verts[:, 0], verts[:, 1], verts[:, 2]
    e1 = torch.linalg.norm(b - a, dim=-1)
    e2 = torch.linalg.norm(c - b, dim=-1)
    e3 = torch.linalg.norm(a - c, dim=-1)
    sides = torch.stack([e1, e2, e3], -1)
    smin = sides.min(-1).values
    smax = sides.max(-1).values
    ratio = smin / torch.clamp(smax, min=1e-9)
    area = 0.5 * torch.linalg.norm(_cross(b - a, c - a), dim=-1)
    height_ratio = (2.0 * area / torch.clamp(smax, min=1e-9)) / torch.clamp(smax, min=1e-9)
    return ((ratio >= min_ratio_btw_largest_smallest_side)
            & (smax <= max_triangle_side)
            & (height_ratio >= 0.1 * min_elongation_ratio))


def triangle_normals(verts: torch.Tensor) -> torch.Tensor:
    """(T, 3, 3) -> unit normals (T, 3)."""
    n = _cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)


def cluster_by_direction(normals: torch.Tensor, axis: torch.Tensor,
                         tolerance: float = 0.011) -> torch.Tensor:
    """Normals parallel to `axis`: |1 - |n . axis|| < tol
    (clusterNormalsAroundAxis, Mesher.cpp:736)."""
    d = torch.abs(normals @ axis)
    return torch.abs(1.0 - d) < tolerance


def _top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k`: the k largest, ties to the lower index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _histogram(idx: torch.Tensor, weight: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.int32, device=idx.device).index_add_(
        0, idx.long(), weight.to(torch.int32))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Per row the first True column, -1 where none."""
    first = torch.argmax(mask.to(torch.uint8), dim=-1)
    return torch.where(mask.any(-1), first, torch.full_like(first, -1))


def segment_horizontal_planes(
    verts: torch.Tensor,
    keep: torch.Tensor,
    normals: torch.Tensor,
    gravity_axis: torch.Tensor,
    *,
    z_min: float = -4.0,
    z_max: float = 4.0,
    n_bins: int = 512,
    min_support: int = 20,
    normal_tol: float = 0.011,
    max_planes: int = 4,
):
    """Height-histogram peaks as horizontal planes. Returns (normals (P, 3),
    ds (P,), valid (P,), triangle assignment (T,), plane index or -1)."""
    horiz = cluster_by_direction(normals, gravity_axis, normal_tol) & keep
    z_centroid = verts.mean(dim=1) @ gravity_axis
    idx = torch.clamp(((z_centroid - z_min) / (z_max - z_min) * n_bins).to(torch.int32),
                      0, n_bins - 1)
    hist = _histogram(idx, horiz, n_bins)
    zero = torch.zeros(1, dtype=hist.dtype, device=hist.device)
    left = torch.cat([zero, hist[:-1]])
    right = torch.cat([hist[1:], zero])
    is_peak = (hist >= left) & (hist >= right) & (hist >= min_support)
    top_vals, top_idx = _top_k(torch.where(is_peak, hist, torch.zeros_like(hist)), max_planes)
    plane_valid = top_vals > 0
    plane_z = z_min + (top_idx.to(verts.dtype) + 0.5) * (z_max - z_min) / n_bins
    plane_normals = gravity_axis.expand(max_planes, 3)
    bin_w = (z_max - z_min) / n_bins
    dz = torch.abs(z_centroid[:, None] - plane_z[None, :])
    close = (dz < 2 * bin_w) & plane_valid[None, :] & horiz[:, None]
    return plane_normals, plane_z, plane_valid, _first_true(close)


def segment_walls(
    verts: torch.Tensor,
    keep: torch.Tensor,
    normals: torch.Tensor,
    gravity_axis: torch.Tensor,
    *,
    n_theta: int = 40,
    n_dist: int = 80,
    dist_max: float = 6.0,
    min_support: int = 20,
    max_planes: int = 4,
):
    """(theta, distance) histogram peaks as vertical planes. Returns
    (normals (P, 3), ds (P,), valid (P,), triangle assignment (T,))."""
    g = gravity_axis
    vert = (torch.abs(normals @ g) < 0.1) & keep
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=verts.dtype, device=verts.device)
    e1 = e1 - (e1 @ g) * g
    e1 = e1 / torch.clamp(torch.linalg.norm(e1), min=1e-9)
    e2 = _cross(g, e1)
    theta = torch.atan2(normals @ e2, normals @ e1)
    theta = torch.where(theta < 0, theta + np.pi, theta)  # fold antipodal normals
    centroid = verts.mean(dim=1)
    d = centroid @ e1 * torch.cos(theta) + centroid @ e2 * torch.sin(theta)
    ti = torch.clamp((theta / np.pi * n_theta).to(torch.int32), 0, n_theta - 1)
    di = torch.clamp(((d + dist_max) / (2 * dist_max) * n_dist).to(torch.int32), 0, n_dist - 1)
    flat = ti * n_dist + di
    hist = _histogram(flat, vert, n_theta * n_dist)
    top_vals, top_idx = _top_k(torch.where(hist >= min_support, hist, torch.zeros_like(hist)),
                               max_planes)
    plane_valid = top_vals > 0
    p_theta = ((top_idx // n_dist).to(verts.dtype) + 0.5) / n_theta * np.pi
    p_d = ((top_idx % n_dist).to(verts.dtype) + 0.5) / n_dist * 2 * dist_max - dist_max
    p_normals = torch.cos(p_theta)[:, None] * e1[None] + torch.sin(p_theta)[:, None] * e2[None]
    same_cell = (flat[:, None] == top_idx[None, :]) & plane_valid[None, :] & vert[:, None]
    return p_normals, p_d, plane_valid, _first_true(same_cell)


class Mesher:
    """Keyframe keypoints + the backend's landmark map -> filtered 3D mesh,
    kept over the time horizon, and plane hypotheses (Mesher::spinOnce +
    updateMesh3D, Mesher.cpp:219-240, 1446-1531). Delaunay, the horizon
    and the id bookkeeping run on the host; the triangle filter and the
    segmentation on `device`."""

    def __init__(self, max_triangle_side: float | None = None,
                 min_side_ratio: float | None = None,
                 gravity_axis=np.array([0.0, 0.0, 1.0], np.float32),
                 device: str | torch.device = "cuda"):
        # Defaults from the flag registry (the reference's Mesher.cpp
        # gflags); explicit arguments win.
        self.device = resolve_device(device)
        self.max_triangle_side = (flags.get_flag("max_triangle_side")
                                  if max_triangle_side is None else max_triangle_side)
        self.min_side_ratio = (flags.get_flag("min_ratio_btw_largest_smallest_side")
                               if min_side_ratio is None else min_side_ratio)
        self.min_elongation_ratio = flags.get_flag("min_elongation_ratio")
        self.reduce_to_horizon = flags.get_flag("reduce_mesh_to_time_horizon")
        self._seg_flags = {
            "z_bins": flags.get_flag("z_histogram_bins"),
            "z_min_support": flags.get_flag("z_histogram_min_support"),
            "z_min": flags.get_flag("z_histogram_min_range"),
            "z_max": flags.get_flag("z_histogram_max_range"),
            "theta_bins": flags.get_flag("hist_2d_theta_bins"),
            "dist_bins": flags.get_flag("hist_2d_distance_bins"),
            "wall_min_support": flags.get_flag("hist_2d_min_support"),
        }
        self.gravity_axis = torch.as_tensor(np.asarray(gravity_axis, np.float32), device=self.device)
        self._horizon: dict[tuple, np.ndarray] = {}  # sorted id triple -> (3, 3) vertices
        # The last keyframe's image-plane triangulation (return_mesh_2d):
        # (uv (N, 2), triangle indices (T, 3) into uv, after the filter).
        self.mesh_2d: tuple[np.ndarray, np.ndarray] | None = None

    def spin_once(
        self,
        kp_uv: np.ndarray,  # (N, 2) keyframe keypoint pixels
        kp_ids: np.ndarray,  # (N,) their landmark ids
        lmk_ids: np.ndarray,  # (L,) backend landmark ids
        lmk_pts: np.ndarray,  # (L, 3) world positions
        lmk_valid: np.ndarray,  # (L,)
        horizon_ids: set | None = None,
    ) -> Mesh3D:
        """One keyframe: Delaunay -> lift -> filter -> horizon update."""
        self._evict(horizon_ids)
        id_to_pt = {int(i): lmk_pts[r] for r, i in enumerate(lmk_ids) if lmk_valid[r] and i >= 0}
        sel = [k for k in range(len(kp_ids)) if int(kp_ids[k]) in id_to_pt]
        # A keyframe without a triangulation has no image-plane mesh (the
        # JAX mesher keeps the previous keyframe's here, mesher.py:271).
        self.mesh_2d = None
        if len(sel) < 3:
            return self.horizon_mesh(horizon_ids)
        uv = kp_uv[sel]
        ids = kp_ids[sel]
        tris = delaunay_2d(uv)
        if len(tris) == 0:
            return self.horizon_mesh(horizon_ids)
        tri_ids = ids[tris]
        verts = np.stack([np.stack([id_to_pt[int(i)] for i in corner_ids])
                          for corner_ids in tri_ids]).astype(np.float32)
        keep = filter_triangles(
            torch.as_tensor(verts, device=self.device),
            min_ratio_btw_largest_smallest_side=self.min_side_ratio,
            min_elongation_ratio=self.min_elongation_ratio,
            max_triangle_side=self.max_triangle_side,
        ).cpu().numpy()
        tri_ids, verts = tri_ids[keep], verts[keep]
        self.mesh_2d = (uv, tris[keep])
        # Triangles keyed by their sorted id triple: a new keyframe updates
        # their positions; old ones persist while their landmarks stay.
        for t in range(len(tri_ids)):
            self._horizon[tuple(sorted(int(x) for x in tri_ids[t]))] = verts[t]
        self._evict(horizon_ids)
        return self.horizon_mesh(horizon_ids)

    def _evict(self, horizon_ids):
        """Drop triangles whose landmarks left the time horizon (behind the
        reduce_mesh_to_time_horizon flag, as in the reference)."""
        if horizon_ids is None or not self.reduce_to_horizon:
            return
        for k in [k for k in self._horizon if not all(i in horizon_ids for i in k)]:
            del self._horizon[k]

    def horizon_mesh(self, horizon_ids=None) -> Mesh3D:
        if not self._horizon:
            return Mesh3D(np.zeros((0, 3), np.int64), np.zeros((0, 3, 3), np.float32))
        keys = list(self._horizon.keys())
        return Mesh3D(lmk_ids=np.array(keys, np.int64),
                      vertices=np.stack([self._horizon[k] for k in keys]))

    def segment_planes(self, mesh: Mesh3D) -> list:
        """Plane hypotheses of a mesh, horizontal then walls, each a dict of
        normal, d and type."""
        if mesh.n_triangles == 0:
            return []
        verts = torch.as_tensor(mesh.vertices, device=self.device)
        normals = triangle_normals(verts)
        keep = torch.ones(mesh.n_triangles, dtype=torch.bool, device=self.device)
        f = self._seg_flags
        hn, hd, hv, _ = segment_horizontal_planes(
            verts, keep, normals, self.gravity_axis, z_min=f["z_min"], z_max=f["z_max"],
            n_bins=f["z_bins"], min_support=f["z_min_support"])
        wn, wd, wv, _ = segment_walls(verts, keep, normals, self.gravity_axis,
                                      n_theta=f["theta_bins"], n_dist=f["dist_bins"],
                                      min_support=f["wall_min_support"])
        planes = []
        for n, d, v, kind in ((hn, hd, hv, "horizontal"), (wn, wd, wv, "wall")):
            n, d, v = n.cpu().numpy(), d.cpu().numpy(), v.cpu().numpy()
            planes += [{"normal": n[i], "d": float(d[i]), "type": kind}
                       for i in range(len(v)) if v[i]]
        return planes
