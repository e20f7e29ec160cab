"""Depth-image-based mesh refinement (MeshOptimization).

Port of kimera_vio_tpu/mesher/mesh_optimization.py (the reference
MeshOptimization, src/mesh/MeshOptimization.cpp, mesh/MeshOptimization.h:
38-60): the mesh, in the keyframe camera's frame, is compared with a dense
depth image (RGB-D, or a stereo depth map) and its vertex depths are
refined so that it follows the observed surface.

The refinement is one linear least squares over the V vertex depths:
each triangle is sampled on a fixed barycentric lattice, the model depth
at a sample is barycentric-linear in the triangle's three vertex depths,
the (V, V) normal equations are summed from 3x3 blocks per triangle, a
depth prior keeps unobserved vertices in place, and a dense Cholesky
solves it. Vertices move along their camera rays, so their pixels stay.
"""

from __future__ import annotations

import numpy as np
import torch

# MeshOptimizerType (reference mesh/MeshOptimization-definitions.h:25-29):
# connected and closed form are the joint solve; disconnected solves each
# triangle alone and averages shared vertices; the GTSAM type is the
# robust iterative mode (Huber IRLS + an edge smoothness term).
K_CONNECTED_MESH = 0
K_DISCONNECTED_MESH = 1
K_CLOSED_FORM = 2
K_GTSAM_MESH = 3


def _bary_grid(n: int = 4) -> np.ndarray:
    """(S, 3) barycentric lattice over the triangle, interior included."""
    return np.asarray([(i / n, j / n, (n - i - j) / n)
                       for i in range(n + 1) for j in range(n + 1 - i)], np.float32)


def _bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    x = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)


def _sample_setup(vertices_cam, tris, tri_mask, depth_img, fx, fy, cx, cy, bary_n, obs_sigma):
    """Lattice samples of every triangle's projection with their observed
    depths. Returns (bary (S,3), d_obs (T,S) zero where invalid, valid,
    w (T,S), z0 (V,), safe_z (V,))."""
    H, W = depth_img.shape
    bary = torch.as_tensor(_bary_grid(bary_n), device=vertices_cam.device)
    z0 = vertices_cam[:, 2]
    safe_z = torch.where(torch.abs(z0) < 1e-6, torch.full_like(z0, 1e-6), z0)
    u = fx * vertices_cam[:, 0] / safe_z + cx
    v = fy * vertices_cam[:, 1] / safe_z + cy
    tri_uv = torch.stack([u, v], -1)[tris.long()]  # (T,3,2)
    sample_uv = torch.einsum("si,tij->tsj", bary, tri_uv)
    d_obs = _bilinear(depth_img, sample_uv)
    inb = ((sample_uv[..., 0] >= 0) & (sample_uv[..., 0] < W)
           & (sample_uv[..., 1] >= 0) & (sample_uv[..., 1] < H))
    valid = inb & torch.isfinite(d_obs) & (d_obs > 1e-3) & tri_mask[:, None]
    w = valid.to(vertices_cam.dtype) / (obs_sigma ** 2)
    return bary, torch.where(valid, d_obs, torch.zeros_like(d_obs)), valid, w, z0, safe_z


def _scatter_blocks(V: int, tris, Ht, gt):
    """(V, V) and (V,) sums of per-triangle 3x3 blocks and 3-vectors."""
    t = tris.long()
    Hm = torch.zeros((V, V), dtype=Ht.dtype, device=Ht.device)
    Hm.index_put_((t[:, :, None].expand(-1, 3, 3), t[:, None, :].expand(-1, 3, 3)), Ht,
                  accumulate=True)
    gm = torch.zeros(V, dtype=gt.dtype, device=gt.device).index_put_((t,), gt, accumulate=True)
    return Hm, gm


def _finish(vertices_cam, z_new, safe_z, tris, valid, max_rel_change):
    """Vertices scaled along their rays by the clipped depth ratio, and the
    per-vertex observation counts."""
    ratio = torch.clamp(z_new / safe_z, 1.0 - max_rel_change, 1.0 + max_rel_change)
    V = vertices_cam.shape[0]
    counts = valid.sum(-1).to(torch.int32)[:, None].expand(-1, 3)
    obs_count = torch.zeros(V, dtype=torch.int32, device=vertices_cam.device).index_put_(
        (tris.long(),), counts, accumulate=True)
    return vertices_cam * ratio[:, None], obs_count


def _cho_solve(H, g):
    return torch.cholesky_solve(g[:, None], torch.linalg.cholesky(H))[:, 0]


def optimize_mesh_depths(vertices_cam, tris, tri_mask, depth_img, fx, fy, cx, cy, *,
                         bary_n: int = 4, prior_sigma: float = 0.5, obs_sigma: float = 0.05,
                         max_rel_change: float = 0.5):
    """The joint solve (connected / closed form). `vertices_cam` (V,3)
    camera-frame vertices, `tris` (T,3) vertex indices, `depth_img` (H,W)
    metric depth (<= 0 or NaN invalid). Returns (refined vertices (V,3),
    per-vertex observation count)."""
    V = vertices_cam.shape[0]
    bary, d_obs, valid, w, z0, safe_z = _sample_setup(
        vertices_cam, tris, tri_mask, depth_img, fx, fy, cx, cy, bary_n, obs_sigma)
    Ht = torch.einsum("ts,si,sj->tij", w, bary, bary)
    gt = torch.einsum("ts,si,ts->ti", w, bary, d_obs)
    Hm, gm = _scatter_blocks(V, tris, Ht, gt)
    lam = 1.0 / (prior_sigma ** 2)
    Hm = Hm + lam * torch.eye(V, dtype=Hm.dtype, device=Hm.device)
    z_new = _cho_solve(Hm, gm + lam * z0)
    return _finish(vertices_cam, z_new, safe_z, tris, valid, max_rel_change)


def optimize_mesh_depths_disconnected(vertices_cam, tris, tri_mask, depth_img, fx, fy, cx, cy, *,
                                      bary_n: int = 4, prior_sigma: float = 0.5,
                                      obs_sigma: float = 0.05, max_rel_change: float = 0.5):
    """kDisconnectedMesh: each triangle solves its own 3x3 least squares;
    a shared vertex takes the observation-weighted mean of its triangles'
    solutions."""
    V = vertices_cam.shape[0]
    bary, d_obs, valid, w, z0, safe_z = _sample_setup(
        vertices_cam, tris, tri_mask, depth_img, fx, fy, cx, cy, bary_n, obs_sigma)
    lam = 1.0 / (prior_sigma ** 2)
    Ht = torch.einsum("ts,si,sj->tij", w, bary, bary) + lam * torch.eye(
        3, dtype=w.dtype, device=w.device)
    gt = torch.einsum("ts,si,ts->ti", w, bary, d_obs) + lam * z0[tris.long()]
    z_tri = torch.linalg.solve(Ht, gt[..., None])[..., 0]
    wt = valid.sum(-1).to(w.dtype)[:, None]
    t = tris.long()
    num = torch.zeros(V, dtype=w.dtype, device=w.device).index_put_((t,), z_tri * wt, accumulate=True)
    den = torch.zeros(V, dtype=w.dtype, device=w.device).index_put_(
        (t,), wt.expand_as(z_tri), accumulate=True)
    z_new = torch.where(den > 0, num / torch.clamp(den, min=1e-9), z0)
    return _finish(vertices_cam, z_new, safe_z, tris, valid, max_rel_change)


def optimize_mesh_depths_robust(vertices_cam, tris, tri_mask, depth_img, fx, fy, cx, cy, *,
                                bary_n: int = 4, prior_sigma: float = 0.5,
                                obs_sigma: float = 0.05, max_rel_change: float = 0.5,
                                huber_k_m: float = 0.10, smooth_sigma: float = 0.10,
                                iters: int = 5):
    """kGtsamMesh: IRLS with a Huber loss on the depth residuals plus a
    smoothness term lam_s (z_i - z_j)^2 on every triangle edge."""
    V = vertices_cam.shape[0]
    bary, d_obs, valid, w0, z0, safe_z = _sample_setup(
        vertices_cam, tris, tri_mask, depth_img, fx, fy, cx, cy, bary_n, obs_sigma)
    lam = 1.0 / (prior_sigma ** 2)
    lam_s = 1.0 / (smooth_sigma ** 2)
    t = tris.long()
    ei = t.reshape(-1)
    ej = t[:, [1, 2, 0]].reshape(-1)
    e_on = tri_mask.to(w0.dtype).repeat_interleave(3) * lam_s
    H_lap = torch.zeros((V, V), dtype=w0.dtype, device=w0.device)
    for a, b, sgn in ((ei, ei, 1.0), (ej, ej, 1.0), (ei, ej, -1.0), (ej, ei, -1.0)):
        H_lap.index_put_((a, b), sgn * e_on, accumulate=True)
    eye = lam * torch.eye(V, dtype=w0.dtype, device=w0.device)
    z = z0
    for _ in range(iters):
        pred = torch.einsum("si,ti->ts", bary, z[t])
        res = torch.abs(pred - d_obs)
        w_h = torch.clamp(huber_k_m / torch.clamp(res, min=1e-9), max=1.0)
        w = w0 * torch.where(valid, w_h, torch.zeros_like(w_h))
        Ht = torch.einsum("ts,si,sj->tij", w, bary, bary)
        gt = torch.einsum("ts,si,ts->ti", w, bary, d_obs)
        Hm, gm = _scatter_blocks(V, tris, Ht, gt)
        z = _cho_solve(Hm + eye + H_lap, gm + lam * z0)
    return _finish(vertices_cam, z, safe_z, tris, valid, max_rel_change)


def optimize_mesh(vertices_cam, tris, tri_mask, depth_img, fx, fy, cx, cy,
                  optimizer_type: int = K_CLOSED_FORM, **kw):
    """The MeshOptimizerType dispatcher (mesh/MeshOptimization.h:50)."""
    if optimizer_type == K_DISCONNECTED_MESH:
        fn = optimize_mesh_depths_disconnected
    elif optimizer_type == K_GTSAM_MESH:
        fn = optimize_mesh_depths_robust
    else:
        fn = optimize_mesh_depths
    return fn(vertices_cam, tris, tri_mask, depth_img, fx, fy, cx, cy, **kw)
