"""The port's mesher slice against the JAX package, on the CPU, module by
module: mesher/mesher.py, mesher/plane_tracker.py,
mesher/mesh_optimization.py, dense stereo (ops/stereo_matching.py), the
MesherLogger and the pipeline's RGB-D mesh refinement; and the import
rule for the new modules.

Inputs come from numpy with seeds or are the JAX tests' own fixtures
(tests/test_mesher.py:21-70 and :123-200, tests/test_stereo_matching.py:121
and :147). Tolerances:

  * the triangle filter, plane clustering, histogram bins, plane
    assignments, tracker slots and hits, keep masks, observation counts
    and dense-stereo validity: exact;
  * normals, plane distances, vertices, disparities: 1e-6 (float32
    round-off of a few products; vertices are copied, so equal);
  * the mesh optimizers: 1e-5 m (a dense Cholesky of a 30x30 system in
    float32, assembled in another order);
  * PLY files: byte for byte.

Delaunay is scipy's on both sides; both meshers are fed identical pixels,
ids and points, so ties among cocircular keypoints resolve the same way
(a run-level comparison of triangle lists could part there).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.mesher import mesh_optimization as jmo
from kimera_vio_tpu.mesher import mesher as jm
from kimera_vio_tpu.mesher.plane_tracker import PlaneTracker as JPlaneTracker
from kimera_vio_tpu.ops.stereo_matching import dense_depth as j_dense_depth
from kimera_vio_tpu.ops.stereo_matching import dense_stereo as j_dense_stereo
from kimera_vio_tpu.pipeline.rgbd_pipeline import RgbdImuPipeline as JRgbdPipeline
from kimera_vio_tpu.utils.logger import MesherLogger as JMesherLogger
from kimera_vio_tpu_torch.convert import plane_tracker_from_state
from kimera_vio_tpu_torch.dataprovider.synthetic import synthetic_params
from kimera_vio_tpu_torch.mesher import mesh_optimization as tmo
from kimera_vio_tpu_torch.mesher import mesher as tm
from kimera_vio_tpu_torch.mesher.plane_tracker import PlaneTracker
from kimera_vio_tpu_torch.ops.stereo_matching import dense_depth, dense_stereo
from kimera_vio_tpu_torch.pipeline.rgbd_pipeline import RgbdImuPipeline
from kimera_vio_tpu_torch.utils.logger import MesherLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UP = np.array([0.0, 0.0, 1.0], np.float32)


def T(x):
    return torch.as_tensor(np.array(x))


def grid_scene(nx=8, ny=6, z=2.0, spacing=0.3):
    """tests/test_mesher.py:11: a horizontal grid of landmarks at height z
    and their fake pixels."""
    xs, ys = np.meshgrid(np.arange(nx) * spacing, np.arange(ny) * spacing)
    pts = np.stack([xs.ravel(), ys.ravel(), np.full(nx * ny, z)], -1).astype(np.float32)
    return (pts[:, :2] * 100).astype(np.float32), np.arange(nx * ny, dtype=np.int32), pts


def wall_scene():
    """tests/test_mesher.py:58: landmarks on the x = 1 wall."""
    ys, zs = np.meshgrid(np.arange(8) * 0.3, np.arange(6) * 0.3)
    pts = np.stack([np.full(48, 1.0), ys.ravel(), zs.ravel()], -1).astype(np.float32)
    return (np.stack([pts[:, 1], pts[:, 2]], -1) * 100).astype(np.float32), \
        np.arange(48, dtype=np.int32), pts


def mixed_scene(seed=0):
    """Two floors, a wall and clutter, each with enough triangles for the
    histograms' 20-vote support; a little noise on the planar points."""
    rng = np.random.default_rng(seed)
    parts = []
    for z in (0.4, 1.6):
        xs, ys = np.meshgrid(np.arange(9) * 0.25, np.arange(7) * 0.25)
        parts.append(np.stack([xs.ravel(), ys.ravel(), np.full(63, z)], -1))
    ys, zs = np.meshgrid(np.arange(9) * 0.25, np.arange(7) * 0.25)
    parts.append(np.stack([np.full(63, -1.2), ys.ravel(), zs.ravel()], -1))
    parts.append(rng.uniform(-1, 2, (30, 3)))
    pts = np.concatenate(parts).astype(np.float32)
    pts[:189] += rng.normal(0, 1e-4, (189, 3)).astype(np.float32)
    return pts


def mesh_tris(pts, n_per=63, parts=3):
    """Grid triangles of each planar part of `mixed_scene` (as the mesher
    would build them from a 9x7 keypoint grid per part)."""
    tris = []
    for p in range(parts):
        for r in range(6):
            for c in range(8):
                a = p * n_per + r * 9 + c
                tris += [(a, a + 1, a + 9), (a + 1, a + 10, a + 9)]
    return np.asarray(tris, np.int64)


def test_filter_and_normals_match_jax():
    rng = np.random.default_rng(0)
    fixture = np.array([[[0, 0, 0], [0.3, 0, 0], [0.15, 0.26, 0]],
                        [[0, 0, 0], [0.5, 0, 0], [0.25, 0.001, 0]],
                        [[0, 0, 0], [2.0, 0, 0], [1.0, 1.7, 0]]], np.float32)
    verts = np.concatenate([fixture, rng.uniform(-0.4, 0.4, (200, 3, 3)).astype(np.float32)])
    for kw in ({}, {"max_triangle_side": 1.0, "min_ratio_btw_largest_smallest_side": 0.3}):
        keep_t = tm.filter_triangles(T(verts), **kw).numpy()
        keep_j = np.asarray(jm.filter_triangles(jnp.asarray(verts), **kw))
        np.testing.assert_array_equal(keep_t, keep_j)
        assert 0 < keep_t.sum() < len(keep_t)
        if not kw:  # tests/test_mesher.py:38's verdicts: good, needle, too big
            assert keep_t[:3].tolist() == [True, False, False]
    n_t = tm.triangle_normals(T(verts))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(jm.triangle_normals(jnp.asarray(verts))),
                               atol=1e-6)
    for tol in (0.011, 0.3):
        np.testing.assert_array_equal(
            tm.cluster_by_direction(n_t, T(UP), tol).numpy(),
            np.asarray(jm.cluster_by_direction(jnp.asarray(n_t.numpy()), jnp.asarray(UP), tol)))


def _segment_both(pts, tris, min_support):
    verts = pts[tris]
    jv = jnp.asarray(verts)
    jn = jm.triangle_normals(jv)
    keep = np.ones(len(tris), bool)
    keep[::11] = False
    out = {}
    for name, jf, tf in (("horizontal", jm.segment_horizontal_planes, tm.segment_horizontal_planes),
                         ("walls", jm.segment_walls, tm.segment_walls)):
        j = jf(jv, jnp.asarray(keep), jn, jnp.asarray(UP), min_support=min_support)
        t = tf(T(verts), T(keep), tm.triangle_normals(T(verts)), T(UP), min_support=min_support)
        out[name] = (t, j)
    return out


@pytest.mark.parametrize("support", [20, 5])
def test_segmentation_matches_jax(support):
    """Horizontal planes and walls of a two-floor, one-wall mesh with
    clutter: the same peaks (a low support lets clutter bins tie, which
    the stable sort resolves as `jax.lax.top_k` does), planes and
    triangle assignments."""
    pts = mixed_scene()
    tris = np.concatenate([mesh_tris(pts), np.random.default_rng(1).integers(189, 219, (40, 3))])
    res = _segment_both(pts, tris, support)
    for name, (t, j) in res.items():
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]), err_msg=name)
        np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]), err_msg=name)
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-6, err_msg=name)
        np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=1e-6, err_msg=name)
    h, w = res["horizontal"][0], res["walls"][0]
    assert int(h[2].sum()) >= 2 and int(w[2].sum()) >= 1


@pytest.mark.parametrize("scene", ["floor", "wall"])
def test_segment_planes_matches_jax(scene):
    """tests/test_mesher.py:52 and :58: `Mesher.segment_planes` on the
    mesher's own mesh of the fixture."""
    uv, ids, pts = grid_scene(z=1.5) if scene == "floor" else wall_scene()
    jmesher, tmesher = jm.Mesher(max_triangle_side=1.0), tm.Mesher(max_triangle_side=1.0, device="cpu")
    valid = np.ones(len(ids), bool)
    jmesh = jmesher.spin_once(uv, ids, ids, pts, valid)
    tmesh = tmesher.spin_once(uv, ids, ids, pts, valid)
    np.testing.assert_array_equal(tmesh.lmk_ids, jmesh.lmk_ids)
    jp, tp = jmesher.segment_planes(jmesh), tmesher.segment_planes(tmesh)
    assert len(tp) == len(jp) >= 1
    for a, b in zip(tp, jp):
        assert a["type"] == b["type"]
        np.testing.assert_allclose(a["normal"], b["normal"], atol=1e-6)
        assert abs(a["d"] - b["d"]) < 1e-6
    kind = "horizontal" if scene == "floor" else "wall"
    assert any(p["type"] == kind for p in tp)


def test_spin_once_sequence_matches_jax():
    """Several keyframes over a drifting window of a noisy landmark grid,
    with invalid landmarks, unknown keypoint ids and eviction: the same
    horizon keys, vertices within 1e-6 and the same 2D mesh after each."""
    rng = np.random.default_rng(2)
    n = 12 * 10
    xs, ys = np.meshgrid(np.arange(12) * 0.2, np.arange(10) * 0.2)
    pts_all = np.stack([xs.ravel(), ys.ravel(), 2.0 + rng.normal(0, 0.01, n)], -1).astype(np.float32)
    uv_all = (pts_all[:, :2] * 150 + rng.normal(0, 2.0, (n, 2))).astype(np.float32)
    jmesher, tmesher = jm.Mesher(), tm.Mesher(device="cpu")
    for k in range(5):
        lo = 12 * k
        lmk_ids = np.arange(lo, lo + 60, dtype=np.int32)
        lmk_valid = rng.uniform(size=60) > 0.1
        lmk_pts = pts_all[lmk_ids] + rng.normal(0, 1e-3, (60, 3)).astype(np.float32)
        kp_ids = np.concatenate([lmk_ids[rng.permutation(60)[:45]], [-1, 999]]).astype(np.int32)
        kp_uv = uv_all[np.clip(kp_ids, 0, n - 1)]
        horizon = {int(i) for i in lmk_ids}
        args = (kp_uv, kp_ids, lmk_ids, lmk_pts, lmk_valid)
        jmesh = jmesher.spin_once(*args, horizon_ids=horizon)
        tmesh = tmesher.spin_once(*args, horizon_ids=horizon)
        assert tmesh.n_triangles == jmesh.n_triangles > 0
        np.testing.assert_array_equal(tmesh.lmk_ids, jmesh.lmk_ids)
        np.testing.assert_allclose(tmesh.vertices, jmesh.vertices, atol=1e-6)
        for a, b in zip(tmesher.mesh_2d, jmesher.mesh_2d):
            np.testing.assert_array_equal(a, b)
    assert (tmesh.lmk_ids >= 48).all()  # the first keyframes' triangles were evicted


def test_plane_tracker_sequence_matches_jax():
    """Association, ageing out, a full table, antiparallel matches,
    solver write-back and parallel pairs over 16 keyframes; also the
    state carried over with `convert.plane_tracker_from_state`."""
    rng = np.random.default_rng(3)
    base_n = np.array([[0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0], [0.02, 0, 1.0]], np.float32)
    base_d = np.array([1.0, 2.0, -1.5, 3.0], np.float32)
    jt, tt = JPlaneTracker(max_planes=4, max_age_kf=3), PlaneTracker(max_planes=4, max_age_kf=3)
    for k in range(16):
        pick = rng.permutation(4)[:rng.integers(1, 4)]
        if k % 5 == 4:
            pick = np.array([0, 1, 2, 3])
        n = base_n[pick] + rng.normal(0, 0.02, (len(pick), 3))
        n = n / np.linalg.norm(n, axis=1, keepdims=True)
        d = base_d[pick] + rng.normal(0, 0.05, len(pick))
        flip = rng.uniform(size=len(pick)) < 0.3
        n[flip], d[flip] = -n[flip], -d[flip]
        if k == 7:  # a fifth plane: it takes a slot only if one has aged out
            n, d = np.concatenate([n, [[0.6, 0.8, 0]]]), np.concatenate([d, [9.0]])
        sj, seen_j = jt.associate(n.astype(np.float32), d.astype(np.float32))
        st, seen_t = tt.associate(n.astype(np.float32), d.astype(np.float32))
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(seen_t, seen_j)
        refined_n = jt.normals + rng.normal(0, 1e-3, (4, 3)).astype(np.float32)
        refined_d = jt.ds + rng.normal(0, 1e-3, 4).astype(np.float32)
        jt.update_from_solver(refined_n, refined_d)
        tt.update_from_solver(refined_n, refined_d)
        assert tt.parallel_pairs() == jt.parallel_pairs()
    for name in ("normals", "ds", "active", "last_seen", "hits", "slot_pid"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name), err_msg=name)
    assert tt._next_pid == jt._next_pid > 4 and tt.parallel_pairs()
    carried = plane_tracker_from_state(vars(jt))
    n = base_n[:2] / np.linalg.norm(base_n[:2], axis=1, keepdims=True)
    np.testing.assert_array_equal(carried.associate(n, base_d[:2])[0], jt.associate(n, base_d[:2])[0])


def _mesh_opt_scene(seed=0):
    """tests/test_mesher.py:123's scene: a slanted plane's depth image and a
    6x5 vertex grid on it with perturbed depths."""
    rng = np.random.default_rng(seed)
    H, W = 120, 160
    fx = fy = 100.0
    cx, cy = W / 2, H / 2
    ys, xs = np.mgrid[0:H, 0:W]
    depth = 2.0 / np.maximum(1.0 - 0.4 * (xs - cx) / fx - 0.2 * (ys - cy) / fy, 0.3)
    uu, vv = np.meshgrid(np.linspace(20, W - 20, 6), np.linspace(15, H - 15, 5))
    uv = np.stack([uu.ravel(), vv.ravel()], -1)
    x_n, y_n = (uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy
    z_gt = 2.0 / np.maximum(1.0 - 0.4 * x_n - 0.2 * y_n, 0.3)
    z = z_gt * (1.0 + rng.uniform(-0.15, 0.15, z_gt.shape))
    from scipy.spatial import Delaunay

    tris = Delaunay(uv).simplices.astype(np.int32)
    return (np.stack([x_n * z, y_n * z, z], -1).astype(np.float32), tris, depth.astype(np.float32),
            z_gt, fx, fy, cx, cy)


@pytest.mark.parametrize("depth_kind", ["clean", "outliers", "invalid"])
@pytest.mark.parametrize("optimizer", [tmo.K_CONNECTED_MESH, tmo.K_DISCONNECTED_MESH,
                                       tmo.K_CLOSED_FORM, tmo.K_GTSAM_MESH])
def test_optimize_mesh_matches_jax(optimizer, depth_kind):
    verts, tris, depth, z_gt, fx, fy, cx, cy = _mesh_opt_scene()
    if depth_kind == "outliers":  # tests/test_mesher.py:166: 10 % blown up
        depth = depth.copy()
        depth[np.random.default_rng(3).random(depth.shape) < 0.10] = 25.0
    elif depth_kind == "invalid":
        depth = np.full_like(depth, np.nan)
    tri_mask = np.ones(len(tris), bool)
    tri_mask[3] = False
    jv, jc = jmo.optimize_mesh(jnp.asarray(verts), jnp.asarray(tris), jnp.asarray(tri_mask),
                               jnp.asarray(depth), fx, fy, cx, cy, optimizer_type=optimizer)
    tv, tc = tmo.optimize_mesh(T(verts), T(tris), T(tri_mask), T(depth), fx, fy, cx, cy,
                               optimizer_type=optimizer)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if depth_kind == "clean":
        assert np.abs(tv.numpy()[:, 2] - z_gt).mean() < 0.5 * np.abs(verts[:, 2] - z_gt).mean()


def test_mesher_logger_writes_the_same_bytes(tmp_path):
    """Three meshes (one empty, one of small coordinates) through both
    loggers: the same file names and bytes."""
    rng = np.random.default_rng(4)
    jlog, tlog = JMesherLogger(str(tmp_path / "jax")), MesherLogger(str(tmp_path / "port"))
    for k in range(3):
        verts = (rng.normal(0, 3, (3 * (k + 4) if k else 0, 3)) * [1, 1, 1e-4 if k == 2 else 1])
        verts = verts.astype(np.float32)
        tri = np.arange(len(verts)).reshape(-1, 3)
        jlog.log(verts, tri)
        tlog.log(verts, tri)
    names = sorted(os.listdir(tmp_path / "jax" / "mesh"))
    assert sorted(os.listdir(tmp_path / "port" / "mesh")) == names and len(names) == 3
    for name in names:
        assert (tmp_path / "port" / "mesh" / name).read_bytes() == \
            (tmp_path / "jax" / "mesh" / name).read_bytes()


def textured(h, w, seed):
    """tests/test_stereo_matching.py:14."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h // 4, w // 4)).astype(np.float32)
    return ndi.zoom(img, 4, order=3)[:h, :w].astype(np.float32)


def constant_pair():
    """tests/test_stereo_matching.py:121: a constant 7.3 px disparity."""
    rng = np.random.RandomState(0)
    H, W, D = 96, 160, 24
    tex = ndi.gaussian_filter(rng.rand(H, W + D + 10).astype(np.float32) * 255, 1.2)
    xs = np.arange(W) + D + 7.3
    x0 = np.floor(xs).astype(int)
    f = xs - x0
    return tex[:, D:D + W], (tex[:, x0] * (1 - f) + tex[:, x0 + 1] * f).astype(np.float32), D


def occlusion_pair():
    """tests/test_stereo_matching.py:147: a foreground strip at disparity
    20 over a background at 4."""
    H, W = 96, 192
    tex = textured(H, W + 64, seed=3)
    left = tex[:, 32:32 + W].copy()
    right = tex[:, 36:36 + W].copy()
    left[:, 90:130] = tex[:, 90:130]
    right[:, 70:110] = tex[:, 90:130]
    return left, right, 32


@pytest.mark.parametrize("lr_check", [False, True], ids=["plain", "lr_check"])
@pytest.mark.parametrize("pair", ["constant", "occlusion"])
def test_dense_stereo_matches_jax(pair, lr_check):
    left, right, D = constant_pair() if pair == "constant" else occlusion_pair()
    for kw in ({}, {"prefilter_xsobel": True, "block_size": 7, "min_disparity": 2}):
        jd, jok = j_dense_stereo(jnp.asarray(left), jnp.asarray(right), num_disparities=D,
                                 lr_check=lr_check, **kw)
        td, tok = dense_stereo(T(left), T(right), num_disparities=D, lr_check=lr_check, **kw)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    assert tok.numpy().mean() > 0.3


def test_dense_depth_matches_jax():
    """On a 160x120 pair (the CPU size of the pipeline tests): a textured
    plane at 2 m with fx 120 and a 0.11 m baseline (6.6 px disparity),
    and a uint8 pair of the same scene."""
    tex = textured(120, 200, seed=5)
    xs = np.arange(160) + 20 + 6.6
    x0 = np.floor(xs).astype(int)
    f = xs - x0
    left = tex[:, 20:180]
    right = (tex[:, x0] * (1 - f) + tex[:, x0 + 1] * f).astype(np.float32)
    for l_img, r_img in ((left, right), (np.round(left).astype(np.uint8),
                                          np.round(right).astype(np.uint8))):
        kw = dict(fx=120.0, baseline=0.11, min_depth=0.3, max_depth=10.0, num_disparities=32)
        jd = np.asarray(j_dense_depth(jnp.asarray(l_img), jnp.asarray(r_img), **kw))
        td = dense_depth(T(l_img), T(r_img), **kw).numpy()
        np.testing.assert_array_equal(td > 0, jd > 0)
        np.testing.assert_allclose(td, jd, atol=1e-5)
        assert (td > 0).mean() > 0.3 and abs(np.median(td[td > 0]) - 2.0) < 0.1


def test_rgbd_refine_mesh_matches_jax():
    """The RGB-D branch of the mesher feed: `_refine_mesh` against the
    sensor depth (the RGB-D pipeline takes no enable_mesher, as in the JAX
    package, so it is driven directly), with the default closed-form
    optimizer, on a mesh of landmarks perturbed off a plane 2 m ahead."""
    jp = j_synthetic_params(width=160, height=120, fx=120.0)
    tp = synthetic_params(width=160, height=120, fx=120.0)
    jpipe, tpipe = JRgbdPipeline(jp, parallel_run=False), RgbdImuPipeline(tp, device="cpu")
    rng = np.random.default_rng(6)
    cam = np.stack([rng.uniform(-1, 1, 40), rng.uniform(-0.7, 0.7, 40),
                    2.0 + rng.uniform(-0.2, 0.2, 40)], -1)
    # The body at the origin: world = R_b_rect cam + t_b_rect.
    world = (cam @ tpipe.stereo.R_b_rect.numpy().T + tpipe.stereo.t_b_rect.numpy()).astype(np.float32)
    ids = np.arange(100, 140)
    tris = np.asarray(jm.delaunay_2d(cam[:, :2] / cam[:, 2:]))
    depth = np.full((120, 160), 2.0, np.float32)
    pose_R, pose_t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jmesh = jpipe._refine_mesh(jm.Mesh3D(ids[tris], world[tris]), depth, pose_R, pose_t)
    tmesh = tpipe._refine_mesh(tm.Mesh3D(ids[tris], world[tris]), T(depth), pose_R, pose_t)
    np.testing.assert_array_equal(tmesh.lmk_ids, jmesh.lmk_ids)
    np.testing.assert_allclose(tmesh.vertices, jmesh.vertices, atol=1e-5)
    assert not np.allclose(tmesh.vertices, world[tris], atol=1e-3)  # the refine moved them


def test_slice_modules_import_without_jax():
    """The new modules import with jax, flax, yaml and cv2 blocked, and
    pull in nothing of the JAX package (tests/test_torch_frontend_ops.py's
    check walks the whole package; this names the slice's modules)."""
    code = r"""
import importlib, sys
for m in ("jax", "flax", "yaml", "cv2"):
    sys.modules[m] = None
for name in ("mesher.mesher", "mesher.plane_tracker", "mesher.mesh_optimization",
             "backend.regular_vio", "ops.stereo_matching", "utils.logger", "convert",
             "pipeline.stereo_pipeline", "__main__"):
    importlib.import_module("kimera_vio_tpu_torch." + name)
bad = [m for m in sys.modules if m == "kimera_vio_tpu" or m.startswith("kimera_vio_tpu.")]
assert not bad, bad
from kimera_vio_tpu_torch.ops.stereo_matching import dense_depth, dense_stereo
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_mesher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.Mesher()
