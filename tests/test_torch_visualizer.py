"""The port's visualizer, file display and playground against the JAX
package's.

  * The twin of tests/test_misc_modules.py:11: the same poses, landmarks
    and mesh through `Visualizer3D` and `FileDisplay` (save_every 1) on
    both sides: the same files, the PLY point clouds and meshes
    byte for byte; `displayed_trajectory_length` trims both trajectory
    widgets alike.
  * The `mesh2d_*.png` overlay (`visualize_mesh_2d`): pixel for pixel the
    JAX package's `cv2.polylines` drawing, tolerance 0, on a float image
    with triangles reaching past the image edges.
  * The trajectory plot: not matplotlib's figure (the JAX package's;
    a named divergence), a numpy raster: the last pose's red marker and
    the path's first point at the pixels `trajectory_pixels` documents.
  * The twin of tests/test_misc_modules.py:122 (`visualize_gt_data`),
    which needs MicroEuroc, absent here: a EuRoC folder written from the
    synthetic provider by chip_smoke.write_euroc. Both sides write the
    same trajectory files; a folder without ground truth raises
    ValueError on both.
  * The mesher's stale `mesh_2d` (JAX mesher.py:271): after a keyframe
    that triangulates nothing, the port's is None, the JAX package's
    still the previous keyframe's (a named divergence).
  * `run()` with `visualize`, the mesher and `visualize_mesh_2d` on the
    near plane (320x240): per keyframe after the bootstrap a point cloud
    and a mesh PLY and, where the mesher triangulated, a `mesh2d` image
    with green edges.
"""

import importlib.util
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from kimera_vio_tpu.config import flags as jflags
from kimera_vio_tpu.mesher import mesher as jm
from kimera_vio_tpu.mesher.mesher import Mesh3D as JMesh3D
from kimera_vio_tpu.playground import visualize_gt_data as j_visualize_gt_data
from kimera_vio_tpu.visualizer import visualizer as jviz
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.dataprovider.png import decode_png_rgb8
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.mesher import mesher as tm
from kimera_vio_tpu_torch.mesher.mesher import Mesh3D
from kimera_vio_tpu_torch.pipeline import stereo_pipeline
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.playground import visualize_gt_data
from kimera_vio_tpu_torch.visualizer import visualizer as tviz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = [(reg, {k: f.value for k, f in reg._REGISTRY.items()}) for reg in (flags, jflags)]
    yield
    for reg, values in saved:
        for k, v in values.items():
            reg._REGISTRY[k].value = v


def _spin(mod, out_dir, mesh_cls, n=3):
    viz = mod.Visualizer3D()
    disp = mod.FileDisplay(str(out_dir), save_every=1)
    mesh = mesh_cls(lmk_ids=np.array([[0, 1, 2]]),
                    vertices=np.array([[[0, 0, 1], [1, 0, 1], [0, 1, 1]]], np.float32))
    widgets = []
    for k in range(n):
        w = viz.spin_once(np.eye(3), np.array([0.1 * k, 0.05 * k * k, 0]),
                          lmk_points=np.array([[0, 0, 2.0], [1, 1, 2.0], [3, 1, 4.0]]),
                          lmk_valid=np.array([True, True, k % 2 == 0]),
                          lmk_ids=np.array([1, 2, 3]), mesh=mesh)
        disp.spin_once(w)
        widgets.append(w)
    return widgets


def test_visualizer_and_file_display(tmp_path):
    jw = _spin(jviz, tmp_path / "j", JMesh3D)
    tw = _spin(tviz, tmp_path / "t", Mesh3D)
    jfiles, tfiles = sorted(os.listdir(tmp_path / "j")), sorted(os.listdir(tmp_path / "t"))
    assert tfiles == jfiles
    assert any(f.startswith("pointcloud") for f in tfiles)
    assert any(f.startswith("mesh") for f in tfiles)
    for f in tfiles:
        if f.endswith(".ply"):
            assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    assert "element face 1" in (tmp_path / "t" / "mesh_000001.ply").read_text()
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(b.trajectory, a.trajectory)
        np.testing.assert_array_equal(b.pointcloud, a.pointcloud)
        np.testing.assert_array_equal(b.pointcloud_ids, a.pointcloud_ids)


def test_displayed_trajectory_length_trims(tmp_path):
    flags.set_flag("displayed_trajectory_length", 2)
    jflags.set_flag("displayed_trajectory_length", 2)
    jw = _spin(jviz, tmp_path / "j", JMesh3D, n=5)
    tw = _spin(tviz, tmp_path / "t", Mesh3D, n=5)
    assert [len(w.trajectory) for w in tw] == [1, 2, 2, 2, 2]
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(b.trajectory, a.trajectory)
    viz = tviz.Visualizer3D(tviz.VIZ_NONE)
    w = viz.spin_once(np.eye(3), np.zeros(3), lmk_points=np.ones((2, 3)),
                      lmk_valid=np.array([True, True]))
    assert w.pointcloud is None


@pytest.mark.parametrize("seed", [0, 1])
def test_mesh_2d_overlay_matches_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    H, W = 50, 70
    image = rng.uniform(-20, 280, (H, W)).astype(np.float32)
    uv = np.stack([rng.uniform(-6, W + 6, 40), rng.uniform(-6, H + 6, 40)], -1)
    uv[:4] = [[0.5, 0.5], [W - 0.5, 3.5], [2.5, H - 0.5], [W + 0.4, H + 0.4]]
    tris = rng.integers(0, 40, (30, 3))
    for mod, d in ((jviz, "j"), (tviz, "t")):
        mod.FileDisplay(str(tmp_path / d), save_every=1).spin_once(
            mod.WidgetMap(mesh_2d=(uv, tris), image=image))
    want = cv2.imread(str(tmp_path / "j" / "mesh2d_000001.png"))
    got = cv2.imread(str(tmp_path / "t" / "mesh2d_000001.png"))
    assert want.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tviz.draw_mesh_2d(image, (uv, tris)), want[..., ::-1])
    assert (want[..., 1] == 255).sum() > 100


def test_trajectory_plot_marker(tmp_path):
    traj = np.array([[0.0, 0.0, 0.0], [1.0, 0.25, 0.0], [2.0, 0.5, 1.0]])
    px = tviz.trajectory_pixels(traj)
    # x extent 2 m fills the 400 px plot area: 200 px a metre, centred.
    np.testing.assert_array_equal(px, [[40, 290], [240, 240], [440, 190]])
    disp = tviz.FileDisplay(str(tmp_path), save_every=1)
    disp.spin_once(tviz.WidgetMap(trajectory=traj))
    img = decode_png_rgb8(str(tmp_path / "trajectory_000001.png"))
    assert img.shape == (480, 480, 3)
    assert tuple(img[190, 440]) == tviz.PLOT_MARKER
    assert tuple(img[190 + tviz.PLOT_MARKER_RADIUS, 440]) == tviz.PLOT_MARKER
    assert tuple(img[290, 40]) == tviz.PLOT_LINE
    assert tuple(img[265, 140]) == tviz.PLOT_LINE  # on the segment (0,0)-(1,0.25)
    assert tuple(img[40, 40]) == (0, 0, 0) and tuple(img[5, 5]) == (255, 255, 255)
    # One pose: no plot (the JAX display's len > 1 rule).
    disp.spin_once(tviz.WidgetMap(trajectory=traj[:1]))
    assert not os.path.exists(tmp_path / "trajectory_000002.png")


@pytest.fixture(scope="module")
def euroc_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("euroc")
    chip_smoke.write_euroc(str(root), SyntheticStereoProvider(n_frames=30, vx=0.5, width=64,
                                                              height=48, fx=50.0))
    return root


def test_playground(tmp_path, euroc_folder):
    jout = j_visualize_gt_data(str(euroc_folder), str(tmp_path / "j"))
    tout = visualize_gt_data(str(euroc_folder), str(tmp_path / "t"), device="cpu")
    assert (jout, tout) == (str(tmp_path / "j"), str(tmp_path / "t"))
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j")) == ["trajectory_000002.png",
                                                           "trajectory_000003.png"]
    img = decode_png_rgb8(str(tmp_path / "t" / files[-1]))
    assert (img == tviz.PLOT_MARKER).all(-1).any()
    no_gt = tmp_path / "no_gt"
    shutil.copytree(euroc_folder, no_gt)
    shutil.rmtree(no_gt / "mav0" / "state_groundtruth_estimate0")
    with pytest.raises(ValueError):
        j_visualize_gt_data(str(no_gt), str(tmp_path / "j2"))
    with pytest.raises(ValueError):
        visualize_gt_data(str(no_gt), str(tmp_path / "t2"), device="cpu")


def test_mesh_2d_cleared_after_empty_keyframe():
    rng = np.random.default_rng(2)
    kp_uv = rng.uniform(10, 150, (12, 2)).astype(np.float32)
    ids = np.arange(12)
    pts = np.concatenate([rng.uniform(-1, 1, (12, 2)), np.full((12, 1), 3.0)], 1).astype(np.float32)
    valid = np.ones(12, bool)
    jmesher, tmesher = jm.Mesher(max_triangle_side=5.0), tm.Mesher(max_triangle_side=5.0,
                                                                   device="cpu")
    for mesher in (jmesher, tmesher):
        mesher.spin_once(kp_uv, ids, ids, pts, valid)
        assert mesher.mesh_2d is not None and len(mesher.mesh_2d[1]) > 0
        mesher.spin_once(kp_uv[:2], ids[:2], ids, pts, valid)  # too few to triangulate
    assert tmesher.mesh_2d is None
    assert jmesher.mesh_2d is not None  # the JAX mesher's stale mesh_2d, named


def test_run_with_visualizer_and_mesh_2d(tmp_path, monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(stereo_pipeline, "make_display",
                        lambda display_type, path: tviz.FileDisplay(path, save_every=1))
    flags.set_flag("visualize", True)
    flags.set_flag("visualize_mesh_2d", True)
    p = synthetic_params(width=320, height=240, fx=240.0, max_features=64, max_landmarks=96,
                         nr_states=5)
    p.frontend.min_point_dist = 0.3
    rows = []  # per keyframe: the mesher's inputs and its 2-D mesh
    spin = tm.Mesher.spin_once

    def recording_spin(mesher, *args, **kw):
        mesh = spin(mesher, *args, **kw)
        rows.append(([np.array(a) for a in args], dict(kw), mesher.mesh_2d))
        return mesh

    monkeypatch.setattr(tm.Mesher, "spin_once", recording_spin)
    try:
        pipe = StereoImuPipeline(p, output_path=str(tmp_path), device="cpu", enable_mesher=True)
        out = pipe.run(SyntheticStereoProvider(n_frames=41, vx=0.25, depth=1.8, width=320,
                                               height=240, fx=240.0))
    finally:
        torch.set_num_threads(n)
    fed = out.n_keyframes - 1
    assert pipe._display._count == fed == len(rows) >= 5
    files = os.listdir(tmp_path / "viz")
    for kind in ("pointcloud", "mesh"):
        assert sorted(f for f in files if f.startswith(kind + "_")) == [
            f"{kind}_{k:06d}.ply" for k in range(1, fed + 1)]
    # The JAX mesher on the same keyframe rows has a 2-D mesh on exactly
    # the same keyframes (its stale mesh_2d reset before each call, the
    # named divergence aside), and the same one.
    jmesher = jm.Mesher()
    for args, kw, got in rows:
        jmesher.mesh_2d = None
        jmesher.spin_once(*args, **kw)
        assert (got is None) == (jmesher.mesh_2d is None)
        if got is not None:
            np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(jmesher.mesh_2d[1]))
            np.testing.assert_allclose(np.asarray(got[0]), np.asarray(jmesher.mesh_2d[0]))
    m2d = sorted(f for f in files if f.startswith("mesh2d"))
    assert len(m2d) == sum(got is not None for _, _, got in rows) >= fed - 2
    img = decode_png_rgb8(str(tmp_path / "viz" / m2d[-1]))
    assert img.shape == (240, 320, 3) and (img == tviz.MESH_2D_COLOR).all(-1).sum() > 100
