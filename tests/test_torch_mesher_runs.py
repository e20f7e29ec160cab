"""The mesher and RegularVIO through the port's `run()`, against the JAX
`run()` and against the JAX package's own gates, on the CPU.

Like with like (the port tracks with the gather rule and draws the JAX
package's RANSAC hypotheses, as tests/test_torch_variants.py sets up):
`run()` with `backend_type: 1` and the mesher on, sequential and
parallel, against the JAX sequential `run()`, on the near plane of
tests/test_regular_vio.py:240 (vx 0.25 m/s, depth 1.8 m) at 320x240 with
fx 240 (the field of view of the 160x120 / fx 120 rig of the earlier run
tests, where that rig detects ~14 keypoints a keyframe and no plane
reaches the segmentation's 20-triangle support), 41 frames, no noise:
the same keyframe stamps, positions within 1e-3 m (measured 8.8e-5 m),
the same plane-tracker hits and active slots, one PLY per keyframe after
the bootstrap on both sides. With pixel noise the two plain
(backend_type 0) runs already part by 2.4 mm on this scene, where one
mono-RANSAC inlier flips at the second keyframe; so the noisy scene
holds the port's own runs to the JAX gates
(tests/test_regular_vio.py:274): some plane slot hit on >= 5 keyframes,
ATE(regular) <= 1.2 ATE(plain) + 5e-4 m.
"""

import functools
import os

import numpy as np
import pytest
import torch

from kimera_vio_tpu.dataprovider import synthetic as jsyn
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.dataprovider import synthetic as tsyn
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.ops.lk_kernel import klt_track_lk
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.utils.logger import compute_ate
from tests.test_torch_variants import _jax_draws

SIZE = dict(width=320, height=240, fx=240.0)
N_FRAMES = 41


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def near_plane(mod, noise: bool, regular: bool = True):
    """(params, provider) of the near plane at 320x240 from `mod`, either
    package's dataprovider.synthetic."""
    p = mod.synthetic_params(nr_states=8, max_features=96, max_landmarks=128, **SIZE)
    p.pipeline.backend_type = 1 if regular else 0
    p.frontend.min_point_dist = 0.3
    nm = mod._NoiseModel(imu_rate=200.0, pixel_noise_std=0.5, acc_noise_density=2e-3,
                         gyro_noise_density=1.6968e-4, seed=5) if noise else None
    return p, mod.SyntheticStereoProvider(n_frames=N_FRAMES, vx=0.25, depth=1.8, noise=nm, **SIZE)


def ate(out, prov):
    gt = prov.ground_truth
    return compute_ate(np.array(out.stamps_ns), np.stack(out.positions), gt.stamps_ns,
                       gt.positions, align=False)["rmse"]


@pytest.fixture
def like_jax(monkeypatch):
    monkeypatch.setenv("KIMERA_LK_IMPL", "gather")
    monkeypatch.setattr(vision_frontend, "klt_track_lk",
                        functools.partial(klt_track_lk, search_rows=None))
    monkeypatch.setattr(transac, "_sample_indices", _jax_draws)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("jax_regular"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KIMERA_LK_IMPL", "gather")
        params, prov = near_plane(jsyn, noise=False)
        pipe = JPipeline(params, parallel_run=False, enable_mesher=True, output_path=out_dir)
        out = pipe.run(prov)
    return out, pipe._plane_tracker, len(os.listdir(os.path.join(out_dir, "mesh")))


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_run_matches_jax(like_jax, jax_run, tmp_path, parallel):
    jout, jtracker, j_plys = jax_run
    params, prov = near_plane(tsyn, noise=False)
    pipe = StereoImuPipeline(params, parallel_run=parallel, device="cpu", enable_mesher=True,
                             output_path=str(tmp_path))
    assert pipe.use_regular_vio
    out = pipe.run(prov)
    assert out.n_frames == jout.n_frames == N_FRAMES
    assert out.stamps_ns == jout.stamps_ns and out.n_keyframes >= 8
    np.testing.assert_allclose(np.stack(out.positions), np.stack(jout.positions), atol=1e-3)
    tracker = pipe._plane_tracker
    assert tracker.hits.max() >= 5
    np.testing.assert_array_equal(tracker.hits, jtracker.hits)
    np.testing.assert_array_equal(tracker.active, jtracker.active)
    assert len(os.listdir(tmp_path / "mesh")) == j_plys == out.n_keyframes - 1


def test_noisy_run_holds_the_jax_gates():
    """tests/test_regular_vio.py:230 on the port: the plain backend, then
    RegularVIO with the mesher, on the noisy near plane."""
    params, prov = near_plane(tsyn, noise=True, regular=False)
    plain = StereoImuPipeline(params, parallel_run=False, device="cpu")
    assert not plain.use_regular_vio
    ate_plain = ate(plain.run(prov), prov)
    params, prov = near_plane(tsyn, noise=True)
    pipe = StereoImuPipeline(params, parallel_run=False, device="cpu", enable_mesher=True)
    refines = []
    orig = pipe._regular_refine
    pipe._regular_refine = lambda *a: refines.append(1) or orig(*a)
    ate_reg = ate(pipe.run(prov), prov)
    assert pipe._plane_tracker.hits.max() >= 5, pipe._plane_tracker.hits
    assert ate_reg <= ate_plain * 1.2 + 5e-4, (ate_reg, ate_plain)
    assert len(refines) >= 5


def test_mesher_without_regular_vio_leaves_the_trajectory():
    """backend_type 0 with the mesher on: PLYs, no refine, and the plain
    run's trajectory exactly (the mesher only reads the keyframes)."""
    params, prov = near_plane(tsyn, noise=True, regular=False)
    out0 = StereoImuPipeline(params, parallel_run=False, device="cpu").run(prov)
    pipe = StereoImuPipeline(params, parallel_run=False, device="cpu", enable_mesher=True)
    assert not pipe.use_regular_vio
    out1 = pipe.run(prov)
    assert out1.stamps_ns == out0.stamps_ns
    np.testing.assert_array_equal(np.stack(out1.positions), np.stack(out0.positions))
    assert pipe._plane_tracker is None and pipe._mesher.horizon_mesh().n_triangles > 0
