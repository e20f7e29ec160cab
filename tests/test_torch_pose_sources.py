"""The port's pose sources and extra factors through `run()`, against the
JAX pipeline.

Three runs of `StereoImuPipeline.run()` on the 160x120 synthetic sequence
(fx = 120, 30 frames, as tests/test_rgbd_provider.py:27 sizes it):

  * between-stereo factors (`addBetweenStereoFactors`, translation
    precision 100) with the STEREO pose guess (`pose_guess_source: 2`);
  * PnP tracking against the backend's landmark map with the PnP guess
    (`use_pnp_tracking`, `pose_guess_source: 3`, 10 inliers needed);
  * external odometry: an `OdometryBuffer` of the ground-truth poses on
    the provider (EXT_ODOM).

The JAX side tracks with its gather LK; the port tracks with the gather
tracker's level plan and draws the JAX package's RANSAC hypotheses (the
same `jax.random` indices through `ops.ransac._sample_indices`), so both
run the same arithmetic up to float32 summation order. Tolerance: the
same keyframe stamps, positions within 1e-3 m; and the JAX tests' effect
gate, ATE < 0.06 m (tests/test_pipeline_wiring.py:62, :73, :85, :203).
The port's PnP run also counts the keyframes whose PnP guess it
accepted: none, since the scene is one plane, where the 6-point DLT refit
is degenerate (the port gates the guess on the refit pose's own inliers);
so that run is the IMU-guess trajectory, as the JAX one is.
"""

import dataclasses
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_vio_tpu.common import geometry as jgeo
from kimera_vio_tpu.dataprovider.odometry import OdometryBuffer as JOdometryBuffer
from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.common import geometry as geo
from kimera_vio_tpu_torch.convert import vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.odometry import OdometryBuffer
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.ops.lk_kernel import klt_track_lk
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.utils.logger import compute_ate


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores,
    and these small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_spec = importlib.util.spec_from_file_location(
    "torch_variants", os.path.join(os.path.dirname(__file__), "test_torch_variants.py"))
_tv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tv)

SIZE = dict(width=160, height=120, fx=120.0)
N_FRAMES = 30


@pytest.fixture
def like_jax(monkeypatch):
    monkeypatch.setenv("KIMERA_LK_IMPL", "gather")
    monkeypatch.setattr(vision_frontend, "klt_track_lk",
                        functools.partial(klt_track_lk, search_rows=None))
    monkeypatch.setattr(transac, "_sample_indices", _tv._jax_draws)


def _params(variant):
    p = j_synthetic_params(**SIZE, nr_states=8, max_features=64, max_landmarks=96)
    p.frontend.klt_max_level = 2
    p.frontend.templ_cols = 31
    p.frontend.templ_rows = 7
    if variant == "between_stereo":
        p.backend.add_between_stereo_factors = True
        p.backend.between_translation_precision = 100.0
        p.backend.pose_guess_source = 2
    elif variant == "pnp":
        p.frontend.use_pnp_tracking = True
        p.frontend.min_pnp_inliers = 10
        p.backend.pose_guess_source = 3
    return p, vio_params_from_dict(dataclasses.asdict(p))


def _with_gt_odometry(prov, buf, to_rot):
    gt = prov.ground_truth
    for i in range(len(gt.stamps_ns)):
        buf.add(int(gt.stamps_ns[i]), to_rot(gt.quats_wxyz[i]), gt.positions[i])
    prov.odometry = buf
    return prov


@pytest.mark.parametrize("variant", ["between_stereo", "pnp", "ext_odometry"])
def test_pose_source_run_matches_jax(like_jax, monkeypatch, variant):
    jp, tp = _params(variant)
    jprov = JProvider(n_frames=N_FRAMES, vx=0.5, **SIZE)
    tprov = SyntheticStereoProvider(n_frames=N_FRAMES, vx=0.5, **SIZE)
    if variant == "ext_odometry":
        _with_gt_odometry(jprov, JOdometryBuffer(), lambda q: np.asarray(
            jgeo.quat_to_rot(jnp.asarray(q, jnp.float32))))
        _with_gt_odometry(tprov, OdometryBuffer(), lambda q: geo.quat_to_rot(
            torch.as_tensor(np.asarray(q, np.float32))).numpy())
    jpipe = JPipeline(jp, parallel_run=False)
    jout = jpipe.run(jprov)
    pipe = StereoImuPipeline(tp, parallel_run=False, device="cpu")
    accepted = []
    if variant == "pnp":
        orig = StereoImuPipeline._pnp_pose

        def counted(self, *a):
            R, t, ok = orig(self, *a)
            accepted.append(bool(ok))
            return R, t, ok
        monkeypatch.setattr(StereoImuPipeline, "_pnp_pose", counted)
    out = pipe.run(tprov)
    assert out.n_frames == jout.n_frames == N_FRAMES
    assert out.stamps_ns == jout.stamps_ns
    assert out.n_keyframes >= 3
    np.testing.assert_allclose(np.stack(out.positions), np.stack(jout.positions), atol=1e-3)
    gt = tprov.ground_truth
    ate = compute_ate(np.array(out.stamps_ns), np.stack(out.positions), gt.stamps_ns,
                      gt.positions, align=False)
    assert ate["rmse"] < 0.06, ate
    if variant == "pnp":
        assert len(accepted) == out.n_keyframes - 1 and not any(accepted)
    if variant == "ext_odometry":
        assert bool(pipe._last_win.ext_valid.any())  # the factors are in the window
