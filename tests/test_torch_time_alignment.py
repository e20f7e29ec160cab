"""Fine IMU-camera time alignment through `run()`, against the JAX
pipeline (`--do_fine_imu_camera_temporal_sync`: the 3-pt stereo solver
forced, its keyframe rotations and the gyro fed to the cross-correlation
aligner until it estimates the offset, then the estimator restarts).

Two runs, each through the JAX and port `StereoImuPipeline.run()` at
160x120 (fx = 120), the JAX side tracking with its gather LK and the port
with the gather tracker's level plan, drawing the JAX package's RANSAC
hypotheses (tests/test_torch_variants.py::_jax_draws):

  * the smoke of tests/test_pipeline_wiring.py:164 on the straight
    30-frame sequence: no rotation, so the variance gate withholds any
    estimate (`time_shift_estimate_s is None` on both sides) and every
    frame is published;
  * the restart on a 40-frame 6-DoF orbit (a 2 s period on every axis,
    the plane at 3 m) with a 1 s window and no variance gate: an estimate
    lands after half a window, the estimator restarts at the next frame.
    The same estimate (the lag is a whole number of IMU samples), the same
    published frame count and keyframe stamps.

Positions within 1e-3 m in both.
"""

import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from kimera_vio_tpu.config import flags as jflags
from kimera_vio_tpu.dataprovider import synthetic as jsyn
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.convert import vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider import synthetic as tsyn
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.ops.lk_kernel import klt_track_lk
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline


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

W, H, FX = 160, 120, 120.0


def _params(**imu):
    p = jsyn.synthetic_params(width=W, height=H, fx=FX, nr_states=8, max_features=64,
                              max_landmarks=96)
    p.frontend.klt_max_level = 2
    p.frontend.templ_cols = 31
    p.frontend.templ_rows = 7
    for k, v in imu.items():
        setattr(p.imu, k, v)
    return p, vio_params_from_dict(dataclasses.asdict(p))


def _orbit(mod, n_frames=40):
    w = 2 * np.pi / 2.0
    return mod.SyntheticPlanar6DofProvider(
        n_frames=n_frames, width=W, height=H, fx=FX, plane_z=3.0, trans_amp=(0.4, 0.2, 0.1),
        rot_amp=(0.05, 0.06, 0.08), trans_freq=(w, w, w), rot_freq=(w, w, w))


def _both(monkeypatch, jp, tp, jprov, tprov):
    monkeypatch.setenv("KIMERA_LK_IMPL", "gather")
    monkeypatch.setattr(vision_frontend, "klt_track_lk",
                        functools.partial(klt_track_lk, search_rows=None))
    monkeypatch.setattr(transac, "_sample_indices", _tv._jax_draws)
    jflags.set_flag("do_fine_imu_camera_temporal_sync", True)
    flags.set_flag("do_fine_imu_camera_temporal_sync", True)
    try:
        jpipe = JPipeline(jp, parallel_run=False)
        jout = jpipe.run(jprov)
        tpipe = StereoImuPipeline(tp, parallel_run=False, device="cpu")
        tout = tpipe.run(tprov)
    finally:
        jflags.set_flag("do_fine_imu_camera_temporal_sync", False)
        flags.set_flag("do_fine_imu_camera_temporal_sync", False)
    assert not tpipe.frontend_cfg.use_1point_stereo  # the 3-pt solver forced
    assert tout.n_frames == jout.n_frames
    assert tout.stamps_ns == jout.stamps_ns
    np.testing.assert_allclose(np.stack(tout.positions), np.stack(jout.positions), atol=1e-3)
    return jpipe, jout, tpipe, tout


def test_time_alignment_smoke_matches_jax(monkeypatch):
    jp, tp = _params()
    n = 30
    jpipe, _, tpipe, out = _both(monkeypatch, jp, tp,
                                 jsyn.SyntheticStereoProvider(n_frames=n, vx=0.5, width=W, height=H, fx=FX),
                                 tsyn.SyntheticStereoProvider(n_frames=n, vx=0.5, width=W, height=H, fx=FX))
    assert out.n_frames == n
    assert tpipe.time_shift_estimate_s is None and jpipe.time_shift_estimate_s is None


def test_time_alignment_restart_matches_jax(monkeypatch):
    jp, tp = _params(time_alignment_window_size_s=1.0, time_alignment_variance_threshold_scaling=0.0)
    jpipe, _, tpipe, out = _both(monkeypatch, jp, tp, _orbit(jsyn), _orbit(tsyn))
    assert tpipe.time_shift_estimate_s is not None
    assert tpipe.time_shift_estimate_s == jpipe.time_shift_estimate_s
    assert 1 < out.n_frames < 40  # restarted: the frames before are not published
    assert out.n_keyframes >= 3
