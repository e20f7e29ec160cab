"""The port's initialization modules against the JAX package's.

Module parity (initial/gravity_alignment.py, initializer.py,
time_alignment.py): the twins of tests/test_initial.py, on the same
synthetic trajectories (tests/test_initial.py::simulate: a rotating,
accelerating body, PIMs integrated with a planted gyro bias). Each twin
runs the JAX function and the port's on the same float32 inputs and holds
the port to the JAX test's own gate and to the JAX result:

  * gyro bias: within 1e-5 rad/s of the JAX estimate (a 3x3 float32 solve
    of the same normal equations);
  * velocities and gravity: within 1e-3 (m/s, m/s^2) of the JAX solution
    (float32 LU of a 27x27 system assembled in the same order, whose
    condition number lets the two LAPACK builds differ in the last few
    digits);
  * the online initializer's attitude within 1e-4, velocity within 1e-3
    m/s, gyro bias within 1e-5 rad/s, the residual gate's verdict equal;
  * the time aligner: the same lag, to the sample.

Slice parity: autoInitialize 2 (online init) through the JAX and port
`StereoImuPipeline.run()` on the 160x120 synthetic sequence (fx = 120, 30 frames), as
tests/test_rgbd_provider.py:27 sizes it; the JAX side tracks with its
gather LK, the port with the gather tracker's level plan and the JAX
package's RANSAC hypotheses. Same published keyframe stamps and frame
count, positions within 1e-3 m (the online initialization amplifies
float32 differences through the crude collection phase: measured 5.2e-4
m), and the JAX test's effect gates (tests/test_pipeline_wiring.py:140).
Time alignment through run(): tests/test_torch_time_alignment.py.
"""

import dataclasses
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_vio_tpu.config import flags as jflags
from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.initial import gravity_alignment as jga
from kimera_vio_tpu.initial.initializer import OnlineInitializer as JInitializer
from kimera_vio_tpu.initial.time_alignment import CrossCorrTimeAligner as JAligner
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.convert import vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.initial import gravity_alignment as tga
from kimera_vio_tpu_torch.initial.initializer import OnlineInitializer
from kimera_vio_tpu_torch.initial.time_alignment import CrossCorrTimeAligner
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
_spec = importlib.util.spec_from_file_location(
    "jax_test_initial", os.path.join(os.path.dirname(__file__), "test_initial.py"))
jti = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jti)
G = jti.G

def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def pim_stack(pims, name):
    return np.stack([np.asarray(getattr(p, name)) for p in pims]).astype(np.float32)


def test_gyro_bias_estimation_matches_jax():
    bias = np.array([0.02, -0.015, 0.01])
    R_vis, p_vis, v_gt, pims = jti.simulate(gyro_bias=bias)
    dR, dRdbg = pim_stack(pims, "delta_R"), pim_stack(pims, "dR_dbg")
    mask = np.ones(len(pims), bool)
    j = np.asarray(jga.estimate_gyro_bias(jnp.asarray(R_vis), jnp.asarray(dR), jnp.asarray(dRdbg),
                                          jnp.asarray(mask)))
    p = tga.estimate_gyro_bias(t(R_vis), t(dR), t(dRdbg), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(p, bias, atol=2e-3)  # the JAX test's gate
    np.testing.assert_allclose(p, j, atol=1e-5)


@pytest.mark.parametrize("refine_iters", [0, 2, 4])
def test_gravity_and_velocity_alignment_matches_jax(refine_iters):
    R_vis, p_vis, v_gt, pims = jti.simulate()
    dv, dp, dts = pim_stack(pims, "delta_v"), pim_stack(pims, "delta_p"), pim_stack(pims, "delta_t")
    mask = np.ones(len(pims), bool)
    jv, jg = jga.align_velocities_and_gravity(
        jnp.asarray(R_vis), jnp.asarray(p_vis), jnp.asarray(dts), jnp.asarray(dv), jnp.asarray(dp),
        jnp.asarray(mask), refine_iters=refine_iters)
    tv, tg = tga.align_velocities_and_gravity(
        t(R_vis), t(p_vis), t(dts), t(dv), t(dp), torch.from_numpy(mask),
        refine_iters=refine_iters)
    np.testing.assert_allclose(tg.numpy(), G, atol=0.05)  # the JAX test's gates
    np.testing.assert_allclose(tv.numpy(), v_gt, atol=0.05)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-3)


def _aligner_signal(offset_samples=14, n=2000, rate=200.0):
    tt = np.arange(n) / rate
    w = 0.5 * np.sin(2 * np.pi * 0.7 * tt) + 0.3 * np.sin(2 * np.pi * 1.3 * tt + 1)
    return tt, w


@pytest.mark.parametrize("offset_samples", [0, 14, 27])
def test_time_aligner_recovers_offset_as_jax(offset_samples):
    rate = 200.0
    tt, w = _aligner_signal()
    kw = dict(window_size_s=10.0, imu_rate_hz=rate, variance_threshold_scaling=0.0)
    aligners = [JAligner(**kw), CrossCorrTimeAligner(**kw, device="cpu")]
    for a in aligners:
        for k in range(len(tt)):
            a.add_imu(int(tt[k] * 1e9), np.array([w[k], 0, 0]), 1.0 / rate)
            kv = k - offset_samples
            if 0 <= kv < len(tt):
                a.add_frame_rotation(int(tt[k] * 1e9), abs(w[kv]) / rate, 1)
    j, p = (a.attempt_estimation() for a in aligners)
    assert p is not None and p == j
    assert abs(p - offset_samples / rate) < 2.5 / rate, p


def test_time_aligner_variance_gate_as_jax():
    """An unexcited (constant-rate) window gives no estimate on either
    side; a window under half full neither."""
    kw = dict(window_size_s=1.0, imu_rate_hz=200.0)
    aligners = [JAligner(**kw), CrossCorrTimeAligner(**kw, device="cpu")]
    for a in aligners:
        for k in range(120):
            a.add_imu(k, np.array([0.1, 0.0, 0.0]), 0.005)
            a.add_frame_rotation(k, 0.0005, 1)
        assert a.attempt_estimation() is None
    short = CrossCorrTimeAligner(**kw, device="cpu")
    short.add_imu(0, np.ones(3), 0.005)
    assert short.attempt_estimation() is None


def _feed(init, R_vis, p_vis, pims, corrupt=False):
    rng = np.random.default_rng(0)
    ready = False
    for k in range(len(R_vis)):
        if k == 0:
            fo = {}
        else:
            Rr = R_vis[k - 1].T @ R_vis[k]
            if corrupt:
                ax = rng.standard_normal(3)
                ax *= 0.2 / np.linalg.norm(ax)
                K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
                Rr = Rr @ (np.eye(3) + np.sin(1.0) * K + (1 - np.cos(1.0)) * K @ K)
            p = pims[k - 1]
            fo = dict(init_R_rel_body=Rr, init_t_rel_body=R_vis[k - 1].T @ (p_vis[k] - p_vis[k - 1]),
                      init_pim_delta_R=np.asarray(p.delta_R), init_pim_delta_v=np.asarray(p.delta_v),
                      init_pim_delta_p=np.asarray(p.delta_p), init_pim_dR_dbg=np.asarray(p.dR_dbg))
        ready = init.add_keyframe(fo, 0.2 * k)
    return ready


def _solve_both(R0, R_vis, p_vis, pims, corrupt=False):
    sols = []
    for init in (JInitializer(G, R0, n_kf=len(R_vis)),
                 OnlineInitializer(G, R0, n_kf=len(R_vis), device="cpu")):
        assert _feed(init, R_vis, p_vis, pims, corrupt)
        sols.append(init.solve())
    j, p = sols
    assert p["ok"] == j["ok"]
    np.testing.assert_allclose(p["R0"], j["R0"], atol=1e-4)
    np.testing.assert_allclose(p["pos0"], j["pos0"], atol=1e-4)
    np.testing.assert_allclose(p["vel"], j["vel"], atol=1e-3)
    np.testing.assert_allclose(p["gyro_bias"], j["gyro_bias"], atol=1e-5)
    np.testing.assert_allclose(p["gyro_residual"], j["gyro_residual"], rtol=1e-3, atol=1e-6)
    return p


def test_online_initializer_corrects_attitude_as_jax():
    from kimera_vio_tpu_torch.common import geometry as geo

    R_vis, p_vis, v_gt, pims = jti.simulate(n_frames=8)
    R_err = geo.so3_exp(torch.tensor([0.26, 0.0, 0.0])).numpy()
    sol = _solve_both(R_err @ R_vis[0], R_vis, p_vis, pims)
    g_dir = G / np.linalg.norm(G)
    np.testing.assert_allclose(sol["R0"].T @ g_dir, R_vis[-1].T @ g_dir, atol=0.03)
    np.testing.assert_allclose(sol["vel"], v_gt[-1], atol=0.1)
    np.testing.assert_allclose(sol["gyro_bias"], 0.0, atol=0.02)


def test_online_initializer_recovers_gyro_bias_as_jax():
    bg = np.array([0.02, -0.015, 0.01])
    R_vis, p_vis, v_gt, pims = jti.simulate(n_frames=8, gyro_bias=bg)
    sol = _solve_both(R_vis[0], R_vis, p_vis, pims)
    np.testing.assert_allclose(sol["gyro_bias"], bg, atol=0.005)


@pytest.mark.parametrize("corrupt", [False, True])
def test_online_initializer_gyro_residual_gate_as_jax(corrupt):
    R_vis, p_vis, v_gt, pims = jti.simulate(n_frames=8)
    sol = _solve_both(R_vis[0], R_vis, p_vis, pims, corrupt=corrupt)
    assert sol["ok"] is (not corrupt)
    if corrupt:
        assert sol["gyro_residual"] > flags.get_flag("gyroscope_residuals")


def test_online_initializer_window_size_flag():
    try:
        flags.set_flag("num_frames_vio_init", 5)
        assert OnlineInitializer(G, np.eye(3), device="cpu").n_kf == 5
    finally:
        flags.set_flag("num_frames_vio_init", None)
    assert OnlineInitializer(G, np.eye(3), device="cpu").n_kf == 8


# ---------------------------------------------------------------------------
# Slice parity: online initialization and time alignment through run()
# ---------------------------------------------------------------------------

SIZE = dict(width=160, height=120, fx=120.0)
N_FRAMES = 30


def _params(**over):
    p = j_synthetic_params(**SIZE, nr_states=8, max_features=64, max_landmarks=96)
    p.frontend.klt_max_level = 2
    p.frontend.templ_cols = 31
    p.frontend.templ_rows = 7
    for k, v in over.items():
        setattr(p.backend, k, v)
    return p, vio_params_from_dict(dataclasses.asdict(p))


def _both(jp, tp, monkeypatch):
    # Like with like: the JAX side tracks with its gather LK; the port with
    # the gather tracker's level plan, drawing the JAX package's RANSAC
    # hypotheses (tests/test_torch_variants.py::_jax_draws); the JAX 2-pt
    # mono RANSAC guarded as the port's (`guard_jax`).
    monkeypatch.setenv("KIMERA_LK_IMPL", "gather")
    _tv.guard_jax(monkeypatch)
    monkeypatch.setattr(vision_frontend, "klt_track_lk",
                        functools.partial(klt_track_lk, search_rows=None))
    monkeypatch.setattr(transac, "_sample_indices", _tv._jax_draws)
    jpipe = JPipeline(jp, parallel_run=False)
    jout = jpipe.run(JProvider(n_frames=N_FRAMES, vx=0.5, **SIZE))
    tpipe = StereoImuPipeline(tp, parallel_run=False, device="cpu")
    tout = tpipe.run(SyntheticStereoProvider(n_frames=N_FRAMES, vx=0.5, **SIZE))
    assert tout.n_frames == jout.n_frames
    assert tout.stamps_ns == jout.stamps_ns
    np.testing.assert_allclose(np.stack(tout.positions), np.stack(jout.positions), atol=1e-3)
    return jpipe, jout, tpipe, tout


def test_online_initialization_run_matches_jax(monkeypatch):
    jp, tp = _params(auto_initialize=2)
    jflags.set_flag("num_frames_vio_init", 5)
    flags.set_flag("num_frames_vio_init", 5)
    try:
        _, _, _, out = _both(jp, tp, monkeypatch)
    finally:
        jflags.set_flag("num_frames_vio_init", None)
        flags.set_flag("num_frames_vio_init", None)
    # tests/test_pipeline_wiring.py:140's gates: nothing published before
    # the alignment, the 0.5 m/s velocity recovered, motion after it.
    assert 1 < out.n_frames < N_FRAMES
    est = np.stack(out.positions)
    assert np.isfinite(est).all() and np.abs(est[-1]).max() < 3.0
    np.testing.assert_allclose(out.velocities[-1], [0.5, 0.0, 0.0], atol=0.1)
    assert est[-1][0] - est[0][0] > 0.05
