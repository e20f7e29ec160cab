"""The options the port used to refuse, against the JAX package: the
Combined IMU factor, `state_covariance`, omni cameras, gyro-only
preintegration, FAST / ORB / Harris detection with ANMS types 0-6, and LK
windows of 33-54 px.

Every input is made with numpy from a seed and goes through the JAX
function and the port's counterpart; each test states its tolerance.

  * `detect_features` for FAST, ORB, Harris and GFTT with each ANMS type on
    the textured image of tests/test_optical_flow.py: `valid` equal, uv
    within 1e-3 px (the same candidates; the sub-pixel step's 21x21 sums
    round in another order). `fast_score` and the Harris response within
    1e-5 of their largest value.
  * `preintegrate_gyro` on a masked block with a bias: within 1e-6.
  * The Combined IMU factor: the JAX smoother runs the synthetic scene of
    tests/test_torch_backend.py with `imu_preintegration_type: 0`, its
    window is carried into the port (`convert.state_from_numpy`), and
    `_imu_factor_blocks` on both sides agree within 1e-4 of each block's
    largest entry (float32 Cholesky whitening, another summation order),
    as tests/test_torch_backend_factors.py holds the other factors.
    `preintegration_type: 0` sets the flag on both sides' BackendConfig.
  * `state_covariance` on that window and on a sick copy (a NaN position,
    as tests/test_smoother.py:495-511): the same `ok`; the healthy
    covariance, and the JAX package's, within 3e-2 of the largest entry
    of the float64 answer. The window information's condition number is
    ~1e9: a 1.7e-7 relative change of it (another summation order) moves
    the float64 covariance by 0.2 % of its largest entry, and each side's
    float32 Cholesky lands ~1 % from the float64 answer.
  * A 160x120 `run()` with `imu_preintegration_type: 0`, the port tracking
    with the gather rule and drawing the JAX RANSAC hypotheses
    (tests/test_torch_variants.py): the same keyframe stamps, positions
    within 1e-4 m, and the JAX tests' ATE gate, 0.05 m.
  * The omni camera from inline OCamCalib parameters: backprojection
    within 1e-6 relative, the Newton projection within 1e-3 px, the
    rectification map within 1e-3 px.
  * `FrontendConfig.from_params` and `BackendConfig.from_params` for each
    lifted option against the JAX package's, and a short run with all of
    them and `visualize` on, the visualizer writing its artifacts.
  * LK at win 41: the plain tracker against `klt_track_pallas(...,
    interpret=True)` at the repository's tolerance (median < 0.05 px,
    tests/test_optical_flow.py:183-186), the gather rule against the JAX
    `klt_track` within 1e-3 px; `lk_pyramid_cuda` admits 33-54 px, refuses
    55 and 101 px with the window rule and its reason, and takes them with
    the gather rule; so does a frontend built for the card (windows over
    54 px: tests/test_torch_wide_window.py).
"""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from kimera_vio_tpu.backend import smoother as jsm
from kimera_vio_tpu.common.types import ImuBlock as JImuBlock
from kimera_vio_tpu.common.types import NavState as JNavState
from kimera_vio_tpu.config.params import CameraParams as JCameraParams
from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.frontend import camera as jcam
from kimera_vio_tpu.frontend import imu_frontend as jimu
from kimera_vio_tpu.frontend.vision_frontend import FrontendConfig as JFrontendConfig
from kimera_vio_tpu.ops import corner_detection as jdet
from kimera_vio_tpu.ops import optical_flow as jof
from kimera_vio_tpu.ops.pallas import lk_kernel as jlk
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.backend import smoother as tsm
from kimera_vio_tpu_torch.common.types import ImuBlock
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.config.params import CameraParams
from kimera_vio_tpu_torch.convert import state_from_numpy, vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider
from kimera_vio_tpu_torch.frontend import camera as tcam
from kimera_vio_tpu_torch.frontend import imu_frontend as timu
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendConfig
from kimera_vio_tpu_torch.ops import corner_detection as tdet
from kimera_vio_tpu_torch.ops import lk_kernel as tlk
from kimera_vio_tpu_torch.ops import optical_flow as tof
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.utils.logger import compute_ate


def _fixture_module(name):
    spec = importlib.util.spec_from_file_location(
        f"options_{name}", os.path.join(os.path.dirname(__file__), f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bk = _fixture_module("test_torch_backend")  # the synthetic backend scene
var = _fixture_module("test_torch_variants")  # the JAX RANSAC draws
textured_image = _fixture_module("test_optical_flow").textured_image


def T(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# Detectors and ANMS
# ---------------------------------------------------------------------------

_DETECTORS = {"fast": dict(detector_type=0), "orb": dict(detector_type=1),
              "harris": dict(detector_type=3, use_harris=True), "gftt": dict(detector_type=3)}
_CASES = [("fast", 5), ("fast", 6), ("orb", 1), ("harris", 2), ("harris", 6)] + [
    ("gftt", a) for a in range(7)]


@pytest.mark.parametrize("detector,anms_type", _CASES, ids=[f"{d}-{a}" for d, a in _CASES])
def test_detect_features_matches_jax(detector, anms_type):
    img = textured_image(240, 320, seed=3)
    rng = np.random.default_rng(6)
    ex_uv = np.stack([rng.uniform(0, 320, 40), rng.uniform(0, 240, 40)], -1).astype(np.float32)
    ex_mask = rng.uniform(size=40) > 0.5
    kw = dict(_DETECTORS[detector], anms_type=anms_type, min_distance=10.0,
              max_nr_keypoints_before_anms=512)
    juv, jok = jdet.detect_features(jnp.asarray(img), jnp.asarray(ex_uv), jnp.asarray(ex_mask),
                                    64, **kw)
    tuv, tok = tdet.detect_features(T(img), T(ex_uv), T(ex_mask), 64, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    m = tok.numpy()
    assert m.sum() >= 48
    np.testing.assert_allclose(tuv.numpy()[m], np.asarray(juv)[m], atol=1e-3)


def test_agast_is_refused_as_in_jax():
    img = T(textured_image(64, 64, seed=1))
    with pytest.raises(NotImplementedError, match="AGAST"):
        tdet.detect_features(img, torch.zeros(4, 2), torch.zeros(4, dtype=torch.bool), 8,
                             detector_type=2)


@pytest.mark.parametrize("response", ["fast", "harris"])
def test_responses_match_jax(response):
    img = textured_image(240, 320, seed=4)
    if response == "fast":
        j, t = jdet.fast_score(jnp.asarray(img), 12.0), tdet.fast_score(T(img), 12.0)
    else:
        j = jdet.gftt_response(jnp.asarray(img), 3, use_harris=True, k=0.05)
        t = tdet.gftt_response(T(img), 3, use_harris=True, k=0.05)
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5 * np.abs(j).max())


# ---------------------------------------------------------------------------
# IMU: gyro-only preintegration, the Combined factor
# ---------------------------------------------------------------------------


def test_preintegrate_gyro_matches_jax():
    rng = np.random.default_rng(2)
    n = 40
    gyr = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    dt = np.full(n, 0.005, np.float32)
    mask = np.arange(n) < 31
    dt[~mask] = 0.0
    bias = np.float32([0.01, -0.02, 0.005])
    acc = np.zeros((n, 3), np.float32)
    jR = jimu.preintegrate_gyro(JImuBlock(acc=jnp.asarray(acc), gyr=jnp.asarray(gyr),
                                          dt=jnp.asarray(dt), mask=jnp.asarray(mask)),
                                jnp.asarray(bias))
    tR = timu.preintegrate_gyro(ImuBlock(acc=T(acc), gyr=T(gyr), dt=T(dt), mask=T(mask)), T(bias))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-6)


@pytest.fixture(scope="module")
def combined_state():
    """The JAX window (Combined factor) after K keyframes of the backend
    scene, its config, and the port's."""
    rng = np.random.default_rng(3)
    K, L = bk.K, bk.L
    jp = j_synthetic_params(width=320, height=240, max_features=64, max_landmarks=L, nr_states=K)
    jp.imu.preintegration_type = 0
    tp = vio_params_from_dict(dataclasses.asdict(jp))
    jstereo = jcam.StereoCamera.from_params(jp.left_cam, jp.right_cam)
    tstereo = tcam.StereoCamera.from_params(tp.left_cam, tp.right_cam, device="cpu")
    jcfg = jsm.BackendConfig.from_params(jp.backend, jp.imu, jstereo, max_landmarks=L)
    tcfg = tsm.BackendConfig.from_params(tp.backend, tp.imu, tstereo, max_landmarks=L, device="cpu")
    assert jcfg.combined_pim and tcfg.combined_pim
    jpp = jimu.PimParams.from_params(jp.imu)
    jstep = jax.jit(lambda w, l, pim, st, ids, uvd, m: jsm.backend_step(
        jcfg, w, l, pim=pim, stamp=st, meas_ids=ids, meas_uvd=uvd, meas_mask=m,
        status=jnp.int32(0)))
    lm = bk.scene(rng)
    nav0 = JNavState(rot=jnp.eye(3), pos=jnp.zeros(3), vel=jnp.array([bk.VX, 0.0, 0.0]))
    win = jsm.bootstrap(jcfg, jsm.Window.empty(K), nav0, jnp.zeros(6), jnp.float32(0.0))
    ids, uvd, vis = bk.measure(lm, 0, rng)
    lmk = jsm.update_landmarks(jsm.LandmarkTable.empty(L, K), jnp.asarray(ids), jnp.asarray(uvd),
                               jnp.asarray(vis), jnp.int32(0))
    for k in range(1, K + 1):
        acc, gyr, dt, mask = bk.imu_block(rng)
        pim = jimu.preintegrate(jpp, JImuBlock(acc=jnp.asarray(acc), gyr=jnp.asarray(gyr),
                                               dt=jnp.asarray(dt), mask=jnp.asarray(mask)),
                                jimu.ImuBias.zero())
        ids, uvd, vis = bk.measure(lm, k, rng)
        win, lmk, _ = jstep(win, lmk, pim, jnp.float32(bk.DT_KF * k), jnp.asarray(ids),
                            jnp.asarray(uvd), jnp.asarray(vis))
    assert int(win.n) == K
    return jcfg, tcfg, win, lmk


def test_combined_imu_factor_matches_jax(combined_state):
    """The JAX side runs op by op, as tests/test_torch_backend_factors.py
    runs it: the residual is a near-cancellation (3.6 % of its largest
    entry from the float64 value on both sides), and `jax.jit` fuses its
    float32 arithmetic into another rounding than either op-by-op run."""
    jcfg, tcfg, win, lmk = combined_state
    twin, _, _ = state_from_numpy(bk.to_np(win), bk.to_np(lmk), device="cpu")
    out_t = tsm._imu_factor_blocks(tcfg, twin)
    out_j = jsm._imu_factor_blocks(jcfg, win)
    for name, a, b in zip(("Ji", "Jj", "r"), out_t, out_j):
        b = np.asarray(b)
        assert a.shape == b.shape and b.shape[1] == 15
        scale = np.abs(b).max()
        assert scale > 0
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * scale, err_msg=name)
    # The plain flavour on the same window differs: the flag is read.
    plain = tsm._imu_factor_blocks(dataclasses.replace(tcfg, combined_pim=False), twin)
    assert plain[2].shape == (bk.K - 1, 15) and not torch.allclose(plain[2], out_t[2])


def _cov_f64(H, n):
    """state_covariance's formula in float64 on a float32 H."""
    H = 0.5 * (H + H.T).astype(np.float64)
    d = np.sqrt(np.maximum(np.diag(H), 1e-12))
    X = np.linalg.inv(H / d[:, None] / d[None, :] + 1e-6 * np.eye(H.shape[0]))
    rows = slice((n - 1) * 15, n * 15)
    return (X / d[:, None] / d[None, :])[rows, rows]


def test_state_covariance_matches_jax(combined_state):
    jcfg, tcfg, win, lmk = combined_state
    twin, tlmk, _ = state_from_numpy(bk.to_np(win), bk.to_np(lmk), device="cpu")
    jcov_fn = jax.jit(lambda w, l: jsm.state_covariance(jcfg, w, l, return_ok=True))
    jcov, jok = jcov_fn(win, lmk)
    tcov, tok = tsm.state_covariance(tcfg, twin, tlmk, return_ok=True)
    assert bool(jok) and bool(tok)
    assert tcov.shape == (15, 15)
    ref = _cov_f64(tsm._assemble(tcfg, twin, tlmk)[0].numpy(), twin.n)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(np.asarray(jcov), ref, atol=3e-2 * scale)
    np.testing.assert_allclose(tcov.numpy(), ref, atol=3e-2 * scale)
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), atol=3e-2 * scale)
    np.testing.assert_array_equal(tcov.numpy(), tcov.numpy().T)
    assert (np.diag(tcov.numpy()) > 0).all()
    np.testing.assert_array_equal(tsm.state_covariance(tcfg, twin, tlmk).numpy(), tcov.numpy())
    sick_j = win.replace(pos=win.pos.at[0].set(jnp.nan))
    sick_t = dataclasses.replace(twin, pos=twin.pos.clone())
    sick_t.pos[0] = torch.nan
    _, jok_sick = jcov_fn(sick_j, lmk)
    _, tok_sick = tsm.state_covariance(tcfg, sick_t, tlmk, return_ok=True)
    assert not bool(jok_sick) and not bool(tok_sick)


@pytest.fixture
def like_jax(monkeypatch):
    """The port tracks with the gather rule and draws the JAX package's
    RANSAC hypotheses; the JAX side tracks with its gather LK."""
    monkeypatch.setenv("KIMERA_LK_IMPL", "gather")
    monkeypatch.setattr(vision_frontend, "klt_track_lk",
                        functools.partial(tlk.klt_track_lk, search_rows=None))
    monkeypatch.setattr(transac, "_sample_indices", var._jax_draws)


def test_combined_run_matches_jax(like_jax):
    jp, tp = var._params()
    jp.imu.preintegration_type = 0
    tp.imu.preintegration_type = 0
    size = var.SIZE
    jout = JPipeline(jp, parallel_run=False).run(JProvider(n_frames=var.N_FRAMES, vx=0.5, **size))
    prov = SyntheticStereoProvider(n_frames=var.N_FRAMES, vx=0.5, **size)
    pipe = StereoImuPipeline(tp, parallel_run=False, device="cpu")
    assert pipe.backend_cfg.combined_pim
    out = pipe.run(prov)
    assert out.stamps_ns == jout.stamps_ns and out.n_keyframes >= 4
    np.testing.assert_allclose(np.stack(out.positions), np.stack(jout.positions), atol=1e-4)
    gt = prov.ground_truth
    ate = compute_ate(np.array(out.stamps_ns), np.stack(out.positions), gt.stamps_ns,
                      gt.positions, align=False)
    assert ate["rmse"] < 0.05, ate
    cov, ok = pipe.state_covariance(return_ok=True)
    assert ok and cov.shape == (15, 15) and np.all(np.diag(cov) > 0)


# ---------------------------------------------------------------------------
# Omni camera
# ---------------------------------------------------------------------------

# OCamCalib parameters of a 1280x960 fisheye: a0..a4 of the z-polynomial
# (decreasing, positive out to the image corners), the distortion centre
# and the affine [c, d, e]; no pinhole intrinsics.
_OMNI = dict(camera_model="omni", width=1280, height=960, intrinsics=np.zeros(0),
             distortion_model="omni",
             distortion_coeffs=np.array([310.0, 0.0, -1.1e-3, 2.5e-7, -4.0e-10]),
             omni_distortion_center=np.array([641.3, 478.6]),
             omni_affine=np.array([-3.0e-4, 2.0e-4, 0.9996]))


def _omni_cams():
    T_BS = np.eye(4)
    T_BS[:3, 3] = [0.02, -0.01, 0.0]
    jc = jcam.PinholeCamera.from_params(JCameraParams(T_BS=T_BS, **_OMNI))
    tc = tcam.PinholeCamera.from_params(CameraParams(T_BS=T_BS, **_OMNI), device="cpu")
    return jc, tc


def _omni_pixels(n, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(5.0, 420.0, n)
    a = rng.uniform(0, 2 * np.pi, n)
    return (np.stack([r * np.cos(a), r * np.sin(a)], -1) + _OMNI["omni_distortion_center"]
            ).astype(np.float32)


def test_omni_camera_matches_jax():
    jc, tc = _omni_cams()
    assert tc.dist_model == tcam.DIST_OMNI == jc.dist_model
    # convert.py carries the omni fields of a JAX params tree.
    jp = j_synthetic_params(width=1280, height=960)
    jp.left_cam = JCameraParams(**_OMNI)
    tp = vio_params_from_dict(dataclasses.asdict(jp))
    conv = tcam.PinholeCamera.from_params(tp.left_cam, device="cpu")
    for name in ("omni_center", "omni_affine_inv", "dist", "cx", "cy"):
        np.testing.assert_array_equal(getattr(conv, name).numpy(), np.asarray(getattr(jc, name)))
    uv = _omni_pixels(64, 0)
    depth = np.random.default_rng(1).uniform(1.0, 8.0, 64).astype(np.float32)
    jxy = np.asarray(jcam.omni_backproject_normalized(jc, jnp.asarray(uv)))
    txy = tcam.omni_backproject_normalized(tc, T(uv))
    np.testing.assert_allclose(txy.numpy(), jxy, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tcam.undistort_to_normalized(tc, T(uv)).numpy(), txy.numpy())
    jp = np.asarray(jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(depth)))
    tp = tcam.backproject(tc, T(uv), T(depth))
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-6, atol=1e-6)
    juv, jok = jcam.project(jc, jnp.asarray(jp))
    tuv, tok = tcam.project(tc, T(jp))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.all()
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-3)
    # The Newton projection inverts the backprojection.
    np.testing.assert_allclose(tuv.numpy(), uv, atol=1e-2)


def test_omni_rectification_map_matches_jax():
    jc, tc = _omni_cams()
    pin = j_synthetic_params(width=1280, height=960, fx=400.0)
    tpin = vio_params_from_dict(dataclasses.asdict(pin))
    jst = jcam.StereoCamera.from_params(pin.left_cam, pin.right_cam)
    tst = tcam.StereoCamera.from_params(tpin.left_cam, tpin.right_cam, device="cpu")
    R = Rotation.from_rotvec([0.01, -0.02, 0.015]).as_matrix()
    jmap = jcam.rectification_map(jst, jc, jnp.asarray(R, jnp.float32))
    tmap = tcam.rectification_map(tst, tc, T(R.astype(np.float32)))
    assert tmap.shape == (960, 1280, 2) and tmap.dtype == np.float32
    np.testing.assert_allclose(tmap, np.asarray(jmap), atol=1e-3)


# ---------------------------------------------------------------------------
# Configuration: every lifted option
# ---------------------------------------------------------------------------

_OPTIONS = {
    "fast": dict(feature_detector_type=0, non_max_suppression_type=5),
    "orb": dict(feature_detector_type=1, non_max_suppression_type=1),
    "harris": dict(use_harris_detector=True, k=0.05, non_max_suppression_type=2),
    "kdtree": dict(non_max_suppression_type=3),
    "rangetree": dict(non_max_suppression_type=4),
    "topn": dict(enable_non_max_suppression=False, max_nr_keypoints_before_anms=2000),
    "fast_thresh": dict(feature_detector_type=0, fast_thresh=17),
    "klt_win_41": dict(klt_win_size=41),
}


@pytest.mark.parametrize("option", list(_OPTIONS))
def test_frontend_config_from_params_matches_jax(option):
    jp = j_synthetic_params(width=320, height=240)
    for k, v in _OPTIONS[option].items():
        setattr(jp.frontend, k, v)
    tp = vio_params_from_dict(dataclasses.asdict(jp))
    jcfg = JFrontendConfig.from_params(jp.frontend, max_features=64)
    tcfg = FrontendConfig.from_params(tp.frontend, max_features=64)
    for name in ("detector_type", "anms_type", "max_nr_keypoints_before_anms", "klt_win",
                 "nr_horizontal_bins", "nr_vertical_bins", "do_subpixel"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.max_nr_keypoints_before_anms <= 1024
    # The JAX package's detector runs with these at their defaults; the
    # port reads them from the params.
    assert tcfg.use_harris == bool(tp.frontend.use_harris_detector)
    assert tcfg.harris_k == float(tp.frontend.k)
    assert tcfg.fast_thresh == float(tp.frontend.fast_thresh)


def test_pipeline_takes_every_option_but_visualize(tmp_path, monkeypatch):
    """Each lifted option at once builds a pipeline (Combined factor, ORB
    with Brown ANMS, a 41 px window), and so does `visualize`, the last
    one lifted: a short 160x120 `run()` with all of them on and the
    visualizer's display writing every keyframe (`save_every` 1) leaves
    one point cloud PLY per keyframe after the bootstrap under
    <output>/viz and a finite trajectory."""
    from kimera_vio_tpu_torch.pipeline import stereo_pipeline
    from kimera_vio_tpu_torch.visualizer.visualizer import FileDisplay

    p = vio_params_from_dict(dataclasses.asdict(j_synthetic_params(width=320, height=240)))
    p.imu.preintegration_type = 0
    p.frontend.feature_detector_type = 1
    p.frontend.non_max_suppression_type = 1
    p.frontend.klt_win_size = 41
    pipe = StereoImuPipeline(p, device="cpu")
    assert pipe.backend_cfg.combined_pim
    assert (pipe.frontend_cfg.detector_type, pipe.frontend_cfg.anms_type) == (1, 1)
    assert pipe.frontend_cfg.klt_win == 41
    small = vio_params_from_dict(dataclasses.asdict(j_synthetic_params(
        width=160, height=120, fx=120.0, nr_states=5, max_features=64, max_landmarks=96)))
    small.frontend.klt_max_level = 2
    small.frontend.templ_cols, small.frontend.templ_rows = 31, 7
    small.imu.preintegration_type = 0
    small.frontend.feature_detector_type = 1
    small.frontend.non_max_suppression_type = 1
    small.frontend.klt_win_size = 41
    monkeypatch.setattr(stereo_pipeline, "make_display",
                        lambda display_type, path: FileDisplay(path, save_every=1))
    flags.set_flag("visualize", True)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the machine's cores
    try:
        pipe = StereoImuPipeline(small, output_path=str(tmp_path), device="cpu")
        out = pipe.run(SyntheticStereoProvider(n_frames=10, vx=0.5, width=160, height=120, fx=120.0))
    finally:
        flags.set_flag("visualize", False)
        torch.set_num_threads(n_threads)
    assert pipe.enable_visualizer and pipe.backend_cfg.combined_pim
    assert np.isfinite(np.stack(out.positions)).all()
    plys = sorted(f for f in os.listdir(tmp_path / "viz") if f.startswith("pointcloud"))
    assert plys == [f"pointcloud_{k:06d}.ply" for k in range(1, out.n_keyframes)]


# ---------------------------------------------------------------------------
# LK at windows of 33-54 px
# ---------------------------------------------------------------------------


def _lk_inputs(win):
    lk_fx = _fixture_module("test_torch_lk")
    prev, cur = lk_fx.textured_pair(240, 320, 4.7, seed=0)
    pts = lk_fx.random_points(240, 320, 24, seed=1, margin=30)
    return lk_fx, prev, cur, pts, pts + np.float32([2.0, 0.0]), np.ones(24, bool)


def test_wide_window_plain_matches_klt_track_pallas():
    lk_fx, prev, cur, pts, init, valid = _lk_inputs(41)
    jp = jof.build_pyramid(jnp.asarray(prev), 2)
    jc = jof.build_pyramid(jnp.asarray(cur), 2)
    out_j, ok_j = jlk.klt_track_pallas(jp, jc, jnp.asarray(pts), jnp.asarray(init),
                                       jnp.asarray(valid), win=41, interpret=True)
    tp = tof.build_pyramid(T(prev), 2)
    tc = tof.build_pyramid(T(cur), 2)
    out_t, ok_t = tlk.klt_track_lk(tp, tc, T(pts), T(init), T(valid), win=41, device="cpu")
    lk_fx.assert_lk_agrees(out_t.numpy(), ok_t.numpy(), out_j, ok_j, min_both=18)
    assert [tlk.level_mode(*t.shape, 41, 56)[0] for t in tp] == ["vmem"] * 3
    # A coarser level could not hold the 41 px window: skipped.
    assert tlk.level_mode(30, 40, 41, 56)[0] == "skip"


def test_wide_window_gather_rule_matches_klt_track():
    lk_fx, prev, cur, pts, init, valid = _lk_inputs(41)
    jp = jof.build_pyramid(jnp.asarray(prev), 3)
    jc = jof.build_pyramid(jnp.asarray(cur), 3)
    out_j, ok_j = jof.klt_track(jp, jc, jnp.asarray(pts), jnp.asarray(init), jnp.asarray(valid),
                                win=41)
    tp = tof.build_pyramid(T(prev), 3)
    tc = tof.build_pyramid(T(cur), 3)
    out_t, ok_t = tlk.klt_track_lk(tp, tc, T(pts), T(init), T(valid), win=41, search_rows=None,
                                   device="cpu")
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.sum() >= 18
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-3)


@pytest.mark.parametrize("win,search_rows", [(33, 56), (41, 56), (54, 56), (41, None), (54, None)])
def test_lk_pyramid_cuda_admits_windows_up_to_54(win, search_rows):
    """The argument check passes (the call then stops at the CPU tensors,
    which the kernel does not take)."""
    pyr = tof.build_pyramid(torch.zeros(120, 160), 2)
    pts = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlk.lk_pyramid_cuda(pyr, pyr, [(p, p) for p in pyr], pts, pts,
                            torch.ones(4, dtype=torch.bool), win=win, max_iter=30, eps=0.1,
                            min_eig_thresh=1e-4, search_rows=search_rows)


@pytest.mark.parametrize("win", [55, 101])
def test_lk_pyramid_cuda_refuses_windows_above_54(win):
    """The window rule (search_rows 56) refuses windows over 54 px."""
    pyr = tof.build_pyramid(torch.zeros(120, 160), 2)
    pts = torch.zeros(4, 2)
    with pytest.raises(ValueError, match=rf"win {win}: .*<= 54.*search_rows - win - 2"):
        tlk.lk_pyramid_cuda(pyr, pyr, [(p, p) for p in pyr], pts, pts,
                            torch.ones(4, dtype=torch.bool), win=win, max_iter=30, eps=0.1,
                            min_eig_thresh=1e-4, search_rows=56)


@pytest.mark.parametrize("win", [55, 61, 101, 151])
def test_lk_pyramid_cuda_admits_wider_windows_with_the_gather_rule(win):
    """The gather rule (search_rows=None) takes any window: the argument
    check passes (the call then stops at the CPU tensors)."""
    pyr = tof.build_pyramid(torch.zeros(120, 160), 2)
    pts = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlk.lk_pyramid_cuda(pyr, pyr, [(p, p) for p in pyr], pts, pts,
                            torch.ones(4, dtype=torch.bool), win=win, max_iter=30, eps=0.1,
                            min_eig_thresh=1e-4, search_rows=None)


@pytest.mark.parametrize("win", [55, 101])
def test_frontend_takes_windows_above_54_on_the_card(win):
    """A frontend built for the card takes klt_win_size over 54 (it tracks
    them with the gather rule, tests/test_torch_wide_window.py). Without a
    card its constructor gets past the window and stops at its first
    tensor on the card; on the CPU the plain tracker takes the window."""
    p = vio_params_from_dict(dataclasses.asdict(j_synthetic_params(width=320, height=240)))
    p.frontend.klt_win_size = win
    cfg = FrontendConfig.from_params(p.frontend, max_features=64)
    stereo = tcam.StereoCamera.from_params(p.left_cam, p.right_cam, device="cpu")
    pim = timu.PimParams.from_params(p.imu, device="cpu")
    if torch.cuda.is_available():
        fe = vision_frontend.StereoFrontend(cfg, stereo, pim, torch.device("cuda"))
        assert fe.cfg.klt_win == win
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            vision_frontend.StereoFrontend(cfg, stereo, pim, torch.device("cuda"))
    assert vision_frontend.StereoFrontend(cfg, stereo, pim, torch.device("cpu")).cfg.klt_win == win
