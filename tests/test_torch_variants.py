"""The port's mono and RGB-D frontends and pipelines, and the 5-pt / 3-pt
RANSAC options, against the JAX package.

Module parity:

  * `_stereo_measurements` in RGB-D mode (bilinear depth -> virtual
    disparity, depth gates, a NaN and out-of-range holes) and in mono mode
    (NaN uR), on the same features: masks equal, (uL, uR, v) within 1e-5
    px (float32 bilinear sums in the same order; the disparity divides by
    an interpolated depth);
  * the keyframe branch with the 5-pt mono and 3-pt Arun stereo solvers,
    and in mono mode: the JAX frontend tracks the first frames of the
    160x120 sequence, its state is carried into the port
    (`convert.state_from_numpy`), and both run the keyframe branch on the
    same tracked features, PIM and images, the port drawing the JAX
    package's RANSAC hypotheses (the same `jax.random` indices, fed
    through `ops.ransac._sample_indices`), the JAX 2-pt mono RANSAC
    guarded as the port's (`guard_jax`). The same inlier counts,
    measurement masks and ids, and next landmark id; measurement uvs
    within 1e-2 px (re-detections refine to sub-pixel and stereo matches
    are SSD minima, summed in another order, as in
    tests/test_torch_frontend.py); R_stereo, the 2-pt solver's rotation
    and the translations within 1e-4. The 5-pt solver's rotation is
    held to the truth within 0.05 rad on both sides only: the scene is a
    plane, where its 8-point refit is degenerate.

Slice parity: `MonoImuPipeline.run()` and `RgbdImuPipeline.run()` (the
constant-depth fixture of tests/test_pipeline_e2e.py:213) on the 160x120
sequence (fx = 120, 30 frames, tests/test_rgbd_provider.py:27), JAX and
port alike tracking with the gather rule and drawing the same
hypotheses: the same keyframe stamps, positions within 1e-3 m, and the
JAX tests' ATE gate, 0.05 m (tests/test_pipeline_e2e.py:201, :232).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_vio_tpu.backend import smoother as jsm
from kimera_vio_tpu.common.types import TrackedFeatures as JTrackedFeatures
from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.frontend import imu_frontend as jimu
from kimera_vio_tpu.frontend.camera import StereoCamera as JStereoCamera
from kimera_vio_tpu.frontend.vision_frontend import FrontendConfig as JFrontendConfig
from kimera_vio_tpu.frontend.vision_frontend import StereoFrontend as JStereoFrontend
from kimera_vio_tpu.ops import optical_flow as jof
from kimera_vio_tpu.ops import ransac as jransac
from kimera_vio_tpu.pipeline.mono_pipeline import MonoImuPipeline as JMonoPipeline
from kimera_vio_tpu.pipeline.mono_pipeline import mono_rig as j_mono_rig
from kimera_vio_tpu.pipeline.rgbd_pipeline import RgbdImuPipeline as JRgbdPipeline
from kimera_vio_tpu_torch.common.types import TrackedFeatures
from kimera_vio_tpu_torch.convert import state_from_numpy, vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.frontend.camera import StereoCamera
from kimera_vio_tpu_torch.frontend.imu_frontend import PimParams
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendConfig, StereoFrontend
from kimera_vio_tpu_torch.ops import optical_flow as tof
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.ops.lk_kernel import klt_track_lk
from kimera_vio_tpu_torch.pipeline.mono_pipeline import MonoImuPipeline, mono_rig
from kimera_vio_tpu_torch.pipeline.rgbd_pipeline import RgbdImuPipeline
from kimera_vio_tpu_torch.utils.logger import compute_ate


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores,
    and these small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE = dict(width=160, height=120, fx=120.0)
N_FRAMES = 30


def _jax_draws(generator, n_hyp, k, n, weights):
    """The hypotheses the JAX package draws where the port draws from
    `generator`: the port seeds it with the frame count (PnP: 7 * 1000003
    + the frame count), the JAX package folds that count into PRNGKey(0)
    (the 3-pt solver: then 1; PnP: into PRNGKey(7))."""
    seed = generator.initial_seed()
    if k == 6:
        key = jax.random.fold_in(jax.random.PRNGKey(7), seed - 7 * 1_000_003)
    else:
        key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
        if k == 3:
            key = jax.random.fold_in(key, 1)
    idx = jransac._sample_indices(key, n_hyp, k, n, jnp.asarray(weights.cpu().numpy()))
    return torch.as_tensor(np.array(idx), dtype=torch.int64, device=weights.device)


JAX_RANSAC_2PT_MONO = jransac.ransac_2pt_mono  # the JAX package's, unguarded
PARALLEL_EPS = 1e-5  # kimera_vio_tpu_torch/ops/ransac.py's bound, restated


def jax_guarded_2pt_mono(f_ref, f_cur, mask, R_ref_cur, key, *, n_hyp=256, threshold=1e-6):
    """The JAX package's `ransac_2pt_mono` with the port's guard: a draw
    whose two indices are equal or whose two normals are parallel,
    |n1 x n2| <= PARALLEL_EPS |n1| |n2|, scores no inliers.

    The JAX function itself scores and refits. Its draws (the JAX
    package's `_sample_indices`) go in with each degenerate draw replaced
    by the batch's first proper one: a copy can only tie the draw it
    copies, and that draw comes first among the proper ones, so the
    winner is the draw the guard lets win. Where no draw is proper, the
    mask is emptied: no inliers, as the port gives. The JAX package's
    fault, repeated draws that win (tests/test_torch_mono_ransac.py),
    does not reach a run that patches this in (`guard_jax`)."""
    n = f_ref.shape[0]
    idx = jransac._sample_indices(key, n_hyp, 2, n, mask.astype(jnp.float32))
    normals = jnp.cross(f_ref, jnp.einsum("ij,nj->ni", R_ref_cur, f_cur))
    n_norm = jnp.linalg.norm(normals, axis=-1)
    t_norm = jnp.linalg.norm(jnp.cross(normals[idx[:, 0]], normals[idx[:, 1]]), axis=-1)
    proper = (idx[:, 0] != idx[:, 1]) & (
        t_norm > PARALLEL_EPS * n_norm[idx[:, 0]] * n_norm[idx[:, 1]])
    draws = jnp.where(proper[:, None], idx, idx[jnp.argmax(proper)])
    sample = jransac._sample_indices
    jransac._sample_indices = lambda *_: draws
    try:
        return JAX_RANSAC_2PT_MONO(f_ref, f_cur, mask & proper.any(), R_ref_cur, key,
                                   n_hyp=n_hyp, threshold=threshold)
    finally:
        jransac._sample_indices = sample


def guard_jax(mp):
    """Through `mp` (a pytest MonkeyPatch), the JAX package's 2-pt mono
    RANSAC guarded as the port's (`jax_guarded_2pt_mono`) in this test
    process. Call it before the JAX frontend is built and traced. No file
    of the JAX package changes."""
    mp.setattr(jransac, "ransac_2pt_mono", jax_guarded_2pt_mono)


@pytest.fixture
def jax_guard(monkeypatch):
    guard_jax(monkeypatch)


@pytest.fixture
def like_jax(monkeypatch):
    """The port tracks with the JAX gather tracker's level plan and draws
    the JAX package's RANSAC hypotheses; the JAX side tracks with its
    gather LK."""
    monkeypatch.setenv("KIMERA_LK_IMPL", "gather")
    monkeypatch.setattr(vision_frontend, "klt_track_lk",
                        functools.partial(klt_track_lk, search_rows=None))
    monkeypatch.setattr(transac, "_sample_indices", _jax_draws)


def _params(**over):
    p = j_synthetic_params(**SIZE, nr_states=8, max_features=64, max_landmarks=96)
    p.frontend.klt_max_level = 2
    p.frontend.templ_cols = 31
    p.frontend.templ_rows = 7
    for k, v in over.items():
        setattr(p.frontend, k, v)
    return p, vio_params_from_dict(dataclasses.asdict(p))


def _frontends(jp, tp, mode):
    """(JAX frontend, port frontend) of the stereo rig, or of the mono rig
    in mode "mono" / "rgbd"."""
    jcfg = JFrontendConfig.from_params(jp.frontend, max_features=64).replace(lk_impl="gather")
    # The port's pyramid tracker (the gather rule under `like_jax`).
    tcfg = FrontendConfig.from_params(tp.frontend, max_features=64)
    tcfg.lk_impl = "pallas"
    if mode == "stereo":
        jrig = JStereoCamera.from_params(jp.left_cam, jp.right_cam)
        trig = StereoCamera.from_params(tp.left_cam, tp.right_cam, device="cpu")
    else:
        jrig = j_mono_rig(jp.left_cam, jp.frontend.nominal_baseline)
        trig = mono_rig(tp.left_cam, tp.frontend.nominal_baseline, device="cpu")
        if mode == "mono":
            jcfg = jcfg.replace(mono=True)
            tcfg.mono = True
        else:
            jcfg = jcfg.replace(rgbd=True, depth_min=jnp.float32(jp.frontend.min_point_dist),
                                depth_max=jnp.float32(jp.frontend.max_point_dist))
            tcfg.rgbd = True
            tcfg.depth_min = float(np.float32(tp.frontend.min_point_dist))
            tcfg.depth_max = float(np.float32(tp.frontend.max_point_dist))
    jfe = JStereoFrontend(jcfg, jrig, jimu.PimParams.from_params(jp.imu))
    tfe = StereoFrontend(tcfg, trig, PimParams.from_params(tp.imu, device="cpu"),
                         torch.device("cpu"))
    return jfe, tfe


@pytest.mark.parametrize("mode", ["rgbd", "mono"])
def test_measurements_match_jax(mode):
    jp, tp = _params()
    jfe, tfe = _frontends(jp, tp, mode)
    rng = np.random.default_rng(2)
    N, H, W = 64, SIZE["height"], SIZE["width"]
    uv = np.stack([rng.uniform(-2, W + 2, N), rng.uniform(-2, H + 2, N)], -1).astype(np.float32)
    uv[:4] = [[0, 0], [W - 1, H - 1], [W - 1.5, 3.25], [17.5, H - 1.0]]
    mask = rng.uniform(size=N) < 0.85
    ids = np.where(mask, np.arange(N), -1).astype(np.int32)
    depth = (4.0 + rng.uniform(-1, 1, (H, W))).astype(np.float32)
    depth[10:20, 30:50] = 0.0  # no depth
    depth[60:70, 100:120] = 60.0  # beyond depth_max
    depth[40, 40] = np.nan
    left = rng.uniform(0, 255, (H, W)).astype(np.float32)
    jf = JTrackedFeatures(uv=jnp.asarray(uv), uv_rect=jnp.asarray(uv), versors=jnp.zeros((N, 3)),
                          ids=jnp.asarray(ids), ages=jnp.zeros(N, jnp.int32),
                          mask=jnp.asarray(mask))
    tf = TrackedFeatures(uv=torch.from_numpy(uv), uv_rect=torch.from_numpy(uv),
                         versors=torch.zeros((N, 3)), ids=torch.from_numpy(ids),
                         ages=torch.zeros(N, dtype=torch.int32), mask=torch.from_numpy(mask))
    jm, _ = jfe._stereo_measurements(jnp.asarray(left), jnp.asarray(depth), jf)
    tm = tfe._stereo_measurements(torch.from_numpy(left), torch.from_numpy(depth), tf)
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    np.testing.assert_array_equal(tm.ids.numpy(), np.asarray(jm.ids))
    np.testing.assert_allclose(tm.uvs.numpy(), np.asarray(jm.uvs), atol=1e-5, equal_nan=True)
    if mode == "rgbd":
        assert 0 < tm.mask.sum() < mask.sum()  # the gates removed some
        assert np.isfinite(tm.uvs.numpy()).all()
    else:
        np.testing.assert_array_equal(tm.mask.numpy(), mask)
        assert np.isnan(tm.uvs.numpy()[:, 1]).all()


def _to_np(tree):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return np.array(x)
    return conv(dataclasses.asdict(tree))


@pytest.mark.parametrize("mode", ["5pt3pt", "mono"])
def test_keyframe_branch_matches_jax(like_jax, jax_guard, mode):
    over = {"ransac_use_2point_mono": False, "ransac_use_1point_stereo": False}
    jp, tp = _params(**over) if mode == "5pt3pt" else _params()
    jfe, tfe = _frontends(jp, tp, "stereo" if mode == "5pt3pt" else "mono")
    assert tfe.cfg.use_2point_mono == (mode == "mono")
    # The JAX frontend tracks frames 1-3 (no keyframe before 0.2 s); its
    # state is carried into the port, and both run the keyframe branch on
    # frame 3 with the same tracked features, PIM and images.
    prov = JProvider(n_frames=8, vx=0.5, **SIZE)
    frames = list(prov.frames())
    img = lambda p, side: prov.load_image(p[side + "_path"])  # noqa: E731
    js, _ = jfe.init_state(jnp.asarray(img(frames[0], "left")), jnp.asarray(img(frames[0], "right")),
                           0.0)
    for p in frames[1:4]:
        stamp = (p["stamp_ns"] - frames[0]["stamp_ns"]) * 1e-9
        js, jo = jfe.process_frame(js, jnp.asarray(img(p, "left")), jnp.asarray(img(p, "right")),
                                   jax.tree.map(jnp.asarray, p["imu"]), stamp)
        assert not bool(jo["is_keyframe"])
    _, _, ts = state_from_numpy(_to_np(jsm.Window.empty(3)), _to_np(jsm.LandmarkTable.empty(8, 3)),
                                _to_np(js), device="cpu")
    left, right = img(frames[3], "left"), img(frames[3], "right")
    jR = jfe.R_cam_body @ js.pim.delta_R @ jfe.R_cam_body.T
    jk, jm, jo = jax.jit(jfe._keyframe_branch)(
        js, js.features, tuple(jof.build_pyramid(jnp.asarray(left), jfe.cfg.klt_max_level)),
        jnp.asarray(left), jnp.asarray(right), js.pim, jR, jnp.float32(stamp))
    tR = tfe.R_cam_body @ ts.pim.delta_R @ tfe.R_cam_body.T
    tk, tm, to = tfe._keyframe_branch(
        ts, ts.features, tof.build_pyramid(torch.from_numpy(left), tfe.cfg.klt_max_level),
        torch.from_numpy(left), torch.from_numpy(right), ts.pim, tR, stamp)
    n_mono = to["n_mono_inliers"]
    assert n_mono == int(jo["n_mono_inliers"])
    if mode == "mono":
        # The best proper 2-pt hypothesis keeps 17 of the 23 tracked pairs:
        # a majority, and enough for the trust gate to filter the tracks.
        # (The unguarded JAX function let a repeated-index draw win with
        # all 23, tests/test_torch_mono_ransac.py.)
        pairs = int((ts.features.mask & ts.lkf_features.mask).sum())
        assert 2 * n_mono > pairs and n_mono >= tfe.cfg.min_mono_inliers
    else:
        assert n_mono >= 20
    assert to["n_stereo_inliers"] == int(jo["n_stereo_inliers"])
    compared = ("R_mono", "t_mono", "R_stereo", "t_stereo_vote")
    if mode == "5pt3pt":
        # The scene is a plane, a critical surface of the essential matrix:
        # the 5-pt solver's 8-point refit is degenerate there and each side
        # returns another rotation of its null space (the solvers are held
        # to each other on a well-conditioned fixture in
        # tests/test_torch_loopclosure.py). Both stay near the true,
        # identity rotation.
        compared = ("R_stereo", "t_stereo_vote")
        for R in (to["R_mono"].numpy(), np.asarray(jo["R_mono"])):
            np.testing.assert_allclose(R, np.eye(3), atol=0.05)
    for k in compared:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    np.testing.assert_array_equal(tm.ids.numpy(), np.asarray(jm.ids))
    np.testing.assert_array_equal(tk.features.mask.numpy(), np.asarray(jk.features.mask))
    assert tk.next_id == int(jk.next_id) and tk.kf_count == int(jk.kf_count)
    m = tm.mask.numpy()
    # Re-detections refine to sub-pixel in float32 sums of another order,
    # and the stereo match is an SSD minimum (as tests/test_torch_frontend.py).
    np.testing.assert_allclose(tm.uvs.numpy()[m], np.asarray(jm.uvs)[m], atol=1e-2, equal_nan=True)
    if mode == "mono":
        assert np.isnan(tm.uvs.numpy()[:, 1]).all() and to["n_stereo_inliers"] == 0
    else:
        assert to["n_stereo_inliers"] >= 20


class _ConstantDepth:
    """tests/test_pipeline_e2e.py:213's RGB-D provider: the synthetic
    sequence's left images and a constant metric depth image."""

    def __init__(self, base):
        self.base = base
        self.ground_truth, self.imu_sync = base.ground_truth, base.imu_sync

    def load_image(self, key):
        if key[0] == "right":
            return np.full((self.base.height, self.base.width), self.base.depth, np.float32)
        return self.base.load_image(key)

    def frames(self):
        return self.base.frames()


@pytest.mark.parametrize("variant", ["mono", "rgbd"])
def test_pipeline_matches_jax(like_jax, variant):
    jp, tp = _params()
    if variant == "mono":
        jout = JMonoPipeline(jp, parallel_run=False).run(JProvider(n_frames=N_FRAMES, vx=0.5, **SIZE))
        prov = SyntheticStereoProvider(n_frames=N_FRAMES, vx=0.5, **SIZE)
        pipe = MonoImuPipeline(tp, parallel_run=False, device="cpu")
        assert pipe.frontend_cfg.mono
    else:
        jout = JRgbdPipeline(jp, parallel_run=False).run(
            _ConstantDepth(JProvider(n_frames=N_FRAMES, vx=0.5, **SIZE)))
        prov = _ConstantDepth(SyntheticStereoProvider(n_frames=N_FRAMES, vx=0.5, **SIZE))
        pipe = RgbdImuPipeline(tp, parallel_run=False, device="cpu")
        assert pipe.frontend_cfg.rgbd
    out = pipe.run(prov)
    assert out.n_frames == jout.n_frames == N_FRAMES
    assert out.stamps_ns == jout.stamps_ns
    assert out.n_keyframes >= 4
    np.testing.assert_allclose(np.stack(out.positions), np.stack(jout.positions), atol=1e-3)
    gt = prov.ground_truth
    ate = compute_ate(np.array(out.stamps_ns), np.stack(out.positions), gt.stamps_ns,
                      gt.positions, align=False)
    assert ate["rmse"] < 0.05, ate
