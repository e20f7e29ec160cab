"""The port's FleetVio (kimera_vio_tpu_torch/parallel/fleet.py) and the
stream axis it adds to the frame step, on the CPU.

Sizes as tests/test_fleet.py: 160x120, fx 120, 64 features and
landmarks, 5 states, 3 pyramid levels, 31x7 stereo templates. Three
distinct streams: the synthetic sequence at vx 0.3 / 0.5 / 0.8 m/s and
20 / 15 / 25 frames/s, so that under the default keyframe policy the
streams keyframe at different frames (a stream keyframes once 0.2 s have
passed since its last keyframe: every 4th, 3rd and 5th frame).

Tolerances:
  * the plain LK with a stream axis, the batched pyramid, gradients,
    rotational prediction and median: bit-identical to the streams run
    one by one;
  * the batched preintegration: within 1e-6, its batched matrix products
    and einsums sum in another order (7.5e-9 seen);
  * FleetVio against the port's own single-stream step: the same keyframe
    flags, states within 1e-5 (only the preintegration differs in bits);
  * FleetVio against the JAX FleetVio: the same keyframe flags, positions
    within 1e-3 m and rotations within 1e-3 rad, the tolerance of
    tests/test_torch_pipeline.py for the same reasons (float32 sums in
    another order throughout). The port tracks with the JAX gather
    tracker's level plan and draws the JAX package's RANSAC hypotheses
    (tests/test_torch_variants.py::_jax_draws).
"""

import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from kimera_vio_tpu_torch.common.geometry import so3_log
from kimera_vio_tpu_torch.common.types import (
    ImuBlock,
    NavState,
    stack_trees,
    tree_clone,
    tree_set,
    unstack_trees,
)
from kimera_vio_tpu_torch.convert import fleet_state_from_numpy
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.frontend import imu_frontend as imu
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.ops import corner_detection as det
from kimera_vio_tpu_torch.ops import lk_kernel as lk
from kimera_vio_tpu_torch.ops import optical_flow as of
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.parallel import FleetVio
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_variants", os.path.join(REPO, "tests", "test_torch_variants.py"))
_tv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tv)

SIZE = dict(width=160, height=120, fx=120.0)
STREAMS = ((0.3, 20.0), (0.5, 15.0), (0.8, 25.0))  # (vx m/s, frames/s)
N_FRAMES = 12
B = len(STREAMS)


def _params(jax_params=False):
    if jax_params:
        from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params

        p = j_synthetic_params(**SIZE, max_features=64, max_landmarks=64, nr_states=5)
    else:
        p = synthetic_params(**SIZE, max_features=64, max_landmarks=64, nr_states=5)
    p.frontend.klt_max_level = 2
    p.frontend.templ_cols = 31
    p.frontend.templ_rows = 7
    return p


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores,
    and these small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _streams():
    """Per stream: its provider and its frames as (left, right, IMU block,
    stamp in float32 seconds since its first frame, stamp ns)."""
    out = []
    for vx, fps in STREAMS:
        prov = SyntheticStereoProvider(n_frames=N_FRAMES, vx=vx, fps=fps, **SIZE)
        packets = list(prov.frames())
        s0 = packets[0]["stamp_ns"]
        frames = [(torch.from_numpy(prov.load_image(p["left_path"])),
                   torch.from_numpy(prov.load_image(p["right_path"])), p["imu"],
                   float(np.float32((p["stamp_ns"] - s0) * 1e-9)), p["stamp_ns"])
                  for p in packets]
        out.append((prov, frames))
    return out


def _frame(k):
    """Fleet frame k: stacked (lefts, rights, IMU blocks, stamps)."""
    fr = [frames[k] for _, frames in _streams()]
    return (torch.stack([f[0] for f in fr]), torch.stack([f[1] for f in fr]),
            stack_trees([f[2] for f in fr]), [f[3] for f in fr])


def _gt_navs(pipe):
    """Each stream's ground-truth state at its first frame."""
    navs, biases = [], []
    for prov, frames in _streams():
        nav, bias = pipe._bootstrap_state(prov, frames[0][4], None)
        navs.append(nav)
        biases.append(bias)
    return stack_trees(navs), torch.stack(biases)


# ---------------------------------------------------------------------------
# 1. The plain LK with a stream axis
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lk_inputs():
    """Three streams' keyframe -> frame+3 pyramids (3 levels) and their
    keyframes' 64 GFTT keypoints."""
    prev, cur, pts, valid = [], [], [], []
    for _, frames in _streams():
        a, b = frames[0][0], frames[3][0]
        uv, ok = det.detect_features(a, torch.zeros((64, 2)), torch.zeros(64, dtype=torch.bool), 64)
        prev.append(of.build_pyramid(a, 2))
        cur.append(of.build_pyramid(b, 2))
        pts.append(uv)
        valid.append(ok)
    stack = lambda levels: [torch.stack(lv) for lv in zip(*levels)]  # noqa: E731
    return prev, cur, pts, valid, stack(prev), stack(cur), torch.stack(pts), torch.stack(valid)


@pytest.mark.parametrize("search_rows", [56, None], ids=["window_rule", "gather_rule"])
def test_batched_plain_lk_is_bit_identical_per_stream(search_rows):
    prev, cur, pts, valid, prevB, curB, ptsB, validB = _lk_inputs()
    kw = dict(win=24, max_iter=30, eps=0.1, min_eig_thresh=1e-4, search_rows=search_rows)
    gradsB = [of._grad(p) for p in prevB]
    init = ptsB + torch.tensor([0.7, -0.4])
    outB, okB, levelsB = lk.track_pyramid(lk.lk_level_plain, prevB, curB, ptsB, init, validB,
                                          gradsB, **kw)
    assert outB.shape == (B, 64, 2) and okB.shape == (B, 64)
    assert int(okB.sum()) > 0.5 * int(validB.sum())
    for b in range(B):
        grads = [of._grad(p) for p in prev[b]]
        out, ok, levels = lk.track_pyramid(lk.lk_level_plain, prev[b], cur[b], pts[b], init[b],
                                           valid[b], grads, **kw)
        assert torch.equal(outB[b], out) and torch.equal(okB[b], ok)
        for lb, l1 in zip(levelsB, levels):
            assert lb["mode"] == l1["mode"] and torch.equal(lb["iters"][b], l1["iters"])
    # klt_track_lk takes the stream axis on the CPU too.
    pts_k, ok_k = lk.klt_track_lk(prevB, curB, ptsB, init, validB, prev_grads=gradsB,
                                  device="cpu", **kw)
    assert torch.equal(pts_k, outB) and torch.equal(ok_k, okB)


def test_lk_wrapper_validates_stream_axis():
    """The CUDA wrapper checks every shape before it needs the card: one B
    for planes, keypoints and flags, planes of the keypoints' rank."""
    _, _, _, _, prevB, curB, ptsB, validB = _lk_inputs()
    gradsB = [of._grad(p) for p in prevB]
    kw = dict(win=24, max_iter=30, eps=0.1, min_eig_thresh=1e-4, search_rows=56)
    call = functools.partial(lk.lk_pyramid_cuda, **kw)
    with pytest.raises(ValueError, match="valid"):
        call(prevB, curB, gradsB, ptsB, ptsB, validB[:, :-1])
    with pytest.raises(ValueError, match="shape"):
        call([p[:2] for p in prevB], curB, gradsB, ptsB, ptsB, validB)
    with pytest.raises(ValueError, match="2-D planes"):
        call([p[0] for p in prevB], curB, gradsB, ptsB, ptsB, validB)
    with pytest.raises(ValueError, match="init_pts"):
        call(prevB, curB, gradsB, ptsB, ptsB[:2], validB)
    with pytest.raises(ValueError, match="needs CUDA"):
        call(prevB, curB, gradsB, ptsB, ptsB, validB)


def test_unstack_trees_inverts_stack_trees():
    """`unstack_trees` gives back what `stack_trees` stacked (tensor views,
    host scalars, dicts, empty tuples, None); `tree_clone` shares no
    storage; `tree_set` writes one stream."""
    trees = [{"nav": NavState(rot=torch.eye(3) * (b + 1), pos=torch.full((3,), float(b)),
                              vel=torch.zeros(3)),
              "n": b, "stamp": 0.5 * b, "empty": (), "none": None} for b in range(B)]
    stacked = stack_trees(trees)
    assert stacked["nav"].rot.shape == (B, 3, 3) and stacked["n"].tolist() == [0, 1, 2]
    for got, want in zip(unstack_trees(stacked, B), trees, strict=True):
        _assert_trees_equal(got["nav"], want["nav"])
        assert got["n"] == want["n"] and type(got["n"]) is int and got["stamp"] == want["stamp"]
        assert got["empty"] == () and got["none"] is None
        assert got["nav"].pos.data_ptr() != want["nav"].pos.data_ptr()  # a view of the stack
    copy = tree_clone(stacked["nav"])
    tree_set(copy, 1, trees[0]["nav"])
    assert torch.equal(copy.pos[1], trees[0]["nav"].pos)
    assert torch.equal(stacked["nav"].pos[1], trees[1]["nav"].pos)  # the original untouched


# ---------------------------------------------------------------------------
# 2. The batched per-frame part
# ---------------------------------------------------------------------------


def test_batched_frame_ops_match_per_stream():
    pipe = StereoImuPipeline(_params(), parallel_run=False, device="cpu")
    fe = pipe.frontend
    lefts, _, blocks, _ = _frame(4)
    pyrB = of.build_pyramid(lefts, 2)
    for b in range(B):
        pyr = of.build_pyramid(lefts[b], 2)
        assert all(torch.equal(lb[b], l1) for lb, l1 in zip(pyrB, pyr))
        for (gxB, gyB), (gx, gy) in zip(map(of._grad, pyrB), map(of._grad, pyr)):
            assert torch.equal(gxB[b], gx) and torch.equal(gyB[b], gy)

    rng = np.random.default_rng(3)
    bias = imu.ImuBias(accel=torch.tensor(rng.normal(0, 0.05, (B, 3)), dtype=torch.float32),
                       gyro=torch.tensor(rng.normal(0, 0.01, (B, 3)), dtype=torch.float32))
    init = imu.preintegrate(fe.pim_params, _frame(2)[2], bias)
    pimB = imu.preintegrate(fe.pim_params, blocks, bias, init=init)
    for b, (blk, blk0, bias_b) in enumerate(zip(unstack_trees(blocks, B),
                                                unstack_trees(_frame(2)[2], B),
                                                unstack_trees(bias, B))):
        pim = imu.preintegrate(fe.pim_params, blk, bias_b,
                               init=imu.preintegrate(fe.pim_params, blk0, bias_b))
        for f in dataclasses.fields(imu.Pim):
            if f.name != "bias_hat":
                torch.testing.assert_close(getattr(pimB, f.name)[b], getattr(pim, f.name),
                                           atol=1e-6, rtol=0)

    R = torch.stack([torch.linalg.matrix_exp(torch.tensor(
        [[0, -w, 0.01], [w, 0, -0.02], [-0.01, 0.02, 0]], dtype=torch.float32)) for w in (0.01, 0.03, -0.02)])
    uv = torch.tensor(rng.uniform(0, 120, (B, 64, 2)), dtype=torch.float32)
    ok = torch.tensor(rng.random((B, 64)) > 0.2)
    predB = of.predict_flow_rotational(uv, ok, R[:, None], fe.K_raw, fe.K_raw_inv, 160, 120)
    disp = torch.tensor(rng.uniform(0, 3, (B, 64)), dtype=torch.float32)
    medB = vision_frontend._nanmedian_linear(disp, ok)
    for b in range(B):
        pred = of.predict_flow_rotational(uv[b], ok[b], R[b][None], fe.K_raw, fe.K_raw_inv, 160, 120)
        assert torch.equal(predB[b], pred)
        assert torch.equal(medB[b], vision_frontend._nanmedian_linear(disp[b], ok[b]))


@pytest.mark.parametrize("distorted", [False, True], ids=["pinhole", "radtan"])
def test_batched_track_matches_per_stream(distorted):
    """`StereoFrontend.track` on the three streams' stacked states against
    each stream's own call: the same pyramid, keypoints and policy
    inputs (1e-5: the batched preintegration's rotation seeds LK), also
    through the radial-tangential undistortion and rectification of a
    distorted rig."""
    params = _params()
    if distorted:
        for cam in (params.left_cam, params.right_cam):
            cam.distortion_model = "radial-tangential"
            cam.distortion_coeffs = np.array([-0.28, 0.07, 2e-4, 1e-5])
    fe = StereoImuPipeline(params, parallel_run=False, device="cpu").frontend
    assert fe.identity_rect != distorted
    states = [fe.init_state(frames[0][0], frames[0][1], 0.0)[0] for _, frames in _streams()]
    lefts, _, blocks, _ = _frame(3)
    trkB = fe.track(stack_trees(states), lefts, blocks)
    for b, (state, blk) in enumerate(zip(states, unstack_trees(blocks, B))):
        trk = fe.track(state, lefts[b], blk)
        assert all(torch.equal(lb[b], l1) for lb, l1 in zip(trkB.pyramid, trk.pyramid))
        for name in ("uv", "uv_rect", "versors"):
            torch.testing.assert_close(getattr(trkB.features, name)[b],
                                       getattr(trk.features, name), atol=1e-5, rtol=0)
        assert torch.equal(trkB.features.mask[b], trk.features.mask)
        assert torch.equal(trkB.features.ids[b], trk.features.ids)
        assert trkB.policy[b, 0] == trk.policy[0] > 10
        assert abs(trkB.policy[b, 1] - trk.policy[1]) < 1e-5
        torch.testing.assert_close(trkB.R_cam[b], trk.R_cam, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# 3. FleetVio against the port's own single-stream step
# ---------------------------------------------------------------------------


def _single_stream_runs(pipe, navs, biases):
    """Each stream alone: `_init_stream` at its ground truth, then `_step`
    per frame; per frame (is_keyframe, rot, pos, vel, bias, backend
    outputs, measurements)."""
    runs = []
    for b, ((_, frames), nav) in enumerate(zip(_streams(), unstack_trees(navs, B))):
        fe, win, lmk = pipe._init_stream(frames[0][0], frames[0][1], 0.0, nav, biases[b])
        rows = []
        for left, right, blk, stamp, _ in frames[1:]:
            fe, win, lmk, fo, bout = pipe._step(fe, win, lmk, left, right, blk, stamp)
            slot = max(win.n - 1, 0)
            state = [bout[k] if bout else getattr(win, k)[slot] for k in ("rot", "pos", "vel", "bias")]
            rows.append((fo["is_keyframe"], *(x.clone() for x in state), bout,
                         fo["measurements"]))
        runs.append(rows)
    return runs


def _assert_trees_equal(a, b):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_trees_equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b, strict=True):
            _assert_trees_equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        torch.testing.assert_close(a, b, atol=0, rtol=0, equal_nan=True)
    else:
        assert np.array_equal(a, b)


def test_fleet_matches_single_stream_steps():
    params = _params()
    pipe = StereoImuPipeline(params, parallel_run=False, device="cpu")
    navs, biases = _gt_navs(pipe)
    gold = _single_stream_runs(pipe, navs, biases)

    fleet = FleetVio(params, B, device="cpu")
    lefts, rights, _, _ = _frame(0)
    state = fleet.init(lefts, rights, navs, biases)
    mixed = 0
    for k in range(1, N_FRAMES):
        before = tree_clone(state)
        prev, (state, out) = state, fleet.step(state, *_frame(k))
        _assert_trees_equal(prev, before)  # step leaves its input as it was
        kf = out["is_keyframe"]
        if kf.any() and not kf.all() and not mixed:
            # A step from the same state gives the same frame again.
            _, again = fleet.step(prev, *_frame(k))
            assert np.array_equal(again["is_keyframe"], kf)
            torch.testing.assert_close(again["pos"], out["pos"], atol=0, rtol=0)
        mixed += bool(kf.any() and not kf.all())
        for b in range(B):
            is_kf, rot, pos, vel, bias, bout, meas = gold[b][k - 1]
            assert bool(kf[b]) == is_kf, (k, b)
            for name, want in zip(("rot", "pos", "vel", "bias"), (rot, pos, vel, bias)):
                torch.testing.assert_close(out[name][b], want, atol=1e-5, rtol=0)
            if is_kf:
                assert torch.equal(out["kp_ids"][b], meas.ids)
                assert torch.equal(out["kp_mask"][b], meas.mask)
                torch.testing.assert_close(out["kp_uv"][b], meas.uvs[:, [0, 2]], atol=1e-5,
                                           rtol=0, equal_nan=True)
                assert torch.equal(out["lmk_ids"][b], bout["lmk_ids"])
                assert torch.equal(out["lmk_valid"][b], bout["lmk_valid"])
                torch.testing.assert_close(out["lmk_points"][b], bout["lmk_points"], atol=1e-5,
                                           rtol=0)
            else:
                assert not bool(out["kp_mask"][b].any()) and not bool(out["lmk_valid"][b].any())
    assert mixed >= 1
    pos = out["pos"]
    assert min(float(torch.linalg.norm(pos[i] - pos[j]))
               for i in range(B) for j in range(i + 1, B)) > 1e-3


# ---------------------------------------------------------------------------
# 4-5. FleetVio against the JAX FleetVio, and the JAX state carried over
# ---------------------------------------------------------------------------


def _to_np(tree):
    """A flax struct as nested dicts of numpy."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return np.array(x)
    return conv(dataclasses.asdict(tree))


def _jax_frame(k):
    from kimera_vio_tpu.common.types import ImuBlock as JImuBlock

    lefts, rights, blocks, stamps = _frame(k)
    if blocks is None:  # the first frame has no IMU block
        return lefts.numpy(), rights.numpy()
    return (lefts.numpy(), rights.numpy(),
            JImuBlock(*(getattr(blocks, f).numpy() for f in ("acc", "gyr", "dt", "mask"))),
            np.asarray(stamps, np.float32))


@pytest.fixture(scope="module")
def jax_fleet_run():
    """The JAX FleetVio on a one-device CPU mesh (the default mesh spans
    the 8 virtual devices and needs B divisible by 8), tracking with its
    gather LK: the state after `init` as numpy, and per step the keyframe
    flags, rotations and positions."""
    import jax
    from jax.sharding import Mesh

    from kimera_vio_tpu.common.types import NavState as JNavState
    from kimera_vio_tpu.parallel import FleetVio as JFleetVio

    pipe = StereoImuPipeline(_params(), parallel_run=False, device="cpu")
    navs, biases = _gt_navs(pipe)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KIMERA_LK_IMPL", "gather")
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
        fleet = JFleetVio(_params(jax_params=True), B, mesh=mesh)
        lefts, rights = _jax_frame(0)
        state = fleet.init(lefts, rights,
                           JNavState(rot=navs.rot.numpy(), pos=navs.pos.numpy(),
                                     vel=navs.vel.numpy()), biases.numpy())
        init = {k: _to_np(getattr(state, k)) for k in ("fe_state", "win", "lmk")}
        steps = []
        for k in range(1, N_FRAMES):
            state, out = fleet.step(state, *_jax_frame(k))
            steps.append({k: np.array(out[k]) for k in ("is_keyframe", "rot", "pos")})
    return {"init": init, "steps": steps, "navs": navs, "biases": biases}


@pytest.fixture
def like_jax(monkeypatch):
    # The port's stereo pipelines built in the test track with the gather
    # rule, as the JAX fleet does under the same variable.
    monkeypatch.setenv("KIMERA_LK_IMPL", "gather")
    monkeypatch.setattr(vision_frontend, "klt_track_lk",
                        functools.partial(lk.klt_track_lk, search_rows=None))
    monkeypatch.setattr(transac, "_sample_indices", _tv._jax_draws)


def _assert_like_jax(out, want, where):
    assert np.array_equal(out["is_keyframe"], want["is_keyframe"]), where
    np.testing.assert_allclose(out["pos"].numpy(), want["pos"], atol=1e-3, err_msg=str(where))
    Rj = torch.as_tensor(want["rot"])
    ang = torch.linalg.norm(so3_log(Rj.transpose(-1, -2) @ out["rot"]), dim=-1)
    assert float(ang.max()) < 1e-3, (where, ang)


def test_fleet_matches_jax_fleet(jax_fleet_run, like_jax):
    fleet = FleetVio(_params(), B, device="cpu")
    lefts, rights, _, _ = _frame(0)
    state = fleet.init(lefts, rights, jax_fleet_run["navs"], jax_fleet_run["biases"])
    mixed = 0
    for k, want in enumerate(jax_fleet_run["steps"], start=1):
        state, out = fleet.step(state, *_frame(k))
        _assert_like_jax(out, want, k)
        mixed += bool(want["is_keyframe"].any() and not want["is_keyframe"].all())
    assert mixed >= 1
    pos = out["pos"]
    assert min(float(torch.linalg.norm(pos[i] - pos[j]))
               for i in range(B) for j in range(i + 1, B)) > 1e-3


def test_fleet_state_from_jax(jax_fleet_run, like_jax):
    """The JAX FleetState after `init` as numpy -> the port's FleetState;
    one step from it agrees with the JAX fleet's first step."""
    init = jax_fleet_run["init"]
    state = fleet_state_from_numpy(init["fe_state"], init["win"], init["lmk"], device="cpu")
    assert state.lmk.ids.shape == (B, 64) and state.win.rot.shape[0] == B
    assert state.fe_state.lkf_pyramid[0].shape == (B, 120, 160)
    assert list(state.fe_state.frame_count) == [1] * B and list(state.win.n) == [1] * B
    # The converted state is the port's own init, leaf by leaf.
    fleet = FleetVio(_params(), B, device="cpu")
    own = fleet.init(*_frame(0)[:2], jax_fleet_run["navs"], jax_fleet_run["biases"])
    torch.testing.assert_close(state.win.pos, own.win.pos, atol=1e-6, rtol=0)
    torch.testing.assert_close(state.fe_state.lkf_features.uv, own.fe_state.lkf_features.uv,
                               atol=1e-3, rtol=0)
    assert torch.equal(state.fe_state.lkf_features.mask, own.fe_state.lkf_features.mask)
    _, out = fleet.step(state, *_frame(1))
    _assert_like_jax(out, jax_fleet_run["steps"][0], 1)


# ---------------------------------------------------------------------------
# 6. Device rule and limits
# ---------------------------------------------------------------------------


def test_fleet_device_rule_and_limits():
    params = _params()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetVio(params, B)
    with pytest.raises(ValueError, match="must divide over the data axis"):
        FleetVio(params, B, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="model_shards=2"):
        FleetVio(params, B, devices=["cpu"] * 3, model_shards=2)
    fleet = FleetVio(params, B, device="cpu")
    lefts, rights, blocks, stamps = _frame(0)
    with pytest.raises(ValueError, match="3 streams"):
        fleet.init(lefts[:2], rights[:2])
    state = fleet.init(lefts, rights)  # identity states, zero biases
    assert list(state.win.n) == [1] * B
    assert torch.equal(state.win.rot[:, 0], torch.eye(3).expand(B, 3, 3))
    lefts, rights, blocks, stamps = _frame(1)
    with pytest.raises(ValueError, match="3 streams"):
        fleet.step(state, lefts, rights[:2], blocks, stamps)
    with pytest.raises(ValueError, match="imu_blocks"):
        fleet.step(state, lefts, rights, ImuBlock(*(getattr(blocks, f)[:1] for f in
                                                   ("acc", "gyr", "dt", "mask"))), stamps)
    with pytest.raises(ValueError, match="stamps"):
        fleet.step(state, lefts, rights, blocks, stamps[:2])
