"""The port's FleetVio over a (data, model) mesh of devices
(kimera_vio_tpu_torch/parallel/fleet.py) and the sharded landmark table
(kimera_vio_tpu_torch/backend/smoother.py), on the CPU.

Sizes as tests/test_torch_fleet.py: 160x120, fx 120, 64 features and
landmarks, 5 states, 3 pyramid levels, 31x7 stereo templates; four
distinct streams (vx 0.3 / 0.5 / 0.8 / 0.7 m/s at 20 / 15 / 25 / 16
frames/s, so that they keyframe at different frames). The meshes repeat
one CPU device (["cpu"] * 4), as the JAX tests run their mesh on virtual
CPU devices (tests/conftest.py).

Tolerances:
  * the port's meshes against the JAX FleetVio on its (2, 2) mesh: the
    same keyframe flags, positions within 1e-3 m and rotations within
    1e-3 rad, tests/test_torch_fleet.py's tolerance (float32 sums in
    another order throughout; the port tracks with the JAX gather
    tracker's level plan and draws the JAX RANSAC hypotheses);
  * the port's meshes against its own one-device fleet: the same keyframe
    flags, positions within 2e-5 m (the tolerance of the JAX package's
    __graft_entry__.dryrun_multichip: the sharded smart-factor system is
    summed in another order), and the landmark table (ids, observations,
    observation masks) equal bit for bit, since the rows a landmark takes
    are chosen over the whole table (and at this size the sum's last-bit
    differences, fed back to the frontend through the IMU bias, flip no
    track; at 752x480 on the card one can, chip_smoke.py phase 11);
  * the sharded landmark functions against the plain ones: row
    assignment and shifting bit for bit, the Gauss-Newton system within
    1e-6 of its largest entry (a sum split over the shards).
"""

import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_map as pytree_map

from kimera_vio_tpu_torch.backend import smoother as sm
from kimera_vio_tpu_torch.common.types import stack_trees, unstack_trees
from kimera_vio_tpu_torch.convert import fleet_state_from_numpy
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider
from kimera_vio_tpu_torch.parallel import FleetVio, fleet_mesh
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_fleet", os.path.join(REPO, "tests", "test_torch_fleet.py"))
_tf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tf)

STREAMS = ((0.3, 20.0), (0.5, 15.0), (0.8, 25.0), (0.7, 16.0))  # (vx m/s, frames/s)
N_FRAMES = 12
B = len(STREAMS)
MESHES = ((2, 2), (2, 1), (1, 2))  # (data rows, model shards)
_params = _tf._params


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
        prov = SyntheticStereoProvider(n_frames=N_FRAMES, vx=vx, fps=fps, **_tf.SIZE)
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


@functools.lru_cache(maxsize=None)
def _gt_navs():
    """Each stream's ground-truth state at its first frame, stacked."""
    pipe = StereoImuPipeline(_params(), parallel_run=False, device="cpu")
    navs, biases = [], []
    for prov, frames in _streams():
        nav, bias = pipe._bootstrap_state(prov, frames[0][4], None)
        navs.append(nav)
        biases.append(bias)
    return stack_trees(navs), torch.stack(biases)


def _mesh_kw(mesh):
    D, M = mesh
    return dict(devices=["cpu"] * (D * M), model_shards=M)


def _run(n_frames=N_FRAMES, **kw):
    """FleetVio(**kw) from the ground truth over the first n_frames
    frames: per step the outputs and the landmark table (ids, obs_uvd,
    obs_mask) gathered over the data rows and model shards."""
    fleet = FleetVio(_params(), B, **kw)
    state = fleet.init(*_frame(0)[:2], *_gt_navs())
    steps = []
    for k in range(1, n_frames):
        state, out = fleet.step(state, *_frame(k))
        table = [torch.cat([getattr(row.lmk, f) for row in state.rows])
                 for f in ("ids", "obs_uvd", "obs_mask")]
        steps.append((out, table))
    return fleet, steps


@functools.lru_cache(maxsize=None)
def _one_device_run():
    return _run(device="cpu")[1]


# ---------------------------------------------------------------------------
# (a) against the JAX FleetVio on its (2, 2) mesh, and the JAX state
# carried over
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mesh_run():
    """The JAX FleetVio on a (2, 2) mesh of four virtual CPU devices,
    tracking with its gather LK: the state after `init` as numpy, and per
    step the keyframe flags, rotations and positions."""
    import jax
    from jax.sharding import Mesh

    from kimera_vio_tpu.common.types import NavState as JNavState
    from kimera_vio_tpu.parallel import FleetVio as JFleetVio

    navs, biases = _gt_navs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KIMERA_LK_IMPL", "gather")
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
        fleet = JFleetVio(_params(jax_params=True), B, mesh=mesh)
        lefts, rights = _frame(0)[0].numpy(), _frame(0)[1].numpy()
        state = fleet.init(lefts, rights,
                           JNavState(rot=navs.rot.numpy(), pos=navs.pos.numpy(),
                                     vel=navs.vel.numpy()), biases.numpy())
        init = {k: _tf._to_np(getattr(state, k)) for k in ("fe_state", "win", "lmk")}
        steps = []
        for k in range(1, N_FRAMES):
            state, out = fleet.step(state, *_jax_frame(k))
            steps.append({k: np.array(out[k]) for k in ("is_keyframe", "rot", "pos")})
    return {"init": init, "steps": steps}


def _jax_frame(k):
    from kimera_vio_tpu.common.types import ImuBlock as JImuBlock

    lefts, rights, blocks, stamps = _frame(k)
    return (lefts.numpy(), rights.numpy(),
            JImuBlock(*(getattr(blocks, f).numpy() for f in ("acc", "gyr", "dt", "mask"))),
            np.asarray(stamps, np.float32))


like_jax = _tf.like_jax


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_mesh_matches_jax_mesh(jax_mesh_run, like_jax, mesh):
    fleet, steps = _run(**_mesh_kw(mesh))
    assert [len(row) for row in fleet.mesh] == [mesh[1]] * mesh[0]
    mixed = 0
    for k, ((out, _), want) in enumerate(zip(steps, jax_mesh_run["steps"]), start=1):
        _tf._assert_like_jax(out, want, (mesh, k))
        mixed += bool(want["is_keyframe"].any() and not want["is_keyframe"].all())
    assert mixed >= 1
    pos = out["pos"]
    assert min(float(torch.linalg.norm(pos[i] - pos[j]))
               for i in range(B) for j in range(i + 1, B)) > 1e-3


def test_mesh_state_from_jax(jax_mesh_run, like_jax):
    """The JAX (2, 2) FleetState after `init`, gathered to numpy -> the
    port's FleetState on a (2, 2) mesh: each row's streams on the row,
    each shard's landmark rows on the shard; one step from it agrees with
    the JAX fleet's first step."""
    init = jax_mesh_run["init"]
    fleet = FleetVio(_params(), B, **_mesh_kw((2, 2)))
    state = fleet_state_from_numpy(init["fe_state"], init["win"], init["lmk"], mesh=fleet.mesh)
    assert len(state.rows) == 2
    for r, row in enumerate(state.rows):
        assert row.win.rot.shape[0] == B // 2 and list(row.fe_state.frame_count) == [1, 1]
        assert [s.ids.shape for s in row.lmk.shards] == [(B // 2, 32)] * 2
        assert np.array_equal(row.lmk.ids.numpy(), init["lmk"]["ids"][2 * r:2 * r + 2])
        assert np.array_equal(row.lmk.obs_uvd.numpy(), init["lmk"]["obs_uvd"][2 * r:2 * r + 2],
                              equal_nan=True)
    _, out = fleet.step(state, *_frame(1))
    _tf._assert_like_jax(out, jax_mesh_run["steps"][0], 1)


# ---------------------------------------------------------------------------
# (b) against the port's own one-device fleet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_mesh_matches_one_device_fleet(mesh):
    gold = _one_device_run()
    _, steps = _run(**_mesh_kw(mesh))
    n_kf = 0
    for k, ((out, table), (want, want_table)) in enumerate(zip(steps, gold), start=1):
        assert np.array_equal(out["is_keyframe"], want["is_keyframe"]), k
        torch.testing.assert_close(out["pos"], want["pos"], atol=2e-5, rtol=0)
        for got, ref in zip(table, want_table):
            torch.testing.assert_close(got, ref, atol=0, rtol=0, equal_nan=True)
        for name in ("lmk_ids", "lmk_valid", "kp_ids", "kp_mask"):
            assert torch.equal(out[name], want[name]), (k, name)
        torch.testing.assert_close(out["lmk_points"], want["lmk_points"], atol=2e-5, rtol=0)
        n_kf += int(out["is_keyframe"].sum())
    assert n_kf >= 2 * B


def test_one_by_one_mesh_is_the_one_device_fleet():
    """An explicit one-device mesh is the default fleet, bit for bit."""
    _, steps = _run(devices=["cpu"])
    for (out, table), (want, want_table) in zip(steps, _one_device_run()):
        for k in want:
            if isinstance(want[k], torch.Tensor):
                assert torch.equal(out[k], want[k]), k
            else:
                assert np.array_equal(out[k], want[k]), k
        assert all(torch.equal(a, b) for a, b in zip(table, want_table))


# ---------------------------------------------------------------------------
# (c) the landmark functions over shards
# ---------------------------------------------------------------------------


def _table_at_capacity(seed=0, L=64, K=5, N=48):
    """A table with 40 of its 64 rows live (scattered), and a keyframe's
    measurements: 16 known ids and 30 new ones, more than the 24 free
    rows, with some masked."""
    rng = np.random.default_rng(seed)
    ids = np.full(L, -1, np.int32)
    live = rng.choice(L, 40, replace=False)
    ids[live] = rng.choice(1000, 40, replace=False)
    lmk = sm.LandmarkTable(
        ids=torch.as_tensor(ids),
        obs_uvd=torch.as_tensor(rng.normal(0, 50, (L, K, 3)).astype(np.float32)),
        obs_mask=torch.as_tensor(rng.random((L, K)) > 0.5) & torch.as_tensor(ids >= 0)[:, None],
        pts=torch.as_tensor(rng.normal(0, 5, (L, 3)).astype(np.float32)),
        pts_ok=torch.as_tensor(rng.random(L) > 0.3))
    meas_ids = np.concatenate([rng.choice(ids[live], 16, replace=False),
                               2000 + np.arange(N - 16)]).astype(np.int32)
    meas = (torch.as_tensor(meas_ids),
            torch.as_tensor(rng.normal(200, 50, (N, 3)).astype(np.float32)),
            torch.as_tensor(rng.random(N) > 0.05))
    return lmk, meas


def _gathered(lmk):
    return [getattr(lmk, f) for f in ("ids", "obs_uvd", "obs_mask", "pts", "pts_ok")]


@pytest.mark.parametrize("M", [2, 4])
def test_update_and_shift_landmarks_over_shards(M):
    lmk, (ids, uvd, mask) = _table_at_capacity()
    n_new = int((mask & ~torch.isin(ids, lmk.ids)).sum())
    assert n_new > int((lmk.ids < 0).sum())  # more new ids than free rows
    sharded = sm.shard_landmarks(lmk, [torch.device("cpu")] * M)
    assert isinstance(sharded, sm.ShardedLandmarkTable) and len(sharded.shards) == M
    for a, b in zip(_gathered(sharded), _gathered(lmk)):
        assert torch.equal(a, b)
    want = sm.update_landmarks(lmk, ids, uvd, mask, 3)
    got = sm.update_landmarks(sharded, ids, uvd, mask, 3)
    assert (want.ids >= 0).all()  # every free row taken
    for a, b in zip(_gathered(got), _gathered(want)):
        assert torch.equal(a, b)
    assert [s.ids.shape[0] for s in got.shards] == [64 // M] * M
    for a, b in zip(_gathered(sm.shift_landmarks(got)), _gathered(sm.shift_landmarks(want))):
        assert torch.equal(a, b)
    # Three shards do not divide 64 rows: the plain table, which the JAX
    # fleet's `_shard` leaves unsplit too.
    whole = sm.shard_landmarks(lmk, [torch.device("cpu")] * 3)
    assert type(whole) is sm.LandmarkTable
    for a, b in zip(_gathered(whole), _gathered(lmk)):
        assert torch.equal(a, b)


def test_backend_on_sharded_table():
    """The Gauss-Newton system, a backend step and the state covariance on
    a two-shard table against the plain table, at a keyframe of the first
    stream's run: the system within 1e-6 of its largest entry, the step's
    pose within 2e-5 m, its landmark table bit for bit."""
    pipe = StereoImuPipeline(_params(), parallel_run=False, device="cpu")
    (_, frames), nav = _streams()[0], unstack_trees(_gt_navs()[0], B)[0]
    fe, win, lmk = pipe._init_stream(frames[0][0], frames[0][1], 0.0, nav, _gt_navs()[1][0])
    kf = None
    for left, right, blk, stamp, _ in frames[1:]:
        trk = pipe.frontend.track(fe, left, blk)
        decision = pipe.frontend.decide(fe, trk, stamp)
        fe2, fo = pipe.frontend.finish(fe, trk, left, right, stamp, decision)
        if decision[0] and win.n >= 2:
            kf = (fe2, fo, stamp)
            break
        fe, win, lmk, *_ = pipe._step(fe, win, lmk, left, right, blk, stamp)
    assert kf is not None
    sharded = sm.shard_landmarks(lmk, [torch.device("cpu")] * 2)
    cfg = pipe.backend_cfg
    H, g, points = sm._assemble(cfg, win, lmk)
    Hs, gs, points_s = sm._assemble(cfg, win, sharded)
    assert len(points) == 1 and len(points_s) == 2
    torch.testing.assert_close(Hs, H, atol=1e-6 * float(H.abs().max()), rtol=0)
    torch.testing.assert_close(gs, g, atol=1e-6 * float(g.abs().max()), rtol=0)
    torch.testing.assert_close(torch.cat([p for p, _ in points_s]), points[0][0], atol=0, rtol=0)
    assert torch.equal(torch.cat([ok for _, ok in points_s]), points[0][1])
    cov, ok = sm.state_covariance(cfg, win, lmk, return_ok=True)
    cov_s, ok_s = sm.state_covariance(cfg, win, sharded, return_ok=True)
    assert bool(ok) and bool(ok_s)
    torch.testing.assert_close(cov_s, cov, atol=1e-3 * float(cov.abs().max()), rtol=0)

    fe2, fo, stamp = kf
    _, w1, l1, _, out1 = pipe._keyframe_half(fe2, win, lmk, fo, stamp)
    _, w2, l2, _, out2 = pipe._keyframe_half(fe2, win, sharded, fo, stamp)
    assert isinstance(l2, sm.ShardedLandmarkTable)
    torch.testing.assert_close(out2["pos"], out1["pos"], atol=2e-5, rtol=0)
    for a, b in zip(_gathered(l2)[:3], _gathered(l1)[:3]):
        assert torch.equal(a, b)
    assert torch.equal(out2["lmk_ids"], out1["lmk_ids"])
    assert torch.equal(out2["lmk_valid"], out1["lmk_valid"])


# ---------------------------------------------------------------------------
# (d) the mesh rules
# ---------------------------------------------------------------------------


def test_mesh_rules(monkeypatch):
    import jax

    from kimera_vio_tpu.parallel import FleetVio as JFleetVio

    names = [torch.device("cpu", i) for i in range(6)]
    # An explicit list reshapes row-major, as the JAX fleet's device array.
    for M in (1, 2, 3, 6):
        want = np.array(names, dtype=object).reshape(6 // M, M).tolist()
        assert fleet_mesh("cpu", names, M) == want
    # A device may repeat in an explicit list; a bare "cuda" is the current card.
    assert fleet_mesh("cpu", ["cpu"] * 4, 2) == [[torch.device("cpu")] * 2] * 2
    # Without a list: every visible card, model_shards shrunk as the JAX
    # fleet shrinks it over its default mesh (here its 8 virtual devices).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(jax.devices()))
    for M in (1, 3, 5, 8, 16):
        jmesh = JFleetVio(_params(jax_params=True), 8, model_shards=M).mesh
        mesh = fleet_mesh("cuda", None, M)
        assert (len(mesh), len(mesh[0])) == (jmesh.shape["data"], jmesh.shape["model"]), M
        assert [d for row in mesh for d in row] == [torch.device("cuda", i) for i in range(8)]
    assert fleet_mesh("cuda:1", None, 4) == [[torch.device("cuda", 1)]]
    monkeypatch.undo()
    assert fleet_mesh("cpu", None, 4) == [[torch.device("cpu")]]
    # The refusals.
    params = _params()
    with pytest.raises(ValueError, match=r"n_streams=4 must divide over the data axis \(3 shards\)"):
        FleetVio(params, 4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="model_shards=2"):
        FleetVio(params, 4, devices=["cpu"] * 3, model_shards=2)
    with pytest.raises(ValueError, match="model_shards=0"):
        FleetVio(params, 4, devices=["cpu"], model_shards=0)
    # A model axis that does not divide the landmark count (64 % 3) builds,
    # each row's table whole on the row's first device: the JAX fleet's
    # `_shard` leaves such an axis unsplit.
    fleet = FleetVio(params, 4, devices=["cpu"] * 3, model_shards=3)
    assert fleet.mesh == [[torch.device("cpu")] * 3]
    state = fleet.init(*_frame(0)[:2])
    assert [type(row.lmk) for row in state.rows] == [sm.LandmarkTable]
    assert state.lmk.ids.shape == (4, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetVio(params, 4, devices=["cuda"] * 2)
    # One data row reads through; two do not.
    fleet = FleetVio(params, 4, devices=["cpu"] * 2)
    state = fleet.init(*_frame(0)[:2])
    assert len(state.rows) == 2 and state.rows[1].win.rot.shape[0] == 2
    with pytest.raises(AttributeError, match="2 data rows"):
        state.win
    with pytest.raises(ValueError, match="data rows"):
        FleetVio(params, 4, device="cpu").step(state, *_frame(1))


# ---------------------------------------------------------------------------
# (e) device placement on a mesh of named devices
# ---------------------------------------------------------------------------


_DEVICE_ATTR = torch._C.TensorBase.__dict__["device"]


class NamedDevices(TorchFunctionMode):
    """The CPU standing in for distinct cards. A tensor made on a named
    CPU device ("cpu:1") or moved to one keeps that name, which its
    `.device` reports; an op's result takes the name of its inputs; an op
    that mixes two names raises, as CUDA raises for tensors on two cards.
    Cross-device copies (`.to`, `copy_`) are allowed; `.cpu()` is the
    host (no name), and so are tensors made without a device or on a
    device without an index."""

    def __init__(self):
        super().__init__()
        self.seen = set()  # every named device a result was placed on

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__self__", None) is _DEVICE_ATTR:
            return getattr(args[0], "_named", None) or func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        inputs = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        target = kwargs.get("device")
        if name == "to" and target is None:
            for a in args[1:]:
                if isinstance(a, (str, torch.device)):
                    target = a
                elif isinstance(a, torch.Tensor):
                    target = getattr(a, "_named", a.device)
        in_place = name.endswith("_") and not name.startswith("__") or name == "__setitem__"
        if target is None and name not in ("copy_", "cpu", "numpy"):
            named = {t._named for t in inputs if hasattr(t, "_named")}
            if len(named) > 1:
                raise RuntimeError(f"{name} mixes devices {sorted(map(str, named))}")
            target = named.pop() if named else None
        out = func(*args, **kwargs)
        if in_place or name == "__setitem__":
            return out

        def mark(t):
            if not isinstance(t, torch.Tensor):
                return t
            if any(t is a for a in inputs):
                t = t.view_as(t)  # `.to` and `as_tensor` may return their input
            if name == "cpu":
                return t
            if target is not None and torch.device(target).index is not None:
                t._named = torch.device(target)
                self.seen.add(t._named)
            return t

        return pytree_map(mark, out)


def _leaves(tree):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _placement_run(names, model_shards):
    """FleetVio on a mesh of named CPU devices from the ground truth over
    six frames: (fleet, state, last outputs, keyframes per stream, the
    named devices any result was placed on)."""
    with NamedDevices() as mode:
        fleet = FleetVio(_params(), B, devices=names, model_shards=model_shards)
        state = fleet.init(*_frame(0)[:2], *_gt_navs())
        n_kf = np.zeros(B, int)
        for k in range(1, 7):
            state, out = fleet.step(state, *_frame(k))
            n_kf += out["is_keyframe"]
    return fleet, state, out, n_kf, mode.seen


def test_mesh_device_placement():
    """A (2, 2) mesh of four named CPU devices: no op mixes two of them,
    every leaf of a row's frontend state and window lies on the row's
    first device, every leaf of a landmark shard on the shard's device,
    and the outputs on the mesh's first device, after steps that keyframe
    in every stream."""
    names = [f"cpu:{i}" for i in range(4)]
    fleet, state, out, n_kf, _ = _placement_run(names, 2)
    assert (n_kf >= 1).all()
    assert fleet.mesh == [[torch.device(n) for n in names[:2]], [torch.device(n) for n in names[2:]]]
    for row, devs in zip(state.rows, fleet.mesh):
        for leaf in _leaves((row.fe_state, row.win)):
            assert getattr(leaf, "_named", None) == devs[0]
        for shard, dev in zip(row.lmk.shards, devs, strict=True):
            for leaf in _leaves(shard):
                assert getattr(leaf, "_named", None) == dev
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            assert getattr(v, "_named", None) == torch.device("cpu", 0), k
    # The mode sees through: a leak from one row into another raises.
    with NamedDevices(), pytest.raises(RuntimeError, match="mixes devices"):
        torch.zeros(3, device="cpu:0") + torch.zeros(3, device="cpu:1")


def test_uneven_mesh_device_placement():
    """A (2, 3) mesh of six named CPU devices at 64 landmarks (64 % 3 = 1):
    each row's table plain and whole on the row's first device, and no
    tensor ever placed on a row's other two devices."""
    names = [f"cpu:{i}" for i in range(6)]
    fleet, state, out, n_kf, seen = _placement_run(names, 3)
    assert (n_kf >= 1).all()
    assert [len(row) for row in fleet.mesh] == [3, 3]
    for row, devs in zip(state.rows, fleet.mesh):
        assert type(row.lmk) is sm.LandmarkTable
        for leaf in _leaves((row.fe_state, row.win, row.lmk)):
            assert getattr(leaf, "_named", None) == devs[0]
    assert seen == {torch.device("cpu", 0), torch.device("cpu", 3)}
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            assert getattr(v, "_named", None) == torch.device("cpu", 0), k
