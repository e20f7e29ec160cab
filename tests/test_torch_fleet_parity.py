"""The port's FleetVio against the JAX FleetVio where the two used to part,
on the CPU.

Sizes as tests/test_torch_fleet.py: 160x120, fx 120, 64 features and
landmarks, 5 states, 3 pyramid levels, 31x7 stereo templates; 12 frames.

(a) A model axis that does not divide the landmark table: the JAX fleet on
    a (2, 3) mesh of six virtual CPU devices (64 % 3 = 1, so `_shard`
    places the table over `data` alone) against the port on
    `["cpu"] * 6` with `model_shards=3`, which keeps each row's table
    whole on the row's first device; the four streams of
    tests/test_torch_fleet_mesh.py.
(b) The outputs the JAX fleet's fused step adds under its switches:
    `use_lcd`, `do_fine_imu_camera_temporal_sync` and `auto_initialize: 2`
    on together, the three streams of tests/test_torch_fleet.py on a
    one-device JAX mesh.

Tolerances: the same keyframe flags, positions within 1e-3 m and
rotations within 1e-3 rad, tests/test_torch_fleet.py's (float32 sums in
another order throughout; the port tracks with the JAX gather tracker's
level plan and draws the JAX RANSAC hypotheses). In (b) the same 28
output keys, and every switched field on every stream and frame,
keyframing or not:
  * the same mono and stereo RANSAC inlier counts on every stream and
    frame, and the float fields within 1e-3 (the three the stereo RANSAC
    gives, `vis_rot_angle`, `init_R_rel_body` and `init_t_rel_body`, within
    5.6e-4 seen). The JAX fleet's 2-pt mono RANSAC is guarded as the
    port's (tests/test_torch_variants.py::guard_jax): unguarded, a
    degenerate draw wins at every keyframe of this run (18-23 inliers
    against the guarded 12-20), the stereo RANSAC then keeps other
    tracks, and `init_t_rel_body` parts by up to 1.6e-2 m;
  * `lcd_ok` equal wherever the two sides' keypoints (`lcd_uv`) agree,
    `lcd_desc` equal bit for bit wherever both sides' `lcd_ok` are true
    and the keypoints agree, but for the bits whose pair of ORB samples
    ties within 1e-5 (the two packages' smoothing rounds differently
    there, tests/test_torch_loopclosure.py).
Every flag set here is reset in a `finally`.
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from kimera_vio_tpu_torch.backend import smoother as sm
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.convert import fleet_state_from_numpy
from kimera_vio_tpu_torch.loopclosure import orb as torb
from kimera_vio_tpu_torch.parallel import FleetVio
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, file):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tests", file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_tf = _load("torch_fleet", "test_torch_fleet.py")
_tm = _load("torch_fleet_mesh", "test_torch_fleet_mesh.py")

_params = _tf._params
_one_thread = _tf._one_thread
like_jax = _tf.like_jax
UNEVEN = (2, 3)  # (data rows, model shards): 64 landmarks do not divide over 3
SWITCHES = ("use_lcd", "do_fine_imu_camera_temporal_sync")
INIT_FIELDS = ("init_R_rel_body", "init_t_rel_body", "init_pim_delta_R", "init_pim_delta_v",
               "init_pim_delta_p", "init_pim_dR_dbg")
LCD_FLOATS = ("lcd_uv", "lcd_versors", "lcd_pts3")
SWITCHED = LCD_FLOATS + ("lcd_ok", "lcd_desc", "vis_rot_angle") + INIT_FIELDS


# ---------------------------------------------------------------------------
# (a) the (2, 3) mesh at 64 landmarks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_uneven_run():
    """The JAX FleetVio on a (2, 3) mesh of six virtual CPU devices,
    tracking with its gather LK: the landmark table's partition, the state
    after `init` as numpy, and per step the keyframe flags, rotations and
    positions."""
    import jax
    from jax.sharding import Mesh

    from kimera_vio_tpu.common.types import NavState as JNavState
    from kimera_vio_tpu.parallel import FleetVio as JFleetVio

    navs, biases = _tm._gt_navs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KIMERA_LK_IMPL", "gather")
        mesh = Mesh(np.array(jax.devices()[:6]).reshape(UNEVEN), ("data", "model"))
        fleet = JFleetVio(_params(jax_params=True), _tm.B, mesh=mesh)
        lefts, rights = _tm._frame(0)[0].numpy(), _tm._frame(0)[1].numpy()
        state = fleet.init(lefts, rights,
                           JNavState(rot=navs.rot.numpy(), pos=navs.pos.numpy(),
                                     vel=navs.vel.numpy()), biases.numpy())
        spec = tuple(state.lmk.ids.sharding.spec)
        init = {k: _tf._to_np(getattr(state, k)) for k in ("fe_state", "win", "lmk")}
        steps = []
        for k in range(1, _tm.N_FRAMES):
            state, out = fleet.step(state, *_tm._jax_frame(k))
            steps.append({k: np.array(out[k]) for k in ("is_keyframe", "rot", "pos")})
    return {"spec": spec, "init": init, "steps": steps}


def _assert_whole_tables(fleet, state):
    """Each row's table plain and whole on the row's first device."""
    for row, devs in zip(state.rows, fleet.mesh, strict=True):
        assert type(row.lmk) is sm.LandmarkTable
        assert row.lmk.ids.shape == (_tm.B // UNEVEN[0], 64)
        assert all(leaf.device == devs[0] for leaf in _tm._leaves(row.lmk))


def test_uneven_mesh_matches_jax_mesh(jax_uneven_run, like_jax):
    assert jax_uneven_run["spec"] == ("data",)  # the JAX rule leaves the axis unsplit
    fleet, steps = _tm._run(**_tm._mesh_kw(UNEVEN))
    assert [len(row) for row in fleet.mesh] == [UNEVEN[1]] * UNEVEN[0]
    mixed = 0
    for k, ((out, table), want) in enumerate(zip(steps, jax_uneven_run["steps"],
                                                 strict=True), start=1):
        _tf._assert_like_jax(out, want, (UNEVEN, k))
        assert table[0].shape == (_tm.B, 64)
        mixed += bool(want["is_keyframe"].any() and not want["is_keyframe"].all())
    assert mixed >= 1
    pos = out["pos"]
    assert min(float(torch.linalg.norm(pos[i] - pos[j]))
               for i in range(_tm.B) for j in range(i + 1, _tm.B)) > 1e-3


def test_uneven_mesh_is_the_two_row_fleet():
    """With its tables whole, the (2, 3) mesh is the (2, 1) mesh bit for
    bit: the model axis holds nothing."""
    fleet, steps = _tm._run(**_tm._mesh_kw(UNEVEN))
    _, gold = _tm._run(**_tm._mesh_kw((2, 1)))
    state = fleet.init(*_tm._frame(0)[:2], *_tm._gt_navs())
    _assert_whole_tables(fleet, state)
    for (out, table), (want, want_table) in zip(steps, gold, strict=True):
        for k in want:
            if isinstance(want[k], torch.Tensor):
                assert torch.equal(out[k], want[k]), k
            else:
                assert np.array_equal(out[k], want[k]), k
        assert all(torch.equal(a, b) for a, b in zip(table, want_table))


def test_uneven_mesh_state_from_jax(jax_uneven_run, like_jax):
    """The JAX (2, 3) FleetState after `init`, gathered to numpy -> the
    port's FleetState on its (2, 3) mesh: each row's streams on the row,
    its tables whole on the row's first device; one step from it agrees
    with the JAX fleet's first step."""
    init = jax_uneven_run["init"]
    fleet = FleetVio(_params(), _tm.B, **_tm._mesh_kw(UNEVEN))
    state = fleet_state_from_numpy(init["fe_state"], init["win"], init["lmk"], mesh=fleet.mesh)
    assert len(state.rows) == UNEVEN[0]
    _assert_whole_tables(fleet, state)
    for r, row in enumerate(state.rows):
        assert row.win.rot.shape[0] == 2 and list(row.fe_state.frame_count) == [1, 1]
        assert np.array_equal(row.lmk.ids.numpy(), init["lmk"]["ids"][2 * r:2 * r + 2])
        assert np.array_equal(row.lmk.obs_uvd.numpy(), init["lmk"]["obs_uvd"][2 * r:2 * r + 2],
                              equal_nan=True)
    _, out = fleet.step(state, *_tm._frame(1))
    _tf._assert_like_jax(out, jax_uneven_run["steps"][0], 1)


# ---------------------------------------------------------------------------
# (b) the switched outputs
# ---------------------------------------------------------------------------


def _switched_params(jax_params=False):
    p = _params(jax_params)
    p.backend.auto_initialize = 2
    return p


@contextlib.contextmanager
def _switches_on():
    from kimera_vio_tpu.config import flags as jflags

    try:
        for name in SWITCHES:
            jflags.set_flag(name, True)
            flags.set_flag(name, True)
        yield
    finally:
        for name in SWITCHES:
            jflags.set_flag(name, False)
            flags.set_flag(name, False)


@pytest.fixture(scope="module")
def jax_switched_run():
    """The JAX FleetVio on a one-device mesh with the three switches on,
    tracking with its gather LK, its 2-pt mono RANSAC guarded as the
    port's (tests/test_torch_variants.py::guard_jax): per step every
    output as numpy."""
    import jax
    from jax.sharding import Mesh

    from kimera_vio_tpu.common.types import NavState as JNavState
    from kimera_vio_tpu.parallel import FleetVio as JFleetVio

    navs, biases = _tf._gt_navs(StereoImuPipeline(_params(), parallel_run=False, device="cpu"))
    with pytest.MonkeyPatch.context() as mp, _switches_on():
        mp.setenv("KIMERA_LK_IMPL", "gather")
        _tf._tv.guard_jax(mp)
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
        fleet = JFleetVio(_switched_params(jax_params=True), _tf.B, mesh=mesh)
        lefts, rights = _tf._jax_frame(0)
        state = fleet.init(lefts, rights,
                           JNavState(rot=navs.rot.numpy(), pos=navs.pos.numpy(),
                                     vel=navs.vel.numpy()), biases.numpy())
        steps = []
        for k in range(1, _tf.N_FRAMES):
            state, out = fleet.step(state, *_tf._jax_frame(k))
            steps.append({k: np.array(v) for k, v in out.items()})
    return {"steps": steps, "navs": navs, "biases": biases}


def _switched_fleet_run(navs, biases):
    """The port's FleetVio with the three switches on: the fleet and per
    step its outputs."""
    with _switches_on():
        fleet = FleetVio(_switched_params(), _tf.B, device="cpu")
        state = fleet.init(*_tf._frame(0)[:2], navs, biases)
        outs = []
        for k in range(1, _tf.N_FRAMES):
            state, out = fleet.step(state, *_tf._frame(k))
            outs.append(out)
    return fleet, outs


def _orb_ties(fleet, k, uv):
    """Per stream of fleet frame k, which descriptor bits of the keypoints
    `uv` (B, n, 2) come from a pair of ORB samples within 1e-5 of a tie, on
    the stream's rectified left image."""
    fe = fleet._pipe.frontend
    lefts = _tf._frame(k)[0]
    ties = []
    for b in range(_tf.B):
        a, c, _ = torb.orb_samples(fe._remap_left(lefts[b].to(torch.float32)), uv[b])
        ties.append((a - c).abs().numpy() < 1e-5)
    return np.stack(ties)  # (B, n, 256)


def _bits(desc):
    desc = np.ascontiguousarray(desc).view(np.uint32)
    return np.unpackbits(desc.view(np.uint8), axis=-1, bitorder="little").astype(bool)


def test_switched_outputs_match_jax_fleet(jax_switched_run, like_jax):
    fleet, outs = _switched_fleet_run(jax_switched_run["navs"], jax_switched_run["biases"])
    n_kf = n_lcd = 0
    for k, (out, want) in enumerate(zip(outs, jax_switched_run["steps"], strict=True), start=1):
        assert set(out) == set(want) and len(want) == 28, sorted(set(out) ^ set(want))
        _tf._assert_like_jax(out, want, k)
        got = {name: out[name].numpy() for name in SWITCHED}
        for name in SWITCHED:
            assert got[name].shape == want[name].shape, name
        for name in ("n_mono_inliers", "n_stereo_inliers"):
            assert np.array_equal(out[name], want[name]), (name, k)
        for name in LCD_FLOATS + ("vis_rot_angle",) + INIT_FIELDS:
            for b in range(_tf.B):
                np.testing.assert_allclose(got[name][b], want[name][b], atol=1e-3, rtol=0,
                                           err_msg=f"{name} at frame {k}, stream {b}")
        same_uv = (np.abs(got["lcd_uv"] - want["lcd_uv"]) < 1e-3).all(-1)  # (B, n)
        assert np.array_equal(got["lcd_ok"][same_uv], want["lcd_ok"][same_uv]), k
        both = same_uv & got["lcd_ok"] & want["lcd_ok"]
        differ = (_bits(got["lcd_desc"]) != _bits(want["lcd_desc"])) & both[..., None]
        if differ.any():
            assert not (differ & ~_orb_ties(fleet, k, out["lcd_uv"])).any(), k
        kf = want["is_keyframe"]
        n_kf += int(kf.sum())
        n_lcd += int(both.sum())
        # A tracking stream's fields are the JAX tracking branch's.
        assert not got["lcd_ok"][~kf].any() and (got["vis_rot_angle"][~kf] == 0).all()
    assert n_kf >= 2 * _tf.B and n_lcd > 0
    assert (np.stack([o["vis_rot_angle"].numpy() for o in outs]) > 0).any()
