"""The port's between, external-odometry and constant-velocity factors and
the pose-guess inputs of `backend_step`, against the JAX smoother.

The JAX backend runs the synthetic stereo-inertial scene of
tests/test_torch_backend.py (constant velocity along x past a landmark
field, pixel noise, outliers, mono rows) until its window is full, with
every optional input of `backend_step` given at every keyframe: a
between-stereo relative pose (`btw_*`), an absolute external-odometry pose
(`odom_*`, which the smoother turns into the keyframe-relative `ext_*`
factor) and a pose guess (`guess_*`, valid on every other keyframe), each
the true motion plus seeded noise. The window is carried into the port
with `convert.state_from_numpy` — every factor field included — and then:

  * each new block (`_ext_odom_blocks`, `_between_stereo_blocks`,
    `_const_vel_blocks` with a finite sigma) on that window: within 1e-4
    of each block's largest entry (float32, another summation order);
  * the next `backend_step` with all those inputs, which marginalizes the
    oldest state with its between factors: states within 1e-4 m / rad
    (the tolerance of tests/test_torch_backend.py), the factor fields of
    the new slot within 1e-6, and the marginal prior block by block as
    tests/test_torch_backend.py holds it.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_vio_tpu.backend import smoother as jsm
from kimera_vio_tpu.common import geometry as jgeo
from kimera_vio_tpu.common.types import ImuBlock as JImuBlock
from kimera_vio_tpu.common.types import NavState as JNavState
from kimera_vio_tpu.dataprovider.odometry import OdometryBuffer as JOdometryBuffer
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.frontend import imu_frontend as jimu
from kimera_vio_tpu.frontend.camera import StereoCamera as JStereoCamera
from kimera_vio_tpu_torch.backend import smoother as tsm
from kimera_vio_tpu_torch.convert import state_from_numpy, vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.odometry import OdometryBuffer
from kimera_vio_tpu_torch.frontend.camera import StereoCamera

_spec = importlib.util.spec_from_file_location(
    "torch_backend_fixture", os.path.join(os.path.dirname(__file__), "test_torch_backend.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)
K, L, DT_KF, VX = fx.K, fx.L, fx.DT_KF, fx.VX


def _rot(rng, scale):
    return np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(0, scale, 3), jnp.float32)))


def _configs():
    jparams = j_synthetic_params(width=320, height=240, max_features=64, max_landmarks=L, nr_states=K)
    jparams.backend.between_rotation_precision = 1.0e4  # rotation rows on
    tparams = vio_params_from_dict(dataclasses.asdict(jparams))
    jstereo = JStereoCamera.from_params(jparams.left_cam, jparams.right_cam)
    tstereo = StereoCamera.from_params(tparams.left_cam, tparams.right_cam, device="cpu")
    jcfg = jsm.BackendConfig.from_params(jparams.backend, jparams.imu, jstereo, max_landmarks=L)
    tcfg = tsm.BackendConfig.from_params(tparams.backend, tparams.imu, tstereo, max_landmarks=L,
                                         device="cpu")
    return jparams, jcfg, tcfg


@pytest.fixture(scope="module")
def scene_state():
    """The JAX window after K keyframes with every optional input, and the
    inputs of keyframe K + 1."""
    rng = np.random.default_rng(1)
    jparams, jcfg, tcfg = _configs()
    jpp = jimu.PimParams.from_params(jparams.imu)
    jstep = jax.jit(lambda w, l, pim, st, ids, uvd, m, status, extra: jsm.backend_step(
        jcfg, w, l, pim=pim, stamp=st, meas_ids=ids, meas_uvd=uvd, meas_mask=m, status=status,
        **extra))
    lm = fx.scene(rng)
    win = jsm.Window.empty(K)
    lmk = jsm.LandmarkTable.empty(L, K)
    nav0 = JNavState(rot=jnp.eye(3), pos=jnp.zeros(3), vel=jnp.array([VX, 0.0, 0.0]))
    win = jsm.bootstrap(jcfg, win, nav0, jnp.zeros(6), jnp.float32(0.0))
    ids, uvd, vis = fx.measure(lm, 0, rng)
    lmk = jsm.update_landmarks(lmk, jnp.asarray(ids), jnp.asarray(uvd), jnp.asarray(vis),
                               jnp.int32(0))

    def inputs(k):
        acc, gyr, dt, mask = fx.imu_block(rng)
        pim = jimu.preintegrate(jpp, JImuBlock(acc=jnp.asarray(acc), gyr=jnp.asarray(gyr),
                                               dt=jnp.asarray(dt), mask=jnp.asarray(mask)),
                                jimu.ImuBias.zero())
        ids, uvd, vis = fx.measure(lm, k, rng)
        step = np.array([VX * DT_KF, 0.0, 0.0])
        extra = {
            "btw_R_rel": _rot(rng, 0.01), "btw_t_rel": (step + rng.normal(0, 0.01, 3)).astype(np.float32),
            "btw_valid": np.bool_(k % 3 != 2),
            "odom_R_abs": _rot(rng, 0.01),
            "odom_t_abs": (step * k + rng.normal(0, 0.01, 3)).astype(np.float32),
            "odom_valid_abs": np.bool_(True),
            "guess_R": _rot(rng, 0.005),
            "guess_t": (step * k + rng.normal(0, 0.005, 3)).astype(np.float32),
            "guess_valid": np.bool_(k % 2 == 0),
        }
        return pim, np.float32(DT_KF * k), ids, uvd, vis, 0, extra

    for k in range(1, K + 1):
        pim, st, ids, uvd, vis, status, extra = inputs(k)
        win, lmk, _ = jstep(win, lmk, pim, st, jnp.asarray(ids), jnp.asarray(uvd), jnp.asarray(vis),
                            jnp.int32(status), {a: jnp.asarray(b) for a, b in extra.items()})
    assert int(win.n) == K and bool(np.asarray(win.ext_valid).any())
    assert bool(np.asarray(win.btw_valid).any()) and bool(win.odom_valid)
    return jcfg, tcfg, jstep, win, lmk, inputs(K + 1)


def test_state_from_numpy_carries_every_factor_field(scene_state):
    jcfg, tcfg, jstep, win, lmk, _ = scene_state
    twin, _, _ = state_from_numpy(fx.to_np(win), fx.to_np(lmk), device="cpu")
    for name in ("ext_R", "ext_t", "ext_valid", "btw_R", "btw_t", "btw_valid",
                 "odom_R", "odom_t", "odom_valid"):
        np.testing.assert_array_equal(getattr(twin, name).numpy(), np.asarray(getattr(win, name)),
                                      err_msg=name)


@pytest.mark.parametrize("block", ["_ext_odom_blocks", "_between_stereo_blocks", "_const_vel_blocks"])
def test_pair_factor_block_matches_jax(scene_state, block):
    jcfg, tcfg, jstep, win, lmk, _ = scene_state
    if block == "_const_vel_blocks":
        # Off (inf sigma) from the params' defaults on both sides: set it.
        assert not np.isfinite(float(jcfg.constant_vel_sigma))
        assert not np.isfinite(float(tcfg.constant_vel_sigma))
        jcfg = jcfg.replace(constant_vel_sigma=jnp.float32(0.1))
        tcfg = dataclasses.replace(tcfg, constant_vel_sigma=torch.tensor(0.1))
    twin, _, _ = state_from_numpy(fx.to_np(win), fx.to_np(lmk), device="cpu")
    for ks in (None, [1]):
        jks = None if ks is None else jnp.asarray(ks)
        for a, b in zip(getattr(tsm, block)(tcfg, twin, ks), getattr(jsm, block)(jcfg, win, jks)):
            b = np.asarray(b)
            scale = np.abs(b).max()
            if ks is None:
                assert scale > 0, block  # the factor is active on this window
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * scale, err_msg=block)


def test_backend_step_with_every_input_matches_jax(scene_state):
    jcfg, tcfg, jstep, win, lmk, nxt = scene_state
    pim, st, ids, uvd, vis, status, extra = nxt
    twin, tlmk, _ = state_from_numpy(fx.to_np(win), fx.to_np(lmk), device="cpu")
    jw, jl, jout = jstep(win, lmk, pim, st, jnp.asarray(ids), jnp.asarray(uvd), jnp.asarray(vis),
                         jnp.int32(status), {a: jnp.asarray(b) for a, b in extra.items()})
    tw, tl, tout = tsm.backend_step(
        tcfg, twin, tlmk, pim=fx.port_pim(pim), stamp=float(st),
        meas_ids=torch.from_numpy(ids), meas_uvd=torch.from_numpy(uvd),
        meas_mask=torch.from_numpy(vis), status=status,
        **{a: torch.as_tensor(np.array(b)) for a, b in extra.items()},
    )
    assert int(jout["n_recovered"]) == tout["n_recovered"]
    np.testing.assert_array_equal(tl.ids.numpy(), np.asarray(jl.ids))
    for k in ("rot", "pos", "vel", "bias"):
        np.testing.assert_allclose(getattr(tw, k).numpy(), np.asarray(getattr(jw, k)), atol=1e-4,
                                   err_msg=k)
    for k in ("ext_R", "ext_t", "btw_R", "btw_t", "odom_R", "odom_t"):
        np.testing.assert_allclose(getattr(tw, k).numpy(), np.asarray(getattr(jw, k)), atol=1e-6,
                                   err_msg=k)
    for k in ("ext_valid", "btw_valid", "odom_valid"):
        np.testing.assert_array_equal(getattr(tw, k).numpy(), np.asarray(getattr(jw, k)), err_msg=k)
    # The marginal prior (the oldest state's between factors folded in),
    # block by block as tests/test_torch_backend.py holds it.
    rw_info = np.float32(1.0 / (float(tcfg.gyro_random_walk) ** 2 * DT_KF))
    ulps = 4 * float(np.spacing(rw_info))
    blocks = {"rot": slice(0, 3), "pos": slice(3, 6), "vel": slice(6, 9), "ba": slice(9, 12),
              "bg": slice(12, 15)}
    tH = tw.prior_H.numpy().reshape(K, 15, K, 15)
    jH = np.asarray(jw.prior_H).reshape(K, 15, K, 15)
    for na, sa in blocks.items():
        for nb, sb in blocks.items():
            a, b = tH[:, sa][:, :, :, sb], jH[:, sa][:, :, :, sb]
            atol = 1e-3 * np.abs(b).max() + (ulps if "bg" in (na, nb) else 0.0)
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"prior_H {na}-{nb}")
    # The guess of this (even) keyframe replaced the IMU prediction, and the
    # solve still lands on the constant-velocity truth.
    np.testing.assert_allclose(tout["pos"].numpy(), [VX * DT_KF * (K + 1), 0, 0], atol=0.02)


@pytest.mark.parametrize("use_factor", [False, True])
def test_backend_config_constant_velocity_switch_matches_jax(use_factor):
    jparams = j_synthetic_params(width=320, height=240, max_landmarks=L, nr_states=K)
    jparams.backend.use_constant_velocity_factor = use_factor  # read with getattr on both sides
    tparams = vio_params_from_dict({k: v for k, v in dataclasses.asdict(jparams).items()})
    tparams.backend.use_constant_velocity_factor = use_factor
    jcfg = jsm.BackendConfig.from_params(
        jparams.backend, jparams.imu, JStereoCamera.from_params(jparams.left_cam, jparams.right_cam))
    tcfg = tsm.BackendConfig.from_params(
        tparams.backend, tparams.imu,
        StereoCamera.from_params(tparams.left_cam, tparams.right_cam, device="cpu"), device="cpu")
    for name in ("constant_vel_sigma", "between_rot_sigma", "between_pos_sigma",
                 "ext_odom_rot_sigma", "ext_odom_pos_sigma"):
        assert float(getattr(tcfg, name)) == float(getattr(jcfg, name)), name


def test_odometry_buffer_matches_jax():
    rng = np.random.default_rng(4)
    bufs = [JOdometryBuffer(max_size=6), OdometryBuffer(max_size=6)]
    stamps = np.cumsum(rng.integers(40, 60, 9)) * 1_000_000
    for s in stamps:
        R, tv = _rot(rng, 0.3).astype(np.float64), rng.normal(0, 1, 3)
        for b in bufs:
            b.add(int(s), R, tv, vel_world=None if s % 2 else tv * 0.5)
    assert len(bufs[0]) == len(bufs[1]) == 6
    for q in list(stamps) + [int(stamps[-1]) + 10**9, 0]:
        for tol in (None, 10**7):
            a, b = (buf.get_nearest(int(q), tol) for buf in bufs)
            assert (a is None) == (b is None)
            if a is not None:
                assert a["stamp_ns"] == b["stamp_ns"]
                for k in ("R", "t", "vel"):
                    np.testing.assert_array_equal(a[k], b[k])
    for qa, qb in ((stamps[4], stamps[7]), (stamps[8], stamps[5]), (stamps[6], stamps[6])):
        a, b = (buf.relative(int(qa), int(qb)) for buf in bufs)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b[0], a[0], atol=1e-12)
            np.testing.assert_allclose(b[1], a[1], atol=1e-12)
    assert bufs[1].get_nearest(0, tolerance_ns=10) is None
    assert OdometryBuffer().get_nearest(5) is None
