"""One backend step of the port against the JAX smoother, from the same
state.

A synthetic stereo-inertial scene (constant velocity past a landmark
field, pixel noise and a few outliers, made with numpy from a seed) is run
through the JAX backend until its window is full. The JAX Window and
LandmarkTable are then carried into the port with
`kimera_vio_tpu_torch.convert.state_from_numpy`, and the next keyframe is
solved by both: it marginalizes the oldest state, triangulates, and runs
the Gauss-Newton iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_vio_tpu.backend import smoother as jsm
from kimera_vio_tpu.common.types import ImuBlock as JImuBlock
from kimera_vio_tpu.common.types import NavState as JNavState
from kimera_vio_tpu.config.params import VioParams as JVioParams
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.frontend import imu_frontend as jimu
from kimera_vio_tpu.frontend.camera import StereoCamera as JStereoCamera
from kimera_vio_tpu_torch.backend import smoother as tsm
from kimera_vio_tpu_torch.common.types import ImuBias
from kimera_vio_tpu_torch.convert import state_from_numpy, vio_params_from_dict
from kimera_vio_tpu_torch.frontend.camera import StereoCamera
from kimera_vio_tpu_torch.frontend.imu_frontend import Pim

K, L, NM = 4, 64, 48
DT_KF = 0.2
VX = 0.5


def to_np(tree):
    """A flax struct (or nested dataclasses) as nested dicts of numpy."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return np.array(x)
    return conv(dataclasses.asdict(tree))


def port_pim(p):
    d = to_np(p)
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    return Pim(**{k: t(v) for k, v in d.items() if k != "bias_hat"},
               bias_hat=ImuBias(accel=t(d["bias_hat"]["accel"]), gyro=t(d["bias_hat"]["gyro"])))


def scene(rng):
    lm = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(3, 8, L)], -1)
    return lm


def measure(lm, k, rng, fx=450.0, cx=160.0, cy=120.0, b=0.11):
    """Stereo measurements of the landmarks from keyframe k (camera = body,
    identity rotation, moving along x)."""
    p = lm - np.array([VX * DT_KF * k, 0.0, 0.0])
    uvd = np.stack([fx * p[:, 0] / p[:, 2] + cx, fx * (p[:, 0] - b) / p[:, 2] + cx,
                    fx * p[:, 1] / p[:, 2] + cy], -1)
    uvd = uvd + rng.normal(0, 0.3, uvd.shape)
    ids = np.arange(L, dtype=np.int32)
    vis = (uvd[:, 0] > 0) & (uvd[:, 0] < 320) & (uvd[:, 2] > 0) & (uvd[:, 2] < 240)
    order = rng.permutation(L)[:NM]
    uvd, ids, vis = uvd[order], ids[order], vis[order]
    uvd[:3] += rng.normal(0, 25.0, (3, 3))  # outliers
    uvd[3:5, 1] = np.nan  # mono observations
    return ids, uvd.astype(np.float32), vis


def imu_block(rng, n=48):
    acc = np.tile([0.0, 0.0, 9.81], (n, 1)) + rng.normal(0, 0.02, (n, 3))
    gyr = rng.normal(0, 0.002, (n, 3))
    dt = np.full(n, 0.005)
    mask = np.arange(n) < int(round(DT_KF / 0.005))
    dt[~mask] = 0.0
    return acc.astype(np.float32), gyr.astype(np.float32), dt.astype(np.float32), mask


def test_backend_step_matches_jax():
    rng = np.random.default_rng(0)
    jparams = j_synthetic_params(width=320, height=240, max_features=64, max_landmarks=L, nr_states=K)
    tparams = vio_params_from_dict(dataclasses.asdict(jparams))
    assert isinstance(jparams, JVioParams)
    jstereo = JStereoCamera.from_params(jparams.left_cam, jparams.right_cam)
    tstereo = StereoCamera.from_params(tparams.left_cam, tparams.right_cam, device="cpu")
    jcfg = jsm.BackendConfig.from_params(jparams.backend, jparams.imu, jstereo, max_landmarks=L)
    tcfg = tsm.BackendConfig.from_params(tparams.backend, tparams.imu, tstereo, max_landmarks=L,
                                         device="cpu")
    jpp = jimu.PimParams.from_params(jparams.imu)

    jstep = jax.jit(lambda w, l, pim, st, ids, uvd, m, status: jsm.backend_step(
        jcfg, w, l, pim=pim, stamp=st, meas_ids=ids, meas_uvd=uvd, meas_mask=m, status=status))

    lm = scene(rng)
    win = jsm.Window.empty(K)
    lmk = jsm.LandmarkTable.empty(L, K)
    nav0 = JNavState(rot=jnp.eye(3), pos=jnp.zeros(3), vel=jnp.array([VX, 0.0, 0.0]))
    win = jsm.bootstrap(jcfg, win, nav0, jnp.zeros(6), jnp.float32(0.0))
    ids, uvd, vis = measure(lm, 0, rng)
    lmk = jsm.update_landmarks(lmk, jnp.asarray(ids), jnp.asarray(uvd), jnp.asarray(vis), jnp.int32(0))

    def inputs(k):
        acc, gyr, dt, mask = imu_block(rng)
        pim = jimu.preintegrate(jpp, JImuBlock(acc=jnp.asarray(acc), gyr=jnp.asarray(gyr),
                                               dt=jnp.asarray(dt), mask=jnp.asarray(mask)),
                                jimu.ImuBias.zero())
        ids, uvd, vis = measure(lm, k, rng)
        return pim, np.float32(DT_KF * k), ids, uvd, vis, 0

    for k in range(1, K + 1):
        pim, st, ids, uvd, vis, status = inputs(k)
        win, lmk, _ = jstep(win, lmk, pim, st, jnp.asarray(ids), jnp.asarray(uvd),
                            jnp.asarray(vis), jnp.int32(status))
    assert int(win.n) == K  # full: the next step marginalizes

    pim, st, ids, uvd, vis, status = inputs(K + 1)
    twin, tlmk, _ = state_from_numpy(to_np(win), to_np(lmk), device="cpu")
    jw, jl, jout = jstep(win, lmk, pim, st, jnp.asarray(ids), jnp.asarray(uvd),
                         jnp.asarray(vis), jnp.int32(status))
    tw, tl, tout = tsm.backend_step(
        tcfg, twin, tlmk, pim=port_pim(pim), stamp=float(st),
        meas_ids=torch.from_numpy(ids), meas_uvd=torch.from_numpy(uvd),
        meas_mask=torch.from_numpy(vis), status=status,
    )
    assert int(jout["n_recovered"]) == tout["n_recovered"]
    np.testing.assert_array_equal(tl.ids.numpy(), np.asarray(jl.ids))
    np.testing.assert_array_equal(tl.obs_mask.numpy(), np.asarray(jl.obs_mask))
    np.testing.assert_array_equal(tout["lmk_valid"].numpy(), np.asarray(jout["lmk_valid"]))
    # Float32 normal equations (equilibrated Cholesky of a 60x60 system)
    # assembled in another summation order: states agree to 1e-4 m / rad.
    for k in ("rot", "pos", "vel", "bias"):
        np.testing.assert_allclose(getattr(tw, k).numpy(), np.asarray(getattr(jw, k)),
                                   atol=1e-4, err_msg=k)
    # The marginal prior, block by block (rotation, position, velocity,
    # accel bias, gyro bias, over all states): each block within 1e-3 of
    # its own largest entry (measured: < 6e-5 outside the gyro bias). The
    # gyro-bias rows and columns of the Schur complement H11 - H01^T H00^-1
    # H01 are differences of terms of the order of the bias random-walk
    # information 1/(sigma_g^2 dt) ~ 1.3e10, where one float32 ulp is 1024,
    # that cancel down to 1e4..1e5: both sides round there, so those blocks
    # get four ulps of that scale on top (measured: up to 2.6 ulps).
    rw_info = np.float32(1.0 / (float(tcfg.gyro_random_walk) ** 2 * DT_KF))
    ulps = 4 * float(np.spacing(rw_info))
    blocks = {"rot": slice(0, 3), "pos": slice(3, 6), "vel": slice(6, 9),
              "ba": slice(9, 12), "bg": slice(12, 15)}
    tH = tw.prior_H.numpy().reshape(K, 15, K, 15)
    jH = np.asarray(jw.prior_H).reshape(K, 15, K, 15)
    for na, sa in blocks.items():
        for nb, sb in blocks.items():
            a, b = tH[:, sa][:, :, :, sb], jH[:, sa][:, :, :, sb]
            assert np.abs(b).max() > 0, (na, nb)
            atol = 1e-3 * np.abs(b).max() + (ulps if "bg" in (na, nb) else 0.0)
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"prior_H {na}-{nb}")
    ok = np.asarray(jout["lmk_valid"])
    np.testing.assert_allclose(tout["lmk_points"].numpy()[ok], np.asarray(jout["lmk_points"])[ok],
                               atol=1e-3)
    # The trajectory itself is right: constant velocity along x.
    np.testing.assert_allclose(tout["pos"].numpy(), [VX * DT_KF * (K + 1), 0, 0], atol=0.02)

    # Zero-velocity / no-motion factors (LOW_DISPARITY keyframes) on the
    # same window: identical rows up to float32 rounding.
    jw1 = jw.replace(status=jnp.ones(K, jnp.int32))
    tw1 = dataclasses.replace(tw, status=torch.ones(K, dtype=torch.int32))
    for a, b in zip(tsm._no_motion_blocks(tcfg, tw1), jsm._no_motion_blocks(jcfg, jw1)):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max())


def test_state_from_numpy_refuses_matmul_frontend_state():
    win = to_np(jsm.Window.empty(K))
    lmk = to_np(jsm.LandmarkTable.empty(L, K))
    fe = {"lkf_pyramid": ()}
    with pytest.raises(ValueError, match="pyramid"):
        state_from_numpy(win, lmk, fe, device="cpu")
    # The between-stereo, external-odometry and odometry fields are carried.
    win["btw_valid"][1] = True
    win["ext_t"][2] = [1.0, 2.0, 3.0]
    win["odom_valid"] = np.bool_(True)
    twin, _, _ = state_from_numpy(win, lmk, device="cpu")
    assert twin.btw_valid.tolist() == [False, True, False, False]
    assert twin.ext_t[2].tolist() == [1.0, 2.0, 3.0] and bool(twin.odom_valid)


def test_vio_params_roundtrip():
    jp = j_synthetic_params(width=320, height=240)
    tp = vio_params_from_dict(dataclasses.asdict(jp))
    from kimera_vio_tpu_torch.dataprovider.synthetic import synthetic_params
    assert tp.equals(synthetic_params(width=320, height=240))
    assert tp.backend.nr_states == jp.backend.nr_states
    np.testing.assert_array_equal(tp.left_cam.T_BS, jp.left_cam.T_BS)
