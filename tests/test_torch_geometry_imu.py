"""Parity of the PyTorch port with the JAX package on the CPU: geometry,
IMU preintegration, pyramids / LK gradients / rotational flow prediction.

Each test makes its inputs with numpy from a seed, runs the JAX function
and its counterpart in kimera_vio_tpu_torch, and compares the outputs with
the tolerance stated at the comparison. Both sides compute in float32; a
tolerance above float32 round-off is explained where it is set.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from kimera_vio_tpu.common import geometry as jgeo
from kimera_vio_tpu.common.types import ImuBias as JImuBias
from kimera_vio_tpu.common.types import ImuBlock as JImuBlock
from kimera_vio_tpu.common.types import NavState as JNavState
from kimera_vio_tpu.config.params import CameraParams as JCameraParams
from kimera_vio_tpu.frontend import camera as jcam
from kimera_vio_tpu.frontend import imu_frontend as jimu
from kimera_vio_tpu.ops import optical_flow as jof
from kimera_vio_tpu_torch.common import geometry as tgeo
from kimera_vio_tpu_torch.common.types import ImuBias, ImuBlock, NavState
from kimera_vio_tpu_torch.config.params import CameraParams, ImuParams
from kimera_vio_tpu_torch.frontend import camera as tcam
from kimera_vio_tpu_torch.frontend import imu_frontend as timu
from kimera_vio_tpu_torch.ops import optical_flow as tof



def T(x):
    return torch.as_tensor(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def textured(h, w, seed, scale=6):
    rng = np.random.default_rng(seed)
    small = rng.uniform(30, 225, (h // scale + 2, w // scale + 2)).astype(np.float32)
    return ndi.zoom(small, scale, order=3)[:h, :w].astype(np.float32)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w[:8] *= 1e-4  # small-angle branch
    w[8:16] *= 3.1 / np.linalg.norm(w[8:16], axis=-1, keepdims=True)  # near pi
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    # Float32 round-off of 3x3 products and trig: 2e-5 absolute on unit-
    # scale entries (the near-pi log amplifies rounding by ~1/sin).
    for name, args in [
        ("hat", (w,)), ("so3_exp", (w,)), ("so3_right_jacobian", (w,)),
        ("so3_right_jacobian_inv", (w[:40],)), ("so3_left_jacobian", (w,)),
    ]:
        a = getattr(jgeo, name)(*map(jnp.asarray, args))
        b = getattr(tgeo, name)(*map(T, args))
        np.testing.assert_allclose(N(b), np.asarray(a), atol=2e-5, err_msg=name)
    R = np.asarray(jgeo.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(N(tgeo.so3_log(T(R))), np.asarray(jgeo.so3_log(jnp.asarray(R))), atol=2e-5)
    np.testing.assert_allclose(N(tgeo.rot_to_quat(T(R))), np.asarray(jgeo.rot_to_quat(jnp.asarray(R))), atol=2e-6)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(N(tgeo.quat_to_rot(T(q))), np.asarray(jgeo.quat_to_rot(jnp.asarray(q))), atol=1e-6)
    Rj, tj = jgeo.se3_exp(jnp.asarray(xi))
    Rt, tt = tgeo.se3_exp(T(xi))
    np.testing.assert_allclose(N(Rt), np.asarray(Rj), atol=2e-5)
    np.testing.assert_allclose(N(tt), np.asarray(tj), atol=2e-5)
    np.testing.assert_allclose(
        N(tgeo.se3_log(Rt[:32], tt[:32])), np.asarray(jgeo.se3_log(Rj[:32], tj[:32])), atol=1e-4
    )


# ---------------------------------------------------------------------------
# IMU preintegration
# ---------------------------------------------------------------------------


def _imu_block(seed, n=20, n_valid=14):
    rng = np.random.default_rng(seed)
    acc = (np.array([0.3, -0.2, 9.81]) + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    gyr = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    dt = np.full(n, 0.005, np.float32)
    mask = np.arange(n) < n_valid
    dt[~mask] = 0.0
    return acc, gyr, dt, mask


def _pim_to_np(p):
    return {k: np.asarray(getattr(p, k)) for k in ("delta_R", "delta_v", "delta_p", "delta_t",
                                                   "cov", "dR_dbg", "dv_dba", "dv_dbg",
                                                   "dp_dba", "dp_dbg")}


def test_imu_preintegration_matches_jax():
    ip = ImuParams()
    jp = jimu.PimParams.from_params(ip)
    tp = timu.PimParams.from_params(ip, device="cpu")
    acc, gyr, dt, mask = _imu_block(1)
    acc2, gyr2, dt2, mask2 = _imu_block(2)
    bias = np.array([0.05, -0.02, 0.01, 0.003, -0.002, 0.001], np.float32)
    jb = JImuBias(accel=jnp.asarray(bias[:3]), gyro=jnp.asarray(bias[3:]))
    tb = ImuBias(accel=T(bias[:3]), gyro=T(bias[3:]))
    jblk = JImuBlock(acc=jnp.asarray(acc), gyr=jnp.asarray(gyr), dt=jnp.asarray(dt), mask=jnp.asarray(mask))
    tblk = ImuBlock(acc=T(acc), gyr=T(gyr), dt=T(dt), mask=T(mask))
    jblk2 = JImuBlock(acc=jnp.asarray(acc2), gyr=jnp.asarray(gyr2), dt=jnp.asarray(dt2), mask=jnp.asarray(mask2))
    tblk2 = ImuBlock(acc=T(acc2), gyr=T(gyr2), dt=T(dt2), mask=T(mask2))

    j_seq = jimu.preintegrate_sequential(jp, jblk, jb)
    t_seq = timu.preintegrate_sequential(tp, tblk, tb)
    j_par = jimu.preintegrate(jp, jblk2, jb, init=jimu.preintegrate(jp, jblk, jb))
    t_par = timu.preintegrate(tp, tblk2, tb, init=timu.preintegrate(tp, tblk, tb))
    for jpim, tpim in ((j_seq, t_seq), (j_par, t_par)):
        a, b = _pim_to_np(jpim), _pim_to_np(tpim)
        for k in a:
            # Relative 1e-4 of each field's scale: float32 products over 14-28
            # samples in another association order (prefix products, sums).
            scale = max(np.abs(a[k]).max(), 1e-12)
            np.testing.assert_allclose(b[k], a[k], atol=1e-4 * scale, err_msg=k)
    # Sequential and parallel forms agree in the port as in the reference.
    t_par1 = timu.preintegrate(tp, tblk, tb)
    np.testing.assert_allclose(N(t_par1.delta_R), N(t_seq.delta_R), atol=1e-6)

    # pim_predict / imu_residual / combined_cov15 on the composed PIM.
    R0 = np.asarray(jgeo.so3_exp(jnp.array([0.1, -0.05, 0.2])))
    p0 = np.array([1.0, 2.0, 0.5], np.float32)
    v0 = np.array([0.4, -0.1, 0.05], np.float32)
    jn = JNavState(rot=jnp.asarray(R0), pos=jnp.asarray(p0), vel=jnp.asarray(v0))
    tn = NavState(rot=T(R0), pos=T(p0), vel=T(v0))
    g = np.array([0, 0, -9.81], np.float32)
    jpred = jimu.pim_predict(j_par, jn, jb, jnp.asarray(g))
    tpred = timu.pim_predict(t_par, tn, tb, T(g))
    for k in ("rot", "pos", "vel"):
        np.testing.assert_allclose(N(getattr(tpred, k)), np.asarray(getattr(jpred, k)), atol=1e-4, err_msg=k)
    b2 = bias + 0.01
    jb2 = JImuBias(accel=jnp.asarray(b2[:3]), gyro=jnp.asarray(b2[3:]))
    tb2 = ImuBias(accel=T(b2[:3]), gyro=T(b2[3:]))
    jr = jimu.imu_residual(j_par, jn, jb2, jpred, jnp.asarray(g))
    tr = timu.imu_residual(t_par, tn, tb2, tpred, T(g))
    np.testing.assert_allclose(N(tr), np.asarray(jr), atol=1e-4)
    jc = jimu.combined_cov15(j_par, 3e-2, 1.9393e-5)
    tc = timu.combined_cov15(t_par, 3e-2, 1.9393e-5)
    np.testing.assert_allclose(N(tc), np.asarray(jc), atol=1e-4 * np.abs(np.asarray(jc)).max())


# ---------------------------------------------------------------------------
# pyramid, gradients, rotational prediction
# ---------------------------------------------------------------------------


def test_pyramid_gradients_prediction_match_jax():
    img = textured(240, 320, seed=3)
    jp = jof.build_pyramid(jnp.asarray(img), 4)
    tp = tof.build_pyramid(T(img), 4)
    assert [tuple(t.shape) for t in tp] == [tuple(j.shape) for j in jp]
    for j, t in zip(jp, tp):
        # Same shifted-add order on both sides: equal to float32 rounding.
        np.testing.assert_allclose(N(t), np.asarray(j), atol=1e-3)
        for jg, tg in zip(jof._grad(j), tof._grad(t)):
            np.testing.assert_allclose(N(tg), np.asarray(jg), atol=1e-3)
    K = np.array([[400.0, 0, 160.0], [0, 400.0, 120.0], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K).astype(np.float32)
    R = np.asarray(jgeo.so3_exp(jnp.array([0.01, 0.03, -0.02])))
    rng = np.random.default_rng(4)
    uv = np.stack([rng.uniform(0, 320, 50), rng.uniform(0, 240, 50)], -1).astype(np.float32)
    valid = rng.uniform(size=50) > 0.2
    a = jof.predict_flow_rotational(jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(R),
                                    jnp.asarray(K), jnp.asarray(Kinv), 320, 240)
    b = tof.predict_flow_rotational(T(uv), T(valid), T(R), T(K), T(Kinv), 320, 240)
    np.testing.assert_allclose(N(b), np.asarray(a), atol=1e-3)


# ---------------------------------------------------------------------------
# cameras: rectification of a distorted, slightly rotated stereo rig
# ---------------------------------------------------------------------------


def _rig(cls, model):
    R_l = np.asarray(jgeo.so3_exp(jnp.array([0.01, -0.02, 0.005])), np.float64)
    R_r = np.asarray(jgeo.so3_exp(jnp.array([0.012, -0.015, 0.002])), np.float64)
    T_l, T_r = np.eye(4), np.eye(4)
    T_l[:3, :3], T_r[:3, :3] = R_l, R_r
    T_l[:3, 3] = [-0.02, 0.01, 0.0]
    T_r[:3, 3] = [0.09, 0.012, 0.001]
    coeffs = np.array([-0.28, 0.074, 1.9e-4, 1.8e-5]) if model == "radial-tangential" \
        else np.array([0.01, -0.005, 0.002, -0.001])
    kw = dict(width=320, height=240, distortion_model=model, distortion_coeffs=coeffs)
    left = cls(camera_id="l", T_BS=T_l, intrinsics=np.array([230.0, 229.0, 158.0, 121.0]), **kw)
    right = cls(camera_id="r", T_BS=T_r, intrinsics=np.array([231.0, 230.0, 161.0, 119.0]), **kw)
    return left, right


@pytest.mark.parametrize("model", ["radial-tangential", "equidistant"])
def test_camera_rectification_matches_jax(model):
    jl, jr = _rig(JCameraParams, model)
    tl, tr = _rig(CameraParams, model)
    js = jcam.StereoCamera.from_params(jl, jr)
    ts = tcam.StereoCamera.from_params(tl, tr, device="cpu")
    for k in ("fx", "fy", "cx", "cy", "baseline", "R_rect_l", "R_rect_r", "R_b_rect", "t_b_rect"):
        np.testing.assert_allclose(N(getattr(ts, k)), np.asarray(getattr(js, k)), atol=1e-6, err_msg=k)
    rng = np.random.default_rng(12)
    uv = np.stack([rng.uniform(5, 315, 64), rng.uniform(5, 235, 64)], -1).astype(np.float32)
    depth = rng.uniform(1, 8, 64).astype(np.float32)
    # 25 fixed-point undistortion steps in float32: 1e-4 px / 1e-5 rad.
    np.testing.assert_allclose(
        N(tcam.rectify_keypoints(ts, ts.left, ts.R_rect_l, T(uv))),
        np.asarray(jcam.rectify_keypoints(js, js.left, js.R_rect_l, jnp.asarray(uv))), atol=1e-4)
    np.testing.assert_allclose(N(tcam.bearing_vectors(ts.left, T(uv))),
                               np.asarray(jcam.bearing_vectors(js.left, jnp.asarray(uv))), atol=1e-5)
    np.testing.assert_allclose(N(tcam.backproject(ts.right, T(uv), T(depth))),
                               np.asarray(jcam.backproject(js.right, jnp.asarray(uv), jnp.asarray(depth))),
                               atol=1e-4)
    uvd = np.concatenate([uv, uv[:, :1] - rng.uniform(2, 30, (64, 1)).astype(np.float32)], -1)[:, [0, 2, 1]]
    np.testing.assert_allclose(N(ts.backproject_rect(T(uvd))), np.asarray(js.backproject_rect(jnp.asarray(uvd))),
                               rtol=1e-5, atol=1e-5)
    # Dense rectification map (host numpy on both sides) and the remap.
    tmap = tcam.rectification_map(ts, ts.right, ts.R_rect_r)
    jmap = np.asarray(jcam.rectification_map(js, js.right, js.R_rect_r))
    np.testing.assert_allclose(tmap, jmap, atol=1e-3)
    img = textured(240, 320, seed=13)
    np.testing.assert_allclose(N(tcam.remap_bilinear(T(img), T(tmap))),
                               np.asarray(jcam.remap_bilinear(jnp.asarray(img), jnp.asarray(jmap))),
                               atol=1e-2)
