"""The port's public names that mirror the JAX package's, against them.

One parametrised test per module; each case is one name, fed seeded numpy
inputs (batched where the function takes leading axes) through the JAX
function and its counterpart in kimera_vio_tpu_torch. Both sides compute
in float32: products and sums of O(1) values agree to float32 round-off
(atol 1e-6); the 3x3 solve and eigenvalues of `triangulate_rays` to the
conditioning of the normal matrix (rtol 1e-4, atol 1e-5).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from kimera_vio_tpu.common import geometry as jgeo
from kimera_vio_tpu.common import types as jtypes
from kimera_vio_tpu.config.params import CameraParams as JCameraParams
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.frontend import camera as jcam
from kimera_vio_tpu.ops.triangulation import triangulate_rays as j_triangulate_rays
from kimera_vio_tpu.utils.logger import MesherLogger as JMesherLogger
from kimera_vio_tpu_torch.common import geometry as tgeo
from kimera_vio_tpu_torch.common import types as ttypes
from kimera_vio_tpu_torch.config.params import CameraParams
from kimera_vio_tpu_torch.convert import vio_params_from_dict
from kimera_vio_tpu_torch.frontend import camera as tcam
from kimera_vio_tpu_torch.ops.triangulation import triangulate_rays as t_triangulate_rays
from kimera_vio_tpu_torch.utils.logger import MesherLogger as TMesherLogger

CPU = torch.device("cpu")


def T(x):
    return torch.as_tensor(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, atol=1e-6, rtol=0.0):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, atol, rtol)
        return
    g, w = N(got), N(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
    np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


def rotations(rng, shape):
    return Rotation.random(int(np.prod(shape)), random_state=rng.integers(1 << 31)).as_matrix(
    ).reshape(*shape, 3, 3).astype(np.float32)


def vec(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# common/geometry.py
# ---------------------------------------------------------------------------


def _vee(rng):
    W = vec(rng, 4, 5, 3, 3)
    close(tgeo.vee(T(W)), jgeo.vee(jnp.asarray(W)))
    w = vec(rng, 7, 3)
    close(tgeo.vee(tgeo.hat(T(w))), w)


def _se3_compose(rng):
    Ra, Rb = rotations(rng, (6,)), rotations(rng, (6,))
    ta, tb = vec(rng, 6, 3), vec(rng, 6, 3)
    close(tgeo.se3_compose(T(Ra), T(ta), T(Rb), T(tb)),
          jgeo.se3_compose(*map(jnp.asarray, (Ra, ta, Rb, tb))))
    # Broadcast one pose against a batch.
    close(tgeo.se3_compose(T(Ra[0]), T(ta[0]), T(Rb), T(tb)),
          jgeo.se3_compose(*map(jnp.asarray, (Ra[0], ta[0], Rb, tb))))


def _se3_inverse(rng):
    R, t = rotations(rng, (3, 4)), vec(rng, 3, 4, 3)
    close(tgeo.se3_inverse(T(R), T(t)), jgeo.se3_inverse(jnp.asarray(R), jnp.asarray(t)))


def _se3_transform(rng):
    R, t, p = rotations(rng, (5,)), vec(rng, 5, 3), vec(rng, 5, 3, scale=4.0)
    close(tgeo.se3_transform(T(R), T(t), T(p)),
          jgeo.se3_transform(*map(jnp.asarray, (R, t, p))), atol=4e-6)


def _se3_retract(rng):
    R, t = rotations(rng, (8,)), vec(rng, 8, 3)
    xi = vec(rng, 8, 6, scale=0.3)
    xi[0] = 0.0  # the small-angle branch
    xi[1, :3] = 1e-5
    close(tgeo.se3_retract(T(R), T(t), T(xi)),
          jgeo.se3_retract(*map(jnp.asarray, (R, t, xi))), atol=2e-6)


def _rotation_between(rng):
    Ra, Rb = rotations(rng, (2, 3)), rotations(rng, (2, 3))
    close(tgeo.rotation_between(T(Ra), T(Rb)), jgeo.rotation_between(jnp.asarray(Ra), jnp.asarray(Rb)))


def _normalize_rotation(rng):
    R = rotations(rng, (9,)) + vec(rng, 9, 3, 3, scale=1e-3)
    got = tgeo.normalize_rotation(T(R))
    close(got, jgeo.normalize_rotation(jnp.asarray(R)), atol=2e-6)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (9, 3, 3))
    np.testing.assert_allclose(N(got @ got.transpose(-1, -2)), eye, atol=2e-6)


GEOMETRY = {"vee": _vee, "se3_compose": _se3_compose, "se3_inverse": _se3_inverse,
            "se3_transform": _se3_transform, "se3_retract": _se3_retract,
            "rotation_between": _rotation_between, "normalize_rotation": _normalize_rotation}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry_names_match_jax(name):
    GEOMETRY[name](np.random.default_rng(sorted(GEOMETRY).index(name)))


# ---------------------------------------------------------------------------
# common/types.py
# ---------------------------------------------------------------------------


def _as_vector(rng):
    acc, gyr = vec(rng, 3), vec(rng, 3)
    close(ttypes.ImuBias(accel=T(acc), gyro=T(gyr)).as_vector(),
          jtypes.ImuBias(accel=jnp.asarray(acc), gyro=jnp.asarray(gyr)).as_vector())
    acc, gyr = vec(rng, 4, 3), vec(rng, 4, 3)  # stacked streams
    close(ttypes.ImuBias(accel=T(acc), gyro=T(gyr)).as_vector(),
          jtypes.ImuBias(accel=jnp.asarray(acc), gyro=jnp.asarray(gyr)).as_vector())


def _nav_identity(rng):
    t, j = ttypes.NavState.identity(CPU), jtypes.NavState.identity()
    for k in ("rot", "pos", "vel"):
        close(getattr(t, k), getattr(j, k), atol=0)
    with pytest.raises(ValueError):
        ttypes.NavState.identity("meta")


def _vio_nav_identity(rng):
    t, j = ttypes.VioNavState.identity(CPU), jtypes.VioNavState.identity()
    for k in ("rot", "pos", "vel"):
        close(getattr(t.nav, k), getattr(j.nav, k), atol=0)
    close(t.bias.as_vector(), j.bias.as_vector(), atol=0)


def _imu_block_capacity(rng):
    n = int(rng.integers(5, 40))
    z3, z1 = np.zeros((n, 3), np.float32), np.zeros(n, np.float32)
    t = ttypes.ImuBlock(acc=T(z3), gyr=T(z3), dt=T(z1), mask=T(z1 > 0))
    j = jtypes.ImuBlock(acc=jnp.asarray(z3), gyr=jnp.asarray(z3), dt=jnp.asarray(z1),
                        mask=jnp.asarray(z1 > 0))
    assert t.capacity == j.capacity == n
    stacked = ttypes.stack_trees([t, t])  # a leading stream axis
    assert stacked.capacity == n


def _tracked_capacity(rng):
    n = int(rng.integers(8, 300))
    t, j = ttypes.TrackedFeatures.empty(n, CPU), jtypes.TrackedFeatures.empty(n)
    assert t.capacity == j.capacity == n
    assert ttypes.stack_trees([t, t, t]).capacity == n


TYPES = {"ImuBias.as_vector": _as_vector, "NavState.identity": _nav_identity,
         "VioNavState.identity": _vio_nav_identity, "ImuBlock.capacity": _imu_block_capacity,
         "TrackedFeatures.capacity": _tracked_capacity}


@pytest.mark.parametrize("name", sorted(TYPES))
def test_types_names_match_jax(name):
    TYPES[name](np.random.default_rng(sorted(TYPES).index(name)))


# ---------------------------------------------------------------------------
# frontend/camera.py
# ---------------------------------------------------------------------------


def _rig():
    jp = j_synthetic_params(width=320, height=240, fx=240.0)
    jp.left_cam.distortion_model = "radial-tangential"
    jp.left_cam.distortion_coeffs = np.array([-0.28, 0.07, 2e-4, 2e-5])
    tp = vio_params_from_dict(dataclasses.asdict(jp))
    return jp, tp


def _K(rng):
    jp, tp = _rig()
    j = jcam.PinholeCamera.from_params(jp.left_cam)
    t = tcam.PinholeCamera.from_params(tp.left_cam, device=CPU)
    close(t.K(), j.K(), atol=0)
    omni = dict(camera_model="omni", width=1280, height=960, intrinsics=np.zeros(0),
                distortion_model="omni", distortion_coeffs=np.array([310.0, 0.0, -1.1e-3, 0, 0]),
                omni_distortion_center=np.array([641.3, 478.6]),
                omni_affine=np.array([-3.0e-4, 2.0e-4, 0.9996]))
    close(tcam.PinholeCamera.from_params(CameraParams(**omni), device=CPU).K(),
          jcam.PinholeCamera.from_params(JCameraParams(**omni)).K(), atol=0)


def _project_rect(rng):
    jp, tp = _rig()
    js = jcam.StereoCamera.from_params(jp.left_cam, jp.right_cam)
    ts = tcam.StereoCamera.from_params(tp.left_cam, tp.right_cam, device=CPU)
    p = np.concatenate([vec(rng, 3, 40, 2, scale=2.0), rng.uniform(-1, 10, (3, 40, 1))],
                       -1).astype(np.float32)
    p[0, 0, 2] = 0.0  # the z guard
    tuv, tok = ts.project_rect(T(p))
    juv, jok = js.project_rect(jnp.asarray(p))
    np.testing.assert_array_equal(N(tok), N(jok))
    close(tuv, juv, rtol=1e-6, atol=1e-3)
    # Round trip through the port's own backprojection.
    m = N(tok)
    np.testing.assert_allclose(N(ts.backproject_rect(tuv))[m], p[m], rtol=1e-4, atol=1e-4)


def _separable_remap(rng):
    H, W = 40, 56
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    mapxy = np.stack([uu * 1.03 - 0.8 + 0.6 * np.sin(vv / 9.0), vv * 0.97 + 0.7 * np.cos(uu / 13.0)],
                     -1).astype(np.float32)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    j = jcam.SeparableRemap(mapxy)
    t = tcam.SeparableRemap(mapxy, device=CPU)
    for k in ("dy", "fy", "dx", "fx"):
        close(getattr(t, k), getattr(j, k), atol=0)
    assert t.n_taps == j.n_taps
    close(t(T(img)), j(jnp.asarray(img)), atol=1e-4)


CAMERA = {"PinholeCamera.K": _K, "StereoCamera.project_rect": _project_rect,
          "SeparableRemap": _separable_remap}


@pytest.mark.parametrize("name", sorted(CAMERA))
def test_camera_names_match_jax(name):
    CAMERA[name](np.random.default_rng(sorted(CAMERA).index(name)))


# ---------------------------------------------------------------------------
# ops/triangulation.py and utils/logger.py
# ---------------------------------------------------------------------------


def _rays(rng, batch, M):
    p = vec(rng, *batch, 1, 3, scale=3.0)
    o = vec(rng, *batch, M, 3)
    d = p - o + vec(rng, *batch, M, 3, scale=1e-3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mask = rng.uniform(size=(*batch, M)) > 0.3
    return o, d, mask


@pytest.mark.parametrize("batch", [(), (7,), (2, 5)], ids=str)
def test_triangulate_rays_matches_jax(batch):
    rng = np.random.default_rng(len(batch) + 10)
    o, d, mask = _rays(rng, batch, 6)
    if batch:
        mask.reshape(-1, 6)[0] = False  # an unobserved point
        mask.reshape(-1, 6)[1] = [True] + [False] * 5  # one ray
    tp, tok, teig = t_triangulate_rays(T(o), T(d), T(mask))
    jp, jok, jeig = j_triangulate_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mask))
    np.testing.assert_array_equal(N(tok), N(jok))
    ok = N(tok)
    assert ok.sum() >= max(1, ok.size - 2)
    assert N(tp).shape == (*batch, 3)
    np.testing.assert_allclose(N(tp)[ok], N(jp)[ok], rtol=1e-4, atol=1e-5)
    close(teig, jeig, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["MesherLogger.close"])
def test_logger_names_match_jax(name, tmp_path):
    """Both loggers write each PLY whole in `log`; `close` leaves the
    same bytes behind."""
    rng = np.random.default_rng(0)
    verts = vec(rng, 9, 3)
    tris = np.arange(9).reshape(3, 3)
    out = {}
    for side, cls in (("jax", JMesherLogger), ("torch", TMesherLogger)):
        lg = cls(str(tmp_path / side))
        lg.log(verts, tris)
        lg.close()
        lg.close()  # closing twice is harmless, as in the JAX logger
        with open(os.path.join(lg.dir, "mesh_00000.ply"), "rb") as f:
            out[side] = f.read()
    assert out["torch"] == out["jax"]
