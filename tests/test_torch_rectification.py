"""Keyframe rectification on distorted rigs: the port against the JAX package.

The JAX frontend rectifies keyframe images with `SeparableRemap`
(kimera_vio_tpu/frontend/camera.py), a vertical then a horizontal resample
over a row-wise re-parametrised map, with its own border clip. The port
computes the same function with two 2-tap gathers. On the synthetic
752x480 rig (fx 450) with three distortion models, all written inline:

  * radial-tangential: EuRoC cam0 / cam1's published coefficients;
  * equidistant: a fisheye set of TUM-VI-like magnitudes (k1..k4);
  * omni: the OCamCalib 1280x960 camera of tests/test_torch_options.py
    on a 1280x960 pinhole rig (the omni model has no pinhole intrinsics
    to rectify to),

the cases are (i) the port's `SeparableRemap` built from the JAX map
against the JAX one: the fields equal, the output within 1e-4 gray levels;
(ii) each package's frontend `_remap_left` / `_remap_right`, each built
from its own params: within a tolerance set by the maps' gap and the
image's gradient; (iii) each package's `_stereo_measurements` on the same
keypoints and its own rectified pair: the same valid mask, uR within
0.01 px; (iv) an identity rectification still skips the remap; and
each FleetVio row's keyframes go through its own frontend's remap.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from kimera_vio_tpu.config.params import CameraParams as JCameraParams
from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.frontend import camera as jcam
from kimera_vio_tpu.frontend import imu_frontend as jimu
from kimera_vio_tpu.frontend.vision_frontend import FrontendConfig as JFrontendConfig
from kimera_vio_tpu.frontend.vision_frontend import StereoFrontend as JStereoFrontend
from kimera_vio_tpu.common.types import TrackedFeatures as JTrackedFeatures
from kimera_vio_tpu_torch.common.types import TrackedFeatures
from kimera_vio_tpu_torch.config.params import CameraParams
from kimera_vio_tpu_torch.convert import vio_params_from_dict
from kimera_vio_tpu_torch.frontend import camera as tcam
from kimera_vio_tpu_torch.frontend.imu_frontend import PimParams
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendConfig, StereoFrontend

CPU = torch.device("cpu")

# EuRoC MAV cam0 / cam1 (sensor.yaml), radial-tangential k1, k2, p1, p2.
EUROC_RADTAN = ([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
                [-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05])
# Equidistant (Kannala-Brandt) k1..k4 of the magnitudes a fisheye
# calibration gives.
EQUIDISTANT = ([0.0034823894, 0.0007150348, -0.0020532361, 0.0002029367],
               [0.0034003171, 0.0017662782, -0.0026631257, 0.0003299517])
# The OCamCalib camera of tests/test_torch_options.py.
OMNI = dict(camera_model="omni", width=1280, height=960, intrinsics=np.zeros(0),
            distortion_model="omni",
            distortion_coeffs=np.array([310.0, 0.0, -1.1e-3, 2.5e-7, -4.0e-10]),
            omni_distortion_center=np.array([641.3, 478.6]),
            omni_affine=np.array([-3.0e-4, 2.0e-4, 0.9996]))
MODELS = ("radtan", "equidistant", "omni")
# The two packages' rectification maps of one rig may differ by up to
# 1e-3 px (tests/test_torch_geometry_imu.py: host float64 against float32
# constants); this is the gap (ii) allows for, and checks.
MAP_GAP_PX = 1e-3
BORDER = 20


def textured(h, w, seed, scale=6):
    rng = np.random.default_rng(seed)
    small = rng.uniform(30, 225, (h // scale + 2, w // scale + 2)).astype(np.float32)
    return ndi.zoom(small, scale, order=3)[:h, :w].astype(np.float32)


def _params(model):
    """(JAX params, port params) of the synthetic rig with `model`'s
    distortion on both cameras (omni: the pinhole rig's size only)."""
    if model == "omni":
        jp = j_synthetic_params(width=1280, height=960, fx=400.0, max_features=128)
    else:
        jp = j_synthetic_params(max_features=128)
        name, coeffs = (("radial-tangential", EUROC_RADTAN) if model == "radtan"
                        else ("equidistant", EQUIDISTANT))
        for cam, c in ((jp.left_cam, coeffs[0]), (jp.right_cam, coeffs[1])):
            cam.distortion_model = name
            cam.distortion_coeffs = np.array(c)
    return jp, vio_params_from_dict(dataclasses.asdict(jp))


def _frontends(model):
    """Each package's StereoFrontend on `model`'s rig, built from its own
    params; an omni rig swaps the omni camera in for both pinholes."""
    jp, tp = _params(model)
    jst = jcam.StereoCamera.from_params(jp.left_cam, jp.right_cam)
    tst = tcam.StereoCamera.from_params(tp.left_cam, tp.right_cam, device=CPU)
    if model == "omni":
        jcams = [jcam.PinholeCamera.from_params(JCameraParams(T_BS=c.T_BS, **OMNI))
                 for c in (jp.left_cam, jp.right_cam)]
        tcams = [tcam.PinholeCamera.from_params(CameraParams(T_BS=c.T_BS, **OMNI), device=CPU)
                 for c in (tp.left_cam, tp.right_cam)]
        jst = jst.replace(left=jcams[0], right=jcams[1])
        tst = dataclasses.replace(tst, left=tcams[0], right=tcams[1])
    jfe = JStereoFrontend(JFrontendConfig.from_params(jp.frontend, max_features=128), jst,
                          jimu.PimParams.from_params(jp.imu))
    tfe = StereoFrontend(FrontendConfig.from_params(tp.frontend, max_features=128), tst,
                         PimParams.from_params(tp.imu, device=CPU), CPU)
    return jfe, tfe


@pytest.fixture(scope="module")
def frontends():
    return {m: _frontends(m) for m in MODELS}


@pytest.mark.parametrize("model", MODELS)
def test_separable_remap_equals_jax(model, frontends):
    """(i) The port's SeparableRemap from the JAX map: fields bit for bit,
    output within 1e-4 gray levels (observed: 0), on float32 and uint8."""
    jfe, _ = frontends[model]
    for jsep, jmap in ((jfe.sep_remap_left, jfe.map_left), (jfe.sep_remap_right, jfe.map_right)):
        tsep = tcam.SeparableRemap(np.asarray(jmap), device=CPU)
        for name in ("dy", "fy", "dx", "fx"):
            np.testing.assert_array_equal(getattr(tsep, name).numpy(), getattr(jsep, name),
                                          err_msg=name)
        assert (tsep.r_lo, tsep.r_hi, tsep.c_lo, tsep.c_hi) == (
            jsep.r_lo, jsep.r_hi, jsep.c_lo, jsep.c_hi)
        img = textured(jsep.H, jsep.W, seed=3)
        want = np.asarray(jsep(jnp.asarray(img)))
        got = tsep(torch.from_numpy(img)).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-4, np.abs(got - want).max()
        u8 = np.round(img).astype(np.uint8)
        got8 = tsep(torch.from_numpy(u8)).numpy()
        want8 = np.asarray(jsep(jnp.asarray(u8)))
        assert np.abs(got8 - want8).max() <= 1e-4
        # A stack of images remaps image by image.
        both = tsep(torch.from_numpy(np.stack([img, img[::-1].copy()])))
        np.testing.assert_array_equal(both[0].numpy(), got)
        np.testing.assert_array_equal(both[1].numpy(), tsep(torch.from_numpy(img[::-1].copy())).numpy())


def _tolerance(img):
    """Gray levels the maps' gap can move a bilinear sample: the largest
    image step between neighbours (a bound on the gradient of the
    interpolant) times the gap, doubled because both passes' coordinates
    carry it (x directly, Y through the row inverse)."""
    grad = max(np.abs(np.diff(img, axis=0)).max(), np.abs(np.diff(img, axis=1)).max())
    return 2.0 * MAP_GAP_PX * float(grad)


@pytest.mark.parametrize("model", MODELS)
def test_frontend_remap_matches_jax(model, frontends):
    """(ii) The frontends' rectified keyframe images, each package built
    from its own params, agree over the whole image within the maps' gap
    times the image's gradient (at most 0.1 gray levels). Before the port
    rectified with SeparableRemap, its 4-tap gather differed from the JAX
    frontend by up to 1.45 gray levels (0.53 in the interior) on the
    radial-tangential rig."""
    jfe, tfe = frontends[model]
    assert not tfe.identity_rect and not jfe.identity_rect
    H, W = tfe.left.height, tfe.left.width
    for jmap, tmap in ((jfe.map_left, tfe.map_left), (jfe.map_right, tfe.map_right)):
        assert np.abs(np.asarray(jmap) - tmap.numpy()).max() <= MAP_GAP_PX
    img = textured(H, W, seed=11, scale=8)
    tol = _tolerance(img)
    assert tol <= 0.1
    for side in ("left", "right"):
        want = np.asarray(getattr(jfe, f"_remap_{side}")(jnp.asarray(img)))
        got = getattr(tfe, f"_remap_{side}")(torch.from_numpy(img)).numpy()
        err = np.abs(got - want)
        assert err.max() <= tol, (side, err.max(), tol)
        assert err[BORDER:-BORDER, BORDER:-BORDER].max() <= tol


@pytest.mark.parametrize("model", ("radtan", "equidistant"))
def test_stereo_measurements_match_jax(model, frontends):
    """(iii) Stereo matching (SAD + sub-pixel fit) on the same keypoints,
    each package on its own rectified pair: the same valid mask, uR within
    0.01 px."""
    jfe, tfe = frontends[model]
    prov = JProvider(n_frames=2)
    left, right = prov.load_image(("left", 0)), prov.load_image(("right", 0))
    jl, jr = jfe._remap_left(jnp.asarray(left)), jfe._remap_right(jnp.asarray(right))
    tl = tfe._remap_left(torch.from_numpy(left))
    tr = tfe._remap_right(torch.from_numpy(right))
    n = tfe.cfg.max_features
    feats = TrackedFeatures.empty(n, CPU)
    uv, valid = tfe._detect(tl, feats)
    assert int(valid.sum()) >= 60
    ids = torch.where(valid, torch.arange(n, dtype=torch.int32), torch.full((n,), -1, dtype=torch.int32))
    feats = dataclasses.replace(feats, uv=uv, uv_rect=uv, ids=ids, mask=valid)
    jfeats = JTrackedFeatures.empty(n).replace(
        uv=jnp.asarray(uv.numpy()), uv_rect=jnp.asarray(uv.numpy()),
        ids=jnp.asarray(ids.numpy()), mask=jnp.asarray(valid.numpy()))
    jmeas, _ = jfe._stereo_measurements(jl, jr, jfeats)
    tmeas = tfe._stereo_measurements(tl, tr, feats)
    mask = tmeas.mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(jmeas.mask))
    assert mask.sum() >= 30
    np.testing.assert_allclose(tmeas.uvs.numpy()[mask], np.asarray(jmeas.uvs)[mask], atol=1e-2)


def test_identity_rect_skips_the_remap():
    """(iv) The undistorted synthetic rig rectifies by identity: no remap
    is built, and the images pass through as they are."""
    tp = vio_params_from_dict(dataclasses.asdict(j_synthetic_params(max_features=64)))
    tst = tcam.StereoCamera.from_params(tp.left_cam, tp.right_cam, device=CPU)
    tfe = StereoFrontend(FrontendConfig.from_params(tp.frontend, max_features=64), tst,
                         PimParams.from_params(tp.imu, device=CPU), CPU)
    assert tfe.identity_rect
    assert not hasattr(tfe, "sep_remap_left") and not hasattr(tfe, "map_left")
    img = torch.from_numpy(textured(480, 752, seed=2))
    assert tfe._remap_left(img) is img and tfe._remap_right(img) is img


def test_fleet_rows_rectify_through_their_remap():
    """Each FleetVio data row's keyframes rectify through the separable
    remap of the row's own frontend (the JAX fleet threads each row's
    remap taps the same way): one left and one right remap for each
    stream's first frame and each of its keyframes. Two rows of one
    stream each, 160x120 (fx 120) with EuRoC's coefficients, 8 frames."""
    from kimera_vio_tpu_torch.common.types import stack_trees
    from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
    from kimera_vio_tpu_torch.parallel import FleetVio

    size = dict(width=160, height=120, fx=120.0)
    params = synthetic_params(**size, max_features=64, max_landmarks=64, nr_states=5)
    params.frontend.klt_max_level = 2
    params.frontend.templ_cols, params.frontend.templ_rows = 31, 7
    for cam, c in ((params.left_cam, EUROC_RADTAN[0]), (params.right_cam, EUROC_RADTAN[1])):
        cam.distortion_model = "radial-tangential"
        cam.distortion_coeffs = np.array(c)
    fleet = FleetVio(params, 2, devices=["cpu", "cpu"])
    assert len(fleet.mesh) == 2
    calls = []
    for pipe in fleet._pipes:
        fe, n = pipe.frontend, {"left": 0, "right": 0}
        assert not fe.identity_rect
        for side in ("left", "right"):
            def counted(img, remap=getattr(fe, f"sep_remap_{side}"), side=side, n=n):
                n[side] += 1
                return remap(img)
            setattr(fe, f"sep_remap_{side}", counted)
        calls.append(n)
    frames = []
    for vx, fps in ((0.3, 20.0), (0.5, 15.0)):
        prov = SyntheticStereoProvider(n_frames=8, vx=vx, fps=fps, **size)
        packets = list(prov.frames())
        frames.append([(torch.from_numpy(prov.load_image(p["left_path"])),
                        torch.from_numpy(prov.load_image(p["right_path"])), p["imu"],
                        float(np.float32((p["stamp_ns"] - packets[0]["stamp_ns"]) * 1e-9)))
                       for p in packets])

    def frame(k):
        fr = [f[k] for f in frames]
        return (torch.stack([f[0] for f in fr]), torch.stack([f[1] for f in fr]),
                stack_trees([f[2] for f in fr]), [f[3] for f in fr])

    state = fleet.init(*frame(0)[:2])
    kf = np.zeros(2, int)
    for k in range(1, 8):
        state, out = fleet.step(state, *frame(k))
        kf += np.asarray(out["is_keyframe"], bool)
    assert kf.min() >= 1
    for r in range(2):
        assert calls[r] == {"left": 1 + kf[r], "right": 1 + kf[r]}, (r, calls[r], kf)
