"""The port's StereoFrontend against the JAX frontend, from the first frame.

On the first synthetic frame both frontends detect (GFTT + binning ANMS +
sub-pixel), rectify and stereo-match; the results must agree slot for
slot. The JAX FrontendState (gather-LK form: it keeps the keyframe
pyramid) is then carried into the port with `convert.state_from_numpy`,
and the port tracks the next frames from it with its LK.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from kimera_vio_tpu.backend import smoother as jsm
from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.frontend import imu_frontend as jimu
from kimera_vio_tpu.frontend.camera import StereoCamera as JStereoCamera
from kimera_vio_tpu.frontend.vision_frontend import FrontendConfig as JFrontendConfig
from kimera_vio_tpu.frontend.vision_frontend import StereoFrontend as JStereoFrontend
from kimera_vio_tpu_torch.convert import state_from_numpy, vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider
from kimera_vio_tpu_torch.frontend.camera import StereoCamera
from kimera_vio_tpu_torch.frontend.imu_frontend import PimParams
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendConfig, StereoFrontend

SIZE = dict(width=320, height=240)


def to_np(tree):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return np.array(x)
    return conv(dataclasses.asdict(tree))


def test_frontend_init_matches_jax_and_tracks_from_converted_state():
    jparams = j_synthetic_params(**SIZE, max_features=64, max_landmarks=96, nr_states=5)
    tparams = vio_params_from_dict(dataclasses.asdict(jparams))
    jcfg = JFrontendConfig.from_params(jparams.frontend, max_features=64).replace(lk_impl="gather")
    jfe = JStereoFrontend(jcfg, JStereoCamera.from_params(jparams.left_cam, jparams.right_cam),
                          jimu.PimParams.from_params(jparams.imu))
    tstereo = StereoCamera.from_params(tparams.left_cam, tparams.right_cam, device="cpu")
    # The port tracks with the Pallas window rule, from the keyframe pyramid
    # the JAX gather tracker's state carries.
    tcfg = FrontendConfig.from_params(tparams.frontend, max_features=64)
    tcfg.lk_impl = "pallas"
    tfe = StereoFrontend(tcfg, tstereo, PimParams.from_params(tparams.imu, device="cpu"),
                         torch.device("cpu"))

    jprov = JProvider(n_frames=6, **SIZE)
    tprov = SyntheticStereoProvider(n_frames=6, **SIZE)
    left, right = jprov.load_image(("left", 0)), jprov.load_image(("right", 0))
    np.testing.assert_array_equal(tprov.load_image(("left", 0)), left)

    jstate, jmeas = jfe.init_state(jnp.asarray(left), jnp.asarray(right), 0.0)
    tstate, tmeas = tfe.init_state(torch.from_numpy(left), torch.from_numpy(right), 0.0)
    jf, tf = jstate.features, tstate.features
    np.testing.assert_array_equal(tf.mask.numpy(), np.asarray(jf.mask))
    np.testing.assert_array_equal(tf.ids.numpy(), np.asarray(jf.ids))
    m = tf.mask.numpy()
    assert m.sum() >= 40
    # Same corners in the same slots; sub-pixel refinement sums in float32.
    np.testing.assert_allclose(tf.uv.numpy()[m], np.asarray(jf.uv)[m], atol=1e-3)
    np.testing.assert_allclose(tf.versors.numpy()[m], np.asarray(jf.versors)[m], atol=1e-5)
    np.testing.assert_array_equal(tmeas.mask.numpy(), np.asarray(jmeas.mask))
    sm = tmeas.mask.numpy()
    assert sm.sum() >= 30
    # Stereo matches: SSD minima from convolutions summed in another order.
    np.testing.assert_allclose(tmeas.uvs.numpy()[sm], np.asarray(jmeas.uvs)[sm], atol=1e-2)

    # Carry the JAX state over and track the next frames with the port.
    _, _, cstate = state_from_numpy(
        to_np(jsm.Window.empty(5)), to_np(jsm.LandmarkTable.empty(96, 5)), to_np(jstate),
        device="cpu",
    )
    assert cstate.next_id == int(jstate.next_id) and cstate.frame_count == int(jstate.frame_count)
    for lvl, (a, b) in enumerate(zip(cstate.lkf_pyramid, tstate.lkf_pyramid)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3, err_msg=f"level {lvl}")
    frames = list(tprov.frames())
    state = cstate
    lkf_uv = cstate.lkf_features.uv.numpy()
    for k, packet in enumerate(frames[1:3], start=1):
        state, out = tfe.process_frame(
            state, torch.from_numpy(tprov.load_image(packet["left_path"])),
            torch.from_numpy(tprov.load_image(packet["right_path"])), packet["imu"],
            (packet["stamp_ns"] - frames[0]["stamp_ns"]) * 1e-9,
        )
        assert not out["is_keyframe"]  # < min_intra_kf_time after the keyframe
        # The Pallas window rule drops tracks within ~20 px of the right and
        # bottom border; the rest are kept.
        assert out["n_tracked"] >= 0.8 * m.sum()
        # The scene shifts by fx * vx * t / depth = 2.25 px per frame to the
        # left: every kept track must have moved by that, to LK accuracy.
        ok = state.features.mask.numpy()
        shift = state.features.uv.numpy()[ok] - lkf_uv[ok]
        np.testing.assert_allclose(shift[:, 0], -2.25 * k, atol=0.05)
        np.testing.assert_allclose(shift[:, 1], 0.0, atol=0.05)
