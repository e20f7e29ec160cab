"""The JAX package's default tracker (lk_impl="matmul") in the port: the
plain versions of ops/optical_flow.py against the JAX package's.

  * `build_lk_templates`: per level the template window, its gradients,
    the inverse gradient matrix and the template gate, with gradients taken
    on the patches (what the frontend uses) and from full-image gradients;
  * `_iterate_level_cached`, one level: positions, gates and the
    `diverged` flag of seeds that leave their search patch;
  * `klt_track_cached` and `klt_track_matmul` at win 24, 53, 61 and 101 on
    the textured image and subpixel shift of tests/test_optical_flow.py,
    with keypoints within a window of the border and seeds far off;
  * a stream axis: B = 2 stacked against two single calls, bit for bit;
  * `state_from_numpy` on a JAX frontend state of the matmul tracker.

Tolerances: templates and gradients within 1e-5 of their scale, the
inverse matrices within 1e-4 relative (float32 sums in another order: the
reference resamples with matmuls, the port with the 4-tap blend in the
same row-then-column order); the same gates; tracked positions within
1e-3 px, the bound of the gather-rule parity tests. The port checks a
keypoint's window before each of its own steps, the reference every
keypoint while any moves; the positions are the same, and so are the
flags on these inputs.
"""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_vio_tpu.backend import smoother as jsm
from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.frontend import imu_frontend as jimu
from kimera_vio_tpu.frontend.camera import StereoCamera as JStereoCamera
from kimera_vio_tpu.frontend.vision_frontend import FrontendConfig as JFrontendConfig
from kimera_vio_tpu.frontend.vision_frontend import StereoFrontend as JStereoFrontend
from kimera_vio_tpu.ops import optical_flow as jof
from kimera_vio_tpu_torch.common.types import stack_trees
from kimera_vio_tpu_torch.convert import state_from_numpy, vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider
from kimera_vio_tpu_torch.frontend.camera import StereoCamera
from kimera_vio_tpu_torch.frontend.imu_frontend import PimParams
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendConfig, StereoFrontend
from kimera_vio_tpu_torch.ops import lk_kernel as tlk
from kimera_vio_tpu_torch.ops import optical_flow as tof

_spec = importlib.util.spec_from_file_location(
    "lk_cached_flow", os.path.join(os.path.dirname(__file__), "test_optical_flow.py"))
_flow = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_flow)
shift_image, textured_image = _flow.shift_image, _flow.textured_image

H, W = 240, 320
SHIFT = (2.3, -1.7)
N_LEVELS = 3  # levels 0-2: 240x320, 120x160, 60x80


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed=0):
    img = textured_image(H, W, seed)
    return img, shift_image(img, *SHIFT)


def _keypoints(win, n=48, seed=1):
    """Random keypoints, a few within a window of each border, one invalid;
    seeds at the true shift, but two far off (the first fails at every
    width)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1).astype(np.float32)
    h = win / 2
    pts[:6] = [[h - 3, 40], [W - h + 2, 100], [60, h - 1], [200, H - h + 4], [2, 3],
               [W - 3, H - 2]]
    valid = np.ones(n, bool)
    valid[7] = False
    init = pts + np.array(SHIFT, np.float32)
    init[8] += [-44.0, 40.0]
    init[9] += [20.0, 0.0]
    return pts, init, valid


def _pyrs(img, cur):
    return (jof.build_pyramid(jnp.asarray(img), N_LEVELS - 1),
            jof.build_pyramid(jnp.asarray(cur), N_LEVELS - 1),
            tof.build_pyramid(torch.from_numpy(img), N_LEVELS - 1),
            tof.build_pyramid(torch.from_numpy(cur), N_LEVELS - 1))


def _assert_templates(jt, tt):
    assert len(jt) == len(tt)
    for lvl, (a, b) in enumerate(zip(jt, tt)):
        assert (a is None) == (b is None), lvl
        if a is None:
            continue
        np.testing.assert_array_equal(b["good_g"].numpy(), np.asarray(a["good_g"]))
        good = np.asarray(a["good_g"])
        for k in ("tmpl", "gx", "gy"):
            x = np.asarray(a[k])
            np.testing.assert_allclose(b[k].numpy(), x, rtol=0, atol=1e-5 * np.abs(x).max(),
                                       err_msg=f"level {lvl} {k}")
        for k in ("inv00", "inv01", "inv11"):
            x = np.asarray(a[k])[good]
            np.testing.assert_allclose(b[k].numpy()[good], x, rtol=1e-4,
                                       atol=1e-4 * np.abs(x).max(), err_msg=f"level {lvl} {k}")


@pytest.mark.parametrize("win", [24, 53])
@pytest.mark.parametrize("grads", [False, True], ids=["patch_scharr", "image_grads"])
def test_build_lk_templates_matches_jax(win, grads):
    img, cur = _images()
    jp, _, tp, _ = _pyrs(img, cur)
    pts, _, valid = _keypoints(win)
    jt = jof.build_lk_templates(jp, jnp.asarray(pts), jnp.asarray(valid), win=win,
                                prev_grads=[jof._grad(p) for p in jp] if grads else None)
    tt = tof.build_lk_templates(tp, torch.from_numpy(pts), torch.from_numpy(valid), win=win,
                                prev_grads=[tof._grad(p) for p in tp] if grads else None)
    _assert_templates(jt, tt)
    # The two branches differ at the border (edge-padded patch vs
    # zero-padded image gradients): a template gradient near it differs.
    assert all(t is not None for t in tt)
    assert int(tt[0]["good_g"].sum()) >= 40


def test_build_lk_templates_skips_levels_without_room():
    img, cur = _images()
    _, _, tp, _ = _pyrs(img, cur)
    pts, _, valid = _keypoints(61)
    tt = tof.build_lk_templates(tp, torch.from_numpy(pts), torch.from_numpy(valid), win=61)
    assert [t is None for t in tt] == [False, False, True]  # 60x80 < 63


def test_iterate_level_flags_diverged_like_jax():
    """Level 0 alone from seeds up to 14 px off: the patch allows 8 px of
    drift, so the far seeds are flagged diverged by both."""
    img, cur = _images()
    jp, jc, tp, tc = _pyrs(img, cur)
    win = 24
    pts, init, valid = _keypoints(win)
    rng = np.random.default_rng(3)
    init = init + rng.uniform(-14, 14, init.shape).astype(np.float32)
    jt = jof.build_lk_templates(jp, jnp.asarray(pts), jnp.asarray(valid), win=win)
    tt = tof.build_lk_templates(tp, torch.from_numpy(pts), torch.from_numpy(valid), win=win)
    jpts, jok, jdiv = jof._iterate_level_cached(jt[0], jc[0], jnp.asarray(init),
                                                 jnp.asarray(valid), win, 30, 0.1, True)
    tpts, tok, tdiv, iters = tof._iterate_level_cached(tt[0], tc[0], torch.from_numpy(init),
                                                       torch.from_numpy(valid), win, 30, 0.1, True)
    jdiv = np.asarray(jdiv)
    np.testing.assert_array_equal(tdiv.numpy(), jdiv)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 5 <= jdiv.sum() <= 40
    keep = ~jdiv & np.asarray(jok)
    assert keep.sum() >= 5
    np.testing.assert_allclose(tpts.numpy()[keep], np.asarray(jpts)[keep], atol=1e-3)
    assert int(iters.max()) <= 30 and int(iters[torch.from_numpy(~valid)].max()) == 0


@pytest.mark.parametrize("win", [24, 53, 61, 101])
def test_klt_track_cached_matches_jax(win):
    img, cur = _images()
    jp, jc, tp, tc = _pyrs(img, cur)
    pts, init, valid = _keypoints(win)
    jt = jof.build_lk_templates(jp, jnp.asarray(pts), jnp.asarray(valid), win=win)
    jo, jok = jof.klt_track_cached(jt, jc, jnp.asarray(init), jnp.asarray(valid), win=win)
    tt = tof.build_lk_templates(tp, torch.from_numpy(pts), torch.from_numpy(valid), win=win)
    to, tok = tof.klt_track_cached(tt, tc, torch.from_numpy(init), torch.from_numpy(valid),
                                   win=win)
    jo, jok = np.asarray(jo), np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert jok.sum() >= 16  # at 101 px the in-image gate keeps a third
    assert not jok[7] and not jok[8]  # invalid; a seed 60 px off
    assert not jok[4] and not jok[5]  # windows outside the image
    np.testing.assert_allclose(to.numpy()[jok], jo[jok], atol=1e-3)
    err = np.linalg.norm(to.numpy()[jok] - pts[jok] - np.array(SHIFT), axis=-1)
    assert np.median(err) < 0.1
    # The CPU wrapper is the plain version.
    wo, wok = tlk.klt_track_cached_lk(tt, tc, torch.from_numpy(init), torch.from_numpy(valid),
                                      win=win, device="cpu")
    assert torch.equal(wo, to) and torch.equal(wok, tok)


def test_klt_track_matmul_matches_jax():
    img, cur = _images(seed=4)
    jp, jc, tp, tc = _pyrs(img, cur)
    pts, init, valid = _keypoints(24, seed=5)
    jo, jok = jof.klt_track_matmul(jp, jc, jnp.asarray(pts), jnp.asarray(init),
                                   jnp.asarray(valid))
    to, tok = tof.klt_track_matmul(tp, tc, torch.from_numpy(pts), torch.from_numpy(init),
                                   torch.from_numpy(valid))
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert jok.sum() >= 0.5 * len(jok)
    np.testing.assert_allclose(to.numpy()[jok], np.asarray(jo)[jok], atol=1e-3)


def test_stream_axis_is_bit_identical_to_single_calls():
    win = 24
    singles, stacks = [], []
    for seed in (0, 6):
        img, cur = _images(seed)
        _, _, tp, tc = _pyrs(img, cur)
        pts, init, valid = (torch.from_numpy(x) for x in _keypoints(win, seed=seed + 1))
        tt = tof.build_lk_templates(tp, pts, valid, win=win)
        singles.append(tof.track_cached(tt, tc, init, valid, win=win))
        stacks.append((tp, tc, pts, init, valid, tt))
    tp, tc, pts, init, valid, tt = (stack_trees(list(x)) for x in zip(*stacks))
    # Templates built with the stream axis are the per-stream ones.
    stacked_tt = tof.build_lk_templates(tp, pts, valid, win=win)
    for lvl in range(N_LEVELS):
        for k in tt[lvl]:
            assert torch.equal(stacked_tt[lvl][k], tt[lvl][k]), (lvl, k)
    out, ok, iters = tof.track_cached(tt, tc, init, valid, win=win)
    for b, (o, k, it) in enumerate(singles):
        assert torch.equal(out[b], o) and torch.equal(ok[b], k) and torch.equal(iters[b], it)
    wo, wok = tlk.klt_track_cached_lk(tt, tc, init, valid, win=win, device="cpu")
    assert torch.equal(wo, out) and torch.equal(wok, ok)


def test_klt_track_cached_lk_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlk.klt_track_cached_lk((None,), [torch.zeros(8, 8)], torch.zeros(1, 2),
                                torch.ones(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tlk.lk_cached_cuda((None,), [torch.zeros(8, 8)], torch.zeros(1, 2),
                           torch.ones(1, dtype=torch.bool), win=4, max_iter=3, eps=0.1)


def test_cached_routes_by_width():
    """The launcher's route (csrc/lk_kernel.cu: cached_smem) at the H100's
    232448-byte opt-in: one warp a keypoint at the main path's 24 px, then
    patch and cache in shared memory to 101 px and a little beyond, the
    patch alone to 222 px, neither above."""
    optin = 232448
    assert tlk.cached_smem("lk_cached shared", 24) == 192 + 4 * (42 * 42 + 3 * 24 * 24)
    assert [tlk.cached_route(w, optin) for w in (24, 54, 101, 151, 222, 223, 401)] == [
        "lk_cached warp", "lk_cached shared", "lk_cached shared", "lk_cached patch",
        "lk_cached patch", "lk_cached global", "lk_cached global"]
    assert tlk.cached_route(24, 1) == "lk_cached global"


def _to_np(tree):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return np.array(x)
    return conv(dataclasses.asdict(tree))


def test_state_from_numpy_carries_a_matmul_frontend_state():
    """A JAX frontend state of the default tracker (a template cache, no
    pyramid) carries over: its templates are the port's own init's, and a
    frame tracked from it is the one tracked from the port's own state."""
    size = dict(width=320, height=240)
    jparams = j_synthetic_params(**size, max_features=64, max_landmarks=96, nr_states=5)
    tparams = vio_params_from_dict(dataclasses.asdict(jparams))
    jcfg = JFrontendConfig.from_params(jparams.frontend, max_features=64)
    assert jcfg.lk_impl == "matmul"
    jfe = JStereoFrontend(jcfg, JStereoCamera.from_params(jparams.left_cam, jparams.right_cam),
                          jimu.PimParams.from_params(jparams.imu))
    tcfg = FrontendConfig.from_params(tparams.frontend, max_features=64)
    assert tcfg.lk_impl == "matmul"
    tfe = StereoFrontend(tcfg, StereoCamera.from_params(tparams.left_cam, tparams.right_cam,
                                                        device="cpu"),
                         PimParams.from_params(tparams.imu, device="cpu"), torch.device("cpu"))
    prov = SyntheticStereoProvider(n_frames=3, **size)
    left, right = prov.load_image(("left", 0)), prov.load_image(("right", 0))
    np.testing.assert_array_equal(JProvider(n_frames=3, **size).load_image(("left", 0)), left)
    jstate, _ = jfe.init_state(jnp.asarray(left), jnp.asarray(right), 0.0)
    tstate, _ = tfe.init_state(torch.from_numpy(left), torch.from_numpy(right), 0.0)
    assert len(jstate.lkf_pyramid) == 0 and len(jstate.lkf_templates) == 5
    assert tstate.lkf_pyramid == () and tstate.lkf_grads == ()
    _, _, cstate = state_from_numpy(_to_np(jsm.Window.empty(5)),
                                    _to_np(jsm.LandmarkTable.empty(96, 5)), _to_np(jstate),
                                    device="cpu")
    assert cstate.lkf_pyramid == () and [t is None for t in cstate.lkf_templates] == [
        t is None for t in jstate.lkf_templates]
    assert torch.equal(cstate.lkf_features.mask, tstate.lkf_features.mask)
    levels = [(a, c, t) for a, c, t in zip(jstate.lkf_templates, cstate.lkf_templates,
                                           tstate.lkf_templates) if a is not None]
    assert len(levels) >= 3
    for a, c, _ in levels:
        for k in a:
            np.testing.assert_array_equal(c[k].numpy(), np.asarray(a[k]))
    # The port's own templates are cut at its own corners, which sub-pixel
    # refinement puts within 1e-3 px of the JAX ones (test_torch_frontend.py).
    for a, _, b in levels:
        assert torch.equal(b["good_g"], torch.from_numpy(np.asarray(a["good_g"])))
        for k in ("tmpl", "gx", "gy"):
            x = np.asarray(a[k])
            np.testing.assert_allclose(b[k].numpy(), x, rtol=0, atol=1e-3 * np.abs(x).max())
    frames = list(prov.frames())
    args = (torch.from_numpy(prov.load_image(frames[1]["left_path"])),
            torch.from_numpy(prov.load_image(frames[1]["right_path"])), frames[1]["imu"],
            (frames[1]["stamp_ns"] - frames[0]["stamp_ns"]) * 1e-9)
    c_next, c_out = tfe.process_frame(cstate, *args)
    t_next, t_out = tfe.process_frame(tstate, *args)
    assert not c_out["is_keyframe"] and c_out["n_tracked"] == t_out["n_tracked"] >= 40
    ok = t_next.features.mask
    assert torch.equal(c_next.features.mask, ok)
    torch.testing.assert_close(c_next.features.uv[ok], t_next.features.uv[ok], atol=1e-3,
                               rtol=0)
