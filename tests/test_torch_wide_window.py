"""LK windows wider than 54 px under the port's pyramid trackers, against
the JAX package.

The Pallas window rule (its 56-row search-window clip) takes no window
over 54 px in either package, so under `KIMERA_LK_IMPL=pallas` (and
`gather`) the port tracks wider windows with the gather rule
(`search_rows=None`). On the card that is the LK kernel's `lk_wide` mode
(csrc/lk_kernel.cu), which chip_smoke.py phase 10 holds against the plain
version; here the plain version is held against the JAX package:

  * the plain tracker (`klt_track_lk(..., search_rows=None)` on the CPU)
    at win 61 and 101 against the JAX `klt_track` on the textured image
    and the subpixel shift of tests/test_optical_flow.py: the same `ok`,
    positions within 1e-3 px (the same float32 arithmetic, the window sums
    in another order);
  * a 320x240 `run()` with `klt_win_size` 61 and `klt_max_level` 2 (levels
    0 and 1 tracked, level 2 at 80x60 skipped), the port built under
    `KIMERA_LK_IMPL=pallas`, against one run of the JAX pipeline with its
    default tracker (`lk_impl="matmul"`), the port drawing the JAX RANSAC
    hypotheses (tests/test_torch_variants.py): the same keyframe stamps,
    positions within 1e-4 m, and the JAX tests' ATE gate, 0.05 m. Under
    `pallas` a frontend built with a 61 px window tracks through the
    gather rule (the window rule would fail every keypoint). The port's
    default tracker, the JAX package's, is held to the JAX run at 53 px in
    tests/test_torch_default_tracker.py.
"""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.ops import optical_flow as jof
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.convert import vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.ops import lk_kernel as tlk
from kimera_vio_tpu_torch.ops import optical_flow as tof
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.utils.logger import compute_ate


def _fixture_module(name):
    spec = importlib.util.spec_from_file_location(
        f"wide_{name}", os.path.join(os.path.dirname(__file__), f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


flow_fx = _fixture_module("test_optical_flow")  # textured_image, shift_image, grid_points
var = _fixture_module("test_torch_variants")  # the JAX RANSAC draws

SIZE = dict(width=320, height=240, fx=240.0)
N_FRAMES = 24
WIN = 61


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores,
    and these small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("win", [61, 101])
def test_gather_rule_matches_klt_track(win):
    h, w = 320, 480
    img = flow_fx.textured_image(h, w, seed=2)
    cur = flow_fx.shift_image(img, 2.3, -1.4)
    pts = flow_fx.grid_points(h, w, margin=win // 2 + 10, step=32)
    valid = np.ones(len(pts), bool)
    jp = jof.build_pyramid(jnp.asarray(img), 3)
    jc = jof.build_pyramid(jnp.asarray(cur), 3)
    out_j, ok_j = jof.klt_track(jp, jc, jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(valid),
                                win=win)
    T = torch.from_numpy
    tp = tof.build_pyramid(T(img), 3)
    tc = tof.build_pyramid(T(cur), 3)
    out_t, ok_t = tlk.klt_track_lk(tp, tc, T(pts), T(pts), T(valid), win=win, search_rows=None,
                                   device="cpu")
    modes = [lv.mode for lv in tlk.level_table([p.shape for p in tp], win, None)]
    assert modes[-2:] == ["xla", "xla"] and "skip" in modes
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.float().mean() > 0.9
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-3)
    err = np.linalg.norm(out_t.numpy() - (pts + [2.3, -1.4]), axis=-1)
    assert np.median(err) < 0.1


def _params():
    p = j_synthetic_params(**SIZE, nr_states=8, max_features=64, max_landmarks=96)
    p.frontend.klt_win_size = WIN
    p.frontend.klt_max_level = 2
    return p, vio_params_from_dict(dataclasses.asdict(p))


@pytest.fixture(scope="module")
def jax_run():
    """One run of the JAX pipeline (its default matmul tracker)."""
    jp, _ = _params()
    return JPipeline(jp, parallel_run=False).run(JProvider(n_frames=N_FRAMES, vx=0.5, **SIZE))


def test_run_with_a_61_px_window_matches_jax(jax_run, monkeypatch):
    monkeypatch.setattr(transac, "_sample_indices", var._jax_draws)
    rules = []
    track = vision_frontend.klt_track_lk

    def recording(*a, **kw):
        rules.append(kw.get("search_rows", 56))
        return track(*a, **kw)

    monkeypatch.setattr(vision_frontend, "klt_track_lk", recording)
    _, tp = _params()
    prov = SyntheticStereoProvider(n_frames=N_FRAMES, vx=0.5, **SIZE)
    monkeypatch.setenv("KIMERA_LK_IMPL", "pallas")
    pipe = StereoImuPipeline(tp, parallel_run=False, device="cpu")
    assert pipe.frontend_cfg.klt_win == WIN and pipe.frontend_cfg.lk_impl == "pallas"
    out = pipe.run(prov)
    assert rules == [None] * (N_FRAMES - 1)
    assert out.stamps_ns == jax_run.stamps_ns and out.n_keyframes >= 4
    np.testing.assert_allclose(np.stack(out.positions), np.stack(jax_run.positions), atol=1e-4)
    gt = prov.ground_truth
    ate = compute_ate(np.array(out.stamps_ns), np.stack(out.positions), gt.stamps_ns,
                      gt.positions, align=False)
    assert ate["rmse"] < 0.05, ate
