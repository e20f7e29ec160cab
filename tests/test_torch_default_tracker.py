"""The port's default tracker, the JAX package's (lk_impl="matmul"), end to
end.

  * `run()` of both packages at 320x240 with no KIMERA_LK_IMPL: both track
    with the matmul rule (the port against its template cache through
    `klt_track_cached_lk`, plain on the CPU), the port drawing the JAX
    RANSAC hypotheses (tests/test_torch_variants.py). The same keyframe
    stamps, positions within 1e-4 m, the JAX tests' ATE gate (0.05 m); at
    the default 24 px window and at 53 px, where the Pallas window rule
    the port used to track with loses every track;
  * KIMERA_LK_IMPL chooses the stereo pipeline's tracker (pallas: the
    window rule, gather: the gather rule, unset or another value: matmul),
    through `run()`, `run_chunked` and the CLI's pipelines alike; the mono
    and RGB-D pipelines keep the default, as in the JAX package;
  * a B = 2 `FleetVio` under the default against each stream's own run,
    one tracker call per fleet frame.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.common.types import stack_trees, unstack_trees
from kimera_vio_tpu_torch.convert import vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.parallel import FleetVio
from kimera_vio_tpu_torch.pipeline.mono_pipeline import MonoImuPipeline
from kimera_vio_tpu_torch.pipeline.rgbd_pipeline import RgbdImuPipeline
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.utils.logger import compute_ate

_spec = importlib.util.spec_from_file_location(
    "default_tracker_variants", os.path.join(os.path.dirname(__file__), "test_torch_variants.py"))
var = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(var)  # the JAX RANSAC draws

SIZE = dict(width=320, height=240, fx=240.0)
N_FRAMES = 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_lk_env(monkeypatch):
    monkeypatch.delenv("KIMERA_LK_IMPL", raising=False)


def _params(win):
    p = j_synthetic_params(**SIZE, nr_states=8, max_features=64, max_landmarks=96)
    p.frontend.klt_win_size = win
    return p, vio_params_from_dict(dataclasses.asdict(p))


@pytest.fixture(scope="module", params=[24, 53], ids=["win24", "win53"])
def jax_run(request):
    """One run of the JAX pipeline per window, with its default tracker and
    its 2-pt mono RANSAC guarded as the port's (`var.guard_jax`)."""
    win = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("KIMERA_LK_IMPL", raising=False)
        var.guard_jax(mp)
        jp, _ = _params(win)
        pipe = JPipeline(jp, parallel_run=False)
        assert pipe.frontend_cfg.lk_impl == "matmul"
        return win, pipe.run(JProvider(n_frames=N_FRAMES, vx=0.5, **SIZE))


class _Calls:
    """Counts the frontend's calls of each tracker entry point."""

    def __init__(self, monkeypatch):
        self.cached, self.rules = 0, []
        cached, pyramid = vision_frontend.klt_track_cached_lk, vision_frontend.klt_track_lk

        def count_cached(*a, **kw):
            self.cached += 1
            return cached(*a, **kw)

        def count_pyramid(*a, **kw):
            self.rules.append(kw.get("search_rows", 56))
            return pyramid(*a, **kw)

        monkeypatch.setattr(vision_frontend, "klt_track_cached_lk", count_cached)
        monkeypatch.setattr(vision_frontend, "klt_track_lk", count_pyramid)


def test_default_run_matches_jax(jax_run, monkeypatch):
    win, jout = jax_run
    monkeypatch.setattr(transac, "_sample_indices", var._jax_draws)
    calls = _Calls(monkeypatch)
    _, tp = _params(win)
    prov = SyntheticStereoProvider(n_frames=N_FRAMES, vx=0.5, **SIZE)
    pipe = StereoImuPipeline(tp, parallel_run=False, device="cpu")
    assert pipe.frontend_cfg.lk_impl == "matmul" and pipe.frontend_cfg.klt_win == win
    out = pipe.run(prov)
    assert calls.cached == N_FRAMES - 1 and calls.rules == []
    assert out.stamps_ns == jout.stamps_ns and out.n_keyframes >= 4
    np.testing.assert_allclose(np.stack(out.positions), np.stack(jout.positions), atol=1e-4)
    gt = prov.ground_truth
    ate = compute_ate(np.array(out.stamps_ns), np.stack(out.positions), gt.stamps_ns,
                      gt.positions, align=False)
    assert ate["rmse"] < 0.05, ate


SMALL = dict(width=160, height=120, fx=120.0)


def _small_params():
    p = synthetic_params(**SMALL, nr_states=5, max_features=48, max_landmarks=64)
    p.frontend.klt_max_level = 2
    p.frontend.templ_cols = 31
    p.frontend.templ_rows = 7
    return p


@pytest.mark.parametrize("impl,want", [(None, "matmul"), ("matmul", "matmul"),
                                       ("gather", "gather"), ("pallas", "pallas"),
                                       ("other", "matmul")])
def test_lk_impl_env_chooses_the_stereo_tracker(impl, want, monkeypatch):
    if impl is not None:
        monkeypatch.setenv("KIMERA_LK_IMPL", impl)
    calls = _Calls(monkeypatch)
    pipe = StereoImuPipeline(_small_params(), parallel_run=False, device="cpu")
    assert pipe.frontend_cfg.lk_impl == want
    out = pipe.run(SyntheticStereoProvider(n_frames=8, vx=0.5, **SMALL))
    assert out.n_keyframes >= 1
    tracked = out.n_frames - 1
    if want == "matmul":
        assert calls.cached == tracked and calls.rules == []
    else:
        assert calls.cached == 0
        assert calls.rules == [56 if want == "pallas" else None] * tracked
    # The state keeps what the tracker needs (the reference's policy).
    chunked = StereoImuPipeline(_small_params(), parallel_run=False, device="cpu")
    calls.cached, calls.rules = 0, []
    cout = chunked.run_chunked(SyntheticStereoProvider(n_frames=8, vx=0.5, **SMALL),
                               chunk_size=4)
    assert cout.stamps_ns == out.stamps_ns
    assert calls.cached + len(calls.rules) == tracked
    assert (calls.cached == tracked) == (want == "matmul")


@pytest.mark.parametrize("cls", [MonoImuPipeline, RgbdImuPipeline], ids=["mono", "rgbd"])
def test_mono_and_rgbd_pipelines_ignore_the_variable(cls, monkeypatch):
    monkeypatch.setenv("KIMERA_LK_IMPL", "gather")
    pipe = cls(_small_params(), parallel_run=False, device="cpu")
    assert pipe.frontend_cfg.lk_impl == "matmul"
    assert StereoImuPipeline(_small_params(), parallel_run=False,
                             device="cpu").frontend_cfg.lk_impl == "gather"


FLEET = ((0.3, 20.0), (0.8, 25.0))  # (vx m/s, frames/s)
FLEET_FRAMES = 10


def test_fleet_under_the_default_matches_single_streams(monkeypatch):
    params = _small_params()
    pipe = StereoImuPipeline(params, parallel_run=False, device="cpu")
    streams = []
    for vx, fps in FLEET:
        prov = SyntheticStereoProvider(n_frames=FLEET_FRAMES, vx=vx, fps=fps, **SMALL)
        packets = list(prov.frames())
        s0 = packets[0]["stamp_ns"]
        streams.append((prov, [(torch.from_numpy(prov.load_image(p["left_path"])),
                                torch.from_numpy(prov.load_image(p["right_path"])), p["imu"],
                                float(np.float32((p["stamp_ns"] - s0) * 1e-9)), p["stamp_ns"])
                               for p in packets]))
    navs, biases = [], []
    for prov, frames in streams:
        nav, bias = pipe._bootstrap_state(prov, frames[0][4], None)
        navs.append(nav)
        biases.append(bias)
    navs, biases = stack_trees(navs), torch.stack(biases)
    gold = []
    for b, ((_, frames), nav) in enumerate(zip(streams, unstack_trees(navs, len(FLEET)))):
        fe, win, lmk = pipe._init_stream(frames[0][0], frames[0][1], 0.0, nav, biases[b])
        rows = []
        for left, right, blk, stamp, _ in frames[1:]:
            fe, win, lmk, fo, bout = pipe._step(fe, win, lmk, left, right, blk, stamp)
            rows.append((fo["is_keyframe"], (bout or {}).get("pos", win.pos[max(win.n - 1, 0)])))
        gold.append(rows)
    assert fe.lkf_pyramid == () and len(fe.lkf_templates) == 3

    calls = _Calls(monkeypatch)
    fleet = FleetVio(params, len(FLEET), device="cpu")
    state = fleet.init(torch.stack([s[1][0][0] for s in streams]),
                       torch.stack([s[1][0][1] for s in streams]), navs, biases)
    assert state.fe_state.lkf_templates[0]["tmpl"].shape[:2] == (len(FLEET), 48)
    keyframes = 0
    for k in range(1, FLEET_FRAMES):
        fr = [frames[k] for _, frames in streams]
        state, out = fleet.step(state, torch.stack([f[0] for f in fr]),
                                torch.stack([f[1] for f in fr]), stack_trees([f[2] for f in fr]),
                                [f[3] for f in fr])
        for b in range(len(FLEET)):
            is_kf, pos = gold[b][k - 1]
            assert bool(out["is_keyframe"][b]) == is_kf, (k, b)
            torch.testing.assert_close(out["pos"][b], pos, atol=1e-5, rtol=0)
            keyframes += is_kf
    assert calls.cached == FLEET_FRAMES - 1 and calls.rules == []
    assert keyframes >= 3
