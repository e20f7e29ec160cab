"""The port's span recorder (kimera_vio_tpu_torch/utils/stats.py) and the
spans the fleet path records, on the CPU.

A two-stream FleetVio at tests/test_torch_fleet.py's size (160x120, fx
120, 64 features and landmarks, 5 states, 3 pyramid levels, 31x7 stereo
templates), 9 frames of the synthetic sequence at 20 and 15 frames/s, so
that both streams keyframe and track. The same frames run once with
recording off and once with it on:

  * off, nothing is recorded and `span` returns the shared `NO_SPAN`;
  * on, every span lies inside its parent, on its parent's thread, and
    carries the fleet step's number and, under `fleet.stream`, its
    stream; each keyframing stream-frame has one `backend.step` with
    `gn_iters` `backend.gn_iter` children, each holding one
    `backend.imu_factors`; a tracking stream-frame has no keyframe
    branch and no backend; every name is in `SPAN_NAMES`;
  * the outputs are the same, bit for bit;
  * a span's duration is read from the monotonic clock, so a step of the
    real-time clock it is stamped with does not bend it.
"""

import functools
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kimera_vio_tpu_torch.common.types import stack_trees
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.parallel import FleetVio
from kimera_vio_tpu_torch.utils import stats
from kimera_vio_tpu_torch.utils.stats import (NO_SPAN, SPAN_NAMES, StatsCollector, span,
                                              start_recording, stop_recording)

SIZE = dict(width=160, height=120, fx=120.0)
STREAMS = ((0.3, 20.0), (0.5, 15.0))  # (vx m/s, frames/s)
N_FRAMES = 9


@pytest.fixture(autouse=True)
def _recording_off():
    """Every test starts and ends with recording off and nothing kept."""
    stop_recording()
    yield
    stop_recording()


def _params():
    p = synthetic_params(**SIZE, max_features=64, max_landmarks=64, nr_states=5)
    p.frontend.klt_max_level = 2
    p.frontend.templ_cols = 31
    p.frontend.templ_rows = 7
    return p


@functools.lru_cache(maxsize=None)
def _frames():
    """Per stream: its provider and (left, right, IMU block, stamp s)."""
    out = []
    for vx, fps in STREAMS:
        prov = SyntheticStereoProvider(n_frames=N_FRAMES, vx=vx, fps=fps, **SIZE)
        packets = list(prov.frames())
        s0 = packets[0]["stamp_ns"]
        out.append((prov, packets[0]["stamp_ns"],
                    [(torch.from_numpy(prov.load_image(p["left_path"])),
                      torch.from_numpy(prov.load_image(p["right_path"])), p["imu"],
                      float(np.float32((p["stamp_ns"] - s0) * 1e-9))) for p in packets]))
    return out


def _run(record: bool):
    """The fleet over every frame: (outputs per step, spans, gn_iters)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fleet = FleetVio(_params(), len(STREAMS), device="cpu")
        pipe = fleet._pipes[0]
        navs, biases = zip(*(pipe._bootstrap_state(prov, ns, None) for prov, ns, _ in _frames()))
        first = [frames[0] for _, _, frames in _frames()]
        state = fleet.init(torch.stack([f[0] for f in first]), torch.stack([f[1] for f in first]),
                           stack_trees(list(navs)), torch.stack(biases))
        if record:
            start_recording()
        outs = []
        for k in range(1, N_FRAMES):
            fr = [frames[k] for _, _, frames in _frames()]
            state, out = fleet.step(state, torch.stack([f[0] for f in fr]),
                                    torch.stack([f[1] for f in fr]),
                                    stack_trees([f[2] for f in fr]), [f[3] for f in fr])
            outs.append(out)
        spans = stop_recording()
        return outs, spans, fleet._pipe.backend_cfg.gn_iters
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _runs():
    return _run(False), _run(True)


def _children(spans):
    kids = {s.index: [] for s in spans}
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append(s)
    return kids


def _under(spans, kids, root, name):
    """Spans called `name` in the tree under `root`."""
    out, todo = [], [root]
    while todo:
        s = todo.pop()
        out += [c for c in kids[s.index] if c.name == name]
        todo += kids[s.index]
    return out


def test_off_records_nothing_and_span_is_the_shared_no_op():
    (outs, spans, _), _ = _runs()
    assert len(outs) == N_FRAMES - 1
    assert spans == []
    assert span("fleet.step", step=1) is NO_SPAN
    with span("fleet.step") as s:
        assert s is NO_SPAN
    assert stop_recording() == []


def test_span_tree_of_the_fleet_path():
    _, (outs, spans, gn_iters) = _runs()
    assert {s.name for s in spans} <= SPAN_NAMES
    by_index = {s.index: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            up = by_index[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns, (s.name, up.name)
            assert up.thread == s.thread
            assert up.ids.items() <= s.ids.items()
    steps = [s for s in spans if s.name == "fleet.step"]
    assert [s.ids["step"] for s in steps] == list(range(1, N_FRAMES))
    assert all(s.parent is None for s in steps)
    assert all(s.parent is not None for s in spans if s.name != "fleet.step")
    kids = _children(spans)
    streams = {(s.ids["step"], s.ids["b"]): s for s in spans if s.name == "fleet.stream"}
    assert len(streams) == len(steps) * len(STREAMS)
    n_kf = 0
    for (step, b), st in streams.items():
        keyframing = bool(outs[step - 1]["is_keyframe"][b])
        branch = _under(spans, kids, st, "frontend.keyframe_branch")
        backend = _under(spans, kids, st, "backend.step")
        if not keyframing:
            assert branch == [] and backend == [], (step, b)
            continue
        n_kf += 1
        assert len(branch) == 1 and len(backend) == 1, (step, b)
        for name in ("frontend.detect", "frontend.stereo_match", "frontend.ransac_mono",
                     "frontend.ransac_stereo", "lk.cache_build"):
            assert len(_under(spans, kids, branch[0], name)) == 1, name
        iters = [c for c in kids[backend[0].index] if c.name == "backend.gn_iter"]
        assert len(iters) == gn_iters
        for it in iters:
            assert [c.name for c in kids[it.index]].count("backend.imu_factors") == 1
            assert len(_under(spans, kids, it, "backend.solve")) == 1
    assert 0 < n_kf < len(streams)  # both kinds of stream-frame are there
    # one batched frame step and one read-back a fleet frame
    for name in ("frontend.track", "frontend.track_read"):
        assert [s.ids["step"] for s in spans if s.name == name] == list(range(1, N_FRAMES))


def test_outputs_are_the_same_with_recording_on_and_off():
    (off, _, _), (on, _, _) = _runs()
    for a, b in zip(off, on):
        assert a.keys() == b.keys()
        for k in a:
            x, y = a[k], b[k]
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), k
            else:
                np.testing.assert_array_equal(x, y, err_msg=k)


def test_recorder_parents_ids_threads_and_a_recording_begun_inside_a_span():
    start_recording()
    with span("fleet.step", step=7):
        with span("fleet.stream", b=1):
            with span("backend.step"):
                pass

        def other():
            with span("lk.track", step=8):
                pass

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        start_recording()  # a fresh recording while fleet.step is open
        with span("backend.solve"):
            pass
    spans = stop_recording()
    assert [(s.name, s.parent, s.ids) for s in spans] == [("backend.solve", None, {})]

    start_recording()
    with span("fleet.step", step=7):
        with span("fleet.stream", b=1):
            with span("backend.step"):
                pass
        t = threading.Thread(target=lambda: span("lk.track", step=8).__enter__().__exit__())
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    spans = stop_recording()
    names = [(s.name, s.parent, s.ids) for s in spans]
    assert names == [("fleet.step", None, {"step": 7}), ("fleet.stream", 0, {"step": 7, "b": 1}),
                     ("backend.step", 1, {"step": 7, "b": 1}), ("lk.track", None, {"step": 8})]
    assert spans[3].thread != spans[0].thread == spans[2].thread
    assert stats._open.stack == []


def test_stats_span_feeds_its_tag_with_recording_off_and_on():
    sc = StatsCollector()
    with sc.span("pipeline.readback", "readback [ms]") as s:
        pass
    assert s.ms >= 0.0 and sc.get("readback [ms]").count == 1
    assert stop_recording() == []
    start_recording()
    with sc.span("pipeline.vio_step", "vio_step [ms]", step=3):
        with span("backend.step"):
            pass
    spans = stop_recording()
    assert [(s.name, s.ids) for s in spans] == [("pipeline.vio_step", {"step": 3}),
                                                ("backend.step", {"step": 3})]
    assert sc.get("vio_step [ms]").count == 1 and sc.get("vio_step [ms]").total == pytest.approx(
        spans[0].ms)


def test_span_duration_is_on_the_monotonic_clock(monkeypatch):
    """A step of the real-time clock between a span's start and end moves
    its stamps, and neither its `ms` nor the tag it feeds."""
    real = iter([1_000_000_000, 1_000_000_000 - 5_000_000_000])  # stepped back 5 s
    mono = iter([7_000_000, 7_000_000 + 2_500_000])  # 2.5 ms
    monkeypatch.setattr(stats, "time", SimpleNamespace(time_ns=lambda: next(real),
                                                       perf_counter_ns=lambda: next(mono),
                                                       monotonic=time.monotonic))
    sc = StatsCollector()
    start_recording()
    with sc.span("pipeline.readback", "readback [ms]") as s:
        pass
    (rec,) = stop_recording()
    assert rec is s and s.end_ns - s.start_ns == -5_000_000_000
    assert s.ms == pytest.approx(2.5)
    assert sc.get("readback [ms]").total == pytest.approx(2.5)
