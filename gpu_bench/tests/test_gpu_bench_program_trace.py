"""The program's spans in a traced run (`program_trace.py`): the five
keyframe readers' arithmetic on spans and runtime calls made up by hand,
a traced run of the small copy on the CPU with the program's recorder on,
and, on the card (marker `card`), that the program's spans, the CUDA
runtime's calls and the device's activities share one clock."""

import time
from types import SimpleNamespace

import pytest
import torch

import harness
import program_trace as pt
import tiny

FLEET = "euroc_stereo.fleet8"
KF = ("kf_branch_ms", "kf_backend_ms", "kf_imu_factors_ms", "kf_fleet_self_ms", "kf_host_syncs")
MS = 1_000_000


def _spans(rows):
    """Span records from (name, start ms, end ms, parent index, ids)."""
    return [SimpleNamespace(index=i, name=n, start_ns=a * MS, end_ns=b * MS, parent=p, ids=ids,
                            thread=1) for i, (n, a, b, p, ids) in enumerate(rows)]


def _run(program, runtime):
    trace = harness.Trace(device=[], host=[], window_s=1.0, stream_frames=2)
    trace.program, trace.runtime = program, runtime
    return harness.Run(cell="x", streams=2, setup_s=1.0, window_s=1.0, steps=[], trace=trace)


def _keyframe_frame(step, b, t, kf_ms):
    """One keyframing stream-frame's spans from `t` ms, parents relative
    to its first span (fleet.stream), the keyframe branch `kf_ms` long."""
    ids = {"step": step, "b": b}
    return [("fleet.stream", t, t + 100, None, ids),
            ("frontend.finish", t + 10, t + 10 + kf_ms + 2, 0, ids),
            ("frontend.keyframe_branch", t + 11, t + 11 + kf_ms, 1, ids),
            ("frontend.detect", t + 12, t + 13, 2, ids),
            ("pipeline.keyframe_half", t + 40, t + 90, 0, ids),
            ("backend.step", t + 41, t + 89, 4, ids),
            ("backend.gn_iter", t + 42, t + 60, 5, ids),
            ("backend.imu_factors", t + 43, t + 47, 6, ids),
            ("backend.gn_iter", t + 61, t + 80, 5, ids),
            ("backend.imu_factors", t + 62, t + 68, 8, ids)]


def _trace_rows():
    step = [("fleet.step", 0, 400, None, {"step": 1})]
    rows = step
    for b, (t, kf) in enumerate(((10, 20), (150, 10))):
        frame = _keyframe_frame(1, b, t, kf)
        base = len(rows)
        rows += [(n, a, e, 0 if p is None else p + base, ids) for n, a, e, p, ids in frame]
    # a tracking stream-frame: no keyframe branch
    rows.append(("fleet.stream", 300, 310, 0, {"step": 1, "b": 2}))
    return rows


def test_self_time_subtracts_nested_children():
    spans = _spans(_trace_rows())
    own = pt.self_ns(spans)
    assert own[0] == (400 - 100 - 100 - 10) * MS  # fleet.step less its three streams
    assert own[1] == (100 - 22 - 50) * MS  # first stream less finish and the half
    assert own[3] == (20 - 1) * MS  # the branch less detect
    assert own[6] == (48 - 18 - 19) * MS  # backend.step less two iterations
    assert sum(own.values()) == 400 * MS  # the self times add up to the root


def test_a_sync_goes_to_the_innermost_open_span():
    spans = _spans(_trace_rows())
    runtime = [("cudaStreamSynchronize", 22 * MS + 5, 22 * MS + 9),  # in detect
               ("cudaLaunchKernel", 23 * MS, 23 * MS + 2),  # not a sync
               ("cudaMemcpyAsync", 24 * MS, 24 * MS + 2),  # not a sync
               ("cudaMemcpy", 54 * MS, 55 * MS),  # in the first imu_factors
               ("cuStreamSynchronize", 45 * MS, 46 * MS),  # in the first stream, between calls
               ("cudaDeviceSynchronize", 500 * MS, 501 * MS)]  # outside every span
    owners = pt.sync_owners(spans, runtime)
    names = [None if i is None else spans[i].name for i, _, _ in owners]
    assert names == ["frontend.detect", "backend.imu_factors", "fleet.stream", None]
    assert [w for _, _, w in owners] == [4, MS, MS, MS]
    table = {r[0]: r for r in pt.by_span(spans, runtime)}
    assert table["frontend.detect"][5:] == [1, pytest.approx(4e-6)]
    assert table["backend.gn_iter"][1:5] == [4, pytest.approx(18.5), pytest.approx(74.0),
                                            pytest.approx(74.0 - 20.0)]


def test_the_five_keyframe_readers():
    spans = _spans(_trace_rows())
    # frame 0: 2 syncs under its branch and half, one in its own code;
    # frame 1: 4 under its half
    runtime = [("cudaStreamSynchronize", 25 * MS, 25 * MS + 1),
               ("cudaStreamSynchronize", 55 * MS, 55 * MS + 1),
               ("cudaStreamSynchronize", 45 * MS, 45 * MS + 1)]
    runtime += [("cudaEventSynchronize", (195 + k) * MS, (195 + k) * MS + 1) for k in range(4)]
    run = _run(spans, runtime)
    got = {n: harness.reader(n)(run) for n in KF}
    assert got["kf_branch_ms"] == pytest.approx(15.0)  # median of 20 and 10
    assert got["kf_backend_ms"] == pytest.approx(48.0)
    assert got["kf_imu_factors_ms"] == pytest.approx(10.0)  # 4 + 6, both iterations
    assert got["kf_fleet_self_ms"] == pytest.approx((28.0 + 38.0) / 2)  # 100 less finish, half
    assert got["kf_host_syncs"] == pytest.approx(3.0)  # median of 2 and 4
    # nothing to read: no program spans, no keyframing stream-frame, no runtime
    for n in KF:
        assert harness.reader(n)(_run([], runtime)) is None
        assert harness.reader(n)(_run(None, None)) is None
        assert harness.reader(n)(_run(_spans(_trace_rows()[:1] + [
            ("fleet.stream", 300, 310, 0, {"step": 1, "b": 2})]), runtime)) is None
    assert harness.reader("kf_host_syncs")(_run(spans, [])) is None
    assert harness.reader("kf_branch_ms")(
        harness.Run(cell="x", streams=2, setup_s=1.0, window_s=1.0, steps=[])) is None


def test_a_traced_run_on_the_cpu_records_the_program(tmp_path, monkeypatch):
    """The small copy traced with the program's recorder on: the harness's
    result as before, the program's spans under every fleet step, each
    keyframing stream-frame read; no runtime calls on the CPU, so no
    syncs. With the recorder off, no spans."""
    from kimera_vio_tpu_torch.utils.stats import SPAN_NAMES

    root = tiny.make(tmp_path)
    tiny.count_cpu_launches(monkeypatch)
    profiler, run_fleet = harness.Profiler, harness.run_fleet
    result, nums, run = pt.traced_execute(root, FLEET, 20231, 3.0, torch.device("cpu"),
                                          time.perf_counter(), bench_dir=root / "gpu_bench")
    assert harness.Profiler is profiler and harness.run_fleet is run_fleet
    assert result["correct"], result["checks"]
    assert "breakdown" in result and result["device"]["busy_s"] == 0.0
    spans = run.trace.program
    assert spans and {s.name for s in spans} <= SPAN_NAMES
    steps = [s for s in spans if s.name == "fleet.step"]
    assert len(steps) == sum(s.traced for s in run.steps)
    assert run.trace.runtime == []
    rep = pt.report(run)
    for n in KF[:4]:
        assert rep["metrics"][n] > 0.0, n
    assert rep["metrics"]["kf_host_syncs"] is None
    assert all(0.0 < c <= 1.0 for c in rep["kf_step_covered_by_children"])
    assert rep["between_steps_ms"]["median"] > 0.0
    assert 0.0 < rep["between_steps_ms"]["untraced_share"] < 1.0
    assert pt.OUTSIDE not in {name for name, _ in rep["idle_gaps"]}
    names = {r[0] for r in rep["by_span"]}
    assert {"fleet.step", "backend.step", "frontend.keyframe_branch"} <= names
    _, _, off = pt.traced_execute(root, FLEET, 20231, 3.0, torch.device("cpu"),
                                  time.perf_counter(), program=False,
                                  bench_dir=root / "gpu_bench")
    assert off.trace.program == []


@pytest.mark.card
def test_spans_runtime_and_device_share_one_clock(cuda_card):
    """A kernel launched inside a span between two host reads, each after
    a synchronise: its launch lies inside the span, and the launch and
    the kernel's device interval inside the two reads."""
    c = pt.clock_check(cuda_card)
    assert len(c["span"]) == len(c["launch"]) == len(c["kernel"]) == 1, c
    (sa, sb), (la, lb), (ka, kb) = c["span"][0], c["launch"][0], c["kernel"][0]
    assert c["t0"] <= sa <= la <= lb <= sb <= c["t1"], c
    assert c["t0"] <= ka <= kb <= c["t1"], c
