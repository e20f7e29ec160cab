"""The metric arithmetic on runs made up by hand: the rate over the whole
window and all streams, the step medians, idle as the union of device
intervals, launches per stream-frame, the roofline shares, the
breakdown."""

import numpy as np
import pytest
import torch

import harness
import roofline

F = harness.Frame


def _run(steps=(), streams=8, window_s=2.0, trace=None):
    return harness.Run(cell="x", streams=streams, setup_s=12.5, window_s=window_s,
                       steps=list(steps), trace=trace)


def read(name, run):
    return harness.reader(name)(run)


def test_rate_is_over_the_whole_window_and_all_streams():
    steps = [F(0.1 * i, 0.1 * i + 0.05, i % 4 == 0) for i in range(20)]
    assert read("frames_per_s", _run(steps, streams=1, window_s=2.5)) == pytest.approx(8.0)
    steps = [F(i, i + 0.5, True) for i in range(10)]
    assert read("frames_per_s", _run(steps=steps, streams=8, window_s=10.0)) == pytest.approx(8.0)
    assert read("setup_s", _run(steps)) == 12.5


def test_fleet_step_medians_split_keyframes_and_leave_out_the_traced_span():
    steps = [F(0, 0.014, False), F(0, 0.016, False), F(0, 2.2, True), F(0, 2.4, True),
             F(0, 0.015, False), F(0, 5.0, False, traced=True), F(0, 9.0, True, traced=True)]
    run = _run(steps=steps, streams=8)
    assert read("fleet_step_ms", run) == pytest.approx(16.0)
    assert read("fleet_keyframe_step_ms", run) == pytest.approx(2300.0)
    assert read("fleet_keyframe_step_ms", _run(steps=steps[:2], streams=8)) is None


def _trace(device, frames=4, lk_work=()):
    return harness.Trace(device=device, host=[], window_s=1.0, stream_frames=frames,
                         lk_work=list(lk_work))


def test_idle_is_the_union_of_device_intervals():
    ms = 1_000_000
    dev = [("a", "kernel", 0, 100 * ms), ("b", "kernel", 50 * ms, 150 * ms),  # overlap
           ("c", "gpu_memcpy", 400 * ms, 500 * ms), ("d", "kernel", 450 * ms, 460 * ms)]
    run = _run(trace=_trace(dev))
    assert harness.busy_s(run.trace) == pytest.approx(0.25)
    assert read("device_idle_pct", run) == pytest.approx(75.0)
    assert read("launches_per_frame", run) == pytest.approx(3 / 4)
    assert read("device_idle_pct", _run()) is None
    assert read("launches_per_frame", _run(trace=_trace([]))) is None


def test_roofline_share_pairs_launches_with_their_work():
    ns = 1000  # 1 us a launch
    dev = [("void lk_cached_warp_kernel<24>(...)", "kernel", 0, ns),
           ("lk_cache_build_kernel", "kernel", 2 * ns, 4 * ns),
           ("void lk_cached_warp_kernel<24>(...)", "kernel", 5 * ns, 6 * ns)]
    nb = roofline.PEAK_BYTES_PER_S * 0.25e-6  # a quarter of a microsecond of bytes
    work = [("lk_cached", nb, 0.0), ("lk_cache_build", nb, 0.0), ("lk_cached", nb, 0.0)]
    run = _run(trace=_trace(dev, lk_work=work))
    assert read("lk_cached_roofline_pct", run) == pytest.approx(25.0)
    assert read("lk_cache_build_roofline_pct", run) == pytest.approx(12.5)
    # unpaired launches give nothing rather than a wrong share
    assert read("lk_cached_roofline_pct", _run(trace=_trace(dev, lk_work=work[:2]))) is None
    assert read("lk_cache_build_roofline_pct", _run(trace=_trace(dev[:1]))) is None


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_work_counts_each_pixel_once():
    win = 24
    shapes = [(480, 752), (240, 376), (120, 188), (60, 94)]
    pts = torch.tensor([[100.0, 100.0], [100.5, 100.0]])  # patches almost the same pixels
    valid = torch.tensor([True, False])
    nb1, fl1 = roofline.cached_build_work(shapes, pts[:1], valid[:1], win)
    nb2, fl2 = roofline.cached_build_work(shapes, pts, valid, win)
    per_slot = sum(4 * 3 * win * win + 4 * 3 + 1 for _ in shapes) + 9
    assert nb2 - nb1 == per_slot and fl1 == fl2  # an invalid slot only adds its outputs
    iters = torch.tensor([[[3, 2, 0, 0]], [[1, 1, 1, 1]]], dtype=torch.int32).reshape(2, 4)
    tracked = [True, True, True, False]
    nb, fl = roofline.cached_work(shapes, tracked, pts, pts, torch.tensor([True, True]), iters,
                                  win)
    assert fl == (3 + 2 + 1 + 1 + 1) * win * win * 17  # level 3 has no template
    assert nb > 0


def test_breakdown_names_the_host_span_in_each_gap():
    ms = 1_000_000
    dev = [("k1", "kernel", 0, 1 * ms), ("k2", "kernel", 10 * ms, 12 * ms),
           ("k1", "kernel", 13 * ms, 14 * ms)]
    tr = _trace(dev)
    tr.host = [("pipeline._keyframe_half (guess, backend)", 0, 20 * ms),
               ("frontend.track (pyramid, preintegration, LK)", 2 * ms, 9 * ms)]
    b = harness.breakdown(tr)
    assert b["device_ops"][0] == ["k1", pytest.approx(0.002)]
    assert b["idle_gaps"][0] == ["frontend.track (pyramid, preintegration, LK)",
                                 pytest.approx(0.009)]
    assert b["idle_gaps"][1] == ["pipeline._keyframe_half (guess, backend)", pytest.approx(0.001)]
