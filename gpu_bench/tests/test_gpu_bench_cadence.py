"""Each mix's keyframe cadence at a small size, through the port's plain
CPU path: a keyframe each 0.2 s in float32 seconds, so every 4th or 5th
frame at 20 Hz (EuRoC); a fleet's
robots, bootstrapped together, keyframe together (the policy is
time-driven), each from its own phase of the trajectory. The window opens
once every stream has made its warm-up's keyframes and closes at the
`last_keyframe`-th however long `seconds` is."""

import time

import numpy as np
import pytest
import torch

import harness
import scene as scene_mod
import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"), streams=4)


def _inputs(root, cell):
    spec = harness.load_spec(root)
    cfg = harness.config_of(spec, harness.cell_entry(spec, cell), root)
    wl = harness.workload_of(cell, root / "gpu_bench")
    scn = scene_mod.Scene(scene_mod.Rig.from_config(cfg), wl["motion"], 11, torch.device("cpu"))
    return harness.vio_params(cfg), scn, wl


def test_window_is_fixed_by_keyframes_when_seconds_run_long(root):
    params, scn, wl = _inputs(root, "euroc_stereo.fleet8")
    wl = dict(wl, warmup_keyframes=3, last_keyframe=6)
    run, capture, launches, streams = harness.run_fleet(
        params, scn, wl, 11, 1e6, False, torch.device("cpu"), time.perf_counter())
    assert launches["keyframes_made"] == [6] * int(wl["streams"])
    # keyframes 3 (the window's first cycle ends at the 4th) to 6
    assert sum(s.keyframe for s in run.steps) == 3
    assert run.steps[-1].keyframe and launches["recovered"] == 0
    assert {len(rows) for rows in capture["keyframes"].values()} == {4}
    assert capture["landmarks"] and all(int(valid.sum()) > 0
                                        for *_, valid, _, _ in capture["landmarks"])


@pytest.mark.parametrize("cell, every", [("euroc_stereo.fleet8", 4)])
def test_fleet_streams_keyframe_together(root, cell, every):
    params, scn, wl = _inputs(root, cell)
    B = int(wl["streams"])
    kf_counts = []
    from kimera_vio_tpu_torch.parallel import fleet as fleet_mod

    step = fleet_mod.FleetVio.step

    def counting(self, *a, **kw):
        state, out = step(self, *a, **kw)
        kf_counts.append(int(out["is_keyframe"].sum()))
        return state, out

    fleet_mod.FleetVio.step = counting
    try:
        run, capture, launches, streams = harness.run_fleet(
            params, scn, wl, 11, 6.0, False, torch.device("cpu"), time.perf_counter())
    finally:
        fleet_mod.FleetVio.step = step
    assert len({s.offset for s in streams}) == B  # each robot its own phase
    assert set(kf_counts) == {0, B}
    kf = [i for i, k in enumerate(kf_counts) if k]
    assert every <= min(np.diff(kf)) and max(np.diff(kf)) <= every + 1
    assert run.steps[0].keyframe is False and run.steps[-1].keyframe  # whole cycles
