"""A small copy of the benchmark's data (320x240 rigs) in a temporary
folder, for runs of the harness on the CPU; and the program's LK counters
counted on the CPU, where the plain trackers run in place of the kernels."""

import json
import shutil
from pathlib import Path

import harness

BENCH_DIR = Path(harness.__file__).resolve().parent
ROOT = BENCH_DIR.parent
TINY_CAMERA = dict(width=320, height=240, fx=240.0, fy=240.0, cx=160.0, cy=120.0)


def make(dst: Path, streams: int = 2, warmup_keyframes: int = 3, last_keyframe: int = 1000) -> Path:
    """dst/BENCHMARK.json and dst/gpu_bench/{configs,workloads,metrics} at
    the small size, each cell with `streams` robots and a window from the
    streams' `warmup_keyframes`-th keyframe; returns dst."""
    spec = harness.load_spec(ROOT)
    shutil.copytree(BENCH_DIR / "metrics", dst / "gpu_bench" / "metrics")
    (dst / "gpu_bench" / "configs").mkdir(parents=True)
    (dst / "gpu_bench" / "workloads").mkdir(parents=True)
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["camera"].update(TINY_CAMERA)
        (dst / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        # a short run samples every tracking frame for the checks
        wl = dict(harness.workload_of(w["name"]), streams=streams,
                  warmup_keyframes=warmup_keyframes, last_keyframe=last_keyframe,
                  trace_cycles=1, check_share=1.0)
        (dst / "gpu_bench" / "workloads" / f"{w['name']}.json").write_text(json.dumps(wl))
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


def count_cpu_launches(monkeypatch):
    """Count the frontend's tracker and cache-build calls on the program's
    launch counters, as the kernels count their launches on the card."""
    from kimera_vio_tpu_torch.frontend import vision_frontend as vf
    from kimera_vio_tpu_torch.ops import lk_kernel as lk

    track, build = vf.klt_track_cached_lk, vf.build_lk_templates_lk

    def tracked(*a, **kw):
        lk.lk_cached_cuda.launches += 1
        return track(*a, **kw)

    def built(*a, **kw):
        lk.lk_cache_build_cuda.launches += 1
        return build(*a, **kw)

    monkeypatch.setattr(vf, "klt_track_cached_lk", tracked)
    monkeypatch.setattr(vf, "build_lk_templates_lk", built)


def run(root: Path, cell: str, seed: int = 20231, seconds: float = 4.0, trace: bool = False,
        faults=None, control: bool = False):
    """One run of the small copy on the CPU: (result line, numbers)."""
    import time

    import torch

    return harness.execute(root, cell, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter(), faults=faults,
                           bench_dir=root / "gpu_bench", control=control)
