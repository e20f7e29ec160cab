#!/usr/bin/env python3
"""Where the host's time goes in one keyframe's template-cache build.

    python3 scripts/build_host_path.py [--other OTHER/kimera_vio_tpu_torch/ops/lk_kernel.py]
        [--reps 300] [--rounds 3] [--path]

Times, on the card, with host clocks (`time.perf_counter`), the main
path's cache build (chip_smoke.main_lk_inputs: 752x480, 5 levels, 256
keypoints, win 24): the entry point `build_lk_templates_lk` and the wrapper
`lk_cache_build_cuda` per call, then each step such a call repeats on every
keyframe, timed alone on the same tensors: the entry point's device checks
and `.contiguous()` calls, the output allocations (three tensors unbound
into 35 views), the per-level dicts, the ctypes launch table, the device
guard, the current stream's lookup, and the C launcher itself (its call,
the device query, the plan and the kernel's launch).
Host times of calls that launch work are taken over `--reps` calls with
one synchronize at the end: the kernel takes ~0.01 ms, far less than a
call's host path, so the card never holds the host back.

`--other` loads another checkout's `ops/lk_kernel.py` beside this one (as
a module of its own, building that checkout's kernel source), and the
entry point and wrapper of both are timed in turns (other, this, this,
other, `--rounds` times) in one process on one card. `--path` also runs
chip_smoke's phase 2 (the 80-frame main path) and prints its cache build
ms a keyframe (CUDA events around each frontend build) beside host clocks
around the entry point, the wrapper and the C launcher in that run; with
`--other`, four runs in turns (other, this, this, other), the frontend
building through each checkout's entry point.
Prints the card's name and power limit, then one JSON line. Needs a card;
exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time


def per_call_us(fn, reps: int) -> float:
    """Mean host µs of fn() over `reps` calls after a warm-up, the card
    synchronised before and after."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def path_with_host_clocks(dev, chip_smoke, lk, mod) -> dict:
    """Phase 2's run with host clocks around each keyframe's entry point
    call (module `mod`'s), the wrapper inside it and the C launcher inside
    that (the launcher's library is wrapped; the wrapper is replaced, in
    `mod` and in this checkout's `lk`, by one timed function that keeps
    the counters chip_smoke reads), beside chip_smoke's CUDA events around
    the entry point. µs per cache build, mean and median."""
    import statistics

    from kimera_vio_tpu_torch.frontend import vision_frontend
    from kimera_vio_tpu_torch.ops import optical_flow

    clocks = {"entry_point_us": [], "wrapper_us": [], "launcher_us": []}

    def timed(fn, key):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            clocks[key].append(1e6 * (time.perf_counter() - t0))
            return out
        return call

    class Lib:
        def __init__(self, lib):
            self._lib = lib
            self.lk_cache_build_launch = timed(lib.lk_cache_build_launch, "launcher_us")

        def __getattr__(self, name):
            return getattr(self._lib, name)

    lib, wrapper = mod._lib, mod.lk_cache_build_cuda
    this_wrapper = lk.lk_cache_build_cuda
    entry, plain = vision_frontend.build_lk_templates_lk, optical_flow.build_lk_templates
    proxy = Lib(lib())
    timed_wrapper = timed(wrapper, "wrapper_us")
    timed_wrapper.launches, timed_wrapper.report = wrapper.launches, wrapper.report
    mod._lib, mod.lk_cache_build_cuda = (lambda: proxy), timed_wrapper
    lk.lk_cache_build_cuda = timed_wrapper
    vision_frontend.build_lk_templates_lk = timed(mod.build_lk_templates_lk, "entry_point_us")
    try:
        path = chip_smoke.path_phase(dev)
    finally:
        mod._lib, mod.lk_cache_build_cuda, lk.lk_cache_build_cuda = lib, wrapper, this_wrapper
        # chip_smoke counts builds by wrapping these two: undo it for the next run.
        vision_frontend.build_lk_templates_lk, optical_flow.build_lk_templates = entry, plain
    res = {k: path[k] for k in ("frames_per_s", "keyframes", "cache_builds",
                                "cache_build_ms_per_keyframe", "cache_build_ms_median")}
    for key, v in clocks.items():
        v = v[-path["cache_builds"]:]  # the run's builds, after its warm-up run
        res[key] = {"mean": sum(v) / len(v), "median": statistics.median(v), "n": len(v)}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout's kimera_vio_tpu_torch/ops/lk_kernel.py")
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--path", action="store_true", help="also run phase 2's 80-frame path")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir)))
    import torch

    if not torch.cuda.is_available():
        print("build_host_path: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from kimera_vio_tpu_torch import resolve_device
    from kimera_vio_tpu_torch.ops import lk_kernel as lk

    mods = {"this": lk}
    if args.other:
        spec = importlib.util.spec_from_file_location("lk_kernel_other", args.other)
        mods["other"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods["other"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    prev, _, pts, valid = chip_smoke.main_lk_inputs(dev)
    win, reps = chip_smoke.WIN, args.reps
    kw = dict(win=win, min_eig_thresh=chip_smoke.MIN_EIG)
    res = {"card": smi, "reps": reps, "other": args.other}
    times = {name: {"entry_point_us": [], "wrapper_us": []} for name in mods}
    for _ in range(args.rounds):
        for name in (("other", "this", "this", "other") if args.other else ("this",)):
            m = mods[name]
            times[name]["entry_point_us"].append(per_call_us(
                lambda: m.build_lk_templates_lk(prev, pts, valid, device=dev, **kw), reps))
            times[name]["wrapper_us"].append(per_call_us(
                lambda: m.lk_cache_build_cuda(prev, pts, valid, **kw), reps))
    res["us"] = times
    res["mean_us"] = {name: {k: sum(v) / len(v) for k, v in t.items()} for name, t in times.items()}
    res["report"] = {k: (v._asdict() if hasattr(v, "_asdict") else v)
                     for k, v in lk.lk_cache_build_cuda.report.items()}

    built = lk.lk_cache_build_cuda(prev, pts, valid, **kw)
    leaves = [t[k] for t in built if t is not None for k in lk._CACHE_KEYS]
    n_l, (N,), keys = sum(t is not None for t in built), pts.shape[:-1], lk._CACHE_KEYS
    tensors = [*prev, pts, valid]

    def allocate_three():
        w = torch.empty((3 * n_l, N, win, win), dtype=torch.float32, device=dev).unbind(0)
        i = torch.empty((3 * n_l, N), dtype=torch.float32, device=dev).unbind(0)
        g = torch.empty((n_l, N), dtype=torch.bool, device=dev).unbind(0)
        return w, i, g

    def ctypes_table():
        ptrs = (ctypes.c_void_p * (10 * n_l))()
        for i in range(n_l):
            ptrs[10 * i:10 * i + 10] = [prev[i].data_ptr(), None, None] + [
                leaves[7 * i + j].data_ptr() for j in range(7)]
        return (ptrs, (ctypes.c_longlong * n_l)(), (ctypes.c_int * (2 * n_l))(),
                (ctypes.c_float * n_l)())

    def guard():
        with torch.cuda.device(dev):
            pass

    lib = lk._lib()
    ptrs, strides, ints, divs = ctypes_table()
    for i in range(n_l):
        strides[i] = prev[i].shape[0] * prev[i].shape[1]
        ints[2 * i:2 * i + 2] = list(prev[i].shape)
        divs[i] = 2.0 ** i
    rep = (ctypes.c_int * 8)()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = lib.lk_cache_build_launch(ptrs, strides, ints, divs, n_l, pts.data_ptr(),
                                       valid.data_ptr(), N, 1, win, chip_smoke.MIN_EIG, stream, rep)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")

    steps = {
        "resolve_device": lambda: resolve_device(dev),
        "device_checks": lambda: [t.device.type != "cuda" for t in tensors],
        "contiguous": lambda: ([p.contiguous() for p in prev], pts.contiguous(),
                               valid.contiguous()),
        "allocate_three_unbound": allocate_three,
        "dicts": lambda: [dict(zip(keys, leaves[7 * i:7 * i + 7])) for i in range(n_l)],
        "ctypes_table": ctypes_table,
        "device_guard": guard,
        "current_device": torch.cuda.current_device,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "launcher": launch,
    }
    res["steps_us"] = {name: per_call_us(fn, reps) for name, fn in steps.items()}
    if args.path:
        turns = ("other", "this", "this", "other") if args.other else ("this",)
        res["path"] = {name: [] for name in mods}
        for name in turns:
            res["path"][name].append(path_with_host_clocks(dev, chip_smoke, lk, mods[name]))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
