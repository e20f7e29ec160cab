#!/usr/bin/env python3
"""Time an LK kernel built from two CUDA sources on one card.

    python3 scripts/lk_kernel_ab.py --other OTHER/kimera_vio_tpu_torch/csrc/lk_kernel.cu
    python3 scripts/lk_kernel_ab.py --replace OLD NEW [--replace ...] \\
        --case 61:none:752x480 --case 101:none:752x480
    python3 scripts/lk_kernel_ab.py --kernel cached --other OTHER/.../lk_kernel.cu --tol 0.01 \\
        --case 24:752x480 --case 24:1241x376 --case 24:752x480:4 --case 53:752x480
    python3 scripts/lk_kernel_ab.py --kernel build --other OTHER/.../lk_kernel.cu \\
        --case 24:752x480 --case 24:752x480:4 --case 24:752x480:1:grads --case 241:752x480

`--kernel pyramid` (the default) times `lk_pyramid_kernel` / `lk_wide_kernel`
(C interface `lk_pyramid_launch`), `--kernel cached` the default tracker's
`lk_cached_kernel` (`lk_cached_launch`), `--kernel build` its cache build
`lk_cache_build_kernel` (`lk_cache_build_launch`).

Builds the other library with the same nvcc flags as this checkout's
csrc/lk_kernel.cu (the C interface of the kernel timed must be the same):
from `--other`, or from this checkout's source with each `--replace` OLD
text (which must occur exactly once) replaced by NEW. Then times one frame
of each `--case` through each library in turns: other, this, this, other,
`--rounds` times. Pyramid cases are WIN:SEARCH_ROWS:SIZE (SEARCH_ROWS
`none` is the gather rule; SIZE 752x480 or 1241x376); the default is the
main path (chip_smoke.main_lk_inputs: 752x480, 5 levels, 256 keypoints, win
24, 56-row search window); other cases take chip_smoke.wide_inputs
(keypoints more than win / 2 + 2 px inside). Cached and build cases are
WIN:SIZE[:B[:grads]]: chip_smoke.main_lk_inputs (752x480) or kitti_lk_inputs
(1241x376) at that window, or with B > 1 chip_smoke.fleet_lk_inputs (B
752x480 streams in one launch); `grads` (build cases) resamples each
level's full-image Scharr gradients (`prev_grads`). The default is
24:752x480, 24:1241x376 and 24:752x480:4. Cached cases track against the
plain cache of the case. Each time is the device time of a CUDA-graph
replay of one launch (chip_smoke.graph_ms); build cases also time both
sides eagerly (chip_smoke.time_ms: the host's launch path included) and
the plain `optical_flow.build_lk_templates` once each way. Tracker outputs
must be identical, or with `--tol` the same `ok` and positions within TOL
px; both sides' caches must pass chip_smoke.check_cache against the plain
build, and their template, gx and gy windows and gates are compared with
each other (`windows_identical`; the inverses, summed in another order,
by their largest relative difference). Prints the card's name and
power limit, then one JSON line per case with the route and shared memory
each library's launcher chose (on the cached routes also the keypoints a
block), each side's time with no Gauss-Newton step and
its µs a step on the longest chain (trackers) and, where its launcher
reports them (`lk_pyramid_cuda.report`), the cluster size, threads and band
rows of the plan and the clusters the card holds at once; for the build,
each side's launch report as its library wrote it (shared memory, and
the plan, or null from a library that reports none). Needs a card;
exits 2 without one.

A sweep over lk_wide's cluster size: `--replace` the plan's candidates,
e.g. "kWideClusters[] = {1, 2, 4, 8}" by "kWideClusters[] = {4}". The
cached tracker's block route at 24 px against its warp route: `--replace
"win == kCachedWarpWin && slack" "false && slack"` (the other side then
takes the block routes everywhere). The cache build's rows staged in shared
memory at every width against this source's plan: `--replace
"kBuildStageFrom = 48;" "kBuildStageFrom = 2;"`.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from kimera_vio_tpu_torch.ops import lk_kernel as lk  # noqa: E402
from kimera_vio_tpu_torch.ops import optical_flow as of  # noqa: E402

SOURCE = os.path.join(os.path.dirname(lk.__file__), os.pardir, "csrc", "lk_kernel.cu")


def other_source(args) -> str:
    """The other library's source: `--other`, or this checkout's source
    with the `--replace` edits, written into _build/."""
    if args.other:
        return args.other
    text = open(SOURCE).read()
    for old, new in args.replace:
        if text.count(old) != 1:
            raise ValueError(f"--replace: {old!r} occurs {text.count(old)} times, not once")
        text = text.replace(old, new)
    lk._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = lk._BUILD_DIR / f"lk_other_{hashlib.sha256(text.encode()).hexdigest()[:16]}.cu"
    src.write_text(text)
    return str(src)


def build_other(src: str) -> ctypes.CDLL:
    """Compile `src` with the kernel's nvcc flags into _build/ and load it
    with the same argument types as this checkout's library."""
    data = open(src, "rb").read()
    key = hashlib.sha256(data + " ".join(lk._NVCC_FLAGS).encode()).hexdigest()[:16]
    so = lk._BUILD_DIR / f"liblk_other_{key}.so"
    if not so.exists():
        lk._BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([lk._nvcc(), *lk._NVCC_FLAGS, "-o", str(so), src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    other = ctypes.CDLL(str(so))
    this = lk._lib()
    for name in ("lk_pyramid_launch", "lk_cached_launch", "lk_cache_build_launch",
                 "lk_error_string"):
        if hasattr(other, name):
            getattr(other, name).argtypes = getattr(this, name).argtypes
            getattr(other, name).restype = getattr(this, name).restype
    return other


def parse_case(text: str) -> tuple:
    """WIN:SEARCH_ROWS:SIZE (pyramid) or WIN:SIZE[:B[:grads]] (cached,
    build), as given: the kernel decides which."""
    return tuple(text.split(":"))


def cached_case(dev, case: tuple) -> tuple:
    """(label, prev_pyr, cur_pyr, keypoints, valid, win) of a WIN:SIZE[:B] case."""
    win, size, n = int(case[0]), case[1], int(case[2]) if len(case) > 2 else 1
    if n > 1:
        if size != "752x480":
            raise ValueError("cases with streams are 752x480")
        inp = chip_smoke.fleet_lk_inputs(dev, n)
        prev, cur, pts, valid = inp["prev"], inp["cur"], inp["pts"], inp["valid"]
    elif size == "752x480":
        prev, cur, pts, valid = chip_smoke.main_lk_inputs(dev)
    elif size == "1241x376":
        prev, cur, pts, valid = chip_smoke.kitti_lk_inputs(dev)
    else:
        raise ValueError(f"size {size}: 752x480 or 1241x376")
    return f"{size} win {win} B {n}", prev, cur, pts, valid, win


def compare(outs: dict, tol: float) -> dict:
    """The two libraries' outputs: identical, or (with tol) the same ok and
    positions within tol px where ok."""
    (pa, oka, ita), (pb, okb, itb) = outs["this"], outs["other"]
    identical = torch.equal(pa, pb) and torch.equal(oka, okb) and torch.equal(ita, itb)
    d = torch.linalg.norm(pa - pb, dim=-1)[oka & okb]
    max_d = float(d.max()) if d.numel() else 0.0
    if not identical and not (tol > 0 and torch.equal(oka, okb) and max_d < tol):
        raise AssertionError(f"the two kernels' outputs differ (max {max_d} px, tol {tol})")
    return {"outputs_identical": identical, "max_abs_diff": max_d, "tracked": int(oka.sum())}


def profiled_ms(fn, reps: int = 20) -> float:
    """Mean device time of the LK kernel over `reps` CUDA-graph replays of
    fn(), from a torch.profiler trace (the kernel alone, without the gaps
    between replays)."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    times = [e.device_time_total / e.count for e in prof.key_averages()
             if "lk_" in e.key and e.count and e.device_time_total > 0]
    if not times:
        raise RuntimeError("the profiler trace holds no LK kernel with device time")
    return max(times) / 1e3


def route_report(route: str) -> dict:
    """The last launch's shared memory on `route` and, where the library
    reports it, its plan and the clusters the card holds at once."""
    rep = lk.lk_pyramid_cuda.report[route]
    res = {"smem_bytes": rep["smem"]}
    if "plan" in rep:
        plan = rep["plan"]
        res.update(clusters=plan.clusters, threads=plan.threads, band_rows=plan.band_rows,
                   active_clusters=rep["active_clusters"])
    return res


def time_turns(fns: dict, rounds: int, timer) -> dict:
    """Each side's times in turns (other, this, this, other) and means."""
    times = {"other": [], "this": []}
    for _ in range(rounds):
        for name in ("other", "this", "this", "other"):
            times[name].append(timer(fns[name]))
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    return {"ms": times, "mean_ms": mean, "this_over_other": mean["this"] / mean["other"]}


def no_step_rows(res: dict, outs: dict, run) -> None:
    """Each side's launch with no Gauss-Newton step (setup on every level)
    and its cost a step on the longest chain of steps."""
    for name in outs:
        no_step = chip_smoke.graph_ms(lambda n=name: run(n, max_iter=0))
        chain = int(outs[name][2].reshape(-1, outs[name][2].shape[-1]).sum(dim=-1).max())
        res.setdefault("no_step_ms", {})[name] = no_step
        res.setdefault("max_chain_steps", {})[name] = chain
        res.setdefault("us_per_step", {})[name] = (
            1e3 * (res["mean_ms"][name] - no_step) / max(chain, 1))


def pyramid_case(dev, libs: dict, case: tuple, args, smi: str) -> dict:
    win, sr, size = int(case[0]), None if case[1] == "none" else int(case[1]), case[2]
    if (win, sr, size) == (24, 56, "752x480"):
        prev_pyr, cur_pyr, uv, valid = chip_smoke.main_lk_inputs(dev)
    else:
        prev_pyr, cur_pyr, uv, valid = chip_smoke.wide_inputs(dev, win, size)
    grads = [of._grad(p) for p in prev_pyr]
    call = (prev_pyr, cur_pyr, grads, uv, uv, valid)
    kw = {**chip_smoke.LK_KW, "win": win, "search_rows": sr}

    def run(name, **over):
        lk._lib = lambda: libs[name]  # the wrapper's library, swapped
        return lk.lk_pyramid_cuda(*call, **{**kw, **over})

    routes, outs = {}, {}
    for name in libs:
        lk.lk_pyramid_cuda.routes.clear()
        lk.lk_pyramid_cuda.report.clear()
        outs[name] = run(name)
        routes[name] = {r: route_report(r) for r in lk.lk_pyramid_cuda.routes}
    torch.cuda.synchronize()
    res = {"card": smi, "shape": f"{size} win {win} search_rows {sr}",
           "routes_and_smem_bytes": routes, **compare(outs, args.tol)}
    res.update(time_turns({n: (lambda n=n: run(n)) for n in libs}, args.rounds,
                          chip_smoke.graph_ms))
    no_step_rows(res, outs, run)
    if args.profile:
        res["profiled_kernel_ms"] = {name: profiled_ms(lambda n=name: run(n)) for name in libs}
    return res


def cached_case_row(dev, libs: dict, case: tuple, args, smi: str) -> dict:
    label, prev, cur, pts, valid, win = cached_case(dev, case)
    templates = of.build_lk_templates(prev, pts, valid, win=win)
    kw = {**chip_smoke.CACHED_KW, "win": win}

    def run(name, **over):
        lk._lib = lambda: libs[name]  # the wrapper's library, swapped
        return lk.lk_cached_cuda(templates, cur, pts, valid, **{**kw, **over})

    routes, outs = {}, {}
    for name in libs:
        lk.lk_cached_cuda.routes.clear()
        lk.lk_cached_cuda.report.clear()
        outs[name] = run(name)
        routes[name] = {r: lk.lk_cached_cuda.report[r] for r in lk.lk_cached_cuda.routes}
    torch.cuda.synchronize()
    res = {"card": smi, "kernel": "lk_cached", "shape": label, "routes_and_smem_bytes": routes,
           **compare(outs, args.tol)}
    res.update(time_turns({n: (lambda n=n: run(n)) for n in libs}, args.rounds,
                          chip_smoke.graph_ms))
    no_step_rows(res, outs, run)
    if args.profile:
        res["profiled_kernel_ms"] = {name: profiled_ms(lambda n=name: run(n)) for name in libs}
    return res


class ReportRecorder:
    """A kernel library whose cache-build launches copy their report ints
    into `into`; every other name is the library's own."""

    def __init__(self, lib, into: list):
        self._lib, self._into = lib, into

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def lk_cache_build_launch(self, *args):
        rc = self._lib.lk_cache_build_launch(*args)
        self._into[:] = list(args[-1])
        return rc


def build_case_row(dev, libs: dict, case: tuple, args, smi: str) -> dict:
    """lk_cache_build_kernel of two sources in turns, each held to the plain
    build; the plain build's own times beside them."""
    label, prev, _, pts, valid, win = cached_case(dev, case[:3])
    grads = [of._grad(p) for p in prev] if case[3:] == ("grads",) else None
    if case[3:] not in ((), ("grads",)):
        raise ValueError(f"case {':'.join(case)}: the fourth field is `grads` or nothing")
    label += " prev_grads" if grads else ""
    kw = {"win": win, "min_eig_thresh": chip_smoke.MIN_EIG, "prev_grads": grads}

    def run(name, lib=None):
        lk._lib = lambda: lib or libs[name]  # the wrapper's library, swapped
        return lk.lk_cache_build_cuda(prev, pts, valid, **kw)

    plain = of.build_lk_templates(prev, pts, valid, **kw)
    reports, outs, checks = {}, {}, {}
    for name in libs:
        # The launch report as the library wrote it: a library that
        # reports no plan leaves the ints after the shared memory at -1.
        rep = []
        outs[name] = run(name, ReportRecorder(libs[name], rep))
        torch.cuda.synchronize()
        reports[name] = {"smem": rep[0], "plan": lk.BuildPlan(
            lk.BUILD_ROUTES[rep[2]], *rep[3:6], rep[0], bool(rep[1]))._asdict()
            if rep[2] >= 0 else None}
        checks[name] = chip_smoke.check_cache(outs[name], plain, f"{label} ({name})")
    identical, inv_rel = True, 0.0
    for a, b in zip(outs["this"], outs["other"]):
        if a is None:
            continue
        identical = identical and all(torch.equal(a[k], b[k]) for k in ("tmpl", "gx", "gy", "good_g"))
        for k in ("inv00", "inv01", "inv11"):
            inv_rel = max(inv_rel, float((a[k] - b[k]).abs().max()
                                         / b[k].abs().max().clamp_min(1e-30)))
    if not identical:
        raise AssertionError(f"{label}: the two kernels' windows or gates differ")
    res = {"card": smi, "kernel": "lk_cache_build", "shape": label, "reports": reports,
           "checks": checks, "windows_identical": identical, "inv_max_rel_diff": inv_rel}
    fns = {n: (lambda n=n: run(n)) for n in libs}
    res.update(time_turns(fns, args.rounds, chip_smoke.graph_ms))
    eager = time_turns(fns, args.rounds, lambda fn: chip_smoke.time_ms(fn, reps=10))
    res.update(eager_ms=eager["ms"], eager_mean_ms=eager["mean_ms"],
               eager_this_over_other=eager["this_over_other"])
    if args.profile:
        res["profiled_kernel_ms"] = {n: profiled_ms(fns[n]) for n in libs}
    plain_fn = lambda: of.build_lk_templates(prev, pts, valid, **kw)  # noqa: E731
    res["plain_ms"] = {"graph": chip_smoke.graph_ms(plain_fn, reps=20),
                       "eager": chip_smoke.time_ms(plain_fn, reps=10)}
    res["bound_ms"], res["bound_by"] = chip_smoke.bound_ms(
        *chip_smoke.cached_build_work(prev, pts, win, grads is not None))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("pyramid", "cached", "build"), default="pyramid")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--other", help="the other lk_kernel.cu")
    src.add_argument("--replace", nargs=2, action="append", metavar=("OLD", "NEW"),
                     help="the other source: this one with OLD replaced by NEW")
    ap.add_argument("--case", action="append", type=parse_case,
                    help="pyramid: WIN:SEARCH_ROWS:SIZE, e.g. 61:none:752x480 (default "
                         "24:56:752x480); cached, build: WIN:SIZE[:B[:grads]], e.g. 24:752x480:4")
    ap.add_argument("--tol", type=float, default=0.0,
                    help="largest |d| in px between the outputs (default 0: identical)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="also each side's mean device time of the kernel in a torch.profiler "
                         "trace of 20 graph replays")
    args = ap.parse_args()
    if not (args.other or args.replace):
        ap.error(f"--kernel {args.kernel} needs --other or --replace")
    if not torch.cuda.is_available():
        print("lk_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    defaults = {"pyramid": [("24", "56", "752x480")],
                "cached": [("24", "752x480"), ("24", "1241x376"), ("24", "752x480", "4")]}
    defaults["build"] = defaults["cached"]
    libs = {"this": lk._lib(), "other": build_other(other_source(args))}
    for case in args.case or defaults[args.kernel]:
        if args.kernel == "pyramid":
            res = pyramid_case(dev, libs, case, args, smi)
        elif args.kernel == "cached":
            res = cached_case_row(dev, libs, case, args, smi)
        else:
            res = build_case_row(dev, libs, case, args, smi)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
