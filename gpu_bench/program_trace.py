"""The program's own spans in a traced run of a cell, beside the device
trace: where each keyframing stream-frame's host time goes, and which
calls wait on the card.

    python3 gpu_bench/program_trace.py --workload <cell> --seed <n> --seconds <s> [--program 0|1]
    python3 gpu_bench/program_trace.py --calibrate

from the root of a checkout, on a machine with the cell's cards. One run
of the cell as `run.py --trace 1` makes it, with the port's span recorder
(`kimera_vio_tpu_torch/utils/stats.py`) on over exactly the traced span
(`--program 0`: off, to measure what recording costs), and the CUDA
runtime's host-side calls kept from the same profiler trace beside the
device's activities. Prints on standard error the by-span table (calls,
median, total and self ms, host syncs and their wait) and the idle gaps
named by the innermost span at each gap's middle; then on standard
output one JSON line: the run's result line, and under "program" the
five keyframe metrics (`metrics/kf_*.py`), the table, the gaps, and the
step medians traced and untraced and the host time between steps. `--calibrate` prints only the clock check
(`clock_check`) and a span's cost off and on (`span_cost`), in a process
of its own: a process's later profiles may miss the device's activities.

A host sync is a runtime call that blocks the host until the card has
done work (`is_host_sync`); it belongs to the innermost program span open
at its start. The program's spans and the profiler's events are both on
the host's CLOCK_REALTIME (`time.time_ns()`), which `clock_check` tests
on the card.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

import numpy as np  # noqa: E402

import harness  # noqa: E402

# CUDA runtime and driver calls that return only once the card has done
# the work they wait on: every synchronize, and the copies that are not
# asynchronous.
SYNC_COPIES = ("cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cuMemcpy", "cuMemcpyDtoH",
               "cuMemcpyHtoD", "cuMemcpyDtoD")
KEYFRAME_PARTS = ("frontend.keyframe_branch", "pipeline.keyframe_half")


def is_host_sync(name: str) -> bool:
    return "Synchronize" in name or name.removesuffix("_v2") in SYNC_COPIES


def is_runtime_call(name: str) -> bool:
    """A CUDA runtime or driver API call (the host side of a CUDA trace)."""
    return name.startswith("cu")


# ---------------------------------------------------------------------------
# The profiler: the harness's, with the program's recorder and the runtime


class SpanProfiler(harness.Profiler):
    """`harness.Profiler` that also turns the program's span recorder on
    and off with the trace (`program`), and keeps the trace's CUDA
    runtime calls [(name, start_ns, end_ns)] in `runtime`. `stop` returns
    the device's activities exactly as `harness.Profiler.stop` does."""

    def __init__(self, device, program: bool = True):
        super().__init__(device)
        self.program = program

    def start(self):
        from kimera_vio_tpu_torch.utils import stats

        super().start()
        if self.program:
            stats.start_recording()

    def stop(self) -> list:
        from kimera_vio_tpu_torch.utils import stats

        self.spans = stats.stop_recording() if self.program else []
        self.prof.stop()
        events = list(self.prof.profiler.kineto_results.events())
        self.runtime = sorted(
            (e.name(), int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()))
            for e in events if "CUDA" not in str(e.device_type()) and is_runtime_call(e.name()))
        # the harness's own reading of the same events, from a profile
        # already stopped
        self.prof = SimpleNamespace(stop=lambda: None, profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events)))
        return super().stop()


def traced_execute(root: Path, name: str, seed: int, seconds: float, device, t_process: float,
                   program: bool = True, bench_dir: Path = harness.BENCH_DIR) -> tuple:
    """`harness.execute` traced, through `SpanProfiler`. Returns (result
    line, numbers, the run) with `run.trace.program` (the spans) and
    `.runtime` set."""
    profilers, runs = [], []
    run_fleet, profiler = harness.run_fleet, harness.Profiler

    def recording(dev):
        profilers.append(SpanProfiler(dev, program))
        return profilers[-1]

    def kept(*a, **kw):
        out = run_fleet(*a, **kw)
        runs.append(out[0])
        return out

    harness.run_fleet, harness.Profiler = kept, recording
    try:
        result, nums = harness.execute(root, name, seed, seconds, True, device, t_process,
                                       bench_dir=bench_dir)
    finally:
        harness.run_fleet, harness.Profiler = run_fleet, profiler
    run, prof = runs[0], profilers[0]
    run.trace.program, run.trace.runtime = prof.spans, prof.runtime
    return result, nums, run


# ---------------------------------------------------------------------------
# The span tree


def children(spans: list) -> dict:
    """index -> its children, in the order they began."""
    kids = {s.index: [] for s in spans}
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append(s)
    return kids


def self_ns(spans: list) -> dict:
    """index -> the span's duration less the part its children cover."""
    kids = children(spans)
    out = {}
    for s in spans:
        covered, end = 0, s.start_ns
        for c in kids[s.index]:
            a, b = max(c.start_ns, end), min(c.end_ns, s.end_ns)
            if b > a:
                covered += b - a
                end = b
        out[s.index] = s.end_ns - s.start_ns - covered
    return out


def sync_owners(spans: list, runtime: list) -> list:
    """[(owner index or None, name, wait ns)] of each host sync: the
    innermost span open at its start (the port's spans on the traced path
    run on one host thread)."""
    kids = children(spans)
    roots = [s for s in spans if s.parent is None]
    out = []
    for name, a, b in runtime:
        if not is_host_sync(name):
            continue
        owner, level = None, roots
        while True:
            starts = [s.start_ns for s in level]
            i = bisect.bisect_right(starts, a) - 1
            if i < 0 or level[i].end_ns < a:
                break
            owner = level[i]
            level = kids[owner.index]
        out.append((None if owner is None else owner.index, name, b - a))
    return out


def by_span(spans: list, runtime: list) -> list:
    """Per span name, most self time first: [name, calls, median ms,
    total ms, self ms, host syncs, sync wait ms]."""
    own = self_ns(spans)
    syncs = {}
    for idx, _, wait in sync_owners(spans, runtime):
        if idx is not None:
            n, w = syncs.get(idx, (0, 0))
            syncs[idx] = (n + 1, w + wait)
    rows = {}
    for s in spans:
        r = rows.setdefault(s.name, [[], 0, 0, 0])
        r[0].append(s.end_ns - s.start_ns)
        r[1] += own[s.index]
        n, w = syncs.get(s.index, (0, 0))
        r[2] += n
        r[3] += w
    table = [[name, len(d), float(np.median(d)) * 1e-6, sum(d) * 1e-6, own_ns * 1e-6, n,
              w * 1e-6] for name, (d, own_ns, n, w) in rows.items()]
    return sorted(table, key=lambda r: -r[4])


def keyframe_frames(spans: list) -> dict:
    """(step, stream) -> that stream-frame's spans, for each stream-frame
    with a keyframe branch."""
    frames = {}
    for s in spans:
        if "step" in s.ids and "b" in s.ids:
            frames.setdefault((s.ids["step"], s.ids["b"]), []).append(s)
    return {k: v for k, v in frames.items()
            if any(s.name == "frontend.keyframe_branch" for s in v)}


def program_spans(run) -> list | None:
    return None if run.trace is None else getattr(run.trace, "program", None)


def per_keyframe(run, value) -> float | None:
    """The median over the traced span's keyframing stream-frames of
    `value(the stream-frame's spans)`; None without program spans."""
    frames = keyframe_frames(program_spans(run) or [])
    if not frames:
        return None
    return float(np.median([value(f) for f in frames.values()]))


def summed_ms(frame: list, name: str) -> float:
    return sum(s.end_ns - s.start_ns for s in frame if s.name == name) * 1e-6


def keyframe_syncs(run) -> float | None:
    """`per_keyframe` of the host syncs under a stream-frame's keyframe
    branch and keyframe half; None without runtime calls."""
    runtime = None if run.trace is None else getattr(run.trace, "runtime", None)
    spans = program_spans(run)
    if not runtime or not spans:
        return None
    by_index = {s.index: s for s in spans}
    under = {}  # keyframe branch or half -> its syncs
    for idx, _, _ in sync_owners(spans, runtime):
        s = by_index.get(idx)
        while s is not None and s.name not in KEYFRAME_PARTS:
            s = by_index.get(s.parent)
        if s is not None:
            under[s.index] = under.get(s.index, 0) + 1
    return per_keyframe(run, lambda f: sum(under.get(s.index, 0) for s in f
                                           if s.name in KEYFRAME_PARTS))


# ---------------------------------------------------------------------------
# The clock


def clock_check(device) -> dict:
    """One kernel launched inside a program span between two reads of
    `time.time_ns()`, each after a synchronise, under `SpanProfiler`.
    Returns the reads, the span, the launch call and the kernel's device
    interval (ns) and the offsets between them."""
    import torch

    from kimera_vio_tpu_torch.utils.stats import span

    x = torch.zeros(1 << 20, device=device)
    x.add_(1.0)
    torch.cuda.synchronize(device)
    prof = SpanProfiler(device)
    prof.start()
    torch.cuda.synchronize(device)
    t0 = time.time_ns()
    with span("clock_check"):
        x.add_(1.0)
    torch.cuda.synchronize(device)
    t1 = time.time_ns()
    device_events = prof.stop()
    kernels = [(a, b) for _, kind, a, b in device_events if kind == "kernel"]
    launches = [(a, b) for n, a, b in prof.runtime if "LaunchKernel" in n]
    spans = [(s.start_ns, s.end_ns) for s in prof.spans]
    out = {"t0": t0, "t1": t1, "span": spans, "launch": launches, "kernel": kernels}
    if len(kernels) == len(launches) == len(spans) == 1:
        (sa, sb), (la, lb), (ka, kb) = spans[0], launches[0], kernels[0]
        out["offsets_us"] = {"span_start_after_t0": (sa - t0) * 1e-3,
                             "launch_start_after_span_start": (la - sa) * 1e-3,
                             "span_end_after_launch_end": (sb - lb) * 1e-3,
                             "kernel_start_after_launch_start": (ka - la) * 1e-3,
                             "t1_after_kernel_end": (t1 - kb) * 1e-3}
    return out


# ---------------------------------------------------------------------------
# One traced run


OUTSIDE = "host outside the layers' calls"  # harness.breakdown's name for a gap in no span
BETWEEN_STEPS = "between fleet.step calls (the harness's loop)"


def report(run) -> dict:
    """The program's side of a traced run: the five keyframe metrics, the
    by-span table, the idle gaps named by the program's spans and the
    harness's together (a gap in no span lies between two
    `fleet.step` calls, in the harness's own loop), the share of each
    keyframing `fleet.step` its child spans cover, the step medians
    traced and untraced, and the host time between the window's steps."""
    tr = run.trace
    metrics = {n: harness.reader(n)(run) for n in ("kf_branch_ms", "kf_backend_ms",
                                                   "kf_imu_factors_ms", "kf_fleet_self_ms",
                                                   "kf_host_syncs")}
    named = harness.Trace(device=tr.device, window_s=tr.window_s, stream_frames=tr.stream_frames,
                          host=tr.host + [(s.name, s.start_ns, s.end_ns) for s in tr.program])
    # every `fleet.step` is a span, so a gap in no span lies between two
    gaps = [[BETWEEN_STEPS if tr.program and name == OUTSIDE else name, g]
            for name, g in harness.breakdown(named, top=20)["idle_gaps"]]
    own = self_ns(tr.program)
    kf_steps = {k[0] for k in keyframe_frames(tr.program)}
    covered = [1.0 - own[s.index] / (s.end_ns - s.start_ns) for s in tr.program
               if s.name == "fleet.step" and s.ids["step"] in kf_steps]
    # the host time between untraced steps (the trace's own stop falls
    # between the traced span and the rest)
    untraced = [s for s in run.steps if not s.traced]
    between = [(b.start - a.done) * 1e3 for a, b in zip(untraced, untraced[1:])]

    def med(steps):
        return float(np.median([s.ms for s in steps])) if steps else None

    return {"metrics": metrics, "by_span": by_span(tr.program, tr.runtime),
            "idle_gaps": gaps, "kf_step_covered_by_children": covered,
            "steps_ms": {f"{'traced' if t else 'untraced'}_{kind}": med(
                [s for s in run.steps if s.traced == t and s.keyframe == kf])
                for t in (True, False) for kind, kf in (("tracking", False),
                                                        ("keyframe", True))},
            "between_steps_ms": {
                "median": float(np.median(between)) if between else None,
                "untraced_share": sum(between) * 1e-3 / (untraced[-1].done - untraced[0].start)
                if between else None}}


def span_cost(n: int = 600, reps: int = 50) -> dict:
    """Median ns a `with span(...)` takes, recording off and on, over
    `reps` recordings of `n` spans (a traced span's count; host only)."""
    from kimera_vio_tpu_torch.utils import stats

    out = {}
    for on in (False, True):
        per = []
        for _ in range(reps):
            if on:
                stats.start_recording()
            t = time.perf_counter_ns()
            for _ in range(n):
                with stats.span("fleet.stream", b=1):
                    pass
            per.append((time.perf_counter_ns() - t) / n)
            stats.stop_recording()
        out["on" if on else "off"] = float(np.median(per))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    ap.add_argument("--calibrate", action="store_true",
                    help="only the clock check and the recorder's cost a span, in a fresh process")
    args = ap.parse_args(argv)

    import run as run_py  # the cache paths and sys.path of run.py

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.calibrate:
        # the process's first profile: a later one may miss the device's activities
        print(json.dumps({"clock": clock_check(dev), "span_ns": span_cost()}))
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        ap.error("--workload, --seed and --seconds are required")
    cell = harness.cell_entry(harness.load_spec(run_py.ROOT), args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s)", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, nums, run = traced_execute(run_py.ROOT, args.workload, args.seed, args.seconds, dev,
                                       T_PROCESS, program=bool(args.program))
    rep = report(run)
    print("reference: " + json.dumps(nums), file=sys.stderr)
    print(f"{'span':<26}{'calls':>7}{'median ms':>11}{'total ms':>11}{'self ms':>11}"
          f"{'syncs':>7}{'wait ms':>10}", file=sys.stderr)
    for name, n, med, tot, own, syncs, wait in rep["by_span"]:
        print(f"{name:<26}{n:>7}{med:>11.3f}{tot:>11.2f}{own:>11.2f}{syncs:>7}{wait:>10.2f}",
              file=sys.stderr)
    for name, s in rep["idle_gaps"]:
        print(f"gap {s * 1e3:.3f} ms in {name}", file=sys.stderr)
    result["program"] = rep
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
