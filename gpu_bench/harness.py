"""One run of one cell of the port's benchmark: set-up, the measured
window, the check of `correct`, and the metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name `BENCHMARK.json` gives it:
`configs/<config>.json` (the deployment: rig, IMU, Kimera-VIO's
parameters), `workloads/<cell>.json` (the traffic: motion, streams,
warm-up, sampling, the limits of `correct`) and `metrics/<metric>.py` (one
reader each: `read(run) -> float | None`).

The loop is closed: a robot's next frame goes in when its last one is
done. A cell drives `FleetVio(params, B).step` once per fleet frame,
timed on the host around each call, the card synchronised after it.

The window is whole keyframe cycles of a full smoother horizon. Warm-up
runs until every stream has made `warmup_keyframes` keyframes (the
25-keyframe horizon full and marginalizing); the window then opens after
a keyframing fleet frame and closes at the first keyframing fleet frame
`seconds` later, or earlier, once a stream has made `last_keyframe`
keyframes: however fast the program runs, the window ends short of the
keyframe at which its smoother loses positive definiteness (PERF.md).
A keyframe that took the smoother's recovery path makes a run not
correct.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

import reference
import roofline
import scene as scene_mod

BENCH_DIR = Path(__file__).resolve().parent
# Top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was made from, compared whole.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "kimera_vio_tpu")


# ---------------------------------------------------------------------------
# Discovery


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_entry(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(spec: dict, cell: dict, root: Path) -> dict:
    for c in spec["configs"]:
        if c["name"] == cell["config"]:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")


def workload_of(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "workloads" / f"{name}.json") as f:
        return json.load(f)


def metrics_for(spec: dict, cell: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries a cell reports."""
    return [m for m in spec[kind] if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """`read(run)` of metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("gpu_bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


# ---------------------------------------------------------------------------
# What a run records


@dataclass
class Frame:
    """One fleet step of the window: hand-off and done on the host clock
    (s), whether its streams keyframed, whether it lies in the traced
    span."""

    start: float
    done: float
    keyframe: bool
    traced: bool = False

    @property
    def ms(self) -> float:
        return (self.done - self.start) * 1e3


@dataclass
class Trace:
    """The traced span: device activities [(name, kind, start_ns, end_ns)]
    on the profiler's clock, host spans [(layer, start_ns, end_ns)] on the
    wall clock, the span's host length, the stream-frames in it, and the
    LK launches' work [(kernel, bytes, flops)] in launch order."""

    device: list
    host: list
    window_s: float
    stream_frames: int
    lk_work: list = field(default_factory=list)


@dataclass
class Run:
    """What the metric readers read."""

    cell: str
    streams: int
    setup_s: float
    window_s: float
    steps: list  # Frame, the window's fleet steps
    trace: Trace | None = None

    @property
    def stream_frames(self) -> int:
        return len(self.steps) * self.streams


# ---------------------------------------------------------------------------
# The system under test's inputs


def vio_params(cfg: dict):
    """VioParams of a configuration: the port's defaults (Kimera-VIO's
    params/Euroc) with the configuration's rig, IMU and overrides."""
    from kimera_vio_tpu_torch.config.params import CameraParams, VioParams

    cam = cfg["camera"]

    def camera(cid: str, x: float) -> CameraParams:
        T = np.eye(4)
        T[0, 3] = x
        return CameraParams(camera_id=cid, T_BS=T, rate_hz=float(cam["rate_hz"]),
                            width=int(cam["width"]), height=int(cam["height"]),
                            intrinsics=np.array([cam["fx"], cam["fy"], cam["cx"], cam["cy"]], float),
                            distortion_model="none", distortion_coeffs=np.zeros(4))

    p = VioParams()
    p.left_cam = camera("cam0", 0.0)
    p.right_cam = camera("cam1", float(cam["baseline"]))
    p.pipeline.parallel_run = False
    for group in ("imu", "frontend", "backend"):
        for k, v in cfg.get("params", {}).get(group, {}).items():
            if not hasattr(getattr(p, group), k):
                raise KeyError(f"{cfg['name']}: {group} has no parameter {k!r}")
            setattr(getattr(p, group), k, v)
    p.imu.rate_hz = float(cfg["imu"]["rate_hz"])
    for k in ("max_features", "max_landmarks"):
        setattr(p, k, int(cfg[k]))
    return p


class Stream:
    """One robot's frames: global frame K is period frame (K + offset) mod
    n, stamped K / fps from 0."""

    def __init__(self, scn: scene_mod.Scene, offset: int):
        self.scene, self.offset = scn, int(offset)
        self.frame_ns = int(round(1e9 / scn.rig.fps))

    def period_frame(self, K: int) -> int:
        return (K + self.offset) % self.scene.n_frames

    def truth(self, K: int, dtype=torch.float64) -> dict:
        return self.scene.state(self.scene.frame_time(self.period_frame(K)), dtype)


# ---------------------------------------------------------------------------
# Host spans around the calls into each layer, and the correctness capture


class Spans:
    """Host spans (wall-clock ns) recorded while `on`."""

    def __init__(self):
        self.on = False
        self.spans = []

    def wrap(self, obj, attr: str, layer):
        """Time obj.attr (an instance's method) under `layer` (a name, or a
        function of the call's result giving one)."""
        fn = getattr(obj, attr)

        def timed(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            t0 = time.time_ns()
            out = fn(*a, **kw)
            self.spans.append((layer(out) if callable(layer) else layer, t0, time.time_ns()))
            return out

        setattr(obj, attr, timed)


class LkWork:
    """Inside its `with` and while `spans.on` (the traced span), records the
    work of each launch of the two LK kernels (roofline.cached_work,
    cached_build_work) from the launcher calls' arguments and results; the
    launchers' own counters keep counting."""

    NAMES = ("lk_cached_cuda", "lk_cache_build_cuda")

    def __init__(self, spans: Spans):
        from kimera_vio_tpu_torch.ops import lk_kernel
        self.lk = lk_kernel
        self.spans = spans
        self.orig = {n: getattr(lk_kernel, n) for n in self.NAMES}
        self.calls = []

    def __enter__(self):
        lk, calls, spans = self.lk, self.calls, self.spans
        cached, build = self.orig["lk_cached_cuda"], self.orig["lk_cache_build_cuda"]

        def lk_cached_cuda(templates, cur_pyr, init_pts, valid, *, win, **kw):
            out = cached(templates, cur_pyr, init_pts, valid, win=win, **kw)
            if spans.on:
                calls.append(("lk_cached", [tuple(c.shape[-2:]) for c in cur_pyr],
                              [t is not None for t in templates], init_pts, out[0], valid,
                              out[2], win))
            return out

        def lk_cache_build_cuda(prev_pyr, prev_pts, valid, *, win, prev_grads=None, **kw):
            out = build(prev_pyr, prev_pts, valid, win=win, prev_grads=prev_grads, **kw)
            if spans.on:
                calls.append(("lk_cache_build", [tuple(p.shape[-2:]) for p in prev_pyr],
                              prev_pts, valid, win, prev_grads is not None))
            return out

        for new, old in ((lk_cached_cuda, cached), (lk_cache_build_cuda, build)):
            new.__dict__.update(old.__dict__)  # the launch counters, routes and reports
            setattr(lk, old.__name__, new)
        return self

    def __exit__(self, *exc):
        for n, old in self.orig.items():
            old.__dict__.update(getattr(self.lk, n).__dict__)
            setattr(self.lk, n, old)

    def work(self) -> list:
        out = []
        for c in self.calls:
            if c[0] == "lk_cached":
                _, shapes, tracked, init, pts, valid, iters, win = c
                nb, fl = roofline.cached_work(shapes, tracked, init, pts, valid, iters, win)
            else:
                _, shapes, pts, valid, win, grads = c
                nb, fl = roofline.cached_build_work(shapes, pts, valid, win, grads)
            out.append((c[0], nb, fl))
        return out


def lk_counts() -> tuple[int, int]:
    """The program's launch counters: (lk_cached_kernel, lk_cache_build_kernel)."""
    from kimera_vio_tpu_torch.ops import lk_kernel as lk
    return lk.lk_cached_cuda.launches, lk.lk_cache_build_cuda.launches


def seed_rng(seed: int, *keys: int) -> np.random.Generator:
    """A generator drawn from --seed (any whole number) and keys."""
    return np.random.default_rng([seed % (2**64), *keys])


def _sampled(seed: int, key: int, share: float) -> bool:
    """Whether frame `key` is in the seed's sample (the same frames for a
    seed whatever the run's speed)."""
    return seed_rng(seed, key).random() < share


# ---------------------------------------------------------------------------
# The profiler


class Profiler:
    """torch.profiler over the traced span, CUDA activity only (the host's
    side comes from `Spans`, which cost no profiler callback per op)."""

    def __init__(self, device):
        self.prof = None
        self.device = device

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        # A CPU run (the tests' rehearsal) has no device activity to record.
        act = ProfilerActivity.CUDA if self.device.type == "cuda" else ProfilerActivity.CPU
        self.prof = profile(activities=[act])
        self.prof.start()

    def stop(self) -> list:
        """[(name, kind, start_ns, end_ns)] of the device's activities."""
        self.prof.stop()
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            name = e.name()
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            start = int(e.start_ns())
            out.append((name, kind, start, start + int(e.duration_ns())))
        self.prof = None
        out.sort(key=lambda a: a[2])
        return out


# ---------------------------------------------------------------------------
# Fleet


def _imu_blocks(scn: scene_mod.Scene, capacity: int) -> list:
    from kimera_vio_tpu_torch.common.types import ImuBlock

    acc, gyr = scn.imu_period()
    out = []
    for k in range(scn.n_frames):
        a, g, dt, m = scn.imu_block_arrays(k, acc, gyr, capacity)
        out.append(ImuBlock(acc=torch.from_numpy(a), gyr=torch.from_numpy(g),
                            dt=torch.from_numpy(dt), mask=torch.from_numpy(m)))
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def run_fleet(params, scn, wl: dict, seed: int, seconds: float, trace: bool, device,
              t_process: float, faults=None):
    """One fleet run: B streams of the period, each from its own
    seed-drawn phase, through FleetVio.step."""
    from kimera_vio_tpu_torch.common.types import ImuBlock, NavState
    from kimera_vio_tpu_torch.parallel.fleet import FleetVio

    B = int(wl["streams"])
    streams = [Stream(scn, int(o)) for o in
               seed_rng(seed).choice(scn.n_frames, size=B, replace=False)]
    left, right = scn.render_period()
    blocks = _imu_blocks(scn, int(wl.get("imu_capacity", 16)))
    fleet = FleetVio(params, B, device=device)
    pipe = fleet._pipes[0]
    spans = Spans()
    spans.wrap(pipe.frontend, "track_async", "frontend.track_async (pyramid, preintegration, LK)")
    spans.wrap(pipe.frontend, "finish", lambda out: "frontend.finish keyframe branch"
               if out[1]["is_keyframe"] else "frontend.finish")
    spans.wrap(pipe, "_keyframe_half", "pipeline._keyframe_half (guess, backend)")
    if faults:
        faults(pipe=pipe, fleet=fleet)

    def images(K):
        ks = [s.period_frame(K) for s in streams]
        return torch.from_numpy(left[ks]), torch.from_numpy(right[ks])

    t0s = [s.truth(0) for s in streams]
    navs = NavState(rot=torch.as_tensor(np.stack([t["rot"] for t in t0s]), dtype=torch.float32),
                    pos=torch.as_tensor(np.stack([t["pos"] for t in t0s]), dtype=torch.float32),
                    vel=torch.as_tensor(np.stack([t["vel"] for t in t0s]), dtype=torch.float32))
    state = fleet.init(*images(0), navs)
    warmup, last = int(wl["warmup_keyframes"]), int(wl["last_keyframe"])
    share = float(wl["check_share"])
    trace_cycles = int(wl["trace_cycles"]) if trace else 0
    trace_steps = 0  # the traced span's steps, once it has closed
    made = np.ones(B, np.int64)  # keyframes each stream has made, the bootstrap's first
    last_kf = {}  # stream -> (K, kp_uv view, kp_ids view, keyframe row)
    tracks, lmks, kfs, steps = [], [], {b: [] for b in range(B)}, []
    recovered = []  # (in the window, n_recovered view) of every keyframe of the run
    prof, work, counts, device_events, span = Profiler(device), None, {}, None, None
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    clock = time.perf_counter
    K, t_window, w, after_kf = 1, None, None, False
    while True:
        now = clock()
        if w is None and made.min() >= warmup and after_kf:
            w, t_window = K, now
            counts["start"] = lk_counts()
            if trace_cycles:
                sync()
                prof.start()
                spans.on = True
                work = LkWork(spans).__enter__()
        if trace_cycles and w is not None and after_kf and device_events is None \
                and sum(s.keyframe for s in steps) == trace_cycles:
            sync()
            spans.on = False
            device_events = prof.stop()
            work.__exit__(None, None, None)
            trace_steps = len(steps)
            span = (steps[0].start, steps[-1].done)
        if w is not None and K > w and after_kf and (now - t_window >= seconds
                                                     or made.max() >= last):
            break
        ks = [s.period_frame(K) for s in streams]
        imu = ImuBlock(*(torch.stack([getattr(blocks[k], f) for k in ks])
                         for f in ("acc", "gyr", "dt", "mask")))
        lefts, rights = images(K)
        stamps = np.full(B, K / scn.rig.fps, np.float32)
        t0 = clock()
        state, out = fleet.step(state, lefts, rights, imu, stamps)
        sync()
        t1 = clock()
        is_kf = out["is_keyframe"]
        made += is_kf
        after_kf = bool(is_kf.any())
        in_window = w is not None and K >= w
        if in_window:
            steps.append(Frame(t0, t1, after_kf, spans.on))
        for b in range(B):
            if is_kf[b]:
                row = (K, out["rot"][b], out["pos"][b], out["vel"][b], out["bias"][b])
                recovered.append((in_window, out["n_recovered"][b]))
                if in_window:
                    if not kfs[b] and b in last_kf:
                        kfs[b].append(last_kf[b][3])
                    kfs[b].append(row)
                    lmks.append((K, b, out["lmk_points"][b], out["lmk_valid"][b],
                                 out["kp_uv"][b], out["kp_mask"][b]))
                last_kf[b] = (K, out["kp_uv"][b], out["kp_ids"][b], row)
            elif in_window and b in last_kf and _sampled(seed, K * B + b, share):
                kK, kuv, kids, _ = last_kf[b]
                tracks.append((K, kK, b, kuv, kids, out["kp_uv"][b], out["kp_ids"][b]))
        K += 1
    counts["end"] = lk_counts()
    setup_s = steps[0].start - t_process
    run = Run(cell="", streams=B, setup_s=setup_s, window_s=steps[-1].done - t_window,
              steps=steps)
    if trace_cycles:
        run.trace = Trace(device=device_events or [], host=spans.spans,
                          window_s=span[1] - span[0], stream_frames=trace_steps * B,
                          lk_work=work.work())
    capture = {"tracks": [], "landmarks": [], "keyframes": {}}
    for K, kK, b, kuv, kids, uv, ids in tracks:
        kids, ids = _host(kids), _host(ids)
        capture["tracks"].append((K, kK, b, _host(kuv), _host(uv), (kids >= 0) & (ids >= 0)))
    for K, b, pts, valid, uv, mask in lmks:
        capture["landmarks"].append((K, b, _host(pts), _host(valid), _host(uv), _host(mask)))
    for b, rows in kfs.items():
        capture["keyframes"][b] = [(k, _host(R), _host(p), _host(v), _host(bi))
                                   for k, R, p, v, bi in rows]
    n_kf = sum(len([r for r in rows if r[0] >= w]) for rows in kfs.values())
    launches = {"lk_cached": counts["end"][0] - counts["start"][0],
                "lk_cache_build": counts["end"][1] - counts["start"][1],
                "tracked_frames": len(steps), "keyframes": n_kf,
                "recovered": sum(int(r) > 0 for _, r in recovered),
                "recovered_in_window": sum(int(r) > 0 for inside, r in recovered if inside),
                "keyframes_made": [int(m) for m in made]}
    del fleet, state, out
    return run, capture, launches, streams


# ---------------------------------------------------------------------------
# Device timeline


def busy_intervals(events: list) -> list:
    """The union of the device activities' intervals, merged, in ns."""
    merged = []
    for _, _, a, b in sorted(events, key=lambda e: e[2]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace.device)) * 1e-9


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between device activities, each named by the host span (the call
    into a layer) running at the gap's middle."""
    by_name = {}
    for name, _, a, b in trace.device:
        by_name[name] = by_name.get(name, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    merged = busy_intervals(trace.device)
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) // 2) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:top]

    def host_at(t: int) -> str:
        inside = [(e - s, layer) for layer, s, e in trace.host if s <= t <= e]
        return min(inside)[1] if inside else "host outside the layers' calls"

    return {"device_ops": [[n, v * 1e-9] for n, v in ops],
            "idle_gaps": [[host_at(mid), g * 1e-9] for g, mid in gaps]}


# ---------------------------------------------------------------------------
# One run of a cell


def judge_run(capture: dict, launches: dict, truth, rig, plane_z: float, limits: dict) -> tuple:
    """(correct, checks): every number of reference.judge that the cell
    has a limit for, at or under it; no keyframe of the run through the
    smoother's recovery path; the program's LK counters equal to the
    window's tracked frames and keyframes (one lk_cached_kernel launch a
    tracked frame, one lk_cache_build_kernel launch a keyframe)."""
    nums = reference.judge(capture, truth, rig, plane_z)
    checks = {}
    for name, limit in limits.items():
        checks[name] = {"value": nums.get(name), "limit": limit}
    checks["recoveries"] = {"value": launches["recovered"], "limit": 0}
    checks["lk_launches"] = {"value": launches["lk_cached"], "limit": launches["tracked_frames"]}
    checks["cache_builds"] = {"value": launches["lk_cache_build"], "limit": launches["keyframes"]}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for n, c in checks.items() if n in limits or n == "recoveries")
    ok = ok and launches["lk_cached"] == launches["tracked_frames"]
    ok = ok and launches["lk_cache_build"] == launches["keyframes"]
    return ok, checks, nums


def execute(root: Path, name: str, seed: int, seconds: float, trace: bool, device,
            t_process: float, faults=None, bench_dir: Path = BENCH_DIR,
            control: bool = False) -> tuple:
    """Run cell `name` once. Returns (result line as a dict, the numbers
    of reference.judge). `faults(pipe=, fleet=)` may break the program
    underneath (the tests' faults). With `control`, the numbers gain
    "control": reference.judge of the same run with the reference itself,
    computed in bfloat16, in the program's place."""
    spec = load_spec(root)
    cell = cell_entry(spec, name)
    cfg = config_of(spec, cell, root)
    wl = workload_of(name, bench_dir)
    rig = scene_mod.Rig.from_config(cfg)
    scn = scene_mod.Scene(rig, wl["motion"], seed, device)
    params = vio_params(cfg)
    run, capture, launches, streams = run_fleet(params, scn, wl, seed, seconds, trace, device,
                                                t_process, faults)
    run.cell = name
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    truth = lambda K, b, dtype=torch.float64: streams[b].truth(K, dtype)  # noqa: E731
    correct, checks, nums = judge_run(capture, launches, truth, rig, scn.plane_z, wl["correct"])
    nums["stream_offsets"] = [s.offset for s in streams]
    nums["keyframes_made"] = launches["keyframes_made"]
    # the window's rate over all of it, and its steps' medians, beside the
    # metrics: what the spreads of the metrics are traced back to
    nums["window"] = {
        "frames_per_s": run.stream_frames / run.window_s, "window_s": run.window_s,
        "fleet_frames": len(run.steps),
        "tracking_step_ms": _median_ms([s for s in run.steps if not s.keyframe]),
        "keyframe_step_ms": _median_ms([s for s in run.steps if s.keyframe])}
    if control:
        nums["control"] = reference.judge(capture, truth, rig, scn.plane_z, torch.bfloat16,
                                          answers_from_reference=True)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(spec, name, kind):
        value = reader(m["name"], bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    # A keyframing stream-frame of the window whose solve took the
    # smoother's recovery path counts as failed; every stream-frame of the
    # window finished.
    result = {"correct": bool(correct), "attempted": run.stream_frames,
              "failed": launches["recovered_in_window"],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = busy_s(run.trace)
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks
    return result, nums


def _median_ms(steps: list) -> float | None:
    return float(np.median([s.ms for s in steps])) if steps else None


class ForbiddenModules(RuntimeError):
    """A module of JAX or of the JAX package was loaded in the run."""
