#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (kimera_vio_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernel from csrc/ (nvcc, sm_90a), holds it
against its plain PyTorch version on the card, drives the port's
stereo-inertial `StereoImuPipeline.run()` on the synthetic 752x480
sequence (80 frames), and checks the result. Every failure ends the run
with a non-zero exit code and no result line. Printed, in order: the
card's name and power limit, the build, the kernel comparison, the main
path, one JSON line with the kernel table, and last the JSON result line.

Phases:
  1. kernel: the LK level kernel vs `lk_level_plain` on the same CUDA
     tensors, at the main path's shapes (a 752x480 keyframe-to-frame pair
     of the synthetic sequence, 5 levels, 256 detected keypoints, win 24,
     30 iterations, 56-row search window) and at 1241x376 (KITTI-sized,
     where level 0 takes the reference's gather kernel). Same float32
     arithmetic in the same term order, only the window sums differ in
     order: median |d| < 0.01 px, >= 98 % agreement of `ok`.
  2. main path: launch counter set to 0, `run()` on the card at the full
     configuration (752x480, 256 features, 10-keyframe horizon, 384
     landmarks, 80 frames); the counter must equal tracked frames x 5
     levels, the trajectory must be finite and within the JAX package's
     ATE gate (rmse < 0.05 m, tests/test_pipeline_e2e.py:35).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.ops import corner_detection as det
from kimera_vio_tpu_torch.ops import lk_kernel as lk
from kimera_vio_tpu_torch.ops import optical_flow as of
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.utils.logger import compute_ate

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
WIN, MAX_ITER, EPS, MIN_EIG, SEARCH_ROWS = 24, 30, 0.1, 1e-4, 56
LK_KW = dict(win=WIN, max_iter=MAX_ITER, eps=EPS, min_eig_thresh=MIN_EIG, search_rows=SEARCH_ROWS)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 200) -> float:
    """Device time of fn() replayed from a CUDA graph: the kernels' time
    without the host's launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def lk_bound_ms(levels, n_kpts: int) -> tuple[float, str]:
    """Least time the card could take for one frame's LK levels: bytes
    (each level's four planes read once, keypoint inputs and outputs once)
    over HBM bandwidth vs the float32 operations this run's steps need
    over the float32 peak. Per window pixel: 27 flops of setup (three
    4-tap blends, the G sums) and 17 per Gauss-Newton step (two y-lerps,
    an x-lerp, the residual, two multiply-adds)."""
    npx = WIN * WIN
    nbytes = 0
    flops = 0.0
    for lv in levels:
        H, W = lv["shape"]
        nbytes += 4 * H * W * 4 + n_kpts * (2 + 2 + 1) * 4 + n_kpts * (2 + 1 + 1) * 4
        steps = int(lv["iters"].sum())
        flops += n_kpts * npx * 27 + steps * npx * 17
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_lk(prev_pyr, cur_pyr, pts, valid, label: str) -> dict:
    """Kernel vs plain version through the same coarse-to-fine loop on
    the same CUDA tensors; returns the errors, times and the bound."""
    grads = [of._grad(p) for p in prev_pyr]
    args = (prev_pyr, cur_pyr, pts, pts, valid, grads)
    calls = []

    def recording(*a, **k):
        calls.append((a, k))
        return lk.lk_level_cuda(*a, **k)

    out_k, ok_k, lv_k = lk.track_pyramid(recording, *args, **LK_KW)
    out_p, ok_p, _ = lk.track_pyramid(lk.lk_level_plain, *args, **LK_KW)
    torch.cuda.synchronize()
    agree = float((ok_k == ok_p).float().mean())
    both = ok_k & ok_p
    d = torch.linalg.norm(out_k - out_p, dim=-1)[both]
    if int(both.sum()) < 0.5 * pts.shape[0]:
        raise AssertionError(f"{label}: only {int(both.sum())} keypoints tracked by both")
    median, max_err = float(d.median()), float(d.max())
    # Same float32 math, different summation order of the window sums.
    if not (median < 0.01 and agree >= 0.98):
        raise AssertionError(f"{label}: median {median} px, ok agreement {agree}")

    def run_levels(level_fn):
        def go():
            lk.track_pyramid(level_fn, *args, **LK_KW)
        return go

    def kernel_calls():
        for a, k in calls:
            lk.lk_level_cuda(*a, **k)

    # ms: device time of one frame's kernel calls (graph replay); the
    # eager time of the whole tracker, host overhead included, beside it.
    ms = graph_ms(kernel_calls)
    eager_ms = time_ms(run_levels(lk.lk_level_cuda), reps=50)
    plain_ms = time_ms(run_levels(lk.lk_level_plain), reps=3, warmup=1)
    bound_ms, bound_by = lk_bound_ms(lv_k, pts.shape[0])
    res = {
        "label": label, "levels": [(lv["shape"], lv["mode"]) for lv in lv_k],
        "launches_per_frame": len(lv_k), "tracked": int(ok_k.sum()),
        "ok_agreement": agree, "median_abs_err": median, "max_abs_err": max_err,
        "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "mean_steps_level0": float(lv_k[-1]["iters"].float().mean()),
    }
    log(f"[kernel] {json.dumps(res)}")
    return res


def kernel_phase(dev) -> dict:
    """Main-path shapes: keyframe -> frame+4 of the synthetic 752x480
    sequence, 256 detected keypoints; plus a 1241x376 pair."""
    prov = SyntheticStereoProvider(n_frames=8, vx=0.5)
    img0 = torch.from_numpy(prov.load_image(("left", 0))).to(dev)
    img4 = torch.from_numpy(prov.load_image(("left", 4))).to(dev)
    empty_uv = torch.zeros((256, 2), device=dev)
    uv, valid = det.detect_features(img0, empty_uv, torch.zeros(256, dtype=torch.bool, device=dev), 256)
    main = compare_lk(of.build_pyramid(img0, 4), of.build_pyramid(img4, 4), uv, valid, "752x480")
    if main["launches_per_frame"] != 5:
        raise AssertionError(f"752x480 should take 5 launches, took {main['launches_per_frame']}")

    rng = np.random.default_rng(7)
    H, W = 376, 1241
    import scipy.ndimage as ndi

    tex = ndi.zoom(rng.uniform(30, 225, (H // 6 + 2, (W + 40) // 6 + 2)).astype(np.float32), 6, order=3)
    a = torch.from_numpy(np.ascontiguousarray(tex[:H, :W])).to(dev)
    b = torch.from_numpy(np.ascontiguousarray(0.4 * tex[:H, 9 : W + 9] + 0.6 * tex[:H, 10 : W + 10])).to(dev)
    pts = torch.from_numpy(np.stack([rng.uniform(14, W - 14, 256), rng.uniform(14, H - 14, 256)], -1)
                           .astype(np.float32)).to(dev)
    kitti = compare_lk(of.build_pyramid(a, 4), of.build_pyramid(b, 4), pts,
                       torch.ones(256, dtype=torch.bool, device=dev), "1241x376")
    if kitti["levels"][-1][1] != "gather":
        raise AssertionError("1241x376 level 0 should take the gather-kernel window rule")
    return main


def path_phase(dev) -> dict:
    params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    # Warm-up (CUDA context, cuBLAS/cuSOLVER handles, kernel library).
    StereoImuPipeline(params, device=dev).run(SyntheticStereoProvider(n_frames=6, vx=0.5))
    provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
    pipe = StereoImuPipeline(params, device=dev)
    torch.cuda.synchronize()
    lk.lk_level_cuda.launches = 0
    t0 = time.perf_counter()
    out = pipe.run(provider)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lk.lk_level_cuda.launches
    tracked = out.n_frames - 1  # the first frame initializes, the rest track
    if launches != tracked * 5:
        raise AssertionError(f"LK kernel launches {launches} != {tracked} tracked frames x 5 levels")
    est = np.stack(out.positions)
    if est.shape != (out.n_keyframes, 3) or not np.isfinite(est).all():
        raise AssertionError("trajectory not finite or of the wrong shape")
    gt = provider.ground_truth
    ate = compute_ate(np.array(out.stamps_ns), est, gt.stamps_ns, gt.positions, align=False)
    if not ate["rmse"] < 0.05:
        raise AssertionError(f"ATE rmse {ate['rmse']} m >= 0.05 m")
    step = pipe.stats.get("vio_step [ms]")
    res = {
        "frames": out.n_frames, "keyframes": out.n_keyframes, "ate_rmse_m": ate["rmse"],
        "wall_s": wall, "frames_per_s": out.n_frames / wall,
        "step_ms_mean": step.total / step.count,
        "frame_ms_mean": pipe.stats.get("VioFrontend Frame Rate [ms]").total
        / pipe.stats.get("VioFrontend Frame Rate [ms]").count,
        "keyframe_ms_mean": pipe.stats.get("VioFrontend Keyframe Rate [ms]").total
        / pipe.stats.get("VioFrontend Keyframe Rate [ms]").count,
        "lk_launches": launches,
    }
    log(f"[path] {json.dumps(res)}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    so, ptxas = lk.build_kernel()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    t = time.perf_counter()
    kern = kernel_phase(dev)
    log(f"[phase] kernel {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    path = path_phase(dev)
    log(f"[phase] path {time.perf_counter() - t:.1f} s")

    kernels = [{
        "name": "lk_level",
        "route": "cuda",
        "source": "kimera_vio_tpu_torch/csrc/lk_kernel.cu",
        "replaces": "kimera_vio_tpu/ops/pallas/lk_kernel.py:332",
        "also_replaces": "kimera_vio_tpu/ops/pallas/lk_kernel.py:68",
        "launches": path["lk_launches"],
        "max_abs_err": kern["max_abs_err"],
        "median_abs_err": kern["median_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,  # no single PyTorch call computes pyramidal LK
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
