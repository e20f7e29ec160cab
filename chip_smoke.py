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
  1. kernel: the LK pyramid kernel (`lk_pyramid_cuda`, one launch per
     frame) vs its plain version `track_pyramid(lk_level_plain, ...)` on
     the same CUDA tensors, at the main path's shapes (a 752x480
     keyframe-to-frame pair of the synthetic sequence, 5 levels, 256
     detected keypoints, win 24, 30 iterations, 56-row search window), at
     1241x376 (KITTI-sized, where level 0 takes the reference's gather
     kernel) and, for the kernel's generic instantiation, at 752x480 with
     win 31 and a 64-row search window (its top level is skipped). Same
     float32 arithmetic in the same term order, only the window sums
     differ in order: median and max |d| < 0.01 px over the keypoints
     both track, and the same `ok` for every keypoint. Printed per level: mean and max
     Gauss-Newton steps; and the launch's time with no Gauss-Newton step.
  2. main path: launch counter set to 0, `run()` on the card at the full
     configuration (752x480, 256 features, 10-keyframe horizon, 384
     landmarks, 80 frames); the counter must equal the tracked frames
     (one launch each), the trajectory must be finite and within the JAX
     package's ATE gate (rmse < 0.05 m, tests/test_pipeline_e2e.py:35).
"""

from __future__ import annotations

import json
import re
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


def _tile_pixels(shape, corners, win: int) -> int:
    """Distinct pixels of an (H, W) plane covered by (win+1)^2 tiles whose
    origins are floor(corner - (win-1)/2), clipped to the plane."""
    H, W = shape
    if corners.shape[0] == 0:
        return 0
    a = torch.arange(win + 1, device=corners.device)
    o = torch.floor(corners - (win - 1) * 0.5).long()
    rows = (o[:, 1:2] + a).clamp(0, H - 1)
    cols = (o[:, 0:1] + a).clamp(0, W - 1)
    mask = torch.zeros(H * W, dtype=torch.bool, device=corners.device)
    mask[(rows[:, :, None] * W + cols[:, None, :]).flatten()] = True
    return int(mask.sum())


def lk_bound_ms(levels, n_kpts: int, win: int = WIN) -> tuple[float, str]:
    """Least time the card could take for one frame's LK levels, from this
    run's data: bytes over HBM bandwidth vs float32 operations over the
    float32 peak, whichever is larger.

    Bytes, each read once: per level, the distinct prev, gx and gy pixels
    under the valid keypoints' (win+1)^2 template tiles, and the distinct
    cur pixels under the tile that each keypoint taking a step there
    samples first (its later samples are not counted, so this is a floor);
    the keypoints' inputs and outputs once. Operations: per valid keypoint
    and window pixel, 27 of setup (three 4-tap blends, the G sums); per
    Gauss-Newton step and pixel, 17 (two y-lerps, an x-lerp, the
    residual, two multiply-adds)."""
    npx = win * win
    nbytes = n_kpts * (2 + 2 + 1) * 4 + n_kpts * (2 + 1 + len(levels)) * 4
    flops = 0.0
    for lv in levels:
        valid = lv["valid"]
        stepped = lv["iters"] > 0
        nbytes += 3 * 4 * _tile_pixels(lv["shape"], lv["base"][valid], win)
        nbytes += 4 * _tile_pixels(lv["shape"], lv["start"][stepped], win)
        flops += int(valid.sum()) * npx * 27 + int(lv["iters"].sum()) * npx * 17
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_lk(prev_pyr, cur_pyr, pts, valid, label: str, **kw) -> dict:
    """Kernel vs plain version on the same CUDA tensors; returns the
    errors, per-level steps, times and the bound."""
    kw = {**LK_KW, **kw}
    grads = [of._grad(p) for p in prev_pyr]
    args = (prev_pyr, cur_pyr, grads, pts, pts, valid)
    seen = []  # each tracked level's inputs, for the bound

    def level_seen(prev, gx, gy, cur, base, start, valid, **lkw):
        out = lk.lk_level_plain(prev, gx, gy, cur, base, start, valid, **lkw)
        seen.append({"base": base, "start": start, "valid": valid})
        return out

    out_k, ok_k, it_k = lk.lk_pyramid_cuda(*args, **kw)
    out_p, ok_p, lv_p = lk.track_pyramid(level_seen, prev_pyr, cur_pyr, pts, pts,
                                         valid, grads, **kw)
    torch.cuda.synchronize()
    agree = float((ok_k == ok_p).float().mean())
    both = ok_k & ok_p
    d = torch.linalg.norm(out_k - out_p, dim=-1)[both]
    if int(both.sum()) < 0.5 * pts.shape[0]:
        raise AssertionError(f"{label}: only {int(both.sum())} keypoints tracked by both")
    median, max_err = float(d.median()), float(d.max())
    # Same float32 math, different summation order of the window sums: the
    # median within 0.01 px, and every keypoint too; the same `ok` for every
    # keypoint (stricter than the >= 98 % agreement the port is held to).
    if not (median < 0.01 and max_err < 0.01 and agree == 1.0):
        raise AssertionError(f"{label}: median {median} px, max {max_err} px, "
                             f"ok agreement {agree}")

    levels = []
    for lv, inp in zip(lv_p, seen):
        steps = it_k[:, lv["level"]]
        levels.append({**lv, **inp, "iters": steps, "plain_iters": lv["iters"]})
    # ms: device time of one frame's kernel launch (graph replay); beside
    # it the same launch with no Gauss-Newton step (staging, template and G
    # on every level) and the eager time of the whole tracker entry point,
    # host work included.
    ms = graph_ms(lambda: lk.lk_pyramid_cuda(*args, **kw))
    ms_no_steps = graph_ms(lambda: lk.lk_pyramid_cuda(*args, **{**kw, "max_iter": 0}))
    chain = int(it_k.sum(dim=1).max())
    eager_ms = time_ms(lambda: lk.klt_track_lk(prev_pyr, cur_pyr, pts, pts, valid,
                                               prev_grads=grads, device=pts.device, **kw), reps=50)
    plain_ms = time_ms(lambda: lk.track_pyramid(lk.lk_level_plain, prev_pyr, cur_pyr, pts, pts,
                                                valid, grads, **kw), reps=3, warmup=1)
    bound_ms, bound_by = lk_bound_ms(levels, pts.shape[0], kw["win"])
    res = {
        "label": label, "win": kw["win"], "search_rows": kw["search_rows"],
        "launches_per_frame": 1, "tracked": int(ok_k.sum()),
        "ok_agreement": agree, "median_abs_err": median, "max_abs_err": max_err,
        "ms": ms, "ms_no_steps": ms_no_steps, "max_chain_steps": chain,
        "us_per_step_on_longest_chain": 1e3 * (ms - ms_no_steps) / max(chain, 1),
        "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "levels": [{
            "level": lv["level"], "shape": lv["shape"], "mode": lv["mode"],
            "mean_steps": float(lv["iters"].float().mean()), "max_steps": int(lv["iters"].max()),
            "plain_mean_steps": float(lv["plain_iters"].float().mean()),
            "plain_max_steps": int(lv["plain_iters"].max()),
        } for lv in levels],
    }
    log(f"[kernel] {json.dumps(res)}")
    return res


def main_lk_inputs(dev):
    """The main path's LK inputs: keyframe -> frame+4 of the synthetic
    752x480 sequence, 5-level pyramids, 256 detected keypoints. Returns
    (prev_pyr, cur_pyr, keypoints, valid)."""
    prov = SyntheticStereoProvider(n_frames=8, vx=0.5)
    img0 = torch.from_numpy(prov.load_image(("left", 0))).to(dev)
    img4 = torch.from_numpy(prov.load_image(("left", 4))).to(dev)
    empty_uv = torch.zeros((256, 2), device=dev)
    uv, valid = det.detect_features(img0, empty_uv, torch.zeros(256, dtype=torch.bool, device=dev), 256)
    return of.build_pyramid(img0, 4), of.build_pyramid(img4, 4), uv, valid


def kernel_phase(dev) -> dict:
    """Main-path shapes (and the generic instantiation on them); plus a
    1241x376 pair."""
    prev_pyr, cur_pyr, uv, valid = main_lk_inputs(dev)
    main = compare_lk(prev_pyr, cur_pyr, uv, valid, "752x480")
    generic = compare_lk(prev_pyr, cur_pyr, uv, valid, "752x480 generic", win=31, search_rows=64)
    if [lv["mode"] for lv in generic["levels"]][0] != "xla" or len(generic["levels"]) != 4:
        raise AssertionError("752x480 with win 31 should skip its top level")

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
    if kitti["levels"][-1]["mode"] != "gather":
        raise AssertionError("1241x376 level 0 should take the gather-kernel window rule")
    return main


def path_phase(dev) -> dict:
    params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    # Warm-up (CUDA context, cuBLAS/cuSOLVER handles, kernel library).
    StereoImuPipeline(params, device=dev).run(SyntheticStereoProvider(n_frames=6, vx=0.5))
    provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
    pipe = StereoImuPipeline(params, device=dev)
    torch.cuda.synchronize()
    lk.lk_pyramid_cuda.launches = 0
    t0 = time.perf_counter()
    out = pipe.run(provider)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lk.lk_pyramid_cuda.launches
    tracked = out.n_frames - 1  # the first frame initializes, the rest track
    if launches != tracked:
        raise AssertionError(f"LK kernel launches {launches} != {tracked} tracked frames")
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
    kernel = "?"
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '\S*?lk_pyramid_kernelILi(\d+)ELi(\d+)E", line)
        if m:
            kernel = "lk_pyramid_kernel<win {}, search_rows {}>".format(*m.groups())
        elif "registers" in line or "spill" in line:
            log(f"[build] {kernel}: {line.strip()}")

    t = time.perf_counter()
    kern = kernel_phase(dev)
    log(f"[phase] kernel {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    path = path_phase(dev)
    log(f"[phase] path {time.perf_counter() - t:.1f} s")

    kernels = [{
        "name": "lk_pyramid",
        "route": "cuda",
        "source": "kimera_vio_tpu_torch/csrc/lk_kernel.cu",
        "replaces": "kimera_vio_tpu/ops/pallas/lk_kernel.py:332",
        "also_replaces": ["kimera_vio_tpu/ops/pallas/lk_kernel.py:68",
                          "kimera_vio_tpu/ops/optical_flow.py:92"],
        "launches": path["lk_launches"],
        "max_abs_err": kern["max_abs_err"],
        "median_abs_err": kern["median_abs_err"],
        "ms": kern["ms"],
        "eager_ms": kern["eager_ms"],
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
