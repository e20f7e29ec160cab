#!/usr/bin/env python3
"""Where the time goes on the card, for the PyTorch port's main path.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/torch_profile_path.py [--frames 80]

Drives `StereoImuPipeline.run()` of kimera_vio_tpu_torch on the synthetic
752x480 sequence (the chip_smoke.py configuration) once to warm up, then
once under `torch.profiler` (CPU + CUDA activities), and once with a
synchronizing host timer around each main-path stage. Prints, as JSON
lines: the card's name and power limit; the wall time, the summed device
time of all kernels and the device's busy share (kernels run on one
stream, so their sum is the busy time); the kernels with the most device
time; the LK pyramid kernel's launches (one per tracked frame) and device
time per launch; and per stage its calls and
milliseconds (stages nest: the keyframe branch holds detection, stereo
matching and RANSAC; the backend holds the solve and marginalization).
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from kimera_vio_tpu_torch.dataprovider.synthetic import (  # noqa: E402
    SyntheticStereoProvider,
    synthetic_params,
)
from kimera_vio_tpu_torch.backend import smoother  # noqa: E402
from kimera_vio_tpu_torch.frontend import vision_frontend as vf  # noqa: E402
from kimera_vio_tpu_torch.pipeline import stereo_pipeline  # noqa: E402
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline  # noqa: E402

# (owner, attribute, stage label): the call sites the main path goes through.
STAGES = [
    (vf.of, "build_pyramid", "frame: pyramid"),
    (vf.imu, "preintegrate", "frame: IMU preintegration"),
    (vf, "klt_track_lk", "frame: LK (kernel + tracker)"),
    (vf.StereoFrontend, "_keyframe_branch", "keyframe: frontend branch"),
    (vf.det, "detect_features", "keyframe: frontend branch > detection"),
    (vf, "match_stereo", "keyframe: frontend branch > stereo matching"),
    (vf.ransac, "ransac_2pt_mono", "keyframe: frontend branch > 2-pt RANSAC"),
    (vf.ransac, "voting_1pt_stereo", "keyframe: frontend branch > 1-pt voting"),
    (stereo_pipeline.sm, "backend_step", "keyframe: backend"),
    (smoother, "_marginalize_oldest", "keyframe: backend > marginalization"),
    (smoother, "_gn_solve", "keyframe: backend > Gauss-Newton"),
    (smoother, "_smart_factor_blocks", "keyframe: backend > Gauss-Newton > smart factors"),
    (smoother, "_imu_factor_blocks", "keyframe: backend > IMU factors (autodiff)"),
]


def instrument(acc):
    """Wrap each stage with a host timer that synchronizes the card before
    and after, so a stage's time includes its device work."""
    for owner, name, label in STAGES:
        fn = getattr(owner, name)

        def wrapper(*a, __fn=fn, __label=label, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = __fn(*a, **k)
            torch.cuda.synchronize()
            acc[__label][0] += 1
            acc[__label][1] += (time.perf_counter() - t) * 1e3
            return out

        setattr(owner, name, wrapper)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}))
    params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    StereoImuPipeline(params, device="cuda").run(SyntheticStereoProvider(n_frames=6, vx=0.5))
    pipe = StereoImuPipeline(params, device="cuda")
    provider = SyntheticStereoProvider(n_frames=args.frames, vx=0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = pipe.run(provider)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = per_kernel[e.name]
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    device_ms = sum(v[1] for v in per_kernel.values())
    print(json.dumps({
        "frames": out.n_frames, "keyframes": out.n_keyframes, "wall_ms": wall_ms,
        "device_kernel_ms": device_ms, "device_busy_share": device_ms / wall_ms,
        "n_kernel_launches": sum(v[0] for v in per_kernel.values()),
        "n_kernel_names": len(per_kernel),
    }))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (n, ms) in top:
        print(json.dumps({"kernel": name[:120], "launches": n, "device_ms": ms,
                          "share_of_device": ms / max(device_ms, 1e-9)}))
    lk = [(n, ms) for name, (n, ms) in per_kernel.items() if "lk_pyramid_kernel" in name]
    if lk:
        n, ms = lk[0]
        print(json.dumps({"lk_pyramid_kernel_launches": n, "lk_device_ms_total": ms,
                          "lk_device_us_per_launch": 1e3 * ms / n,
                          "lk_device_ms_per_frame": ms / max(out.n_frames - 1, 1)}))
    else:
        print(json.dumps({"lk_pyramid_kernel": "no device events recorded"}))

    acc = defaultdict(lambda: [0, 0.0])
    instrument(acc)
    pipe = StereoImuPipeline(params, device="cuda")
    t0 = time.perf_counter()
    out = pipe.run(SyntheticStereoProvider(n_frames=args.frames, vx=0.5))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({"stage_run_wall_ms": wall_ms, "frames": out.n_frames,
                      "keyframes": out.n_keyframes}))
    for _, _, label in STAGES:
        n, ms = acc[label]
        print(json.dumps({"stage": label, "calls": n, "ms_total": ms,
                          "ms_per_call": ms / max(n, 1), "share_of_wall": ms / wall_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
