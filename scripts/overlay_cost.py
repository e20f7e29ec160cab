#!/usr/bin/env python3
"""Host cost of the frontend-image overlays (`log_frontend_images`) on the
card, for the PyTorch port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/overlay_cost.py [--pairs 3]

Drives `StereoImuPipeline.run()` (sequential) on chip_smoke.py's phase-2
configuration (80 synthetic 752x480 frames, 256 features) once to warm
up, then `--pairs` times without and with the overlays, alternating which
goes first. Prints, as JSON lines: the card's name and power limit; per
pair the wall of each run, the overlays' extra milliseconds per written
overlay, and the milliseconds spent in the overlay writer
(`_log_frontend_img`: readback done, drawing, PNG encoding, the file
write) per overlay. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from kimera_vio_tpu_torch.config import flags  # noqa: E402
from kimera_vio_tpu_torch.dataprovider.synthetic import (  # noqa: E402
    SyntheticStereoProvider,
    synthetic_params,
)
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline  # noqa: E402


def one_run(overlays: bool, out_dir: str) -> dict:
    """One sequential run; with `overlays`, the writer's time per call."""
    writer = StereoImuPipeline._log_frontend_img
    spent = []

    def timed(self, *a, **k):
        t = time.perf_counter()
        writer(self, *a, **k)
        spent.append((time.perf_counter() - t) * 1e3)

    StereoImuPipeline._log_frontend_img = timed
    flags.set_flag("log_frontend_images", overlays)
    try:
        params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
        pipe = StereoImuPipeline(params, parallel_run=False, output_path=out_dir, device="cuda")
        provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.run(provider)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        StereoImuPipeline._log_frontend_img = writer
        flags.set_flag("log_frontend_images", False)
    return {"wall_s": wall, "keyframes": out.n_keyframes, "overlays": len(spent),
            "writer_ms": spent}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}))
    with tempfile.TemporaryDirectory() as work:
        one_run(True, os.path.join(work, "warm"))
        for k in range(args.pairs):
            order = (False, True) if k % 2 == 0 else (True, False)
            runs = {on: one_run(on, os.path.join(work, f"p{k}_{int(on)}")) for on in order}
            off, on = runs[False], runs[True]
            n = max(on["overlays"], 1)
            print(json.dumps({
                "pair": k, "first": "with" if order[0] else "without",
                "wall_s_without": off["wall_s"], "wall_s_with": on["wall_s"],
                "overlays": on["overlays"],
                "extra_ms_per_overlay": (on["wall_s"] - off["wall_s"]) * 1e3 / n,
                "writer_ms_per_overlay": sum(on["writer_ms"]) / n,
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
