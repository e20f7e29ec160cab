#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one card, in turns.

    python3 scripts/tree_ab.py --path OTHER_ROOT [--fleet OTHER_ROOT]
        [--stage OTHER_ROOT] [--inliers OTHER_ROOT] [--rounds 2]

Every measurement is a fresh process that imports the package (and
chip_smoke.py) from one checkout's root, builds that checkout's LK kernel
and warms up before it times anything:

  * `--path`: chip_smoke.py's phase 2, `StereoImuPipeline.run()`
    (sequential) over the 80-frame 752x480 synthetic sequence (256
    features, 384 landmarks, 10 keyframes), `--runs` times: frames/s and
    the pipeline's frame / keyframe step ms;
  * `--fleet`: phase 9(b), `FleetVio` with chip_smoke.FLEET_STREAMS' eight
    streams of 40 frames (needs a checkout that has the fleet): the
    batched frame step ms on fleet frames without a keyframe (host
    clock, each step ending in `torch.cuda.synchronize`), the keyframe ms
    per keyframing stream and stream-frames/s;
  * `--stage`: `run_chunked`'s stager, `StereoImuPipeline._stage`, on 64
    frames of chip_smoke's 0.05 m/s 752x480 scene (CODEC_VX, rounded to
    uint8 and rendered before timing) in each `KIMERA_STAGE_CODEC` codec,
    three super-batches a codec with the last two alive (the prefetch
    depth): the stager's own ms (image loads, encode, pack, pinned
    allocation) and the copy's ms (CUDA events), medians of the three;
  * `--inliers`: phase 2's run and phase 13(b)'s, the same 80 frames on
    chip_smoke's radial-tangential rig (EuRoC cam0 / cam1), `--runs`
    times each: every keyframe's `n_mono_inliers` (the 2-pt mono
    RANSAC's count, read from the frame step's outputs) and frames/s.

Each round runs other, this, this, other for each comparison given. Prints
the card's name and power limit, one JSON line per process, then one
summary line per comparison: the medians of each side and the largest
difference between the two sides' positions (the same code path gives 0).
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def path_runs(runs: int) -> dict:
    import numpy as np
    import torch

    from kimera_vio_tpu_torch.dataprovider.synthetic import (
        SyntheticStereoProvider,
        synthetic_params,
    )
    from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

    params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    StereoImuPipeline(params, parallel_run=False, device="cuda").run(
        SyntheticStereoProvider(n_frames=6, vx=0.5))
    rows = []
    for _ in range(runs):
        pipe = StereoImuPipeline(params, parallel_run=False, device="cuda")
        provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.run(provider)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        fr = pipe.stats.get("VioFrontend Frame Rate [ms]")
        kf = pipe.stats.get("VioFrontend Keyframe Rate [ms]")
        rows.append({"frames_per_s": out.n_frames / wall, "frame_ms": fr.total / fr.count,
                     "keyframe_ms": kf.total / kf.count,
                     "positions": np.stack(out.positions).tolist()})
    return {"runs": rows}


def fleet_runs(runs: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from kimera_vio_tpu_torch.common.types import stack_trees
    from kimera_vio_tpu_torch.dataprovider.synthetic import synthetic_params
    from kimera_vio_tpu_torch.parallel import FleetVio
    from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

    dev = torch.device("cuda")
    params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    streams = cs.fleet_streams(dev)
    pipe = StereoImuPipeline(params, parallel_run=False, device=dev)
    for st in streams:
        st["nav"], st["bias"] = pipe._bootstrap_state(st["provider"], st["frames"][0][4], None)
    B = len(streams)
    inputs = []
    for k in range(1, len(streams[0]["frames"])):
        fr = [st["frames"][k] for st in streams]
        inputs.append((torch.stack([f[0] for f in fr]), torch.stack([f[1] for f in fr]),
                       stack_trees([f[2] for f in fr]), [f[3] for f in fr]))
    rows = []
    for r in range(runs + 1):  # the first, on 5 frames, warms up
        fleet = FleetVio(params, B, device=dev)
        state = fleet.init(torch.stack([st["frames"][0][0] for st in streams]),
                           torch.stack([st["frames"][0][1] for st in streams]),
                           stack_trees([st["nav"] for st in streams]),
                           torch.stack([st["bias"] for st in streams]))
        torch.cuda.synchronize()
        step_ms, n_kf, pos = [], [], []
        t0 = time.perf_counter()
        for args in inputs if r else inputs[:5]:
            t = time.perf_counter()
            state, out = fleet.step(state, *args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            n_kf.append(int(out["is_keyframe"].sum()))
            pos.append(out["pos"].cpu().numpy())
        wall = time.perf_counter() - t0
        step_ms, n_kf = np.array(step_ms), np.array(n_kf)
        track_ms = float(step_ms[n_kf == 0].mean())
        if r:
            rows.append({"stream_frames_per_s": B * len(inputs) / wall,
                         "frame_step_ms": track_ms,
                         "keyframe_ms_per_stream": float(np.mean(
                             (step_ms[n_kf > 0] - track_ms) / n_kf[n_kf > 0])),
                         "positions": np.stack(pos).tolist()})
    return {"runs": rows}


def inlier_runs(runs: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from kimera_vio_tpu_torch.dataprovider.synthetic import (
        SyntheticStereoProvider,
        synthetic_params,
    )
    from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

    def run(params):
        pipe = StereoImuPipeline(params, parallel_run=False, device="cuda")
        kf = []

        def step(*a, **kw):
            res = type(pipe)._step(pipe, *a, **kw)
            if res[4] is not None:
                kf.append(int(res[3]["n_mono_inliers"]))
            return res

        pipe._step = step
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.run(SyntheticStereoProvider(n_frames=80, vx=0.5))
        torch.cuda.synchronize()
        return out.n_frames / (time.perf_counter() - t), kf, np.stack(out.positions).tolist()

    kw = dict(nr_states=10, max_features=256, max_landmarks=384)
    StereoImuPipeline(synthetic_params(**kw), parallel_run=False, device="cuda").run(
        SyntheticStereoProvider(n_frames=6, vx=0.5))
    rows = []
    for _ in range(runs):
        fps, kf, pos = run(synthetic_params(**kw))
        d_fps, d_kf, d_pos = run(cs.distorted_params("radtan", **kw))
        rows.append({"frames_per_s": fps, "keyframe_n_mono_inliers": kf, "positions": pos,
                     "distorted_frames_per_s": d_fps, "distorted_keyframe_n_mono_inliers": d_kf,
                     "distorted_positions": d_pos})
    return {"runs": rows}


CODECS = ("raw", "delta4", "delta4c", "delta3")


def stage_runs(runs: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from kimera_vio_tpu_torch.dataprovider.synthetic import (
        SyntheticStereoProvider,
        synthetic_params,
    )
    from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

    dev = torch.device("cuda")
    pipe = StereoImuPipeline(synthetic_params(nr_states=10, max_features=256, max_landmarks=384),
                             device=dev)
    prov = SyntheticStereoProvider(n_frames=65, vx=cs.CODEC_VX)
    batch = list(prov.frames())[1:65]
    images = {p[k]: np.clip(prov.load_image(p[k]), 0, 255).astype(np.uint8)
              for p in batch for k in ("left_path", "right_path")}
    frames = type("Frames", (), {"load_image": staticmethod(images.__getitem__)})
    side = torch.cuda.Stream(device=dev)
    rows = []
    for r in range(runs + 1):  # the first warms up
        row, alive = {}, []
        for codec in CODECS:
            stage_ms, copy_ms = [], []
            for _ in range(3):
                st = pipe._stage(frames, batch, side, codec)
                alive = (alive + [st])[-2:]
                side.synchronize()
                if st.codec != codec:
                    raise AssertionError(f"{codec}: the super-batch landed on {st.codec}")
                stage_ms.append(st.encode_ms)
                copy_ms.append(st.copy[0].elapsed_time(st.copy[1]))
            row[f"{codec}_stage_ms"] = statistics.median(stage_ms)
            row[f"{codec}_copy_ms"] = statistics.median(copy_ms)
            row[f"{codec}_wire_mb"] = st.host.numel() / 1e6
        if r:
            rows.append(row)
    return {"runs": rows}


def worker(root: str, what: str, runs: int) -> int:
    sys.path.insert(0, root)
    os.chdir(root)
    res = {"path": path_runs, "fleet": fleet_runs, "stage": stage_runs,
           "inliers": inlier_runs}[what](runs)
    print(json.dumps(res))
    return 0


def measure(root: str, what: str, runs: int) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", what,
                           "--root", root, "--runs", str(runs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"{what} in {root}: exit {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def summary(what: str, sides: dict) -> dict:
    import numpy as np

    keys = {"path": ("frames_per_s", "frame_ms", "keyframe_ms"),
            "fleet": ("stream_frames_per_s", "frame_step_ms", "keyframe_ms_per_stream"),
            "stage": tuple(f"{c}_{k}" for c in CODECS for k in ("stage_ms", "copy_ms")),
            "inliers": ("frames_per_s", "distorted_frames_per_s")}[what]
    res = {"compare": what}
    for side, runs in sides.items():
        for k in keys:
            res[f"{side}_{k}"] = [r[k] for r in runs]
            res[f"{side}_{k}_median"] = statistics.median(r[k] for r in runs)
    if what == "stage":
        return res
    pos = {side: [np.array(r["positions"]) for r in runs] for side, runs in sides.items()}
    res["max_abs_dpos_m"] = max(float(np.abs(a - b).max())
                                for a in pos["this"] for b in pos["other"])
    if what == "inliers":
        for side, runs in sides.items():
            for k in ("keyframe_n_mono_inliers", "distorted_keyframe_n_mono_inliers"):
                res[f"{side}_{k}"] = [r[k] for r in runs]
        pos = {side: [np.array(r["distorted_positions"]) for r in runs]
               for side, runs in sides.items()}
        res["distorted_max_abs_dpos_m"] = max(float(np.abs(a - b).max())
                                              for a in pos["this"] for b in pos["other"])
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", help="the other checkout's root for the phase-2 comparison")
    ap.add_argument("--fleet", help="the other checkout's root for the fleet comparison")
    ap.add_argument("--stage", help="the other checkout's root for the stager comparison")
    ap.add_argument("--inliers", help="the other checkout's root for the keyframe-inlier "
                    "comparison (phases 2 and 13)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--runs", type=int, default=2, help="timed runs per process")
    ap.add_argument("--worker", choices=("path", "fleet", "stage", "inliers"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    if args.worker:
        return worker(args.root, args.worker, args.runs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    plan = [(what, os.path.abspath(other)) for what, other in
            (("path", args.path), ("fleet", args.fleet), ("stage", args.stage),
             ("inliers", args.inliers)) if other]
    sides = {what: {"this": [], "other": []} for what, _ in plan}
    for rnd in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            for what, other in plan:
                res = measure(HERE if side == "this" else other, what, args.runs)
                sides[what][side] += res["runs"]
                print(json.dumps({"round": rnd, "side": side, "compare": what,
                                  **{k: [r[k] for r in res["runs"]] for k in res["runs"][0]
                                     if not k.endswith("positions")}}), flush=True)
    for what, _ in plan:
        print(json.dumps(summary(what, sides[what])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
