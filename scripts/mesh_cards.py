#!/usr/bin/env python3
"""chip_smoke.py's phase 11 (FleetVio over a data x model mesh) alone.

    python3 scripts/mesh_cards.py [--meshes 2x2,2x1,1x2,1x1] [--cards]

Builds the LK kernel, runs phase 9's first four streams (752x480, 256
features, 384 landmarks, 10-keyframe horizon, 40 frames) alone through
the single-stream step and through the one-device fleet at B = 4 (phase
9's references), then `chip_smoke.mesh_phase` on the meshes asked for:
`--meshes DxM,...` logical meshes of D data rows and M model shards, all
on cuda:0; `--cards` also phase 11's meshes over the real cards (a (D, 1)
mesh over the first D cards, D = 4 where there are four, else 2, where
D = 4 a (2, 2) mesh over them, and a (2, 5) mesh cycling through them,
whose tables stay whole on cuda:0 and cuda:1; needs two or more cards).
Phase 11's switched-output run is left out. Without
either, phase 11's own meshes. Prints each card's name and power limit,
the `[fleet]` line of the one-device run and one `[mesh]` line per mesh
(printed before its gates are checked). Exits non-zero without CUDA or
when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kimera_vio_tpu_torch.ops import lk_kernel as lk  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshes", default="", help="logical meshes on cuda:0, e.g. 2x2,1x2")
    ap.add_argument("--cards", action="store_true", help="also the meshes over the real cards")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_cards: needs CUDA", file=sys.stderr)
        return 2
    n_cards = torch.cuda.device_count()
    if args.cards and n_cards < 2:
        print(f"mesh_cards: --cards needs two or more cards, found {n_cards}", file=sys.stderr)
        return 2
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    for i, card in enumerate(cards):
        cs.log(f"cuda:{i} {card}")
    t0 = time.perf_counter()
    lk.build_kernel()
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    meshes = None
    if args.meshes or args.cards:
        meshes = []
        for spec in filter(None, args.meshes.split(",")):
            D, M = map(int, spec.split("x"))
            meshes.append(([dev] * (D * M), M))
        if args.cards:
            real = [torch.device("cuda", i) for i in range(4 if n_cards >= 4 else 2)]
            meshes += [(real, 1)] + ([(real, 2)] if len(real) >= 4 else [])
            # (2, 5): the model axis does not divide the 384 landmarks, so each
            # row's table stays whole on the row's first card (cuda:0, cuda:1).
            meshes.append(([real[i % len(real)] for i in range(10)], cs.UNEVEN_SHARDS))
    params = cs.synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    streams = cs.fleet_gold(dev, params, cs.fleet_streams(dev)[:cs.MESH_STREAMS])
    row, traj = cs.fleet_run(dev, params, streams, cs.MESH_STREAMS, None)
    cs.log(f"[fleet] {json.dumps(row)}")
    fleet_res = {"params": params, "streams": streams, "runs": {cs.MESH_STREAMS: row},
                 "traj": {cs.MESH_STREAMS: traj}}
    res = cs.mesh_phase(dev, {"frames_per_s": None}, fleet_res, cards, meshes, switched=False)
    cs.log(json.dumps({"ok": True, "meshes": list(res), "cards": n_cards,
                       "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
