#!/usr/bin/env python3
"""Time the LK pyramid kernel built from two CUDA sources on one card.

    python3 scripts/lk_kernel_ab.py --other OTHER/kimera_vio_tpu_torch/csrc/lk_kernel.cu

Builds `--other` with the same nvcc flags as this checkout's
csrc/lk_kernel.cu (the C interface `lk_pyramid_launch` must be the same),
then times one 752x480 frame of the main path (chip_smoke.main_lk_inputs:
5 levels, 256 keypoints, win 24, 56-row search window) through each
library in turns: other, this, this, other, `--rounds` times. Each time is
the device time of a CUDA-graph replay of one launch (chip_smoke.graph_ms).
Both libraries' outputs must be identical. Prints the card's name and
power limit, then one JSON line. Needs a card; exits 2 without one.
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
    for name in ("lk_pyramid_launch", "lk_error_string"):
        getattr(other, name).argtypes = getattr(this, name).argtypes
        getattr(other, name).restype = getattr(this, name).restype
    return other


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="the other lk_kernel.cu")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lk_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    libs = {"this": lk._lib(), "other": build_other(args.other)}
    prev_pyr, cur_pyr, uv, valid = chip_smoke.main_lk_inputs(dev)
    grads = [of._grad(p) for p in prev_pyr]
    call = (prev_pyr, cur_pyr, grads, uv, uv, valid)

    def run(name):
        lk._lib = lambda: libs[name]  # the wrapper's library, swapped
        return lk.lk_pyramid_cuda(*call, **chip_smoke.LK_KW)

    outs = {name: run(name) for name in libs}
    torch.cuda.synchronize()
    for a, b in zip(outs["this"], outs["other"]):
        if not torch.equal(a, b):
            raise AssertionError("the two kernels' outputs differ")
    times = {"other": [], "this": []}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            times[name].append(chip_smoke.graph_ms(lambda n=name: run(n)))
    res = {"card": smi, "shape": "752x480 5 levels 256 keypoints win 24 search_rows 56",
           "ms": times, "mean_ms": {k: sum(v) / len(v) for k, v in times.items()},
           "outputs_identical": True}
    res["this_over_other"] = res["mean_ms"]["this"] / res["mean_ms"]["other"]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
