"""The control of `correct`, and the readings its limits are set from.

    python3 gpu_bench/control.py --workload <cell> --seconds <s> --seeds 1,2,3

Runs the cell once per seed in one process (the port's library loaded
once), as run.py does, and prints per seed one JSON line: the numbers that
decide `correct` for the program (`program`), and for the control
(`control`): the plain reference itself, computed in bfloat16 (the
precision below the configuration's float32), put in the program's place
on the same keypoints, keyframes and frames. A limit lies above the
largest program reading over the seeds and below the smallest control
reading. The benchmark's own runs never run this.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench_run  # noqa: E402  (sets the cache directories and sys.path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)

    import torch

    import harness

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    t0 = T_PROCESS
    for seed in (int(s) for s in args.seeds.split(",")):
        result, nums = harness.execute(bench_run.ROOT, args.workload, seed, args.seconds, False,
                                       torch.device("cuda", 0), t0, control=True)
        control = nums.pop("control")
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "program": nums, "control": control,
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "checks": result["checks"]}), flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
