"""Run cells of the benchmark several times in turn and report each
metric's spread, the way the bounds are set.

    python3 gpu_bench/sets.py --workload <cell> [--workload ...] --seeds 1,2,3 \
        --seconds 30 [--trace 0|1] [--sets 2] [--out chiprun_out/sets.jsonl]

Each run is `run.py` in a process of its own, one after another (one
process on the card at a time). For each cell, each set runs every seed
once; the report gives per metric each set's median and its spread (the
first-to-third quartile distance over the median, from
`statistics.quantiles(values, n=4)`), and the wider of the sets'
spreads. Every run's result line (or its failure) and the numbers of
reference.judge go to --out.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default="chiprun_out/sets.jsonl")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(f"card: {power}", flush=True)
    rc = 0
    for cell in args.workload:
        runs = []
        for s in range(args.sets):
            for seed in seeds:
                cmd = [sys.executable, str(ROOT / "gpu_bench/run.py"), "--workload", cell,
                       "--seed", str(seed), "--seconds", str(args.seconds),
                       "--trace", str(args.trace)]
                t0 = time.perf_counter()
                p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
                wall = time.perf_counter() - t0
                rec = {"cell": cell, "set": s, "seed": seed, "rc": p.returncode, "wall_s": wall,
                       "card": power}
                try:
                    rec["result"] = json.loads(p.stdout.strip().splitlines()[-1])
                except (IndexError, json.JSONDecodeError):
                    rec["result"] = None
                rec["stderr_tail"] = p.stderr[-3000:]
                # the numbers reference.judge read, kept whole (run.py's
                # "reference:" line), to set the limits of `correct` from
                ref = [ln for ln in p.stderr.splitlines() if ln.startswith("reference: ")]
                rec["reference"] = json.loads(ref[-1][len("reference: "):]) if ref else None
                with open(out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                res = rec["result"]
                if p.returncode or res is None:
                    rc = 1
                    print(f"{cell} set {s} seed {seed}: rc {p.returncode}\n{p.stderr[-3000:]}",
                          flush=True)
                    continue
                runs.append(rec)
                m = {k: round(v["value"], 4) for k, v in res["metrics"].items()}
                checks = {k: v["value"] for k, v in res["checks"].items()}
                window = (rec["reference"] or {}).get("window")
                print(f"{cell} set {s} seed {seed}: correct {res['correct']} wall {wall:.1f} s "
                      f"{m} checks {checks} peak {res['device']['memory_peak_bytes']} "
                      f"window {window}", flush=True)
        names = sorted({k for r in runs for k in r["result"]["metrics"]})
        for name in names:
            per_set = []
            for s in range(args.sets):
                vals = [r["result"]["metrics"][name]["value"] for r in runs
                        if r["set"] == s and name in r["result"]["metrics"]]
                if vals:
                    per_set.append((statistics.median(vals), spread(vals), vals))
            widest = max((sp for _, sp, _ in per_set if sp is not None), default=None)
            print(f"{cell} {name}: " + " | ".join(
                f"set median {med:.6g} spread {sp if sp is None else round(sp, 5)}"
                for med, sp, _ in per_set) + f" | widest {widest}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
