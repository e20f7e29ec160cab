"""Run one cell of the port's benchmark once, on this machine's card.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's `end_to_end`
metrics with --trace 0, its `per_layer` ones with --trace 1), `device`
(with --trace 1 also `busy_s`, `window_s`) and, traced, `breakdown`; then
`checks`, each number that decided `correct` with its limit, which the
last lines of standard error repeat. Exits non-zero, printing no result,
without enough CUDA cards, or when a module of JAX or of the JAX package
was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Every build and kernel cache the program or PyTorch writes stays at a
# fixed path inside the checkout (the port's own nvcc build goes to
# kimera_vio_tpu_torch/_build/ there).
CACHE = ROOT / ".bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness

    cell = harness.cell_entry(harness.load_spec(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    try:
        result, nums = harness.execute(ROOT, args.workload, args.seed, args.seconds,
                                       bool(args.trace), torch.device("cuda", 0), T_PROCESS)
    except harness.ForbiddenModules as e:
        print(f"modules of JAX or the JAX package were loaded: {e.args[0]}", file=sys.stderr)
        return 3
    print("reference: " + json.dumps(nums), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
