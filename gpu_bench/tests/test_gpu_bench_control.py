"""The control of `correct`: the plain reference itself, computed in
bfloat16 (the precision below the configurations' float32), put in the
program's place. At each cell's own size on the card (marker `card`) it
comes out not correct where the program comes out correct. At the small
size on the CPU the limits, set at the cells' sizes, do not carry over
(a 320 px image's columns round to finer steps in bfloat16), so there
the control's track error has to stand well clear of the program's."""

import subprocess
import sys

import pytest

import harness
import tiny

SPEC = harness.load_spec(tiny.ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]


def _fails(numbers: dict, limits: dict) -> list:
    return [n for n, lim in limits.items() if numbers.get(n) is None or numbers[n] > lim]


@pytest.mark.parametrize("cell", CELLS)
def test_control_stands_clear_of_the_program(tmp_path, monkeypatch, cell):
    root = tiny.make(tmp_path)
    tiny.count_cpu_launches(monkeypatch)
    result, nums = tiny.run(root, cell, seconds=5.0, control=True)
    limits = harness.workload_of(cell, root / "gpu_bench")["correct"]
    assert result["correct"] and not _fails(nums, limits), result["checks"]
    assert nums["control"]["lk_px"] > 5 * nums["lk_px"], (nums, nums["control"])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cuda_card, cell):
    """control.py at the cell's own size, three seeds, a 30 s window."""
    out = subprocess.run([sys.executable, str(tiny.BENCH_DIR / "control.py"), "--workload", cell,
                          "--seconds", "30", "--seeds", "501,502,503"],
                         capture_output=True, text=True, cwd=tiny.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    limits = harness.workload_of(cell)["correct"]
    for line in out.stdout.strip().splitlines():
        rec = json.loads(line)
        assert rec["correct"] and not _fails(rec["program"], limits)
        assert _fails(rec["control"], limits)
