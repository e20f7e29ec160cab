"""No module that a run of the harness loads is JAX or the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's)."""

import subprocess
import sys

import harness
import tiny


def test_forbidden_names_are_whole_top_level_names():
    mods = ["kimera_vio_tpu_torch", "kimera_vio_tpu_torch.ops.lk_kernel", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["kimera_vio_tpu.ops"]) == ["kimera_vio_tpu"]
    assert harness.forbidden_modules(["jax._src", "jaxlib", "flax.linen"]) == ["flax", "jax",
                                                                              "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole small run on the CPU in a fresh interpreter, traced, then
    every module it loaded."""
    code = f"""
import sys, time, torch
sys.path[:0] = [{str(tiny.BENCH_DIR / 'tests')!r}, {str(tiny.BENCH_DIR)!r}, {str(tiny.ROOT)!r}]
import harness, tiny
from pathlib import Path
root = tiny.make(Path({str(tmp_path)!r}))
harness.execute(root, "euroc_stereo.fleet8", 5, 2.0, True, torch.device("cpu"),
                time.perf_counter(), bench_dir=root / "gpu_bench")
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print("FORBIDDEN", harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN []"
    assert "kimera_vio_tpu_torch" in out.stdout
