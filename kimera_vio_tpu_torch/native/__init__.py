"""Host-side C++ helpers, built at first use and loaded through ctypes.

Each `native/<name>.cpp` has a plain C interface. `load(name)` compiles it
with the host C++ compiler (the one nvcc drives, `g++` or `c++` on the
PATH) into `kimera_vio_tpu_torch/_build/`, once per source, and returns
the library. A missing compiler or a failed build raises: no caller falls
back to its plain version, which exists for the tests.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE.parent / "_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_LOCK = threading.Lock()  # the stager and prefetch threads load too


def _compiler() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++ or c++) on the PATH: "
                       "the native helpers cannot be built")


def build(name: str) -> Path:
    """Compile native/<name>.cpp into _build/ (once per source and flags);
    returns the .so path. Raises on failure."""
    src = _HERE / f"{name}.cpp"
    key = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"lib{name}_{key}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"lib{name}_{key}.{os.getpid()}.tmp"
    res = subprocess.run([_compiler(), *_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {src.name} failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of native/<name>.cpp, built if needed."""
    with _LOCK:
        return _load(name)
