#!/usr/bin/env python3
"""Count the instructions nvcc emitted for the LK kernels.

    python3 scripts/sass_counts.py [--kernel lk_cache_build_kernel]

Builds csrc/lk_kernel.cu as the wrapper does (ops/lk_kernel.py:build_kernel),
disassembles the library with the toolkit's `cuobjdump -sass` and, for
each instantiation of the kernels whose name holds `--kernel`, counts its
instructions by opcode: those from its entry to its first EXIT (the path
a warp runs when its shuffles converge; the code after it handles
divergent shuffles), and in each loop of that path (a backward branch).
Prints one JSON line a kernel. Needs the CUDA toolkit; a card is not
used.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kimera_vio_tpu_torch.ops import lk_kernel as lk  # noqa: E402

INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")


def opcode(name: str) -> str:
    return name.split(".")[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="lk_cache_build_kernel")
    args = ap.parse_args()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass_counts: needs the CUDA toolkit's cuobjdump", file=sys.stderr)
        return 2
    so, _ = lk.build_kernel()
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        if args.kernel not in name:
            continue
        insns = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in INSN.finditer(part)]
        path = []
        for ins in insns:
            path.append(ins)
            if ins[1] == "EXIT":
                break
        loops = []
        for addr, op, rest in path:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and target and int(target.group(1), 16) < addr:
                body = [o for a, o, _ in path if int(target.group(1), 16) <= a <= addr]
                loops.append({"instructions": len(body),
                              "by_opcode": dict(collections.Counter(map(opcode, body))
                                                .most_common())})
        print(json.dumps({"kernel": re.sub(r"_ZN\w*?_GLOBAL__N__\w+?_cu_\w+?\d+(?=lk_)", "", name),
                          "path_instructions": len(path),
                          "path_by_opcode": dict(collections.Counter(opcode(o) for _, o, _ in path)
                                                 .most_common()),
                          "loops": loops}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
