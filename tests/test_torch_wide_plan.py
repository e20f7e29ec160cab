"""The launch plan of the LK kernel's `lk_wide_kernel` (windows over 54 px).

`ops/lk_kernel.py:wide_plan(win, optin_bytes)` is the Python twin of the
launcher's `plan_wide` in csrc/lk_kernel.cu: per window, the route (the
template in shared memory or re-blended from the level planes), the
cluster size C, the threads per block, the window rows per block and the
shared memory per block. chip_smoke.py holds the launcher's report of each
launch to it on the card; here, on the H100's opt-in shared memory
(232,448 B), the plan is checked against what the kernel needs:

  * the cluster's bands cover the window's rows exactly once, in rank
    order, none empty;
  * the shared memory per block is the kernel's layout (two mbarriers,
    2 x C x warps reduction slots, the band's template and gradients on
    the shared route) and at most the opt-in bytes;
  * C is a portable cluster size, the threads a multiple of 32, at most
    1024;
  * the global route only where no cluster size fits the band;

at the windows the card runs and at the edges of the rule, and at every
window from 55 to 401 px in one case. The source's constants, its `Route`
enum and `plan_wide` itself are parsed from csrc/lk_kernel.cu: the plan
built with g++ from that text gives the twin's plan at every window.
"""

import re
import shutil
import subprocess

import pytest
import torch

from kimera_vio_tpu_torch.ops import lk_kernel as lk

H100_OPTIN = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
SRC = lk._SRC.read_text()
WINDOWS = range(lk.MAX_WIN + 1, 402)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shared_fits(win: int, optin: int) -> bool:
    """Whether some cluster size and block size holds the band's template
    and gradients (3 planes of runs of 4 pixels, one float4 each) with its
    mbarriers and reduction slots in the opt-in shared memory."""
    nrun = -(-win // 4)
    return any(16 * (1 + 2 * C * (T // 32)) + 3 * 16 * -(-win // C) * nrun <= optin
               for C in (1, 2, 4, 8) for T in (128, 256, 512))


def _bands(plan: lk.WidePlan, win: int) -> list[tuple[int, int]]:
    """The window rows [start, stop) of each block of the cluster, in rank
    order, as lk_wide_kernel splits them (block r from r * band_rows)."""
    return [(r * plan.band_rows, min((r + 1) * plan.band_rows, win))
            for r in range(plan.clusters)]


def _check(win: int, optin: int = H100_OPTIN) -> lk.WidePlan:
    plan = lk.wide_plan(win, optin)
    assert plan is not None, win
    bands = _bands(plan, win)
    assert len(bands) == plan.clusters
    assert bands[0][0] == 0 and bands[-1][1] == win, (win, bands)
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:])), (win, bands)
    assert all(stop > start for start, stop in bands), (win, bands)
    assert plan.clusters in (1, 2, 4, 8)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.smem <= optin
    slots = 16 * (1 + 2 * plan.clusters * (plan.threads // 32))
    nrun = -(-win // 4)
    if plan.route == "lk_wide shared":
        assert plan.smem == slots + 3 * 16 * plan.band_rows * nrun
    else:
        assert plan.route == "lk_wide global" and plan.smem == slots
    assert (plan.route == "lk_wide global") == (not _shared_fits(win, optin)), win
    return plan


# The rows the card runs (chip_smoke.py WIDE_WINS: 61, 101, 151, 401), the
# window over the old single-block shared limit (139 / 140), the narrowest
# lk_wide window and one on the global route; the plans the card measured
# fastest in the C sweep (PERF.md, scripts/lk_kernel_ab.py).
@pytest.mark.parametrize("win, route, clusters, threads", [
    (55, "lk_wide shared", 4, 128),
    (61, "lk_wide shared", 4, 128),
    (101, "lk_wide shared", 8, 128),
    (139, "lk_wide shared", 8, 128),
    (140, "lk_wide shared", 8, 128),
    (151, "lk_wide shared", 8, 128),
    (401, "lk_wide global", 4, 128),
])
def test_wide_plan_at(win, route, clusters, threads):
    plan = _check(win)
    assert (plan.route, plan.clusters, plan.threads) == (route, clusters, threads)


def test_wide_plan_every_window():
    plans = [_check(win) for win in WINDOWS]
    shared = [p.route == "lk_wide shared" for p in plans]
    # The shared route up to some width, the global one above it.
    assert shared == sorted(shared, reverse=True)
    assert shared[0] and not shared[-1]


def test_wide_wins_run_both_routes():
    """chip_smoke.py's lk_wide rows take both routes of the plan, each on a
    cluster of two or more blocks, so the card holds both against plain."""
    import chip_smoke

    plans = [lk.wide_plan(win, H100_OPTIN) for win, _ in chip_smoke.WIDE_WINS]
    assert {p.route for p in plans} == {"lk_wide shared", "lk_wide global"}
    assert all(p.clusters >= 2 for p in plans), plans


def _constexpr(name: str) -> str:
    m = re.search(rf"constexpr int {re.escape(name)}(\[\])? = ([^;]+);", SRC)
    assert m, name
    return m.group(2)


def test_plan_constants_match_the_source():
    assert int(_constexpr("kRun")) == lk._RUN
    ints = lambda text: tuple(int(x) for x in text.strip("{} ").split(","))  # noqa: E731
    assert ints(_constexpr("kWideClusters")) == lk._WIDE_CLUSTERS
    assert ints(_constexpr("kWideThreads")) == lk._WIDE_THREADS
    for name, value in (("kWideMaxThreads", lk._WIDE_MAX_THREADS),
                        ("kWideMinBlocks", lk._WIDE_MIN_BLOCKS),
                        ("kWideKeypoints", lk._WIDE_KEYPOINTS), ("kSms", lk._SMS),
                        ("kBlockSmemReserve", lk._BLOCK_SMEM_RESERVE),
                        ("kReportInts", lk._REPORT_INTS)):
        assert int(_constexpr(name).split("//")[0]) == value, name
    m = re.search(r"constexpr int kSmThreads = (\d+), kSmBlocks = (\d+), kSmRegs = (\d+);", SRC)
    assert m and tuple(map(int, m.groups())) == (lk._SM_THREADS, lk._SM_BLOCKS, lk._SM_REGS)
    assert lk._WIDE_REGS == 64  # the registers of (512, 2) launch bounds


def test_routes_match_the_enum():
    m = re.search(r"enum Route \{([^}]*)\};", SRC)
    assert m
    names = [e.split("=")[0].strip() for e in m.group(1).split(",")]
    assert len(names) == len(lk.ROUTES)
    assert lk.ROUTES[names.index("kRouteWideShared")] == "lk_wide shared"
    assert lk.ROUTES[names.index("kRouteWideGlobal")] == "lk_wide global"
    assert {lk.wide_plan(w, H100_OPTIN).route for w in WINDOWS} == {"lk_wide shared",
                                                                      "lk_wide global"}


def _plan_source() -> str:
    """plan_wide and what it reads, cut out of csrc/lk_kernel.cu, with a
    main() printing its plan for each window on stdin's opt-in bytes."""
    def cut(start: str, end: str) -> str:
        i = SRC.index(start)
        return SRC[i:SRC.index(end, i) + len(end)]
    return "\n".join([
        "#include <cstdio>",
        cut("constexpr int kRun = 4;", "constexpr int kBlockSmemReserve = 1024;"),
        cut("enum Route {", "};"),
        cut("struct WidePlan {", "};"),
        cut("long lmin(", "}"),
        cut("WidePlan plan_wide(int win, int optin) {", "\n  return best;\n}"),
        "int main() {",
        "  int optin, lo, hi;",
        "  if (std::scanf(\"%d %d %d\", &optin, &lo, &hi) != 3) return 1;",
        "  for (int w = lo; w <= hi; ++w) {",
        "    const WidePlan p = plan_wide(w, optin);",
        "    std::printf(\"%d %d %d %d %d %d\\n\", w, p.route, p.clusters, p.threads,",
        "                p.band_rows, p.smem);",
        "  }",
        "}",
    ])


def test_launcher_plan_equals_twin(tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "no C++ compiler to build the launcher's plan"
    src = tmp_path / "plan.cpp"
    src.write_text(_plan_source())
    exe = tmp_path / "plan"
    subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(exe), str(src)], check=True,
                   capture_output=True, text=True)
    for optin in (H100_OPTIN, 101376):  # the H100's opt-in bytes, and a smaller one (99 KB)
        out = subprocess.run([str(exe)], input=f"{optin} {WINDOWS[0]} {WINDOWS[-1]}",
                             capture_output=True, text=True, check=True).stdout.split("\n")
        for line in filter(None, out):
            win, route, clusters, threads, band_rows, smem = map(int, line.split())
            plan = lk.wide_plan(win, optin)
            assert plan is not None, (win, optin)
            assert (lk.ROUTES[route], clusters, threads, band_rows, smem) == tuple(plan), line
