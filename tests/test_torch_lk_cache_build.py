"""The default tracker's keyframe half in the port: `build_lk_templates_lk`
(ops/lk_kernel.py), whose CUDA path is `lk_cache_build_kernel`, and the
launch plan of the frame half's kernel, `lk_cached_kernel`.

  * on the CPU the entry point is the plain `optical_flow.build_lk_templates`
    bit for bit, with gradients taken on the patches (what the frontend
    uses) and from full-image gradients, for one stream and for B = 3;
  * it matches the JAX package's `build_lk_templates` at the tolerances of
    tests/test_torch_lk_cached.py (templates and gradients within 1e-5 of
    their scale, inverse matrices within 1e-4 relative, the same gates);
  * CPU tensors handed to the CUDA wrappers raise, and so does the entry
    point's default device without a card;
  * `cached_plan` / `cached_route` / `cached_smem`, the twin of the
    launcher's `plan_cached`: the warp route at 24 px (slack 8), the block
    routes at every other window, under the H100's opt-in shared memory and
    a smaller one; the launcher's plan, cut out of csrc/lk_kernel.cu and
    built with g++, equals the twin;
  * `build_plan`, the twin of the build launcher's `plan_build`: a route
    at every window, shared memory within the opt-in, four one-warp items
    a block with no staging at the main path's 24 px, past 16 strips (464
    px) the wide route of 16 warps an item, each strip taken by one warp;
    the launcher's plan, cut out of csrc/lk_kernel.cu and built with g++,
    equals the twin at every window from 2 to 241 px and at wide windows
    to 1000 px, three opt-in limits, with and without gradients;
  * the frontend builds its cache through `build_lk_templates_lk`.

The kernel itself runs only on the card: chip_smoke.py holds it to the
plain version there (tmpl, gx and gy bit for bit).
"""

import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_vio_tpu.ops import optical_flow as jof
from kimera_vio_tpu_torch.common.types import stack_trees
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.frontend.camera import StereoCamera
from kimera_vio_tpu_torch.frontend.imu_frontend import PimParams
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendConfig, StereoFrontend
from kimera_vio_tpu_torch.ops import lk_kernel as lk
from kimera_vio_tpu_torch.ops import optical_flow as of

H, W = 120, 160
N_LEVELS = 3  # 120x160, 60x80, 30x40
H100_OPTIN = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
SMALL_OPTIN = 101376  # 99 KB, a smaller card's
SRC = lk._SRC.read_text()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(seed: int) -> np.ndarray:
    """A smooth random texture (bilinear upsampling of 8 px cells)."""
    rng = np.random.default_rng(seed)
    cells = rng.uniform(20, 235, (H // 8 + 2, W // 8 + 2)).astype(np.float32)
    y = np.arange(H, dtype=np.float32) / 8
    x = np.arange(W, dtype=np.float32) / 8
    y0, x0 = y.astype(int), x.astype(int)
    fy, fx = (y - y0)[:, None], (x - x0)[None, :]
    a, b = cells[y0][:, x0], cells[y0][:, x0 + 1]
    c, d = cells[y0 + 1][:, x0], cells[y0 + 1][:, x0 + 1]
    img = (1 - fy) * ((1 - fx) * a + fx * b) + fy * ((1 - fx) * c + fx * d)
    return np.ascontiguousarray(img, dtype=np.float32)


def _keypoints(win: int, seed: int, n: int = 24):
    """Keypoints anywhere in the image, a few within a window of each
    border, one invalid."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1).astype(np.float32)
    h = win / 2
    pts[:4] = [[h - 3, 40], [W - h + 2, 60], [2, 3], [W - 3, H - 2]]
    valid = np.ones(n, bool)
    valid[5] = False
    return pts, valid


def _inputs(win: int, seed: int):
    img = _image(seed)
    pts, valid = _keypoints(win, seed + 1)
    return img, pts, valid


def _torch(img, pts, valid, grads: bool):
    pyr = of.build_pyramid(torch.from_numpy(img), N_LEVELS - 1)
    return (pyr, torch.from_numpy(pts), torch.from_numpy(valid),
            [of._grad(p) for p in pyr] if grads else None)


def _assert_equal(a, b):
    assert len(a) == len(b)
    for lvl, (x, y) in enumerate(zip(a, b)):
        assert (x is None) == (y is None), lvl
        if x is not None:
            assert x.keys() == y.keys()
            for k in x:
                assert torch.equal(x[k], y[k]), (lvl, k)


@pytest.mark.parametrize("win", [24, 33])
@pytest.mark.parametrize("grads", [False, True], ids=["patch_scharr", "image_grads"])
def test_cpu_entry_point_is_the_plain_build(win, grads):
    pyr, pts, valid, g = _torch(*_inputs(win, 0), grads)
    out = lk.build_lk_templates_lk(pyr, pts, valid, win=win, prev_grads=g, device="cpu")
    plain = of.build_lk_templates(pyr, pts, valid, win=win, prev_grads=g)
    _assert_equal(out, plain)
    # 30x40 has no room for a window of 33 px.
    assert [t is None for t in out] == [False, False, win + 2 > 30]


@pytest.mark.parametrize("grads", [False, True], ids=["patch_scharr", "image_grads"])
def test_cpu_entry_point_with_three_streams(grads):
    """B = 3 stacked keyframes: the plain build of the stack, and each
    stream's own cache, bit for bit."""
    win = 24
    singles, stacks = [], []
    for seed in (0, 3, 6):
        pyr, pts, valid, g = _torch(*_inputs(win, seed), grads)
        singles.append(lk.build_lk_templates_lk(pyr, pts, valid, win=win, prev_grads=g,
                                                device="cpu"))
        stacks.append((pyr, pts, valid, g))
    pyr, pts, valid = (stack_trees(list(x)) for x in list(zip(*stacks))[:3])
    g = [tuple(torch.stack(list(pair)) for pair in zip(*lv))
         for lv in zip(*[s[3] for s in stacks])] if grads else None
    out = lk.build_lk_templates_lk(pyr, pts, valid, win=win, prev_grads=g, device="cpu")
    _assert_equal(out, of.build_lk_templates(pyr, pts, valid, win=win, prev_grads=g))
    for b, single in enumerate(singles):
        _assert_equal([None if t is None else {k: v[b] for k, v in t.items()} for t in out],
                      single)


@pytest.mark.parametrize("win", [24, 33])
@pytest.mark.parametrize("grads", [False, True], ids=["patch_scharr", "image_grads"])
def test_entry_point_matches_jax(win, grads):
    img, pts, valid = _inputs(win, 2)
    jp = jof.build_pyramid(jnp.asarray(img), N_LEVELS - 1)
    jt = jof.build_lk_templates(jp, jnp.asarray(pts), jnp.asarray(valid), win=win,
                                prev_grads=[jof._grad(p) for p in jp] if grads else None)
    tt = lk.build_lk_templates_lk(*_torch(img, pts, valid, False)[:3], win=win,
                                  prev_grads=_torch(img, pts, valid, grads)[3], device="cpu")
    assert len(jt) == len(tt)
    for lvl, (a, b) in enumerate(zip(jt, tt)):
        assert (a is None) == (b is None), lvl
        if a is None:
            continue
        good = np.asarray(a["good_g"])
        np.testing.assert_array_equal(b["good_g"].numpy(), good)
        assert good.sum() >= 10
        for k in ("tmpl", "gx", "gy"):
            x = np.asarray(a[k])
            np.testing.assert_allclose(b[k].numpy(), x, rtol=0, atol=1e-5 * np.abs(x).max(),
                                       err_msg=f"level {lvl} {k}")
        for k in ("inv00", "inv01", "inv11"):
            x = np.asarray(a[k])[good]
            np.testing.assert_allclose(b[k].numpy()[good], x, rtol=1e-4,
                                       atol=1e-4 * np.abs(x).max(), err_msg=f"level {lvl} {k}")


def test_cuda_wrappers_refuse_cpu_tensors_and_no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    pyr, pts, valid, _ = _torch(*_inputs(24, 0), False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lk.build_lk_templates_lk(pyr, pts, valid)  # device="cuda" by default
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        lk.lk_cache_build_cuda(pyr, pts, valid, win=24)
    templates = of.build_lk_templates(pyr, pts, valid, win=24)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        lk.lk_cached_cuda(templates, pyr, pts, valid, win=24, max_iter=3, eps=0.1)


@pytest.mark.parametrize("optin", [H100_OPTIN, SMALL_OPTIN])
def test_cached_routes_by_width(optin):
    """The warp route at 24 px with slack 8 (the JAX default), where one
    warp's patch and cache buffer fit; the block routes at every other
    window and slack, the first whose shared memory fits."""
    for slack in (8, 6):
        for win in range(2, 241):
            plan = lk.cached_plan(win, optin, slack)
            assert lk.cached_route(win, optin, slack) == plan.route
            assert plan.smem == lk.cached_smem(plan.route, win, slack, plan.warps) <= optin
            if (win, slack) == (24, 8):
                assert plan.route == "lk_cached warp" and plan.warps == lk._CACHED_WARP_BLOCK
            else:
                want = next((r for r in lk.CACHED_ROUTES[:2]
                             if lk.cached_smem(r, win, slack) <= optin), "lk_cached global")
                assert plan == lk.CachedPlan(want, 1, lk.cached_smem(want, win, slack)), win
    # The main path: 24 px, two keypoints a block, each warp's mbarrier (16
    # bytes), its 42x42 patch at a 56-float stride and one cache buffer.
    assert lk.cached_plan(24, optin) == lk.CachedPlan(
        "lk_cached warp", 2, 2 * (16 + 4 * (42 * 56 + 3 * 576)))
    assert lk.cached_plan(24, 16400) == lk.CachedPlan("lk_cached warp", 1, 16 + 4 * (42 * 56 + 3 * 576))
    assert lk.cached_route(23, optin) in lk.CACHED_ROUTES[:2]
    assert lk.cached_route(25, optin) in lk.CACHED_ROUTES[:2]


def test_warp_route_smem_layout():
    """The warp route's patch rows at a stride congruent to the window mod
    32 (a warp's 32 consecutive window pixels, and each lane's runs of 3,
    in distinct banks), every buffer whole 16-byte units."""
    win = lk._CACHED_WARP_WIN
    ps = lk.cached_patch_stride(win, lk._CACHED_WARP_SLACK)
    assert ps == 56 and ps >= win + 18 and ps % 32 == win % 32
    assert len({((p // win) * ps + p % win) % 32 for p in range(32)}) == 32
    assert len({((p // win) * ps + p % win) % 32 for p in range(0, 96, 3)}) == 32
    for warps in (1, 2):
        assert lk.cached_smem("lk_cached warp", win, 8, warps) % 16 == 0
    assert (42 * ps * 4) % 16 == 0 and (3 * win * win * 4) % 16 == 0


def _cut(start: str, end: str) -> str:
    i = SRC.index(start)
    return SRC[i:SRC.index(end, i) + len(end)]


def _constexpr(name: str) -> int:
    m = re.search(rf"constexpr int {re.escape(name)} = (\d+);", SRC)
    assert m, name
    return int(m.group(1))


def test_plan_constants_match_the_source():
    assert _constexpr("kCachedWarpWin") == lk._CACHED_WARP_WIN
    assert _constexpr("kCachedWarpSlack") == lk._CACHED_WARP_SLACK
    assert _constexpr("kCachedWarpBlock") == lk._CACHED_WARP_BLOCK
    assert _constexpr("kCachedReportInts") == lk._CACHED_REPORT_INTS
    m = re.search(r"enum CachedRoute : int \{([^}]*)\};", SRC)
    assert m
    names = [e.split("=")[0].strip() for e in m.group(1).split(",")]
    assert [lk.CACHED_ROUTES[names.index(n)] for n in
            ("kCachedShared", "kCachedPatch", "kCachedGlobal", "kCachedWarp")] == list(
        lk.CACHED_ROUTES)


def test_launcher_plan_equals_twin(tmp_path):
    """plan_cached and what it reads, cut out of csrc/lk_kernel.cu and built
    with g++, against `cached_plan` at every window to 240 px, two slacks,
    three opt-in limits."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "no C++ compiler to build the launcher's plan"
    src = "\n".join([
        "#include <cstdio>",
        "#include <cstddef>",
        "#include <cstdint>",
        "#define __host__",
        "#define __device__",
        _cut("constexpr int kMaxLevels", ";"),
        _cut("constexpr int kThreads", ";"),
        _cut("constexpr int kWarps", ";"),
        _cut("enum CachedRoute", "};"),
        _cut("constexpr int kCachedWarpWin", ";"),
        _cut("constexpr int kCachedWarpSlack", ";"),
        _cut("constexpr int kCachedWarpBlock", ";"),
        _cut("__host__ __device__ constexpr int round4", "}"),
        _cut("__host__ __device__ constexpr int cached_patch_stride", "\n}"),
        _cut("constexpr int kCachedWarpS =", "kCachedWarpWin));"),
        _cut("size_t cached_smem(int route", "\n}"),
        _cut("struct CachedPlan {", "};"),
        _cut("CachedPlan plan_cached(", "\n}\n"),
        "int main() {",
        "  int optin, win, slack;",
        "  while (std::scanf(\"%d %d %d\", &optin, &win, &slack) == 3) {",
        "    const CachedPlan p = plan_cached(win, slack, optin);",
        "    std::printf(\"%d %d %d\\n\", p.route, p.warps, p.smem);",
        "  }",
        "}",
    ])
    (tmp_path / "plan.cpp").write_text(src)
    exe = tmp_path / "plan"
    subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(exe), str(tmp_path / "plan.cpp")],
                   check=True, capture_output=True, text=True)
    cases = [(optin, win, slack) for optin in (H100_OPTIN, SMALL_OPTIN, 16400)
             for win in range(2, 241) for slack in (8, 6)]
    out = subprocess.run([str(exe)], input="\n".join(" ".join(map(str, c)) for c in cases),
                         capture_output=True, text=True, check=True).stdout.split("\n")
    assert len(list(filter(None, out))) == len(cases)
    for (optin, win, slack), line in zip(cases, out):
        route, warps, smem = map(int, line.split())
        want = lk.cached_plan(win, optin, slack)
        assert (lk.CACHED_ROUTES[route], warps, smem) == tuple(want), (optin, win, slack)


@pytest.mark.parametrize("optin", [H100_OPTIN, SMALL_OPTIN, 16400])
def test_build_plan_by_width(optin):
    """Every window has a route; its shared memory fits the opt-in; a
    window is cut into strips of at most _BUILD_STRIP columns (32 lanes
    less 3 of halo), as few as that allows, equal but for the last; a
    block is whole warps, at most 512 threads; rows are
    staged in shared memory from _BUILD_STAGE_FROM px wherever one item's
    staging fits; the main path's 24 px takes four one-warp items a block
    and no staging; with gradients an item gets _BUILD_WARPS warps."""
    for grads in (False, True):
        for win in range(2, 242):
            plan = lk.build_plan(win, optin, grads)
            assert plan.route in lk.BUILD_ROUTES and plan.smem <= optin, (win, plan)
            cw = lk.build_strip_cols(win)
            assert plan.strips == lk.build_strips(win) == -(-win // cw)
            assert cw <= lk._BUILD_STRIP and plan.strips == -(-win // lk._BUILD_STRIP)
            assert (plan.strips - 1) * cw < win <= plan.strips * cw
            units = lk._BUILD_WARPS if grads else plan.strips
            assert plan.threads == 32 * plan.items * units <= 512, (win, plan)
            assert plan.items == 1 or not grads
            assert plan.route == f"lk_cache_build {'grads' if grads else 'sweep'}", (win, plan)
            stage = lk.build_stage_bytes(win)
            assert plan.staged == (not grads and win >= lk._BUILD_STAGE_FROM
                                   and 16 * units + stage <= optin), (win, plan)
            if not grads:
                assert plan.smem == plan.items * (16 * units + (stage if plan.staged else 0))
    assert lk.build_stage_bytes(24) == 0 and lk.build_stage_bytes(61) == 4 * 6 * 492
    assert lk.build_plan(24, H100_OPTIN) == lk.BuildPlan("lk_cache_build sweep", 1, 4, 128, 64, False)
    assert lk.build_plan(41, H100_OPTIN) == lk.BuildPlan("lk_cache_build sweep", 2, 2, 128, 64, False)
    assert lk.build_plan(61, H100_OPTIN) == lk.BuildPlan("lk_cache_build sweep", 3, 1, 96,
                                                         48 + 4 * 6 * 492, True)
    assert lk.build_plan(101, H100_OPTIN)[1::4] == (4, True)
    assert lk.build_plan(241, H100_OPTIN)[1::4] == (9, True)


@pytest.mark.parametrize("optin", [H100_OPTIN, SMALL_OPTIN, 16400])
@pytest.mark.parametrize("win", [440, 464, 465, 470, 478, 493, 494, 600, 752, 1000])
def test_build_plan_past_sixteen_strips(optin, win):
    """A window of more strips than an item may have warps takes the wide
    route: _BUILD_MAX_UNITS warps, which take the strips unit, unit +
    _BUILD_MAX_UNITS, ... in turn, so that each strip is swept by exactly
    one warp; its rows go out directly (a staged chunk would hold columns
    of a warp's later strip), and the plan's shared memory is the warps'
    partial sums. Up to 16 strips the sweep, a warp a strip."""
    plan = lk.build_plan(win, optin)
    strips = lk.build_strips(win)
    units = plan.threads // (32 * plan.items)
    assert plan.strips == strips and plan.items == 1
    assert units == min(strips, lk._BUILD_MAX_UNITS)
    swept = sorted(s for unit in range(units) for s in range(unit, strips, units))
    assert swept == list(range(strips)), (win, plan)
    if strips > lk._BUILD_MAX_UNITS:
        assert plan == lk.BuildPlan("lk_cache_build wide", strips, 1, 512, 256, False)
    else:
        assert plan.route == "lk_cache_build sweep", (win, plan)
        assert plan.staged == (16 * units + lk.build_stage_bytes(win) <= optin), (win, plan)
    assert lk.build_plan(win, optin, True) == lk.BuildPlan(
        "lk_cache_build grads", strips, 1, 32 * lk._BUILD_WARPS, 16 * lk._BUILD_WARPS, False)


def test_build_stage_layout():
    """Each plane of an item's row staging holds a chunk of window rows
    after up to 3 floats of alignment, in whole 16-byte units."""
    for win in range(2, 242):
        assert lk.build_stage_bytes(win) % 96 == 0
        if win != lk._BUILD_FIXED_WIN:
            plane = lk.build_stage_bytes(win) // 24
            assert lk._BUILD_CHUNK * win + 3 <= plane < lk._BUILD_CHUNK * win + 7


def test_build_launcher_plan_equals_twin(tmp_path):
    """plan_build and what it reads, cut out of csrc/lk_kernel.cu and built
    with g++, against `build_plan` at every window from 2 to 241 px and at
    wide windows past 16 strips, with and without gradients, under three
    opt-in limits; the source's
    constants equal the twin's."""
    assert _constexpr("kBuildStrip") == lk._BUILD_STRIP
    assert _constexpr("kBuildWarps") == lk._BUILD_WARPS
    assert _constexpr("kBuildMaxUnits") == lk._BUILD_MAX_UNITS
    assert _constexpr("kBuildChunk") == lk._BUILD_CHUNK
    assert _constexpr("kBuildFixedWin") == lk._BUILD_FIXED_WIN
    assert _constexpr("kBuildStageFrom") == lk._BUILD_STAGE_FROM
    assert _constexpr("kBuildReportInts") == lk._BUILD_REPORT_INTS
    m = re.search(r"enum BuildRoute : int \{([^}]*)\};", SRC)
    assert m
    names = [e.split("=")[0].strip() for e in m.group(1).split(",")]
    assert [lk.BUILD_ROUTES[names.index(n)]
            for n in ("kBuildSweep", "kBuildGrads", "kBuildWide")] == list(lk.BUILD_ROUTES)
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "no C++ compiler to build the launcher's plan"
    src = "\n".join([
        "#include <cstdio>",
        "#include <cstddef>",
        "#define __host__",
        "#define __device__",
        _cut("constexpr int kBuildStrip", "BuildPlan plan_build("),
        _cut("BuildPlan plan_build(", "\n}\n"),
        "int main() {",
        "  int optin, win, grads;",
        "  while (std::scanf(\"%d %d %d\", &optin, &win, &grads) == 3) {",
        "    const BuildPlan p = plan_build(win, grads, optin);",
        "    std::printf(\"%d %d %d %d %d %d\\n\", p.route, p.strips, p.items, p.threads, p.smem,",
        "                p.staged);",
        "  }",
        "}",
    ]).replace("BuildPlan plan_build(\nBuildPlan plan_build(", "BuildPlan plan_build(")
    (tmp_path / "plan.cpp").write_text(src)
    exe = tmp_path / "plan"
    subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(exe), str(tmp_path / "plan.cpp")],
                   check=True, capture_output=True, text=True)
    cases = [(optin, win, grads) for optin in (H100_OPTIN, SMALL_OPTIN, 16400)
             for win in [*range(2, 242), 464, 465, 470, 478, 494, 600, 1000]
             for grads in (0, 1)]
    out = subprocess.run([str(exe)], input="\n".join(" ".join(map(str, c)) for c in cases),
                         capture_output=True, text=True, check=True).stdout.split("\n")
    assert len(list(filter(None, out))) == len(cases)
    for (optin, win, grads), line in zip(cases, out):
        route, *rest, staged = map(int, line.split())
        want = lk.build_plan(win, optin, bool(grads))
        assert (lk.BUILD_ROUTES[route], *rest, bool(staged)) == tuple(want), (optin, win, grads)


def test_frontend_builds_its_cache_through_the_entry_point(monkeypatch):
    """The keyframe's template cache (`_lk_store`, under the default
    tracker) comes from `build_lk_templates_lk` on the frontend's device,
    and equals the plain build at the keyframe's features."""
    params = synthetic_params(width=320, height=240, max_features=64, max_landmarks=96,
                              nr_states=5)
    cfg = FrontendConfig.from_params(params.frontend, max_features=64)
    assert cfg.lk_impl == "matmul"
    dev = torch.device("cpu")
    fe = StereoFrontend(cfg, StereoCamera.from_params(params.left_cam, params.right_cam,
                                                      device="cpu"),
                        PimParams.from_params(params.imu, device="cpu"), dev)
    calls = []
    entry = vision_frontend.build_lk_templates_lk

    def counted(prev_pyr, prev_pts, valid, **kw):
        calls.append(kw)
        return entry(prev_pyr, prev_pts, valid, **kw)

    monkeypatch.setattr(vision_frontend, "build_lk_templates_lk", counted)
    prov = SyntheticStereoProvider(n_frames=2, width=320, height=240)
    left = torch.from_numpy(prov.load_image(("left", 0)))
    state, _ = fe.init_state(left, torch.from_numpy(prov.load_image(("right", 0))), 0.0)
    assert len(calls) == 1 and calls[0]["device"] == dev and calls[0]["win"] == cfg.klt_win
    pyr = of.build_pyramid(left.to(torch.float32), cfg.klt_max_level)
    feats = state.lkf_features
    _assert_equal(state.lkf_templates,
                  of.build_lk_templates(pyr, feats.uv, feats.mask, win=cfg.klt_win))
    assert int(state.lkf_templates[0]["good_g"].sum()) >= 20
