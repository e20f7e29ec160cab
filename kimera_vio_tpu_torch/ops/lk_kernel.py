"""Pyramidal Lucas-Kanade: the CUDA kernels, their plain PyTorch twins, the trackers.

Replaces the Pallas TPU tracker kimera_vio_tpu/ops/pallas/lk_kernel.py:
both of its kernels, `_level_kernel` (:68, windows gathered by XLA) and
`_level_kernel_vmem` (:332, whole level resident in VMEM), the XLA level
`klt_track_pallas` falls back to on small levels, and its coarse-to-fine
loop become ONE CUDA kernel (csrc/lk_kernel.cu) launched once per frame;
the tracker `klt_track_lk` has the signature and the level plan of
`klt_track_pallas` (:649-728).

The level function, per keypoint:
  * template/gx/gy windows blended bilinearly at the previous-frame
    position; 2x2 gradient matrix G, min-eigenvalue gate, G^-1;
  * up to `max_iter` forward-additive Gauss-Newton steps, exiting at the
    keypoint's own convergence (|step| < eps);
  * with `window_rule` (the Pallas kernels): windows clamped as
    `_gather_windows` / `_level_kernel_vmem` clamp them, and the keypoint
    fails when it leaves its (search_rows x 128) search window;
  * without it: the reference's XLA level (`optical_flow._track_level` of
    the JAX package, edge-replicated windows), which `klt_track_pallas`
    uses on levels too small for the search window.

Pallas ran a block of 8 keypoints until all 8 converged and re-checked the
window of a converged keypoint while its neighbours iterated; here each
keypoint stops at its own convergence and its window is checked before
each of its own steps (the same per-keypoint rule as the XLA tracker). The
TPU workarounds (bf16 residency, one-hot select matmuls, dynamic lane
roll, blocks of 8) have no counterpart.

`level_table` is the level plan both sides walk: `track_pyramid` (the
plain coarse-to-fine loop over `lk_level_plain`) and the kernel, which
receives it by value as a launch parameter.

Stream axis: levels may be (B, H, W) planes of B streams with keypoints
(B, N, 2) and flags (B, N); each keypoint reads its own stream's planes,
and one launch tracks all B x N keypoints (`FleetVio`,
parallel/fleet.py). 2-D levels with (N, 2) keypoints are one stream.

Dispatch: a CPU tensor runs `track_pyramid(lk_level_plain, ...)`; a CUDA
tensor launches the kernel (`lk_pyramid_cuda`) or raises. There is no
fallback between the two.

The JAX package's default tracker (lk_impl="matmul",
kimera_vio_tpu/ops/optical_flow.py:461 `klt_track_cached`) tracks against
a per-keyframe template cache inside one search patch a level. Its two
halves have entry points with the same no-fallback rule:
`build_lk_templates_lk` builds the cache (CPU tensors: the plain
`optical_flow.build_lk_templates`; CUDA tensors: one launch of
`lk_cache_build_kernel`, `lk_cache_build_cuda`), and `klt_track_cached_lk`
tracks a frame against it (CPU: the plain `optical_flow.klt_track_cached`;
CUDA: one launch of `lk_cached_kernel`, `lk_cached_cuda`).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.ops.corner_detection import image_gradients

_LANES = 128  # search-window width (the TPU lane width in the reference)
# Largest padded level `klt_track_pallas` keeps resident in VMEM
# (klt_track_pallas: VMEM_LIMIT_PX); larger levels took the gather kernel.
_VMEM_LIMIT_PX = 480 * 768 + 8

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC = _PKG_DIR / "csrc" / "lk_kernel.cu"
_BUILD_DIR = _PKG_DIR / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # Keep a*b + c as two roundings, like the plain PyTorch version, so the
    # two differ only in the order of the window sums.
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# Level plan (klt_track_pallas's per-level choice)
# ---------------------------------------------------------------------------


def level_mode(H: int, W: int, win: int, search_rows: int | None):
    """How `klt_track_pallas` treats an (H, W) level: ("vmem", clamp_h),
    ("gather", clamp_h), ("xla", None) or ("skip", None). `clamp_h` is the
    height the window origins are clamped to: the 8-row padded height for
    the VMEM kernel, the true height for the gather kernel. With
    `search_rows=None` (the reference's gather tracker, `klt_track`) every
    level the window fits in is an "xla" level."""
    if search_rows is None:
        return ("xla", None) if min(H, W) >= win + 2 else ("skip", None)
    Hp8 = _round_up(H, 8)
    fits_vmem = Hp8 * _round_up(W, _LANES) <= _VMEM_LIMIT_PX
    if fits_vmem and H >= search_rows and min(H, W) >= win + 4:
        return "vmem", Hp8
    if H < search_rows + 4 or W < _LANES + 4:
        return ("xla", None) if min(H, W) >= win + 2 else ("skip", None)
    return "gather", H


_MODE_CODES = {"skip": 0, "xla": 1, "vmem": 2, "gather": 3}  # csrc/lk_kernel.cu: Mode
_MAX_LEVELS = 8  # csrc/lk_kernel.cu: kMaxLevels
# csrc/lk_kernel.cu: Route, what a launch ran (the instantiation or, for
# lk_wide, where its template lives).
ROUTES = ("<24, 56, 24>", "<0, 0, 32>", "<0, 0, 54>", "lk_wide shared", "lk_wide global")
_REPORT_INTS = 7  # csrc/lk_kernel.cu: kReportInts
# csrc/lk_kernel.cu: kMaxWinWide. The widest window of the window rule, as
# of the Pallas tracker: its search-window clip search_rows - win - 2
# (pallas/lk_kernel.py:177-181) must stay >= 0 at its fixed 56 rows. Wider
# windows take the gather rule (search_rows=None), at any width.
MAX_WIN = 54


# csrc/lk_kernel.cu: the constants of lk_wide_kernel's launch plan
# (tests/test_torch_wide_plan.py parses them from the source).
_RUN = 4                         # kRun: adjacent pixels a thread blends at a time
_WIDE_CLUSTERS = (1, 2, 4, 8)    # kWideClusters
_WIDE_THREADS = (128, 256, 512)  # kWideThreads
_WIDE_MAX_THREADS = 512          # kWideMaxThreads
_WIDE_MIN_BLOCKS = 2             # kWideMinBlocks
_WIDE_REGS = 65536 // (_WIDE_MAX_THREADS * _WIDE_MIN_BLOCKS) // 8 * 8  # kWideRegs
_WIDE_KEYPOINTS = 256            # kWideKeypoints
_SMS = 132                       # kSms
_SM_THREADS, _SM_BLOCKS, _SM_REGS = 2048, 32, 65536
_BLOCK_SMEM_RESERVE = 1024       # kBlockSmemReserve


class WidePlan(NamedTuple):
    """How `lk_wide_kernel` (windows over 54 px) is launched: `route` (a
    name of ROUTES: the template in shared memory or re-blended from the
    level planes), `clusters` blocks per keypoint, `threads` per block,
    `band_rows` window rows per block (block r holds rows r * band_rows
    onward) and `smem` dynamic shared memory per block in bytes."""

    route: str
    clusters: int
    threads: int
    band_rows: int
    smem: int


def wide_plan(win: int, optin_bytes: int) -> WidePlan | None:
    """The launch plan of `lk_wide_kernel`, the twin of csrc/lk_kernel.cu's
    `plan_wide` (the launcher reports the plan it took; chip_smoke.py holds
    the report to this). Candidates are a cluster size C and a block size T:
    a block holds ceil(win / C) window rows, two mbarriers (16 bytes) and
    2 x C x warps reduction slots (16 bytes each), and on the shared route
    its band's template and gradients (3 x _RUN floats per run of _RUN
    pixels). An SM holds the blocks its threads, registers, block slots and
    shared memory allow; the card holds _SMS times that over C keypoints at
    once. The shared route wins wherever a candidate fits it; then the
    fewest waves of a _WIDE_KEYPOINTS frame, then the fewest runs per
    thread, then the larger cluster. None if no candidate fits."""
    nrun = -(-win // _RUN)
    for shared in (True, False):
        best, best_key = None, None
        for C in _WIDE_CLUSTERS:
            R = -(-win // C)
            for T in _WIDE_THREADS:
                smem = 16 * (1 + 2 * C * (T // 32)) + (4 * 3 * _RUN * R * nrun if shared else 0)
                if smem > optin_bytes:
                    continue
                blocks = min(_SM_BLOCKS, _SM_THREADS // T, _SM_REGS // (T * _WIDE_REGS),
                             (optin_bytes + _BLOCK_SMEM_RESERVE) // (smem + _BLOCK_SMEM_RESERVE))
                resident = _SMS * blocks // C
                if resident < 1:
                    continue
                waves = -(-_WIDE_KEYPOINTS // resident)
                runs_per_thread = -(-(R * nrun) // T)
                key = (-waves, -runs_per_thread, C)
                if best_key is None or key > best_key:
                    best_key = key
                    best = WidePlan("lk_wide shared" if shared else "lk_wide global",
                                    C, T, R, smem)
        if best is not None:
            return best
    return None


class LevelPlan(NamedTuple):
    """One entry of the coarse-to-fine plan: pyramid level `level` of
    `shape` (H, W) is tracked in `mode` with window origins clamped to
    `clamp_h`; the running point and its base are first multiplied by
    `scale`, and the level's `ok` joins the result when `keep_ok`."""

    level: int
    shape: tuple[int, int]
    mode: str
    clamp_h: int | None
    scale: float
    keep_ok: bool


def level_table(shapes, win: int, search_rows: int | None) -> list[LevelPlan]:
    """`klt_track_pallas`'s coarse-to-fine plan over pyramid level shapes
    (level 0 first), coarsest entry first. Points start at
    `pts / 2**(n-1)` and double on every finer level, skipped levels
    included; every level sees the original `valid`; only level 0's `ok`
    is kept, and not when it is an XLA level of the Pallas tracker."""
    n = len(shapes)
    plan = []
    for lvl in range(n - 1, -1, -1):
        H, W = (int(d) for d in shapes[lvl])
        mode, clamp_h = level_mode(H, W, win, search_rows)
        keep_ok = lvl == 0 and mode != "skip" and (mode != "xla" or search_rows is None)
        scale = 1.0 / 2.0 ** (n - 1) if lvl == n - 1 else 2.0
        plan.append(LevelPlan(lvl, (H, W), mode, clamp_h, scale, keep_ok))
    return plan


# ---------------------------------------------------------------------------
# Plain PyTorch version of the level function
# ---------------------------------------------------------------------------


def _read(img: torch.Tensor, s: torch.Tensor, rows: torch.Tensor,
          cols: torch.Tensor) -> torch.Tensor:
    """img[s, rows, cols] with edge-clamped indices; img (B,H,W), s (M,)
    the stream of each keypoint, rows (M,R), cols (M,C) -> (M,R,C)."""
    _, H, W = img.shape
    r = torch.clamp(rows, 0, H - 1)
    c = torch.clamp(cols, 0, W - 1)
    return img[s[:, None, None], r[:, :, None], c[:, None, :]]


def _blend4(raw: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """4-tap bilinear blend of (N, w+1, w+1) windows with per-keypoint
    scalar weights, in the reference's term order."""
    fx = fx[:, None, None]
    fy = fy[:, None, None]
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    return (
        w00 * raw[:, :-1, :-1]
        + w01 * raw[:, :-1, 1:]
        + w10 * raw[:, 1:, :-1]
        + w11 * raw[:, 1:, 1:]
    )


def lk_level_plain(
    prev, gx, gy, cur, base, pts, valid, *,
    win: int, max_iter: int, eps: float, min_eig_thresh: float,
    window_rule: bool, search_rows: int = 56, clamp_h: int | None = None,
):
    """One LK pyramid level for all keypoints, plain PyTorch.

    prev/gx/gy/cur: (H, W) float32 level images; base: (N,2) keypoints in
    prev; pts: (N,2) initial guesses in cur; valid: (N,) bool. With a
    stream axis: (B, H, W) images, (B, N, 2) points, (B, N) flags, each
    keypoint reading its own stream's images.
    Returns (pts (..., N, 2), ok (..., N), iters (..., N) int32 — the
    Gauss-Newton steps each keypoint took)."""
    if prev.dim() == 2:
        out = lk_level_plain(
            prev[None], gx[None], gy[None], cur[None], base[None], pts[None], valid[None],
            win=win, max_iter=max_iter, eps=eps, min_eig_thresh=min_eig_thresh,
            window_rule=window_rule, search_rows=search_rows, clamp_h=clamp_h)
        return tuple(x[0] for x in out)
    B, H, W = prev.shape
    dev = prev.device
    n_per = base.shape[1]
    # B x N keypoints in one flat batch; s is each keypoint's stream.
    s = torch.arange(B, device=dev).repeat_interleave(n_per)
    base, pts, valid = base.reshape(-1, 2), pts.reshape(-1, 2), valid.reshape(-1)
    N = base.shape[0]
    half = (win - 1) * 0.5
    a1 = torch.arange(win + 1, device=dev)
    px, py = base[:, 0], base[:, 1]
    cx, cy = pts[:, 0].clone(), pts[:, 1].clone()

    if window_rule:
        clamp_h = H if clamp_h is None else clamp_h
        TR = _round_up(win + 2, 8)
        TC = _round_up(win + 3, 32)
        t_ox = torch.clamp(torch.floor(px - half).to(torch.int64), 0, max(W - TC, 0))
        t_oy = torch.clamp(torch.floor(py - half).to(torch.int64), 0, max(clamp_h - TR, 0))
        ftx = px - half - t_ox.to(torch.float32)
        fty = py - half - t_oy.to(torch.float32)
        frac_ok = (ftx >= 0.0) & (ftx < 1.5) & (fty >= 0.0) & (fty < 1.5)
    else:
        pad = win // 2 + 2
        x0f = (px + pad) - half
        y0f = (py + pad) - half
        x0 = torch.floor(x0f)
        y0 = torch.floor(y0f)
        ftx = x0f - x0
        fty = y0f - y0
        t_ox = torch.clamp(x0.to(torch.int64), 0, W + 2 * pad - win - 1) - pad
        t_oy = torch.clamp(y0.to(torch.int64), 0, H + 2 * pad - win - 1) - pad
        frac_ok = torch.ones_like(valid)

    rows = t_oy[:, None] + a1[None, :]
    cols = t_ox[:, None] + a1[None, :]
    tmpl = _blend4(_read(prev, s, rows, cols), ftx, fty)
    tgx = _blend4(_read(gx, s, rows, cols), ftx, fty)
    tgy = _blend4(_read(gy, s, rows, cols), ftx, fty)

    gxx = torch.sum(tgx * tgx, dim=(-2, -1))
    gxy = torch.sum(tgx * tgy, dim=(-2, -1))
    gyy = torch.sum(tgy * tgy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    half_tr = 0.5 * (gxx + gyy)
    min_eig = (half_tr - torch.sqrt(torch.clamp(half_tr**2 - det, min=0.0))) / (win * win)
    good_g = (min_eig > min_eig_thresh) & valid & frac_ok
    safe_det = torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))
    inv00 = gyy / safe_det
    inv01 = -gxy / safe_det
    inv11 = gxx / safe_det

    if window_rule:
        SR = search_rows
        sx0 = torch.clamp(torch.floor(cx).to(torch.int64) - _LANES // 2, 0, max(W - _LANES, 0))
        sy0 = torch.clamp(torch.floor(cy).to(torch.int64) - SR // 2, 0, max(clamp_h - SR, 0))
        S = _read(
            cur, s,
            sy0[:, None] + torch.arange(SR, device=dev)[None, :],
            sx0[:, None] + torch.arange(_LANES, device=dev)[None, :],
        )  # (N, SR, 128)
        sxf = sx0.to(torch.float32)
        syf = sy0.to(torch.float32)
        n_idx = torch.arange(N, device=dev)[:, None, None]

    moving = torch.ones(N, dtype=torch.bool, device=dev)
    inb = torch.ones(N, dtype=torch.bool, device=dev)
    iters = torch.zeros(N, dtype=torch.int32, device=dev)
    for _ in range(max_iter):
        act = moving & inb & good_g
        if not bool(act.any()):
            break
        if window_rule:
            ox = cx - half - sxf
            oy = cy - half - syf
            oxi = torch.floor(ox).to(torch.int64)
            oyi = torch.floor(oy).to(torch.int64)
            in_b = (
                (oxi >= 0) & (oyi >= 0)
                & (oxi <= _LANES - win - 2) & (oyi <= SR - win - 2)
            )
            inb = torch.where(act, inb & in_b, inb)
            act = act & inb
            oxc = torch.clamp(oxi, 0, _LANES - win - 2)
            oyc = torch.clamp(oyi, 0, SR - win - 2)
            fx = (ox - oxc.to(torch.float32))[:, None, None]
            fy = (oy - oyc.to(torch.float32))[:, None, None]
            P = S[n_idx, (oyc[:, None] + a1)[:, :, None], (oxc[:, None] + a1)[:, None, :]]
            ya = (1.0 - fy) * P[:, :-1, :-1] + fy * P[:, 1:, :-1]
            yb = (1.0 - fy) * P[:, :-1, 1:] + fy * P[:, 1:, 1:]
            sample = (1.0 - fx) * ya + fx * yb
        else:
            x0f = (cx + pad) - half
            y0f = (cy + pad) - half
            x0 = torch.floor(x0f)
            y0 = torch.floor(y0f)
            xi = torch.clamp(x0.to(torch.int64), 0, W + 2 * pad - win - 1) - pad
            yi = torch.clamp(y0.to(torch.int64), 0, H + 2 * pad - win - 1) - pad
            raw = _read(cur, s, yi[:, None] + a1[None, :], xi[:, None] + a1[None, :])
            sample = _blend4(raw, x0f - x0, y0f - y0)
        dI = sample - tmpl
        bx = torch.sum(dI * tgx, dim=(-2, -1))
        by = torch.sum(dI * tgy, dim=(-2, -1))
        dx = -(inv00 * bx + inv01 * by)
        dy = -(inv01 * bx + inv11 * by)
        cx = torch.where(act, cx + dx, cx)
        cy = torch.where(act, cy + dy, cy)
        moving = moving & ~(act & (dx * dx + dy * dy < eps * eps))
        iters = iters + act.to(torch.int32)
    return (torch.stack([cx, cy], dim=-1).reshape(B, n_per, 2), (good_g & inb).reshape(B, n_per),
            iters.reshape(B, n_per))


# ---------------------------------------------------------------------------
# Coarse-to-fine tracker, plain version
# ---------------------------------------------------------------------------


def track_pyramid(
    level_fn, prev_pyr, cur_pyr, prev_pts, init_pts, valid, prev_grads, *,
    win: int, max_iter: int, eps: float, min_eig_thresh: float, search_rows: int | None,
):
    """`klt_track_pallas`'s coarse-to-fine loop over `level_fn`
    (`lk_level_plain`, or a wrapper of it); with `search_rows=None` the
    loop of the reference's gather tracker `klt_track` (no window rule on
    any level, level 0's gate kept). Levels are (H, W), or (B, H, W) with
    a stream axis on the points and flags. Returns (tracked_pts, ok,
    levels), `levels` one dict per tracked level: its shape, mode and
    per-keypoint step counts."""
    pts, base, ok = init_pts, prev_pts, valid
    levels = []
    for e in level_table([p.shape[-2:] for p in prev_pyr], win, search_rows):
        pts = pts * e.scale
        base = base * e.scale
        if e.mode == "skip":
            continue
        Ix, Iy = prev_grads[e.level]
        pts, ok_lvl, iters = level_fn(
            prev_pyr[e.level].contiguous(), Ix.contiguous(), Iy.contiguous(),
            cur_pyr[e.level].contiguous(), base, pts, valid,
            win=win, max_iter=max_iter, eps=eps, min_eig_thresh=min_eig_thresh,
            window_rule=e.mode != "xla", search_rows=search_rows or 0, clamp_h=e.clamp_h,
        )
        levels.append({"level": e.level, "shape": e.shape, "mode": e.mode, "iters": iters})
        if e.keep_ok:
            ok = ok & ok_lvl
    H0, W0 = prev_pyr[0].shape[-2:]
    half = win * 0.5
    inb = (
        (pts[..., 0] >= half)
        & (pts[..., 0] < W0 - half)
        & (pts[..., 1] >= half)
        & (pts[..., 1] < H0 - half)
    )
    return pts, ok & inb, levels


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA LK kernel cannot be built")
    return path


def build_kernel() -> tuple[Path, str]:
    """Compile csrc/lk_kernel.cu into _build/ (once per source and flags)
    and return (path of the .so, ptxas report). Raises on failure."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"liblk_{key}.so"
    log = _BUILD_DIR / f"liblk_{key}.log"
    if so.exists():
        return so, log.read_text() if log.exists() else ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"liblk_{key}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    log.write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so, res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    so, _ = build_kernel()
    lib = ctypes.CDLL(str(so))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lk_pyramid_launch.argtypes = [
        P, P, P, P, I,  # planes, stream strides, level ints, level scales, n_levels
        I, I,  # H0, W0
        P, P, P,  # prev_pts, init_pts, valid
        P, P, P,  # out_pts, out_ok, out_iters
        I, I, I, I, I,  # N, n_streams, win, search_rows, max_iter
        Fl, Fl,  # eps^2, min_eig_thresh
        P, P,  # stream, out_route
    ]
    lib.lk_pyramid_launch.restype = I
    lib.lk_cached_launch.argtypes = [
        P, P, P, P, I,  # level pointers, stream strides, level ints, level scales, n_levels
        P, P,  # init_pts, valid
        P, P, P,  # out_pts, out_ok, out_iters
        I, I, I, I, I,  # N, n_streams, win, slack, max_iter
        Fl,  # eps^2
        P, P,  # stream, out_route
    ]
    lib.lk_cached_launch.restype = I
    lib.lk_cache_build_launch.argtypes = [
        P, P, P, P, I,  # level pointers, stream strides, level ints, level divisors, n_levels
        P, P,  # pts, valid
        I, I, I,  # N, n_streams, win
        Fl,  # min_eig_thresh
        P, P,  # stream, out_report
    ]
    lib.lk_cache_build_launch.restype = I
    lib.lk_error_string.argtypes = [I]
    lib.lk_error_string.restype = ctypes.c_char_p
    return lib


def _check_image(name, t, dev, shape):
    if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 tensor on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")


def lk_pyramid_cuda(
    prev_pyr, cur_pyr, prev_grads, prev_pts, init_pts, valid, *,
    win: int, max_iter: int, eps: float, min_eig_thresh: float, search_rows: int | None,
):
    """Track one frame of every stream, every level, in ONE launch of the
    CUDA kernel. Computes what `track_pyramid(lk_level_plain, ...)`
    computes (the window sums in another order), with the window rule of
    `klt_track_pallas` at `search_rows` (windows of 2-54 px), or with
    `search_rows=None` the gather rule (every level an XLA level; any
    window of 2 px or more, above 54 px in the kernel's `lk_wide` path: one
    thread-block cluster per keypoint, launched as `wide_plan` gives).

    Levels (B, H, W) with keypoints (B, N, 2) and `valid` (B, N) track B
    streams; (H, W) levels with (N, 2) keypoints are one stream (B = 1
    views). Returns (pts (..., N, 2) float32, ok (..., N) bool, iters
    (..., N, n_levels) int32: the Gauss-Newton steps per level, indexed by
    level number), with the inputs' leading axes. Adds one to
    `lk_pyramid_cuda.launches` per launch, whatever B, to
    `lk_pyramid_cuda.launches_by_device[str(device)]` for the device it
    launched on, and to `lk_pyramid_cuda.routes[route]` for the route the launcher chose (a
    name of ROUTES); `lk_pyramid_cuda.report[route]` holds that route's
    last launch report: the dynamic shared memory per block in bytes it
    asked for (`smem`) and, on the lk_wide routes, its `plan` (a
    WidePlan), the clusters the card holds at once (`active_clusters`) and
    the opt-in shared memory the launcher read (`optin`). A library that
    reports only the route and shared memory gives `smem` alone."""
    n = len(prev_pyr)
    if n == 0 or len(cur_pyr) != n or len(prev_grads) != n:
        raise ValueError("need one prev, cur and gradient pair per level")
    if n > _MAX_LEVELS:
        raise ValueError(f"at most {_MAX_LEVELS} pyramid levels, got {n}")
    if win < 2:
        raise ValueError(f"win {win}: the kernel takes windows of 2 px or more")
    if search_rows is not None and win > MAX_WIN:
        raise ValueError(
            f"win {win}: the window rule takes 2 <= win <= {MAX_WIN}, the widest window the "
            f"Pallas tracker admits (its clip search_rows - win - 2 must stay >= 0 at 56 rows); "
            f"wider windows take the gather rule (search_rows=None)")
    if search_rows is not None and search_rows < win + 2:
        raise ValueError(f"search_rows {search_rows} < win + 2 = {win + 2}")
    dev = prev_pyr[0].device
    batched = prev_pts.dim() == 3
    if prev_pts.dim() not in (2, 3):
        raise ValueError(f"prev_pts: need (N,2) or (B,N,2) keypoints, got {tuple(prev_pts.shape)}")
    B, N = (prev_pts.shape[0], prev_pts.shape[1]) if batched else (1, prev_pts.shape[0])
    pts_shape, flag_shape = tuple(prev_pts.shape[:-1]) + (2,), tuple(prev_pts.shape[:-1])
    for name, t in (("prev_pts", prev_pts), ("init_pts", init_pts)):
        if (t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != pts_shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {pts_shape} float32 tensor on {dev}")
    if (valid.device != dev or valid.dtype != torch.bool or tuple(valid.shape) != flag_shape
            or not valid.is_contiguous()):
        raise ValueError(f"valid: need a contiguous {flag_shape} bool tensor on {dev}")

    def planes3(name, t):
        """A level's plane as (B, H, W): 2-D planes go with 2-D keypoints."""
        if t.dim() != prev_pts.dim():
            raise ValueError(f"{name}: {t.dim()}-D planes with keypoints {pts_shape}")
        return t if batched else t[None]

    plan = level_table([p.shape[-2:] for p in prev_pyr], win, search_rows)
    planes = (ctypes.c_void_p * (4 * n))()
    strides = (ctypes.c_longlong * n)()
    ints = (ctypes.c_int * (5 * n))()
    scales = (ctypes.c_float * n)()
    for e, lv in enumerate(plan):
        scales[e] = lv.scale
        ints[5 * e : 5 * e + 5] = [*lv.shape, _MODE_CODES[lv.mode], lv.clamp_h or 0, int(lv.keep_ok)]
        if lv.mode == "skip":
            continue
        lvl = lv.level
        gx, gy = prev_grads[lvl]
        level = []
        for name, t in (("prev_pyr", prev_pyr[lvl]), ("gx", gx), ("gy", gy), ("cur", cur_pyr[lvl])):
            t = planes3(f"{name}[{lvl}]", t)
            _check_image(f"{name}[{lvl}]", t, dev, (B, *lv.shape))
            level.append(t)
        planes[4 * e : 4 * e + 4] = [t.data_ptr() for t in level]
        strides[e] = lv.shape[0] * lv.shape[1]
    out_pts = torch.empty(pts_shape, dtype=torch.float32, device=dev)
    out_ok = torch.empty(flag_shape, dtype=torch.bool, device=dev)
    out_iters = torch.empty(flag_shape + (n,), dtype=torch.int32, device=dev)
    if dev.type != "cuda":
        raise ValueError("lk_pyramid_cuda needs CUDA tensors")
    if N == 0:
        return out_pts, out_ok, out_iters
    lib = _lib()
    H0, W0 = prev_pyr[0].shape[-2:]
    route = (ctypes.c_int * _REPORT_INTS)(*([-1] * _REPORT_INTS))
    with torch.cuda.device(dev):
        rc = lib.lk_pyramid_launch(
            planes, strides, ints, scales, n, H0, W0,
            prev_pts.data_ptr(), init_pts.data_ptr(), valid.data_ptr(),
            out_pts.data_ptr(), out_ok.data_ptr(), out_iters.data_ptr(),
            N, B, win, search_rows or 0, max_iter, float(eps * eps), float(min_eig_thresh),
            torch.cuda.current_stream(dev).cuda_stream, route,
        )
    if rc != 0:
        raise RuntimeError(f"LK kernel launch failed: {lib.lk_error_string(rc).decode()}")
    lk_pyramid_cuda.launches += 1
    lk_pyramid_cuda.launches_by_device[str(dev)] += 1
    name = ROUTES[route[0]]
    lk_pyramid_cuda.routes[name] += 1
    rep = {"smem": route[1]}
    if name.startswith("lk_wide") and route[2] >= 0:
        rep.update(plan=WidePlan(name, route[2], route[3], route[4], route[1]),
                   active_clusters=route[5], optin=route[6])
    lk_pyramid_cuda.report[name] = rep
    return out_pts, out_ok, out_iters


lk_pyramid_cuda.launches = 0
lk_pyramid_cuda.launches_by_device = collections.Counter()  # str(device) -> launches
lk_pyramid_cuda.routes = collections.Counter()
lk_pyramid_cuda.report = {}


# csrc/lk_kernel.cu: CachedRoute, where lk_cached_kernel keeps its data.
CACHED_ROUTES = ("lk_cached shared", "lk_cached patch", "lk_cached global", "lk_cached warp")
_CACHE_KEYS = ("tmpl", "gx", "gy", "inv00", "inv01", "inv11", "good_g")
_CACHED_WARP_WIN = 24        # kCachedWarpWin: the window of the warp route
_CACHED_WARP_SLACK = 8       # kCachedWarpSlack: its slack
_CACHED_WARP_BLOCK = 2       # kCachedWarpBlock: keypoints (warps) a block of the warp route
_CACHED_REPORT_INTS = 4      # kCachedReportInts


def cached_patch_stride(win: int, slack: int = 8) -> int:
    """Row stride of the warp route's patch (csrc: cached_patch_stride): the
    smallest stride >= win + 2 slack + 2 congruent to win mod 32."""
    return win + 32 * -(-(2 * slack + 2) // 32)


def cached_smem(route: str, win: int, slack: int = 8, warps: int = 1) -> int:
    """Dynamic shared memory per block of `lk_cached_kernel` on `route`, the
    twin of csrc/lk_kernel.cu's `cached_smem`. Block routes: the warps'
    partials (2 x 6 float4), and on the shared routes the (win + 2 slack +
    2)^2 search patch and, on "lk_cached shared", the template, gx and gy
    windows. "lk_cached warp" (24 px, slack 8 only): for each of `warps`
    warps, its mbarrier (16 bytes), its patch at `cached_patch_stride` and
    one cache buffer (template, gx, gy), each a whole number of 16-byte
    units (csrc: kCachedWarpBytes)."""
    S = win + 2 * slack + 2
    if route == "lk_cached warp":
        w, sl = _CACHED_WARP_WIN, _CACHED_WARP_SLACK
        floats = (_round_up((w + 2 * sl + 2) * cached_patch_stride(w, sl), 4)
                  + _round_up(3 * w * w, 4))
        return warps * (16 + 4 * floats)
    fixed = 4 * 8 * 6
    return fixed + 4 * {"lk_cached shared": S * S + 3 * win * win,
                        "lk_cached patch": S * S, "lk_cached global": 0}[route]


class CachedPlan(NamedTuple):
    """How `lk_cached_kernel` is launched: `route` (a name of
    CACHED_ROUTES), `warps` keypoints a block (the warp route; 1 on the
    block routes) and `smem` dynamic shared memory per block in bytes."""

    route: str
    warps: int
    smem: int


def cached_plan(win: int, optin_bytes: int, slack: int = 8) -> CachedPlan:
    """The launch plan of `lk_cached_kernel`, the twin of csrc/lk_kernel.cu's
    `plan_cached` (the launcher reports the plan it took; chip_smoke.py
    holds the report to this). At 24 px and slack 8 the warp route, at
    _CACHED_WARP_BLOCK warps a block where they fit, else one. At other
    widths, or where not even one warp fits, the first block route whose
    shared memory fits."""
    if win == _CACHED_WARP_WIN and slack == _CACHED_WARP_SLACK:
        w = _CACHED_WARP_BLOCK
        while w >= 1:
            smem = cached_smem("lk_cached warp", win, slack, w)
            if smem <= optin_bytes:
                return CachedPlan("lk_cached warp", w, smem)
            w //= 2
    route = next((r for r in CACHED_ROUTES[:2] if cached_smem(r, win, slack) <= optin_bytes),
                 "lk_cached global")
    return CachedPlan(route, 1, cached_smem(route, win, slack))


def cached_route(win: int, optin_bytes: int, slack: int = 8) -> str:
    """The route the launcher takes at `win` under `optin_bytes`."""
    return cached_plan(win, optin_bytes, slack).route


def lk_cached_cuda(templates, cur_pyr, init_pts, valid, *, win: int, max_iter: int, eps: float,
                   slack: int = 8):
    """Track one frame of every stream against a template cache
    (`optical_flow.build_lk_templates`), every level, in ONE launch of
    `lk_cached_kernel`. Computes what `optical_flow.track_cached` computes
    (the window sums in another order). Levels (B, H, W) with keypoints (B,
    N, 2), `valid` (B, N) and a cache of (B, N, ...) leaves track B
    streams; (H, W) levels with (N, 2) keypoints are one stream. The
    launcher takes the route of `cached_plan` (`CACHED_ROUTES`: one warp a
    keypoint at 24 px, else a block a keypoint on the first block route
    whose shared memory fits the card's opt-in limit); the routes compute
    the same arithmetic. The warp route copies the template, gx and gy
    leaves by bulk copy, which needs them 16-byte aligned (what
    `lk_cache_build_cuda` and the plain build allocate); a leaf that is not
    fails the launch.

    Returns (pts (..., N, 2), ok (..., N), iters (..., N, n_levels) int32:
    the Gauss-Newton steps per level, indexed by level number). Adds one to
    `lk_cached_cuda.launches` per launch, whatever B, to
    `.launches_by_device[str(device)]` and to `.routes[route]` (a name of
    CACHED_ROUTES); `.report[route]` holds that route's last launch report:
    {"smem", "optin", "warps"} (the keypoints a block; -1 from a library
    that reports only the first two)."""
    n = len(cur_pyr)
    if n == 0 or len(templates) != n:
        raise ValueError("need one template level (or None) per pyramid level")
    if n > _MAX_LEVELS:
        raise ValueError(f"at most {_MAX_LEVELS} pyramid levels, got {n}")
    if win < 2:
        raise ValueError(f"win {win}: the kernel takes windows of 2 px or more")
    dev = cur_pyr[0].device
    if init_pts.dim() not in (2, 3):
        raise ValueError(f"init_pts: need (N,2) or (B,N,2) keypoints, got {tuple(init_pts.shape)}")
    batched = init_pts.dim() == 3
    B, N = (init_pts.shape[0], init_pts.shape[1]) if batched else (1, init_pts.shape[0])
    flag_shape = tuple(init_pts.shape[:-1])
    pts_shape = flag_shape + (2,)
    if (init_pts.device != dev or init_pts.dtype != torch.float32
            or tuple(init_pts.shape) != pts_shape or not init_pts.is_contiguous()):
        raise ValueError(f"init_pts: need a contiguous {pts_shape} float32 tensor on {dev}")
    if (valid.device != dev or valid.dtype != torch.bool or tuple(valid.shape) != flag_shape
            or not valid.is_contiguous()):
        raise ValueError(f"valid: need a contiguous {flag_shape} bool tensor on {dev}")
    ptrs = (ctypes.c_void_p * (8 * n))()
    strides = (ctypes.c_longlong * n)()
    ints = (ctypes.c_int * (3 * n))()
    scales = (ctypes.c_float * n)()
    for e in range(n):
        lvl = n - 1 - e
        scales[e] = 1.0 / 2.0 ** (n - 1) if e == 0 else 2.0
        T = templates[lvl]
        cur = cur_pyr[lvl] if batched else cur_pyr[lvl][None]
        if cur.dim() != 3 or cur.shape[0] != B:
            raise ValueError(f"cur_pyr[{lvl}]: {tuple(cur_pyr[lvl].shape)} with keypoints {pts_shape}")
        H, W = (int(d) for d in cur.shape[-2:])
        ints[3 * e : 3 * e + 3] = [H, W, int(T is None)]
        if T is None:
            continue
        _check_image(f"cur_pyr[{lvl}]", cur, dev, (B, H, W))
        leaves = []
        for key in _CACHE_KEYS:
            t = T[key]
            want = flag_shape + ((win, win) if key in ("tmpl", "gx", "gy") else ())
            dtype = torch.bool if key == "good_g" else torch.float32
            if (t.device != dev or t.dtype != dtype or tuple(t.shape) != want
                    or not t.is_contiguous()):
                raise ValueError(f"templates[{lvl}][{key!r}]: need a contiguous {want} {dtype} "
                                 f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
            leaves.append(t)
        ptrs[8 * e : 8 * e + 8] = [cur.data_ptr()] + [t.data_ptr() for t in leaves]
        strides[e] = H * W
    if dev.type != "cuda":
        raise ValueError("lk_cached_cuda needs CUDA tensors")
    out_pts = torch.empty(pts_shape, dtype=torch.float32, device=dev)
    out_ok = torch.empty(flag_shape, dtype=torch.bool, device=dev)
    out_iters = torch.empty(flag_shape + (n,), dtype=torch.int32, device=dev)
    if N == 0:
        return out_pts, out_ok, out_iters
    lib = _lib()
    route = (ctypes.c_int * _CACHED_REPORT_INTS)(*([-1] * _CACHED_REPORT_INTS))
    with torch.cuda.device(dev):
        rc = lib.lk_cached_launch(
            ptrs, strides, ints, scales, n, init_pts.data_ptr(), valid.data_ptr(),
            out_pts.data_ptr(), out_ok.data_ptr(), out_iters.data_ptr(),
            N, B, win, slack, max_iter, float(eps * eps),
            torch.cuda.current_stream(dev).cuda_stream, route,
        )
    if rc != 0:
        raise RuntimeError(f"LK cached kernel launch failed: {lib.lk_error_string(rc).decode()}")
    lk_cached_cuda.launches += 1
    lk_cached_cuda.launches_by_device[str(dev)] += 1
    name = CACHED_ROUTES[route[0]]
    lk_cached_cuda.routes[name] += 1
    lk_cached_cuda.report[name] = {"smem": route[1], "optin": route[2], "warps": route[3]}
    return out_pts, out_ok, out_iters


lk_cached_cuda.launches = 0
lk_cached_cuda.launches_by_device = collections.Counter()  # str(device) -> launches
lk_cached_cuda.routes = collections.Counter()
lk_cached_cuda.report = {}


# csrc/lk_kernel.cu: BuildRoute (the sweep of the keyframe's patch, the
# windows resampled from given gradients, or the sweep of windows past
# _BUILD_MAX_UNITS strips, a warp taking several), and the constants of the
# build's launch plan `plan_build` (tests/test_torch_lk_cache_build.py
# parses them from the source).
BUILD_ROUTES = ("lk_cache_build sweep", "lk_cache_build grads", "lk_cache_build wide")
_BUILD_STRIP = 29       # kBuildStrip: window columns a strip holds at most
_BUILD_WARPS = 4        # kBuildWarps: warps a block of narrow items holds
_BUILD_MAX_UNITS = 16   # kBuildMaxUnits: warps an item may have
_BUILD_CHUNK = 8        # kBuildChunk: window rows a warp loads ahead and stages out
_BUILD_FIXED_WIN = 24   # kBuildFixedWin: the window compiled in
_BUILD_STAGE_FROM = 48  # kBuildStageFrom: windows that stage their rows in shared memory
_BUILD_REPORT_INTS = 7  # kBuildReportInts


class BuildPlan(NamedTuple):
    """How `lk_cache_build_kernel` is launched: `route` (a name of
    BUILD_ROUTES), `strips` equal column strips of the window (one warp
    each, a window column a lane), `items` (keypoint, level) items a block,
    `threads` a block, `smem` dynamic shared memory per block in bytes, and
    whether the rows leave through shared memory (`staged`)."""

    route: str
    strips: int
    items: int
    threads: int
    smem: int
    staged: bool


def build_strip_cols(win: int) -> int:
    """Window columns of each of a window's equal strips (csrc:
    build_strip_cols): at most _BUILD_STRIP (32 lanes less 3 columns of
    halo)."""
    return -(-win // -(-win // _BUILD_STRIP))


def build_strips(win: int) -> int:
    """Strips of `build_strip_cols` columns a window is cut into."""
    return -(-win // build_strip_cols(win))


def build_stage_bytes(win: int) -> int:
    """Bytes of one item's row staging (csrc: build_stage_bytes): two
    buffers of three planes of _BUILD_CHUNK window rows, each plane after up
    to 3 floats of alignment in whole 16-byte units; none at the
    compiled-in window, whose rows go out directly."""
    if win == _BUILD_FIXED_WIN:
        return 0
    return 4 * 2 * 3 * ((_BUILD_CHUNK * win + 6) // 4 * 4)


def build_plan(win: int, optin_bytes: int, grads: bool = False) -> BuildPlan:
    """The launch plan of `lk_cache_build_kernel`, the twin of
    csrc/lk_kernel.cu's `plan_build` (the launcher reports the plan it
    took; chip_smoke.py holds the report to this). An item gets one warp a
    strip; a block holds _BUILD_WARPS / that many items, at least one,
    fewer if their shared memory does not fit: a 16-byte slot a warp for
    its partial sums and, from _BUILD_STAGE_FROM px where it fits, the
    item's row staging (`build_stage_bytes`). Past _BUILD_MAX_UNITS strips
    the wide route: _BUILD_MAX_UNITS warps an item, each taking every
    _BUILD_MAX_UNITS-th strip, rows stored directly. With gradients an item
    gets _BUILD_WARPS warps, which take its pixels in turn."""
    strips = build_strips(win)
    items = _BUILD_WARPS // strips if strips < _BUILD_WARPS else 1
    if grads:
        return BuildPlan(BUILD_ROUTES[1], strips, 1, 32 * _BUILD_WARPS, 16 * _BUILD_WARPS, False)
    if strips > _BUILD_MAX_UNITS:
        return BuildPlan(BUILD_ROUTES[2], strips, 1, 32 * _BUILD_MAX_UNITS, 16 * _BUILD_MAX_UNITS,
                         False)
    for staged in ((True, False) if win >= _BUILD_STAGE_FROM else (False,)):
        item = 16 * strips + (build_stage_bytes(win) if staged else 0)
        i = items
        while i >= 1:
            if i * item <= optin_bytes or (not staged and i == 1):
                return BuildPlan(BUILD_ROUTES[0], strips, i, 32 * i * strips, i * item, staged)
            i //= 2
    raise AssertionError("not reached: the unstaged plan always returns")


def lk_cache_build_cuda(prev_pyr, prev_pts, valid, *, win: int, min_eig_thresh: float = 1e-4,
                        prev_grads=None):
    """Build the template cache of every level and stream of a keyframe in
    ONE launch of `lk_cache_build_kernel`. Computes what
    `optical_flow.build_lk_templates` computes: the template, gx and gy
    windows bit for bit, the gradient sums (so the inverse matrices) in
    another order. Levels (H, W) with keypoints (N, 2), or (B, H, W) with
    (B, N, 2) and `valid` (B, N); `prev_grads`, one (gx, gy) pair of planes
    per level, resamples the given gradients instead of taking Scharr on
    the patches. Returns per level (level 0 first) a dict of (..., N, win,
    win) "tmpl", "gx", "gy", (..., N) "inv00", "inv01", "inv11" float32 and
    "good_g" bool, contiguous and 16-byte aligned (what `lk_cached_cuda`
    reads, by bulk copy at 24 px), or None for a
    level too small for a window. Adds one to
    `lk_cache_build_cuda.launches` per launch, whatever B; `.report` holds
    the last launch's "smem", "route" (a name of BUILD_ROUTES), "plan" (a
    BuildPlan) and the opt-in shared memory it read ("optin")."""
    n = len(prev_pyr)
    if n == 0 or n > _MAX_LEVELS:
        raise ValueError(f"need 1 to {_MAX_LEVELS} pyramid levels, got {n}")
    if prev_grads is not None and len(prev_grads) != n:
        raise ValueError("need one gradient pair per level")
    if win < 2:
        raise ValueError(f"win {win}: the kernel takes windows of 2 px or more")
    dev = prev_pyr[0].device
    if prev_pts.dim() not in (2, 3):
        raise ValueError(f"prev_pts: need (N,2) or (B,N,2) keypoints, got {tuple(prev_pts.shape)}")
    batched = prev_pts.dim() == 3
    B, N = (prev_pts.shape[0], prev_pts.shape[1]) if batched else (1, prev_pts.shape[0])
    flag_shape = tuple(prev_pts.shape[:-1])
    if (prev_pts.device != dev or prev_pts.dtype != torch.float32 or prev_pts.shape[-1] != 2
            or not prev_pts.is_contiguous()):
        raise ValueError(f"prev_pts: need a contiguous (..., N, 2) float32 tensor on {dev}")
    if (valid.device != dev or valid.dtype != torch.bool or tuple(valid.shape) != flag_shape
            or not valid.is_contiguous()):
        raise ValueError(f"valid: need a contiguous {flag_shape} bool tensor on {dev}")
    levels = [lvl for lvl, img in enumerate(prev_pyr) if min(img.shape[-2:]) >= win + 2]
    # Every level's leaves as slices of three allocations (one call each).
    n_l = len(levels)
    windows = torch.empty((3 * n_l, *flag_shape, win, win), dtype=torch.float32,
                          device=dev).unbind(0)
    inverses = torch.empty((3 * n_l, *flag_shape), dtype=torch.float32, device=dev).unbind(0)
    gates = torch.empty((n_l, *flag_shape), dtype=torch.bool, device=dev).unbind(0)
    out = [None] * n
    ptrs = (ctypes.c_void_p * (10 * len(levels)))()
    strides = (ctypes.c_longlong * len(levels))()
    ints = (ctypes.c_int * (2 * len(levels)))()
    divs = (ctypes.c_float * len(levels))()
    for i, lvl in enumerate(levels):
        img = prev_pyr[lvl] if batched else prev_pyr[lvl][None]
        if img.dim() != 3 or img.shape[0] != B:
            raise ValueError(f"prev_pyr[{lvl}]: {tuple(prev_pyr[lvl].shape)} with keypoints "
                             f"{tuple(prev_pts.shape)}")
        H, W = (int(d) for d in img.shape[-2:])
        planes = [img]
        if prev_grads is not None:
            planes += [g if batched else g[None] for g in prev_grads[lvl]]
        for name, t in zip(("prev_pyr", "gx", "gy"), planes):
            _check_image(f"{name}[{lvl}]", t, dev, (B, H, W))
        leaves = dict(zip(_CACHE_KEYS, (*windows[3 * i:3 * i + 3], *inverses[3 * i:3 * i + 3],
                                        gates[i])))
        out[lvl] = leaves
        grads = [t.data_ptr() for t in planes[1:]] or [None, None]
        ptrs[10 * i:10 * i + 10] = [img.data_ptr(), *grads] + [leaves[k].data_ptr()
                                                               for k in _CACHE_KEYS]
        strides[i] = H * W
        ints[2 * i:2 * i + 2] = [H, W]
        divs[i] = 2.0 ** lvl
    if dev.type != "cuda":
        raise ValueError("lk_cache_build_cuda needs CUDA tensors")
    if not levels or N == 0:
        return tuple(out)
    lib = _lib()
    rep = (ctypes.c_int * _BUILD_REPORT_INTS)(*([-1] * _BUILD_REPORT_INTS))
    with torch.cuda.device(dev):
        rc = lib.lk_cache_build_launch(
            ptrs, strides, ints, divs, len(levels), prev_pts.data_ptr(), valid.data_ptr(),
            N, B, win, float(min_eig_thresh), torch.cuda.current_stream(dev).cuda_stream, rep)
    if rc != 0:
        raise RuntimeError(f"LK cache build launch failed: {lib.lk_error_string(rc).decode()}")
    lk_cache_build_cuda.launches += 1
    plan = BuildPlan(BUILD_ROUTES[rep[2]], *rep[3:6], rep[0], bool(rep[1]))
    lk_cache_build_cuda.report = {"smem": rep[0], "route": plan.route, "plan": plan,
                                  "optin": rep[6]}
    return tuple(out)


lk_cache_build_cuda.launches = 0
lk_cache_build_cuda.report = {}


# ---------------------------------------------------------------------------
# Tracker entry points
# ---------------------------------------------------------------------------


def klt_track_lk(
    prev_pyr, cur_pyr, prev_pts, init_pts, valid, *,
    win: int = 24, max_iter: int = 30, eps: float = 0.1,
    min_eig_thresh: float = 1e-4, prev_grads=None, search_rows: int | None = 56,
    device: str | torch.device = "cuda",
):
    """Pyramidal LK with the level plan of `klt_track_pallas`: coarse to
    fine, window-rule levels where `klt_track_pallas` used a kernel, the
    reference XLA level below the search-window size, a final in-image
    gate. All tensors must already lie on `device`: CUDA tensors go
    through the kernel (one launch), CPU tensors through the plain
    version. Levels (B, H, W) with (B, N, 2) keypoints track B streams in
    that one launch. Returns (tracked_pts (..., N, 2), ok (..., N))."""
    dev = resolve_device(device)
    tensors = [*prev_pyr, *cur_pyr, prev_pts, init_pts, valid]
    if prev_grads is not None:
        tensors += [g for pair in prev_grads for g in pair]
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"klt_track_lk(device={dev}): got a tensor on {t.device}")
    if prev_grads is None:
        prev_grads = [image_gradients(p, scharr=True) for p in prev_pyr]
    kw = dict(win=win, max_iter=max_iter, eps=eps, min_eig_thresh=min_eig_thresh,
              search_rows=search_rows)
    if dev.type == "cpu":
        pts, ok, _ = track_pyramid(lk_level_plain, prev_pyr, cur_pyr, prev_pts, init_pts,
                                   valid, prev_grads, **kw)
        return pts, ok
    pts, ok, _ = lk_pyramid_cuda(
        [p.contiguous() for p in prev_pyr], [c.contiguous() for c in cur_pyr],
        [(gx.contiguous(), gy.contiguous()) for gx, gy in prev_grads],
        prev_pts.contiguous(), init_pts.contiguous(), valid.contiguous(), **kw,
    )
    return pts, ok


def build_lk_templates_lk(prev_pyr, prev_pts, valid, *, win: int = 24,
                          min_eig_thresh: float = 1e-4, prev_grads=None,
                          device: str | torch.device = "cuda"):
    """The keyframe half of the JAX package's default tracker,
    `build_lk_templates`: the per-level template cache that
    `klt_track_cached_lk` tracks against (level 0 first; None for a level
    too small for a window). All tensors must already lie on `device`: CUDA
    tensors go through `lk_cache_build_kernel` (one launch for every level
    and stream), CPU tensors through the plain version
    (`optical_flow.build_lk_templates`). Levels (B, H, W) with (B, N, 2)
    keypoints build B streams' caches in that one launch."""
    dev = resolve_device(device)
    tensors = [*prev_pyr, prev_pts, valid]
    if prev_grads is not None:
        tensors += [g for pair in prev_grads for g in pair]
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"build_lk_templates_lk(device={dev}): got a tensor on {t.device}")
    kw = dict(win=win, min_eig_thresh=min_eig_thresh)
    if dev.type == "cpu":
        # optical_flow imports this module: import it at call time.
        from kimera_vio_tpu_torch.ops import optical_flow
        return optical_flow.build_lk_templates(prev_pyr, prev_pts, valid, prev_grads=prev_grads,
                                               **kw)
    if prev_grads is not None:
        prev_grads = [(gx.contiguous(), gy.contiguous()) for gx, gy in prev_grads]
    return lk_cache_build_cuda([p.contiguous() for p in prev_pyr], prev_pts.contiguous(),
                               valid.contiguous(), prev_grads=prev_grads, **kw)


def klt_track_cached_lk(templates, cur_pyr, init_pts, valid, *, win: int = 24,
                        max_iter: int = 30, eps: float = 0.1,
                        device: str | torch.device = "cuda"):
    """The JAX package's default tracker, `klt_track_cached`, against a
    template cache from `build_lk_templates_lk`. All tensors must
    already lie on `device`: CUDA tensors go through `lk_cached_kernel`
    (one launch a frame), CPU tensors through the plain version
    (`optical_flow.klt_track_cached`). Levels (B, H, W) with (B, N, 2)
    keypoints and a (B, N, ...) cache track B streams in that one launch.
    Returns (tracked_pts (..., N, 2), ok (..., N))."""
    dev = resolve_device(device)
    tensors = [*cur_pyr, init_pts, valid]
    tensors += [T[k] for T in templates if T is not None for k in _CACHE_KEYS]
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"klt_track_cached_lk(device={dev}): got a tensor on {t.device}")
    kw = dict(win=win, max_iter=max_iter, eps=eps)
    if dev.type == "cpu":
        # optical_flow imports this module: import it at call time.
        from kimera_vio_tpu_torch.ops import optical_flow
        return optical_flow.klt_track_cached(templates, cur_pyr, init_pts, valid, **kw)
    pts, ok, _ = lk_cached_cuda(
        templates, [c.contiguous() for c in cur_pyr], init_pts.contiguous(), valid.contiguous(),
        **kw)
    return pts, ok
