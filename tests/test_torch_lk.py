"""The port's LK tracker against the Pallas TPU kernels it replaces.

The CUDA kernel cannot run here; its plain PyTorch twin (`lk_level_plain`,
the function the kernel is held against on the card by chip_smoke.py) is
compared with the real Pallas kernels run the way the JAX package's own
tests run them on the CPU, in interpret mode:

  * the whole tracker `klt_track_pallas` on a 240x320 pair (the VMEM kernel
    on levels 0-2, the XLA level on level 3);
  * `_track_level_pallas` (gather kernel, B1) and
    `_track_level_pallas_vmem` (VMEM kernel, B2) directly on one level;
  * the level table the CUDA kernel receives (`level_table`, pure Python)
    against `klt_track_pallas`'s branch choice, base-point scaling and
    level-0 gate, and against `track_pyramid`'s loop.

Tolerance: median distance < 0.05 px over the points both sides track and
>= 90 % agreement of `ok`, the repository's own bound for Pallas vs XLA LK
(tests/test_optical_flow.py:183-186). The slack covers the VMEM kernel's
bf16 storage of gradients and blurred coarse levels, which the port keeps
in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from kimera_vio_tpu.ops import optical_flow as jof
from kimera_vio_tpu.ops.pallas import lk_kernel as jlk
from kimera_vio_tpu_torch.ops import lk_kernel as tlk
from kimera_vio_tpu_torch.ops import optical_flow as tof


def textured_pair(h, w, dx, seed):
    rng = np.random.default_rng(seed)
    small = rng.uniform(30, 225, (h // 6 + 2, (w + 40) // 6 + 2)).astype(np.float32)
    tex = ndi.zoom(small, 6, order=3)[:h, : w + 40].astype(np.float32)
    i0 = int(np.floor(dx))
    f = dx - i0
    cur = ((1 - f) * tex[:, i0 : i0 + w] + f * tex[:, i0 + 1 : i0 + 1 + w]).astype(np.float32)
    return tex[:, :w].copy(), cur


def random_points(h, w, n, seed, margin=14):
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.uniform(margin, w - margin, n), rng.uniform(margin, h - margin, n)], -1
    ).astype(np.float32)


def assert_lk_agrees(pts_t, ok_t, pts_j, ok_j, min_both=10):
    ok_t, ok_j = np.asarray(ok_t), np.asarray(ok_j)
    assert (ok_t == ok_j).mean() >= 0.90, (ok_t == ok_j).mean()
    both = ok_t & ok_j
    assert both.sum() >= min_both
    d = np.linalg.norm(np.asarray(pts_t)[both] - np.asarray(pts_j)[both], axis=-1)
    assert np.median(d) < 0.05, np.median(d)


def test_klt_track_lk_matches_klt_track_pallas():
    prev, cur = textured_pair(240, 320, 4.7, seed=0)
    pts = random_points(240, 320, 24, seed=1)
    init = pts + np.float32([2.0, 0.0])
    valid = np.ones(24, bool)
    jp = jof.build_pyramid(jnp.asarray(prev), 4)
    jc = jof.build_pyramid(jnp.asarray(cur), 4)
    out_j, ok_j = jlk.klt_track_pallas(
        jp, jc, jnp.asarray(pts), jnp.asarray(init), jnp.asarray(valid), interpret=True
    )
    tp = tof.build_pyramid(torch.from_numpy(prev), 4)
    tc = tof.build_pyramid(torch.from_numpy(cur), 4)
    out_t, ok_t = tlk.klt_track_lk(
        tp, tc, torch.from_numpy(pts), torch.from_numpy(init), torch.from_numpy(valid),
        device="cpu",
    )
    assert_lk_agrees(out_t.numpy(), ok_t.numpy(), out_j, ok_j, min_both=18)
    # The level plan is `klt_track_pallas`'s: VMEM kernel on 240x320,
    # 120x160 and 60x80 (60 rows >= the 56-row search window), XLA level
    # on 30x40, 15x20 skipped.
    plan = [tlk.level_mode(*t.shape, 24, 56)[0] for t in tp]
    assert plan == ["vmem", "vmem", "vmem", "xla", "skip"]


def _level_inputs(h, w, n, seed):
    prev, cur = textured_pair(h, w, 3.3, seed)
    ix, iy = tof._grad(torch.from_numpy(prev))
    pts = random_points(h, w, n, seed + 1, margin=2)
    init = pts + np.float32([2.5, -0.5])
    valid = np.random.default_rng(seed + 2).uniform(size=n) > 0.1
    return prev, cur, ix.numpy(), iy.numpy(), pts, init, valid


@pytest.mark.parametrize(
    "kernel,h,w",
    [("gather", 96, 192), ("vmem", 100, 200)],
    ids=["B1_track_level_pallas", "B2_track_level_pallas_vmem"],
)
def test_level_matches_pallas_kernel(kernel, h, w):
    prev, cur, ix, iy, pts, init, valid = _level_inputs(h, w, 40, seed=3)
    fn = jlk._track_level_pallas if kernel == "gather" else jlk._track_level_pallas_vmem
    out_j, ok_j = fn(
        *map(jnp.asarray, (prev, ix, iy, cur, pts, init, valid)),
        win=24, search_rows=56, max_iter=30, eps=0.1, min_eig_thresh=1e-4, interpret=True,
    )
    # B1 clamps window origins to the true height, B2 to the height padded
    # to 8 rows (100 -> 104 here).
    clamp_h = h if kernel == "gather" else (h + 7) // 8 * 8
    out_t, ok_t, iters = tlk.lk_level_plain(
        *map(torch.from_numpy, (prev, ix, iy, cur, pts, init, valid)),
        win=24, max_iter=30, eps=0.1, min_eig_thresh=1e-4,
        window_rule=True, search_rows=56, clamp_h=clamp_h,
    )
    assert_lk_agrees(out_t.numpy(), ok_t.numpy(), out_j, ok_j)
    # Keypoints near the border fail the template-fraction gate on both
    # sides; the ones kept took at least one step.
    assert (~ok_t.numpy()).sum() > 0 and (iters.numpy()[ok_t.numpy()] >= 1).all()


def test_plain_klt_track_matches_xla_tracker():
    """The port's plain `klt_track` is the reference's gather tracker."""
    prev, cur = textured_pair(240, 320, 6.2, seed=5)
    pts = random_points(240, 320, 32, seed=6)
    valid = np.ones(32, bool)
    jp = jof.build_pyramid(jnp.asarray(prev), 3)
    jc = jof.build_pyramid(jnp.asarray(cur), 3)
    out_j, ok_j = jof.klt_track(jp, jc, jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(valid))
    tp = tof.build_pyramid(torch.from_numpy(prev), 3)
    tc = tof.build_pyramid(torch.from_numpy(cur), 3)
    out_t, ok_t = tof.klt_track(tp, tc, torch.from_numpy(pts), torch.from_numpy(pts),
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    # Same arithmetic in the same order; 1e-3 px covers float32 sums.
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-3)


def test_klt_track_lk_refuses_cuda_without_a_card():
    """The default device is CUDA; without a card the tracker raises
    instead of running its plain version."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    pyr = tof.build_pyramid(torch.zeros(64, 64), 1)
    pts = torch.zeros(4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlk.klt_track_lk(pyr, pyr, pts, pts, torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlk.lk_pyramid_cuda(pyr, pyr, [(p, p) for p in pyr], pts, pts, torch.ones(4, dtype=torch.bool),
                            win=24, max_iter=30, eps=0.1, min_eig_thresh=1e-4, search_rows=56)


def _pyramid_shapes(h, w, n):
    """Level shapes of `build_pyramid` (each level ceil-halves the last)."""
    shapes = [(h, w)]
    for _ in range(n - 1):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return shapes


@pytest.mark.parametrize(
    "h,w,n,plan",
    [
        (480, 752, 5, [("xla", None), ("vmem", 64), ("vmem", 120), ("vmem", 240), ("vmem", 480)]),
        (376, 1241, 4, [("xla", None), ("vmem", 96), ("vmem", 192), ("gather", 376)]),
        (240, 320, 5, [("skip", None), ("xla", None), ("vmem", 64), ("vmem", 120), ("vmem", 240)]),
        (50, 200, 2, [("skip", None), ("xla", None)]),
    ],
    ids=["752x480", "1241x376", "320x240_top_skipped", "200x50_xla_level0"],
)
def test_level_table_is_klt_track_pallas_plan(monkeypatch, h, w, n, plan):
    """The kernel's level table (built on the host) against the branch
    `klt_track_pallas` takes on each level, the base point each level
    receives there and in `track_pyramid`, and which level's `ok` counts.
    The level functions on both sides are replaced by recorders that
    fail every keypoint, so the final `ok` shows whether level 0's was
    kept."""
    shapes = _pyramid_shapes(h, w, n)
    table = tlk.level_table(shapes, 24, 56)
    assert [(e.mode, e.clamp_h) for e in table] == plan
    assert [e.level for e in table] == list(range(n - 1, -1, -1))
    assert [e.shape for e in table] == shapes[::-1]
    tracked = [e for e in table if e.mode != "skip"]
    pts = random_points(h, w, 8, seed=11, margin=13)
    # Every level's base point: the keypoints scaled by the product of the
    # table's scales so far (x2 per level below the top, skipped ones too).
    scale, expect = 1.0, {}
    for e in table:
        scale *= e.scale
        expect[e.level] = pts * np.float32(scale)

    calls = []

    def recorder(kind):
        def level(prev, gx, gy, cur, base, p, valid, *a, **k):
            calls.append((kind, tuple(prev.shape), np.asarray(base).copy()))
            return p, np.zeros(len(valid), bool)
        return level

    monkeypatch.setattr(jlk, "_track_level_pallas_vmem", recorder("vmem"))
    monkeypatch.setattr(jlk, "_track_level_pallas", recorder("gather"))
    monkeypatch.setattr(jlk.of, "_track_level", recorder("xla"))
    zeros = [np.zeros(s, np.float32) for s in shapes]
    _, ok_j = jlk.klt_track_pallas(zeros, zeros, pts, pts, np.ones(8, bool),
                                   prev_grads=[(z, z) for z in zeros])
    assert [(k, s) for k, s, _ in calls] == [(e.mode, e.shape) for e in tracked]
    for (_, _, base), e in zip(calls, tracked):
        np.testing.assert_array_equal(base, expect[e.level])
    assert bool(np.asarray(ok_j).any()) == (not table[-1].keep_ok)

    seen = []

    def level_fn(prev, gx, gy, cur, base, p, valid, **kw):
        seen.append((tuple(prev.shape), kw["window_rule"], kw["clamp_h"], base.numpy().copy()))
        return p, torch.zeros_like(valid), torch.zeros(len(valid), dtype=torch.int32)

    tz = [torch.from_numpy(z) for z in zeros]
    _, ok_t, _ = tlk.track_pyramid(
        level_fn, tz, tz, torch.from_numpy(pts), torch.from_numpy(pts),
        torch.ones(8, dtype=torch.bool), [(z, z) for z in tz],
        win=24, max_iter=30, eps=0.1, min_eig_thresh=1e-4, search_rows=56,
    )
    assert [s[:3] for s in seen] == [(e.shape, e.mode != "xla", e.clamp_h) for e in tracked]
    for (*_, base), e in zip(seen, tracked):
        np.testing.assert_array_equal(base, expect[e.level])
    assert bool(ok_t.any()) == (not table[-1].keep_ok)
