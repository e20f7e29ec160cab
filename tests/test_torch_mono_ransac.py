"""The port's 2-pt mono RANSAC guard against the JAX package, and the rest
of the RANSAC family's repeated draws.

The port's `ransac_2pt_mono` scores no inliers for a degenerate
hypothesis: two equal indices, or two normals parallel to working
precision (|n1 x n2| <= PARALLEL_EPS |n1| |n2|). The JAX function has no
such guard (kimera_vio_tpu/ops/ransac.py:40-43, :85-90): where a draw
names one match twice, t = n x n is rounding noise, and below the
1e-12 clamp a short t passes most matches. That is the named divergence.

Unit tests, on seeded bearings: the hypotheses are injected into both
packages (the port's `indices`; the JAX function through a patched
`kimera_vio_tpu.ops.ransac._sample_indices`), scored one draw at a time
or as a batch.

  * Repeated and parallel draws at |n| from 1e-4 to 1e-1, among proper
    draws whose matches carry noise (so that proper hypotheses keep few
    inliers, as on a distorted rig): the port scores each 0, scores every
    proper draw, and answers a batch as it answers the proper draws
    alone. Under the clamp (|n| <= 1e-3) the unguarded JAX function
    scores a repeated draw above every proper one and answers the batch
    with that count.
  * Draws without repeats on a well-conditioned fixture: the port equals
    the JAX function in count and inliers, and t within 1e-5; with the
    repeats, the port equals `jax_guarded_2pt_mono`
    (tests/test_torch_variants.py), the form the run-level tests give
    the JAX side.
  * Low parallax (|n| ~ 1e-3), every pair of distinct matches: the port
    scores each pair the JAX function scores, and PARALLEL_EPS lies a
    decade above the cross product's float32 noise and a decade under
    the smallest sine between two of the fixture's normals.
  * `ransac_5pt_mono`, `ransac_3pt_arun` and `ransac_pnp` also draw with
    replacement. Their residuals do not scale with the hypothesis: each
    repeated draw builds a model of the same class and scale as a proper
    draw (an essential matrix with singular values 1, 1, 0; a rotation),
    on both packages. On a fixture of exact inliers and 25 % gross
    outliers no repeated draw scores above the true model's inliers on
    either package, and a batch mixing repeated and proper draws gives
    the same count and inliers on both. Per draw the two packages differ:
    a repeated index leaves the sample's model underdetermined (a null
    space of two or more dimensions), and each package's eigh / SVD picks
    another member of it. So these three solvers are sound and unguarded.

Run level: the port's `StereoImuPipeline.run()` against the JAX `run()`
at 320x240 (fx 240, 20 frames, 64 features, the default tracker, as
tests/test_torch_default_tracker.py) on the radial-tangential (EuRoC cam0
/ cam1) and the equidistant rig of tests/test_torch_rectification.py,
the port drawing the JAX hypotheses. With the JAX side guarded: the same
keyframe stamps, the same `n_mono_inliers` at every keyframe, positions
within 1e-4 m. The unguarded JAX run on the radial-tangential rig parts
from the port: another `n_mono_inliers` at a keyframe or positions more
than 1e-4 m apart.
"""

import dataclasses
import importlib.util
import os
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.ops import ransac as jransac
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.convert import vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline


def _load(name, file):
    spec = importlib.util.spec_from_file_location(name, os.path.join(os.path.dirname(__file__),
                                                                     file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


var = _load("mono_ransac_variants", "test_torch_variants.py")  # draws, guarded JAX form
rect = _load("mono_ransac_rectification", "test_torch_rectification.py")  # the rigs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.as_tensor(np.asarray(x))


@contextmanager
def _draws(idx):
    """The JAX solvers draw `idx` in place of their `_sample_indices`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jransac, "_sample_indices", lambda *_: idx)
        yield


def _jax_per_draw(solver, args, idx):
    """The JAX `solver`'s count for each row of `idx` alone (under jit, as
    the frontend calls it)."""
    def one(ii):
        with _draws(ii[None]):
            return solver(*[jnp.asarray(a) for a in args], jax.random.PRNGKey(0), n_hyp=1)[-1]
    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(idx)))


def _port_per_draw(solver, args, idx):
    """The port `solver`'s count for each row of `idx` alone."""
    targs = [T(a) for a in args]
    return np.array([int(solver(*targs, indices=T(idx[h:h + 1]))[-1]) for h in range(len(idx))])


def _jax_batch(solver, args, idx):
    with _draws(jnp.asarray(idx)):
        return jax.jit(lambda *a: solver(*a, jax.random.PRNGKey(0), n_hyp=len(idx)))(
            *[jnp.asarray(a) for a in args])


# ---------------------------------------------------------------------------
# The 2-pt mono solver
# ---------------------------------------------------------------------------

N = 64


def _bearings(scale, seed=0, rel_noise=1e-2):
    """(f_ref, f_cur, R, mask) of N matches whose normals |f_ref x R f_cur|
    lie around `scale` (the translation is 10 `scale` m, the points 4-12 m
    away), f_cur perturbed by rel_noise * scale rad: proper hypotheses
    then keep about a dozen inliers of the 1e-6 threshold."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N), rng.uniform(4, 12, N)], -1)
    R = Rotation.from_rotvec([0.02, -0.03, 0.01]).as_matrix()
    t = np.array([0.6, 0.2, -0.4])
    p_cur = (pts - t / np.linalg.norm(t) * 10 * scale) @ R
    f_ref = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    f_cur = p_cur / np.linalg.norm(p_cur, axis=-1, keepdims=True)
    f_cur = f_cur + rng.normal(0, rel_noise * scale, f_cur.shape)
    f_cur /= np.linalg.norm(f_cur, axis=-1, keepdims=True)
    return (f_ref.astype(np.float32), f_cur.astype(np.float32), R.astype(np.float32),
            np.ones(N, bool))


def _normals(f_ref, f_cur, R):
    return np.cross(f_ref.astype(np.float64), f_cur.astype(np.float64) @ R.T.astype(np.float64))


def _proper_pairs(rng, n_matches, count):
    idx = rng.choice(n_matches, (2 * count, 2))
    return idx[idx[:, 0] != idx[:, 1]][:count]


@pytest.mark.parametrize("scale", [1e-4, 1e-3, 1e-2, 1e-1])
def test_repeated_draws_score_nothing(scale):
    f_ref, f_cur, R, mask = _bearings(scale)
    # Eight matches twice over: distinct indices, parallel normals.
    f_ref, f_cur, mask = (np.concatenate([a, a[:8]]) for a in (f_ref, f_cur, mask))
    args = (f_ref, f_cur, mask, R)
    n = f_ref.shape[0]
    repeated = np.stack([np.arange(n), np.arange(n)], -1)
    parallel = np.stack([np.arange(8), np.arange(N, n)], -1)
    proper = _proper_pairs(np.random.default_rng(5), N, 192)
    assert (np.abs(np.median(np.linalg.norm(_normals(f_ref, f_cur, R), axis=-1)) / scale - 1)
            < 0.25)

    port = _port_per_draw(transac.ransac_2pt_mono, args, np.concatenate([repeated, parallel]))
    assert (port == 0).all()
    port_proper = _port_per_draw(transac.ransac_2pt_mono, args, proper)
    assert (port_proper >= 2).all()  # each proper draw passes its own two matches at least
    # The batch, degenerate draws spread through it, answers as the proper
    # draws alone do.
    mixed = np.random.default_rng(6).permutation(np.concatenate([repeated, parallel, proper]))
    t_all, inl_all, n_all = transac.ransac_2pt_mono(*map(T, args), indices=T(mixed))
    keep = (mixed < N).all(-1) & (mixed[:, 0] != mixed[:, 1])
    t_pro, inl_pro, n_pro = transac.ransac_2pt_mono(*map(T, args), indices=T(mixed[keep]))
    assert int(n_all) == int(n_pro) == port_proper.max()
    assert torch.equal(inl_all, inl_pro) and torch.equal(t_all, t_pro)

    if scale <= 1e-3:
        # The named divergence: under the clamp the unguarded JAX function
        # scores a repeated draw above every proper one, and that count is
        # its answer.
        jax_rep = _jax_per_draw(jransac.ransac_2pt_mono, args, repeated)
        jax_pro = _jax_per_draw(jransac.ransac_2pt_mono, args, proper)
        assert jax_rep.max() > jax_pro.max()
        _, _, jn = _jax_batch(jransac.ransac_2pt_mono, args, mixed)
        assert int(jn) >= jax_rep.max() > int(n_all)


def _scene(seed):
    """tests/test_torch_frontend_ops.py's well-conditioned 2-pt fixture:
    120 matches at 4-12 m, 0.39 m of translation, 30 outliers, 10 % of the
    mask off."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, 120), rng.uniform(-3, 3, 120), rng.uniform(4, 12, 120)],
                   -1).astype(np.float32)
    R = Rotation.from_rotvec([0.02, -0.03, 0.01]).as_matrix().astype(np.float32)
    p_cur = (pts - np.array([0.3, 0.1, -0.2], np.float32)) @ R
    f_ref = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    f_cur = p_cur / np.linalg.norm(p_cur, axis=-1, keepdims=True)
    out = rng.choice(120, 30, replace=False)
    bad = rng.normal(size=(30, 3)) + [0, 0, 5]
    f_cur[out] = bad / np.linalg.norm(bad, axis=-1, keepdims=True)
    mask = rng.uniform(size=120) > 0.1
    return f_ref, f_cur.astype(np.float32), R, mask


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_proper_draws_match_jax(seed):
    f_ref, f_cur, R, mask = _scene(seed)
    args = (f_ref, f_cur, mask, R)
    key = jax.random.PRNGKey(seed)
    # 512 draws from 108-odd valid matches: a few name one match twice.
    idx = np.asarray(jransac._sample_indices(key, 512, 2, 120, jnp.asarray(mask, jnp.float32)))
    repeats = idx[:, 0] == idx[:, 1]
    assert repeats.any()
    proper = idx[~repeats]
    jt, jinl, jn = _jax_batch(jransac.ransac_2pt_mono, args, proper)
    tt, tinl, tn = transac.ransac_2pt_mono(*map(T, args), indices=T(proper))
    assert int(tn) == int(jn) > 60
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    # With the repeats: the JAX side's guarded form, as the runs use it.
    with _draws(jnp.asarray(idx)):
        gt, ginl, gn = jax.jit(lambda *a: var.jax_guarded_2pt_mono(*a, key, n_hyp=512))(
            *[jnp.asarray(a) for a in args])
    tt, tinl, tn = transac.ransac_2pt_mono(*map(T, args), indices=T(idx))
    assert int(tn) == int(gn) == int(jn)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(ginl))
    np.testing.assert_allclose(tt.numpy(), np.asarray(gt), atol=1e-5)


def test_low_parallax_rejects_no_proper_hypothesis():
    f_ref, f_cur, R, mask = _bearings(1e-3, seed=3)
    args = (f_ref, f_cur, mask, R)
    pairs = np.stack(np.triu_indices(N, 1), -1)  # every pair of distinct matches
    jax_scores = _jax_per_draw(jransac.ransac_2pt_mono, args, pairs)
    port_scores = _port_per_draw(transac.ransac_2pt_mono, args, pairs)
    assert (jax_scores > 0).all()
    assert (port_scores > 0).all()
    # PARALLEL_EPS against the fixture: n x n in float32 is noise at most
    # a tenth of it, and two distinct matches' normals sit ten times
    # further apart.
    nt = torch.linalg.cross(T(f_ref), T(f_cur) @ T(R).T)
    noise = torch.linalg.norm(torch.linalg.cross(nt, nt), dim=-1) / torch.linalg.norm(nt, dim=-1)**2
    assert float(noise.max()) < transac.PARALLEL_EPS / 10
    n64 = _normals(f_ref, f_cur, R)
    a, b = n64[pairs[:, 0]], n64[pairs[:, 1]]
    sines = np.linalg.norm(np.cross(a, b), axis=-1) / (np.linalg.norm(a, axis=-1)
                                                        * np.linalg.norm(b, axis=-1))
    assert sines.min() > 10 * transac.PARALLEL_EPS
    assert var.PARALLEL_EPS == transac.PARALLEL_EPS


# ---------------------------------------------------------------------------
# 5-pt mono, 3-pt Arun and PnP
# ---------------------------------------------------------------------------

K = {"5pt": 8, "3pt": 3, "pnp": 6}
SOLVERS = {"5pt": (jransac.ransac_5pt_mono, transac.ransac_5pt_mono),
           "3pt": (jransac.ransac_3pt_arun, transac.ransac_3pt_arun),
           "pnp": (jransac.ransac_pnp, transac.ransac_pnp)}
N_OUT = N // 4


def _solver_fixture(name):
    """The solver's arguments on N matches of 4-12 m points: the first
    3N/4 exact, the rest gross outliers; and the count of exact ones."""
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N), rng.uniform(4, 12, N)], -1)
    R = Rotation.from_rotvec([0.02, -0.03, 0.01]).as_matrix()
    t = np.array([0.3, 0.1, -0.2])
    out = slice(N - N_OUT, N)
    mask = np.ones(N, bool)
    if name == "pnp":  # world points and the camera's bearings, x_cam = R x + t
        cam = pts @ R.T + t
        cam[out] = rng.normal(size=(N_OUT, 3)) + [0, 0, 5]
        f = cam / np.linalg.norm(cam, axis=-1, keepdims=True)
        return (pts.astype(np.float32), f.astype(np.float32), mask), N - N_OUT
    p_cur = (pts - t) @ R
    if name == "3pt":  # 3-D points in both frames
        p_cur[out] += rng.normal(0, 1.0, (N_OUT, 3))
        return (pts.astype(np.float32), p_cur.astype(np.float32), mask), N - N_OUT
    bad = rng.normal(size=(N_OUT, 3)) + [0, 0, 5]
    p_cur[out] = bad
    f_ref = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    f_cur = p_cur / np.linalg.norm(p_cur, axis=-1, keepdims=True)
    return (f_ref.astype(np.float32), f_cur.astype(np.float32), mask), N - N_OUT


def _repeated_draws(rng, k, count):
    """`count` draws of k indices, each naming one index twice, and eight
    draws naming one index k times."""
    idx = np.stack([rng.choice(N, k, replace=False) for _ in range(count)])
    j = rng.integers(1, k, count)
    idx[np.arange(count), j] = idx[np.arange(count), rng.integers(0, j)]
    return np.concatenate([idx, np.repeat(np.arange(8)[:, None], k, 1)])


def _models(name, args, idx):
    """Each package's model of each draw: 5pt the essential matrix, 3pt and
    PnP the rotation (numpy, (H, 3, 3) each)."""
    a, b = args[0][idx], args[1][idx]
    ones = np.ones(idx.shape, np.float32)
    if name == "5pt":
        j = jax.vmap(jransac._essential_from_8pt)(jnp.asarray(a), jnp.asarray(b))
        return np.asarray(j), transac._essential_from_8pt(T(a), T(b)).numpy()
    jfit, tfit = ((jransac._arun, transac._arun) if name == "3pt"
                  else (jransac._dlt_pnp, transac._dlt_pnp))
    j = jax.vmap(jfit)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ones))[0]
    return np.asarray(j), tfit(T(a), T(b), T(ones))[0].numpy()


@pytest.mark.parametrize("name", list(K))
def test_repeated_draws_do_not_inflate(name):
    args, n_exact = _solver_fixture(name)
    jsolve, tsolve = SOLVERS[name]
    rng = np.random.default_rng(7)
    repeated = _repeated_draws(rng, K[name], 48)
    # A repeated draw's model is of the proper draws' class and scale, so
    # its residuals are: no norm to shrink them.
    for M in _models(name, args, repeated):
        if name == "5pt":
            np.testing.assert_allclose(np.linalg.svd(M, compute_uv=False),
                                       np.broadcast_to([1, 1, 0], (len(M), 3)), atol=1e-5)
        else:
            np.testing.assert_allclose(M @ M.transpose(0, 2, 1),
                                       np.broadcast_to(np.eye(3), M.shape), atol=1e-5)
            np.testing.assert_allclose(np.linalg.det(M), 1.0, atol=1e-5)
    # The best proper draw recovers the true model, every exact match; no
    # repeated draw scores above it, on either package.
    proper = np.stack([rng.choice(N, K[name], replace=False) for _ in range(48)])
    for per_draw, solve in ((_jax_per_draw, jsolve), (_port_per_draw, tsolve)):
        best = per_draw(solve, args, proper).max()
        assert best >= n_exact
        assert per_draw(solve, args, repeated).max() <= best
    # A batch that mixes them: the same count and inliers on both.
    mixed = rng.permutation(np.concatenate([repeated, proper]))
    jout = _jax_batch(jsolve, args, mixed)
    tout = tsolve(*map(T, args), indices=T(mixed))
    assert int(tout[-1]) == int(jout[-1]) >= n_exact
    np.testing.assert_array_equal(tout[-2].numpy(), np.asarray(jout[-2]))
    assert tout[-2].numpy()[:n_exact].all()


# ---------------------------------------------------------------------------
# Run level, on the distorted rigs
# ---------------------------------------------------------------------------

SIZE = dict(width=320, height=240, fx=240.0)
N_FRAMES = 20
RIGS = {"radtan": ("radial-tangential", rect.EUROC_RADTAN),
        "equidistant": ("equidistant", rect.EQUIDISTANT)}


def _rig_params(rig):
    """(JAX params, port params): tests/test_torch_default_tracker.py's
    320x240 rig with `rig`'s distortion on both cameras."""
    p = j_synthetic_params(**SIZE, nr_states=8, max_features=64, max_landmarks=96)
    model, coeffs = RIGS[rig]
    for cam, c in ((p.left_cam, coeffs[0]), (p.right_cam, coeffs[1])):
        cam.distortion_model = model
        cam.distortion_coeffs = np.array(c)
    return p, vio_params_from_dict(dataclasses.asdict(p))


class _KeyframeInliers:
    """A frontend logger that keeps each keyframe's (stamp, n_mono_inliers)."""

    def __init__(self):
        self.rows = []

    def log(self, stamp_ns, is_kf, n_tracked, med_disp, n_mono, n_stereo, ms):
        if is_kf:
            self.rows.append((int(stamp_ns), int(n_mono)))

    def close(self):
        pass


def _jax_run(rig, guarded):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("KIMERA_LK_IMPL", raising=False)
        if guarded:
            var.guard_jax(mp)
        jp, _ = _rig_params(rig)
        pipe = JPipeline(jp, parallel_run=False)
        assert pipe.frontend_cfg.lk_impl == "matmul"
        assert not pipe.frontend.identity_rect
        pipe.frontend_logger = rec = _KeyframeInliers()
        return pipe.run(JProvider(n_frames=N_FRAMES, vx=0.5, **SIZE)), rec.rows


@pytest.fixture(scope="module")
def port_runs():
    """The port's run on each rig, drawing the JAX hypotheses: (output,
    keyframe inliers)."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("KIMERA_LK_IMPL", raising=False)
        mp.setattr(transac, "_sample_indices", var._jax_draws)
        for rig in RIGS:
            _, tp = _rig_params(rig)
            pipe = StereoImuPipeline(tp, parallel_run=False, device="cpu")
            assert pipe.frontend_cfg.lk_impl == "matmul" and not pipe.frontend.identity_rect
            rec = _KeyframeInliers()
            mp.setattr(pipe, "_open_loggers", lambda provider, rec=rec: (None, rec))
            runs[rig] = pipe.run(SyntheticStereoProvider(n_frames=N_FRAMES, vx=0.5, **SIZE)), \
                rec.rows
    return runs


@pytest.mark.parametrize("rig", list(RIGS))
def test_distorted_run_matches_guarded_jax(rig, port_runs):
    jout, jrows = _jax_run(rig, guarded=True)
    out, rows = port_runs[rig]
    assert out.stamps_ns == jout.stamps_ns and out.n_keyframes >= 4
    assert len(rows) >= 3 and rows == jrows  # each keyframe's stamp and n_mono_inliers
    np.testing.assert_allclose(np.stack(out.positions), np.stack(jout.positions), atol=1e-4)


def test_unguarded_jax_run_parts_from_the_port(port_runs):
    jout, jrows = _jax_run("radtan", guarded=False)
    out, rows = port_runs["radtan"]
    assert out.stamps_ns == jout.stamps_ns
    gap = float(np.abs(np.stack(out.positions) - np.stack(jout.positions)).max())
    assert [n for _, n in rows] != [n for _, n in jrows] or gap > 1e-4, (rows, jrows, gap)
