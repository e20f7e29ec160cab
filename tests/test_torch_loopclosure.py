"""The port's loop-closure modules against the JAX package, on the CPU.

Same inputs, made from a seed with numpy, through the JAX function and
its port (kimera_vio_tpu_torch/ops/ransac.py, loopclosure/orb.py,
vocab.py, pgo.py, lcd.py, frame_cache.py). Tolerances:

  * RANSAC solvers, fed the JAX draws (`indices=`): R within 1e-4 rad,
    t within 1e-4 m, inlier masks equal; the refinements on the same
    RANSAC result: R and t within 1e-4;
  * ORB: every bit equal except where the pair's two samples tie within
    1e-5 (float32 rounding can order them either way), angles within
    1e-5 rad; Hamming distances and matches exact on the same words;
  * vocabularies: BoW vectors exact on the host, within 1e-6 on the
    device; training exact from the same initial centres;
  * PGO: poses within 1e-4, PCM keep masks equal, GNC weights within 1e-4;
  * the detector, fed the same descriptors (`desc_override`): the same
    loops, R and t within 1e-4;
  * the keyframe branch's fused LCD front half (GFTT, ORB, sparse stereo):
    the same keypoints and ok mask, bits as for ORB, backprojections
    within the stereo matcher's parity.
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from kimera_vio_tpu.common import geometry as jgeo
from kimera_vio_tpu.dataprovider import synthetic as jsyn
from kimera_vio_tpu.loopclosure import lcd as jlcd
from kimera_vio_tpu.loopclosure import orb as jorb
from kimera_vio_tpu.loopclosure import pgo as jpgo
from kimera_vio_tpu.loopclosure import vocab as jvocab
from kimera_vio_tpu.ops import corner_detection as jdet
from kimera_vio_tpu.ops import ransac as jransac
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.common.geometry import so3_log
from kimera_vio_tpu_torch.dataprovider import synthetic as tsyn
from kimera_vio_tpu_torch.loopclosure import lcd as tlcd
from kimera_vio_tpu_torch.loopclosure import orb as torb
from kimera_vio_tpu_torch.loopclosure import pgo as tpgo
from kimera_vio_tpu_torch.loopclosure import vocab as tvocab
from kimera_vio_tpu_torch.loopclosure.frame_cache import FrameCache
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.pipeline.lcd_module import LcdModule
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCABS = ["bow_vocab_256.npz", "bow_vocab_tree_4096.npz", "bow_vocab_tree_32768.npz"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def rot_err(Ra, Rb) -> float:
    """Angle of Ra^T Rb in rad."""
    Ra, Rb = t(Ra, torch.float32), t(Rb, torch.float32)
    return float(torch.linalg.norm(so3_log(Ra.T @ Rb)))


def assert_pose_close(R_jax, t_jax, R_port, t_port, tol=1e-4):
    assert rot_err(R_jax, R_port) < tol
    np.testing.assert_allclose(np.asarray(t_port), np.asarray(t_jax), atol=tol)


# ---------------------------------------------------------------------------
# RANSAC family
# ---------------------------------------------------------------------------


def _jax_draws(seed, n_hyp, k, mask):
    key = jax.random.PRNGKey(seed)
    idx = jransac._sample_indices(key, n_hyp, k, mask.shape[0], jnp.asarray(mask, jnp.float32))
    return key, torch.from_numpy(np.asarray(idx).astype(np.int64))


def _scene(seed=3, n=128, n_out=16, noise=0.02, out_mag=3.0, z=6.0):
    """The 3D-3D scene of tests/test_loopclosure.py::TestRefinePose
    (points `z` m ahead of the query camera, +-3 m around)."""
    rng = np.random.default_rng(seed)
    p_q = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    p_q[:, 2] += z
    R_true = np.asarray(jgeo.so3_exp(jnp.asarray([0.15, -0.1, 0.25], jnp.float32)))
    t_true = np.array([0.8, -0.4, 0.3], np.float32)
    p_m = p_q @ R_true.T + t_true
    p_m_noisy = p_m + rng.normal(size=(n, 3)).astype(np.float32) * noise
    d = rng.normal(size=(n_out, 3)).astype(np.float32)
    d *= out_mag / np.linalg.norm(d, axis=-1, keepdims=True)
    p_m_noisy[:n_out] += d
    return p_q, p_m_noisy.astype(np.float32), R_true, t_true


def _bearings(seed, noise=2e-3, z=6.0, n_out=0):
    """PnP fixture of TestRefinePose: match-frame points, query bearings
    with `noise`, the first `n_out` bearings swapped among themselves
    (outliers), a few entries masked out."""
    p_q, p_m, R_true, t_true = _scene(seed=10 + seed, noise=0.0, z=z)
    R_cw = R_true.T
    t_cw = -R_cw @ t_true
    rng = np.random.default_rng(seed)
    cam = p_m @ R_cw.T + t_cw
    b = cam / np.linalg.norm(cam, axis=-1, keepdims=True)
    b = b + rng.normal(size=b.shape).astype(np.float32) * noise
    b = (b / np.linalg.norm(b, axis=-1, keepdims=True)).astype(np.float32)
    b[:n_out] = np.roll(b[:n_out], 2, axis=0)
    mask = np.ones(len(b), bool)
    mask[5:9] = False
    return p_m, b, mask, R_cw, t_cw


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_5pt_mono_matches_jax(seed):
    """The essential refit is the null vector of a float32 A^T A: at a
    baseline of 0.46 m over 4-9 m depths both sides land ~1e-3 from the
    true direction (and from each other); at this 1.6 m baseline both are
    within ~4e-5 of it, so the comparison sees the port, not the
    conditioning."""
    rng = np.random.default_rng(seed)
    n = 96
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 9, n)], -1)
    R = np.asarray(jgeo.so3_exp(jnp.asarray([0.05, -0.12, 0.08], jnp.float32)), np.float64)
    tt = np.array([1.5, 0.5, 0.2])
    f_ref = X / np.linalg.norm(X, axis=-1, keepdims=True)
    Xc = (X - tt) @ R  # x_ref = R x_cur + t
    f_cur = Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)
    f_cur[:12] = np.roll(f_cur[:12], 3, axis=0)  # outliers
    f_ref, f_cur = f_ref.astype(np.float32), f_cur.astype(np.float32)
    mask = np.ones(n, bool)
    mask[-5:] = False
    key, idx = _jax_draws(seed, 128, 8, mask)
    Rj, tj, inl_j, nj = jransac.ransac_5pt_mono(jnp.asarray(f_ref), jnp.asarray(f_cur),
                                                jnp.asarray(mask), key, threshold=1e-6)
    Rt, tt_, inl_t, nt = transac.ransac_5pt_mono(t(f_ref), t(f_cur), t(mask), indices=idx,
                                                 threshold=1e-6)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(nt) == int(nj) >= 60
    assert_pose_close(Rj, tj, Rt, tt_)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_3pt_arun_and_refine_match_jax(seed):
    """ransac_3pt_arun, then refine_arun_huber on the fixture of
    tests/test_loopclosure.py:370 (coherent outliers just inside the
    gate)."""
    p_q, p_m, _, _ = _scene(seed=seed, n_out=24, noise=0.01, out_mag=0.12)
    mask = np.ones(len(p_q), bool)
    mask[:3] = False
    key, idx = _jax_draws(seed, 128, 3, mask)
    Rj, tj, inl_j, nj = jransac.ransac_3pt_arun(jnp.asarray(p_m), jnp.asarray(p_q),
                                                jnp.asarray(mask), key, threshold=0.2)
    Rt, tt_, inl_t, nt = transac.ransac_3pt_arun(t(p_m), t(p_q), t(mask), indices=idx,
                                                 threshold=0.2)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(nt) == int(nj)
    assert_pose_close(Rj, tj, Rt, tt_)
    R1j, t1j = jransac.refine_arun_huber(jnp.asarray(p_m), jnp.asarray(p_q), inl_j, Rj, tj,
                                         huber_m=0.03)
    R1t, t1t = transac.refine_arun_huber(t(p_m), t(p_q), t(inl_j), t(Rj), t(tj), huber_m=0.03)
    assert_pose_close(R1j, t1j, R1t, t1t)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_pnp_and_refine_match_jax(seed):
    """ransac_pnp on noise-free bearings with 10 outliers, points 3 m
    ahead: the final linear refit is the null vector of a float32 12x12
    A^T A, and with points 6 m ahead both sides already sit up to 2.5e-4
    from the true pose (and from each other); at 3 m both are within
    1e-5 of it. Then refine_pnp_gn on the noisy fixture of
    tests/test_loopclosure.py:405, both sides from the JAX RANSAC pose."""
    p_m, b, mask, R_cw, t_cw = _bearings(seed, noise=0.0, z=3.0, n_out=10)
    key, idx = _jax_draws(100 + seed, 128, 6, mask)
    Rj, tj, inl_j, nj = jransac.ransac_pnp(jnp.asarray(p_m), jnp.asarray(b), jnp.asarray(mask),
                                           key, threshold=3.0, focal=450.0)
    Rt, tt_, inl_t, nt = transac.ransac_pnp(t(p_m), t(b), t(mask), indices=idx, threshold=3.0,
                                            focal=450.0)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(nt) == int(nj) == 118
    assert_pose_close(Rj, tj, Rt, tt_)
    assert_pose_close(R_cw, t_cw, Rt, tt_)

    p_m, b, mask, _, _ = _bearings(seed)
    key = jax.random.PRNGKey(100 + seed)
    Rj, tj, inl_j, _ = jransac.ransac_pnp(jnp.asarray(p_m), jnp.asarray(b), jnp.asarray(mask),
                                          key, threshold=3.0, focal=450.0)
    R1j, t1j = jransac.refine_pnp_gn(jnp.asarray(p_m), jnp.asarray(b), inl_j, Rj, tj,
                                     focal=450.0, huber_px=3.0)
    R1t, t1t = transac.refine_pnp_gn(t(p_m), t(b), t(inl_j), t(Rj), t(tj), focal=450.0,
                                     huber_px=3.0)
    assert_pose_close(R1j, t1j, R1t, t1t)


def test_ransac_samplers_draw_from_the_mask():
    """Without `indices` the samplers draw from a torch.Generator: only
    masked-in correspondences, reproducibly for a seed."""
    p_q, p_m, R_true, t_true = _scene(seed=2, n_out=0, noise=0.0)
    mask = np.zeros(len(p_q), bool)
    mask[::2] = True
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        runs.append(transac.ransac_3pt_arun(t(p_m), t(p_q), t(mask), gen, threshold=0.05))
    (R, tt_, inl, n), (R2, _, inl2, _) = runs
    assert torch.equal(R, R2) and torch.equal(inl, inl2)
    assert int(n) == mask.sum() and not (inl.numpy() & ~mask).any()
    assert_pose_close(R_true, t_true, R, tt_, tol=1e-3)


# ---------------------------------------------------------------------------
# ORB
# ---------------------------------------------------------------------------


def _textured(seed, h=240, w=320):
    rng = np.random.default_rng(seed)
    return ndi.zoom(rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32), 8, order=3)[:h, :w].astype(np.float32)


def _corners(img, n=128):
    uv, ok = jdet.detect_features(jnp.asarray(img), jnp.zeros((4, 2), jnp.float32), jnp.zeros(4, bool),
                                  k_new=n, min_distance=12.0, do_subpixel=False)
    return np.asarray(uv), np.asarray(ok)


def _bits(words_u32):
    return np.unpackbits(np.ascontiguousarray(words_u32).view(np.uint8), axis=1,
                         bitorder="little").astype(bool)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_orb_descriptors_match_jax(seed):
    img = _textured(seed)
    uv, ok = _corners(img)
    dj, aj, okj = jorb.orb_descriptors(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(ok))
    dt, at, okt = torb.orb_descriptors(t(img), t(uv), t(ok))
    a, b, _ = torb.orb_samples(t(img), t(uv))
    tie = np.abs((a - b).numpy()) < 1e-5
    differ = _bits(np.asarray(dj)) != _bits(tvocab.as_u32(dt))
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    assert differ.mean() <= tie.mean()  # share of tie bits bounds the differing bits
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-5)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def test_hamming_and_matching_match_jax():
    imgs = [_textured(3), ndi.shift(_textured(3), (0, 3.0), order=3, mode="nearest").astype(np.float32),
            _textured(4)]
    uv, ok = _corners(imgs[0])
    descs = []
    for img, shift in zip(imgs, (0.0, 3.0, 0.0)):
        d, _, k = jorb.orb_descriptors(jnp.asarray(img), jnp.asarray(uv + [shift, 0.0]), jnp.asarray(ok))
        descs.append((np.asarray(d), np.asarray(k)))
    for (da, ka), (db, kb) in [(descs[0], descs[1]), (descs[0], descs[2]), (descs[1], descs[0])]:
        wa, wb = tvocab.as_words(da, "cpu"), tvocab.as_words(db, "cpu")
        np.testing.assert_array_equal(torb.hamming_matrix(wa, wb).numpy(),
                                      np.asarray(jorb.hamming_matrix(jnp.asarray(da), jnp.asarray(db))))
        ij, mj = jorb.match_descriptors(jnp.asarray(da), jnp.asarray(ka), jnp.asarray(db), jnp.asarray(kb))
        it, mt = torb.match_descriptors(wa, t(ka), wb, t(kb))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.numpy().sum() > 10


def test_pack_unpack_and_popcount():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    w = tvocab.as_words(words, "cpu")
    assert w.dtype == torch.int32
    np.testing.assert_array_equal(tvocab.as_u32(torb.pack_bits(torb.unpack_bits(w))), words)
    expect = np.array([[bin(int(x)).count("1") for x in row] for row in words])
    np.testing.assert_array_equal(torb.popcount(w).numpy(), expect)
    np.testing.assert_array_equal(tvocab._popcount_np(words), expect)


# ---------------------------------------------------------------------------
# Vocabularies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", VOCABS)
def test_packaged_vocabulary_copies_are_identical(name):
    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert sha(os.path.join(REPO, "kimera_vio_tpu_torch", "data", name)) == \
        sha(os.path.join(REPO, "kimera_vio_tpu", "data", name))


@pytest.mark.parametrize("name", VOCABS)
def test_vocabulary_transform_and_score_match_jax(name):
    jv = jvocab.load_vocabulary(os.path.join(REPO, "kimera_vio_tpu", "data", name))
    tv = tvocab.load_vocabulary(os.path.join(REPO, "kimera_vio_tpu_torch", "data", name))
    assert type(tv).__name__ == type(jv).__name__ and tv.n_words == jv.n_words
    rng = np.random.default_rng(1)
    vj, vt, vd = [], [], []
    for seed in range(3):
        img = _textured(10 + seed)
        uv, ok = _corners(img)
        d, _, k = jorb.orb_descriptors(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(ok))
        d, k = np.asarray(d), np.asarray(k) & (rng.uniform(size=len(k)) > 0.1)
        vj.append(jv.transform_np(d, k))
        vt.append(tv.transform_np(d, k))
        vd.append(tv.transform(tvocab.as_words(d, "cpu"), t(k)).numpy())
        np.testing.assert_array_equal(vt[-1], vj[-1])
        np.testing.assert_allclose(vd[-1], vj[-1], atol=1e-6)
        np.testing.assert_allclose(vd[-1], np.asarray(jv.transform(jnp.asarray(d), jnp.asarray(k))),
                                   atol=1e-6)
    db = np.stack(vj[1:])
    np.testing.assert_allclose(tv.score_np(vt[0], db), jv.score_np(vj[0], db), atol=1e-6)
    np.testing.assert_allclose(tv.score(t(vt[0]), t(db)).numpy(),
                               np.asarray(jv.score(jnp.asarray(vj[0]), jnp.asarray(db))), atol=1e-6)


def test_train_vocabulary_matches_jax_from_the_same_start():
    rng = np.random.default_rng(0)
    descs = rng.integers(0, 2**32, (600, 8), dtype=np.uint32)
    mask = rng.uniform(size=600) > 0.2
    n_words, seed = 48, 3
    p = mask.astype(np.float32) / mask.sum()
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), 600, shape=(n_words,),
                                        replace=True, p=jnp.asarray(p)))
    cj = jvocab.train_vocabulary(jnp.asarray(descs), jnp.asarray(mask), n_words=n_words, iters=5,
                                 seed=seed)
    ct = tvocab.train_vocabulary(tvocab.as_words(descs, "cpu"), t(mask), n_words=n_words, iters=5,
                                 init_idx=torch.from_numpy(init.astype(np.int64)))
    np.testing.assert_array_equal(tvocab.as_u32(ct), np.asarray(cj))
    # Own draw: a codebook of masked descriptors' majorities, reproducible.
    c1 = tvocab.train_vocabulary(tvocab.as_words(descs, "cpu"), t(mask), n_words=n_words, iters=2)
    c2 = tvocab.train_vocabulary(tvocab.as_words(descs, "cpu"), t(mask), n_words=n_words, iters=2)
    assert torch.equal(c1, c2) and c1.shape == (n_words, 8)


def test_hierarchical_training_and_idf_match_jax():
    rng = np.random.default_rng(2)
    descs = rng.integers(0, 2**32, (900, 8), dtype=np.uint32)
    mask = rng.uniform(size=900) > 0.1
    lj = jvocab.train_hierarchical_vocabulary(descs, mask, k=4, depth=3, iters=3, seed=5)
    lt = tvocab.train_hierarchical_vocabulary(descs, mask, k=4, depth=3, iters=3, seed=5)
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(b, a)
    words = [tvocab.HierarchicalBowVocabulary(lt).words_np(descs[i::3]) for i in range(3)]
    np.testing.assert_array_equal(words[0], jvocab.HierarchicalBowVocabulary(lj).words_np(descs[0::3]))
    np.testing.assert_array_equal(tvocab.compute_idf(words, 64), jvocab.compute_idf(words, 64))


# ---------------------------------------------------------------------------
# PGO
# ---------------------------------------------------------------------------


def _circle(K=20, radius=2.0, drift=0.02):
    """The drifted circle of tests/test_loopclosure.py::TestPgo."""
    angles = np.linspace(0, 2 * np.pi, K, endpoint=False)
    gt_pos = np.stack([radius * np.cos(angles), radius * np.sin(angles), np.zeros(K)], -1).astype(np.float32)
    gt_rot = np.stack([np.asarray(jgeo.so3_exp(jnp.array([0, 0, a], jnp.float32))) for a in angles])
    est_rot, est_pos = [gt_rot[0]], [gt_pos[0]]
    for k in range(1, K):
        Rrel = gt_rot[k - 1].T @ gt_rot[k]
        trel = gt_rot[k - 1].T @ (gt_pos[k] - gt_pos[k - 1]) + drift
        est_rot.append(est_rot[-1] @ Rrel)
        est_pos.append(est_pos[-1] + est_rot[-2] @ trel)
    return gt_rot, gt_pos, np.stack(est_rot).astype(np.float32), np.stack(est_pos).astype(np.float32)


@pytest.mark.parametrize("repeat_loop", [False, True], ids=["one_loop", "repeated_edges"])
def test_optimize_pose_graph_matches_jax(repeat_loop):
    """The drift fixture of tests/test_loopclosure.py:116; with
    `repeated_edges` the loop edge appears three times and one odometry
    edge twice, so the block scatter accumulates."""
    gt_rot, gt_pos, est_rot, est_pos = _circle()
    K = len(gt_pos)
    ei, ej = list(range(K - 1)), list(range(1, K))
    Rm = [est_rot[i].T @ est_rot[j] for i, j in zip(ei, ej)]
    tm = [est_rot[i].T @ (est_pos[j] - est_pos[i]) for i, j in zip(ei, ej)]
    loops = [(K - 1, 0)] * (3 if repeat_loop else 1) + ([(3, 4)] if repeat_loop else [])
    for i, j in loops:
        ei.append(i)
        ej.append(j)
        Rm.append(gt_rot[i].T @ gt_rot[j])
        tm.append(gt_rot[i].T @ (gt_pos[j] - gt_pos[i]))
    w = np.linspace(0.5, 1.0, len(ei)).astype(np.float32)
    args = (est_rot, est_pos, np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(Rm).astype(np.float32), np.stack(tm).astype(np.float32), w)
    rj, pj, cj = jpgo.optimize_pose_graph(*map(jnp.asarray, args))
    rt, pt, ct = tpgo.optimize_pose_graph(*(t(a, torch.int64 if a.dtype == np.int32 else None) for a in args))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-3, atol=1e-6)
    assert np.linalg.norm(pt.numpy()[-1] - gt_pos[-1]) < 0.5 * np.linalg.norm(est_pos[-1] - gt_pos[-1])


def test_pcm_consistency_matches_jax():
    """The bad-loop fixture of tests/test_loopclosure.py:143, plus a
    masked-out candidate and an inconsistent pair."""
    gt_rot, gt_pos, est_rot, est_pos = _circle(drift=0.0)
    K = len(gt_pos)
    li, lj = [K - 1, K - 2, 5, 7, 3], [0, 0, 15, 12, 9]
    lR, lt = [], []
    for i, j in zip(li, lj):
        lR.append(gt_rot[i].T @ gt_rot[j])
        lt.append(gt_rot[i].T @ (gt_pos[j] - gt_pos[i]))
    lR[2], lt[2] = np.eye(3, dtype=np.float32), np.array([9.0, 9.0, 9.0], np.float32)
    lt[3] = lt[3] + np.array([0.3, 0.0, 0.0], np.float32)
    mask = np.array([True, True, True, True, False])
    args = (est_rot, est_pos, np.asarray(li, np.int32), np.asarray(lj, np.int32),
            np.stack(lR).astype(np.float32), np.stack(lt).astype(np.float32), mask)
    kj = np.asarray(jpgo.pcm_consistency(*map(jnp.asarray, args)))
    kt = tpgo.pcm_consistency(*(t(a, torch.int64 if a.dtype == np.int32 else None) for a in args)).numpy()
    np.testing.assert_array_equal(kt, kj)
    assert kt[0] and kt[1] and not kt[2] and not kt[4]


def _gnc_detectors():
    """The GNC fixture of tests/test_loopclosure.py:289 on both sides."""
    K = 24
    angles = np.linspace(0, 2 * np.pi, K, endpoint=False)
    gt_rot = np.stack([np.asarray(jgeo.so3_exp(jnp.array([0, 0, a], jnp.float32))) for a in angles])
    gt_pos = np.stack([2.0 * np.cos(angles), 2.0 * np.sin(angles), np.zeros(K)], -1).astype(np.float32)
    dets = []
    for mod, extra in ((jlcd, {}), (tlcd, {"device": "cpu"})):
        cfg = mod.LcdConfig(pcm_rot_threshold=0.5, pcm_trans_threshold=1.0, gnc_alpha=0.7)
        vocab_mod = jvocab if mod is jlcd else tvocab
        det = mod.LoopClosureDetector(vocab_mod.BowVocabulary(np.zeros((8, 256), np.float32)), cfg, **extra)
        for k in range(K):
            det.kf_pose.append((gt_rot[k], gt_pos[k]))
            det.kf_stamps.append(k)
        det.n_kf = K
        for i, j, terr in [(0, 12, 0.0), (1, 13, 0.0), (2, 14, 0.6)]:
            R = (gt_rot[i].T @ gt_rot[j]).astype(np.float32)
            tt_ = (gt_rot[i].T @ (gt_pos[j] - gt_pos[i]) + [terr, 0.0, 0.0]).astype(np.float32)
            det.loops.append(mod.LoopResult(query_id=j, match_id=i, R_match_query=R,
                                            t_match_query=tt_, n_inliers=30))
        dets.append(det)
    return dets, gt_pos


def test_gnc_optimize_matches_jax():
    (dj, dt), gt_pos = _gnc_detectors()
    rj, pj = dj.optimize_graph()
    rt, pt = dt.optimize_graph()
    np.testing.assert_allclose(dt.gnc_weights, dj.gnc_weights, atol=1e-4)
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    np.testing.assert_allclose(rt, rj, atol=1e-4)
    w = dt.gnc_weights
    assert w[0] > 0.5 and w[1] > 0.5 and w[2] < 0.2 * min(w[0], w[1])
    assert np.linalg.norm(pt - gt_pos, axis=-1).max() < 0.2


# ---------------------------------------------------------------------------
# The detector, fed the same payloads
# ---------------------------------------------------------------------------


def _revisit_payloads():
    """Keyframes of five scenes of 96 random 3D points 3-6 m ahead, each
    point with its own random descriptor words: keyframes 0-4 see scenes
    0-4 from the origin, keyframes 5-7 see scenes 0-2 again from a pose
    1.6 m and ~0.2 rad away, with 8 points of each displaced (geometric
    outliers) and 4 masked out. Returns (payloads, the true
    T_match_query as (R, t))."""
    rng = np.random.default_rng(7)
    R1 = np.asarray(jgeo.so3_exp(jnp.asarray([0.1, -0.15, 0.05], jnp.float32)), np.float64)
    c1 = np.array([1.5, 0.5, 0.2])
    scenes = []
    for _ in range(5):
        X = np.stack([rng.uniform(-3, 3, 96), rng.uniform(-2, 2, 96), rng.uniform(3, 6, 96)], -1)
        scenes.append((X, rng.integers(0, 2**32, (96, 8), dtype=np.uint32)))
    out = []
    for k, (scene, (Rc, c)) in enumerate([(s, (np.eye(3), np.zeros(3))) for s in range(5)]
                                         + [(s, (R1, c1)) for s in range(3)]):
        X, desc = scenes[scene]
        pts = (X - c) @ Rc
        mask = np.ones(96, bool)
        if k >= 5:
            pts[:8] += rng.uniform(-1, 1, (8, 3))
            mask[-4:] = False
        pts = pts.astype(np.float32)
        versors = (pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(np.float32)
        uv = (450.0 * pts[:, :2] / pts[:, 2:] + [160.0, 120.0]).astype(np.float32)
        out.append(dict(uv=uv, mask=mask, versors=versors, pts3d=pts, desc=desc,
                        pose_R=np.eye(3, dtype=np.float32),
                        pose_t=np.array([0.1 * k, 0, 0], np.float32), stamp_ns=k))
    return out, (R1, c1)


@pytest.mark.parametrize("pose_recovery_type", [0, 1, 2], ids=["k3d3d", "kPnP", "k5ptRotOnly"])
def test_detector_matches_jax_on_the_same_descriptors(pose_recovery_type):
    """Each side draws its own RANSAC samples; on this noise-free fixture
    every side's best hypothesis keeps the same inliers, and the refit
    (and the refinement) over them agrees within 1e-4."""
    payloads, (R_true, t_true) = _revisit_payloads()
    cb = np.concatenate([p["desc"] for p in payloads[:5]])[::7]
    results = []
    for mod, vocab_mod, extra in ((jlcd, jvocab, {}), (tlcd, tvocab, {"device": "cpu"})):
        cfg = mod.LcdConfig(recent_frames_window=2, min_temporal_matches=1, alpha=0.3,
                            min_inliers=8, n_features=96, pose_recovery_type=pose_recovery_type)
        det = mod.LoopClosureDetector(vocab_mod.BowVocabulary(cb), cfg, **extra)
        for p in payloads:
            det.add_keyframe(None, p["uv"], p["mask"], p["versors"], p["pts3d"], p["pose_R"],
                             p["pose_t"], p["stamp_ns"], desc_override=(p["desc"], p["mask"]))
        results.append(det)
    dj, dt = results
    assert [(l.query_id, l.match_id) for l in dt.loops] == [(l.query_id, l.match_id) for l in dj.loops]
    assert [(l.query_id, l.match_id) for l in dt.loops] == [(5, 0), (6, 1), (7, 2)]
    for a, b in zip(dj.loops, dt.loops):
        assert b.rot_only == a.rot_only == (pose_recovery_type == 2)
        assert_pose_close(a.R_match_query, a.t_match_query, b.R_match_query, b.t_match_query)
        t_ref = t_true / np.linalg.norm(t_true) if pose_recovery_type == 2 else t_true
        assert_pose_close(R_true, t_ref, b.R_match_query, b.t_match_query, tol=1e-3)
    rj, pj = dj.optimize_graph()
    rt, pt = dt.optimize_graph()
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    np.testing.assert_allclose(rt, rj, atol=1e-4)


def test_detector_memory_bounded_and_disk_fetch(tmp_path):
    """Twin of tests/test_loopclosure.py:226: FrameCache keeps at most 5
    payloads in RAM, the rest on disk, and verification fetches them."""
    rng = np.random.default_rng(0)
    n_words, n_feat = 32, 64
    codebook = rng.integers(0, 2, (n_words, 256)).astype(np.uint8)
    cache = FrameCache(str(tmp_path), max_in_memory=5)
    cfg = tlcd.LcdConfig(recent_frames_window=3, min_temporal_matches=1, alpha=0.01,
                         min_correspondences=4, min_inliers=4)
    det = tlcd.LoopClosureDetector(tvocab.BowVocabulary(codebook), cfg, cache=cache, device="cpu")
    desc0 = rng.integers(0, 2, (n_feat, 256)).astype(np.uint8)
    pts = rng.uniform(-2, 2, (n_feat, 3)).astype(np.float32)
    for k in range(20):
        det.add_keyframe(None, uv=rng.uniform(0, 100, (n_feat, 2)).astype(np.float32),
                         mask=np.ones(n_feat, bool),
                         versors=pts / np.linalg.norm(pts, axis=-1, keepdims=True), pts3d=pts,
                         pose_R=np.eye(3, dtype=np.float32), pose_t=np.zeros(3, np.float32),
                         stamp_ns=k * 10**8, desc_override=(desc0, np.ones(n_feat, bool)))
    assert len(det.cache._mem) <= 5
    assert det.n_kf == 20
    assert det.cache.get(0) is not None
    assert len(det.loops) > 0


# ---------------------------------------------------------------------------
# The pipeline's LCD front half and LcdModule
# ---------------------------------------------------------------------------


def _orbit(mod, n_frames=1):
    """(params, provider) of the 320x240 orbit of
    tests/test_torch_lcd_pipeline.py from either package."""
    w = np.pi
    params = mod.synthetic_params(width=320, height=240, fx=300.0, nr_states=5, max_features=64,
                                  max_landmarks=96)
    params.lcd.nfeatures = 128
    prov = mod.SyntheticPlanar6DofProvider(
        n_frames=n_frames, width=320, height=240, fx=300.0, plane_z=3.0,
        noise=mod._NoiseModel(imu_rate=200.0, pixel_noise_std=0.3, seed=3),
        trans_amp=(0.8, 0.4, 0.2), rot_amp=(0.05, 0.06, 0.08), trans_freq=(w, w, w),
        rot_freq=(w, w, w))
    return params, prov


def test_fused_lcd_extract_matches_jax():
    """The keyframe branch's LCD front half on one rectified stereo pair
    of the orbit: the same keypoints, descriptor bits equal except where
    a pair's samples tie within 1e-5, the same ok mask, and the stereo
    backprojections within the matcher's parity (1e-2 px, depth rtol
    1e-3; tests/test_torch_frontend_ops.py)."""
    params, prov = _orbit(jsyn)
    left, right = prov.load_image(("left", 0)), prov.load_image(("right", 0))
    jf = JPipeline(params, enable_lcd=True).frontend._lcd_extract(jnp.asarray(left), jnp.asarray(right))
    tparams, _ = _orbit(tsyn)
    tf = StereoImuPipeline(tparams, enable_lcd=True, device="cpu").frontend._lcd_extract(
        torch.from_numpy(left), torch.from_numpy(right))
    assert tf["lcd_uv"].shape == (128, 2) and tf["lcd_desc"].shape == (128, 8)
    np.testing.assert_array_equal(tf["lcd_uv"].numpy(), np.asarray(jf["lcd_uv"]))
    np.testing.assert_array_equal(tf["lcd_ok"].numpy(), np.asarray(jf["lcd_ok"]))
    ok = tf["lcd_ok"].numpy()
    assert ok.sum() > 60
    a, b, _ = torb.orb_samples(torch.from_numpy(left), tf["lcd_uv"])
    tie = np.abs((a - b).numpy()) < 1e-5
    bits = [np.unpackbits(w.view(np.uint8), axis=1, bitorder="little").astype(bool)
            for w in (tvocab.as_u32(tf["lcd_desc"]), np.asarray(jf["lcd_desc"]))]
    assert not ((bits[0] != bits[1]) & ~tie).any()
    np.testing.assert_allclose(tf["lcd_pts3"].numpy()[ok], np.asarray(jf["lcd_pts3"])[ok], rtol=1e-3)
    np.testing.assert_allclose(tf["lcd_versors"].numpy()[ok], np.asarray(jf["lcd_versors"])[ok],
                               atol=1e-4)


def test_lcd_module_trains_its_vocabulary_and_finishes():
    """Without a packaged vocabulary LcdModule keeps the first
    `vocab_train_kfs` keyframes, trains a k-majority codebook on them and
    processes them in order; `finish` needs two keyframes."""
    params, prov = _orbit(tsyn, n_frames=4)
    stereo = StereoImuPipeline(params, device="cpu").stereo
    mod = LcdModule(stereo, lcd_params=params.lcd, vocab_path=None, vocab_train_kfs=3,
                    n_words=32, device="cpu")
    assert mod.lcd is None
    assert mod.finish() is None
    gt = prov.ground_truth
    for k in range(4):
        mod.add_keyframe(prov.load_image(("left", k)), prov.load_image(("right", k)),
                         np.eye(3, dtype=np.float32), gt.positions[k].astype(np.float32),
                         int(gt.stamps_ns[k]))
        assert (mod.lcd is None) == (k < 2)
    assert mod.lcd.n_kf == 4 and mod.lcd.vocab.n_words == 32
    res = mod.finish()
    assert res["stamps"] == [int(s) for s in gt.stamps_ns[:4]]
    assert res["pos"].shape == (4, 3) and np.isfinite(res["pos"]).all()


def test_pipeline_with_lcd_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    params, _ = _orbit(tsyn)
    with pytest.raises(RuntimeError, match="CUDA"):
        StereoImuPipeline(params, enable_lcd=True)


def test_detector_and_module_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlcd.LoopClosureDetector(tvocab.BowVocabulary(np.zeros((4, 8), np.uint32)))
    with pytest.raises(RuntimeError, match="CUDA"):
        LcdModule(None)
