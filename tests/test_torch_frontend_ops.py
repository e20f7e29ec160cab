"""Parity of the PyTorch port with the JAX package on the CPU: GFTT
detection, stereo matching, RANSAC / stereo voting, triangulation; and the
port's import hygiene.

Each test makes its inputs with numpy from a seed, runs the JAX function
and its counterpart in kimera_vio_tpu_torch, and compares the outputs with
the tolerance stated at the comparison. Both sides compute in float32; a
tolerance above float32 round-off is explained where it is set.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import scipy.ndimage as ndi
import torch

from kimera_vio_tpu.common import geometry as jgeo
from kimera_vio_tpu.ops import corner_detection as jdet
from kimera_vio_tpu.ops import ransac as jransac
from kimera_vio_tpu.ops.stereo_matching import match_stereo as jmatch
from kimera_vio_tpu.ops.triangulation import triangulate_stereo_landmarks as jtri
from kimera_vio_tpu_torch.ops import corner_detection as tdet
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.ops.stereo_matching import match_stereo as tmatch
from kimera_vio_tpu_torch.ops.triangulation import triangulate_stereo_landmarks as ttri

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(x):
    return torch.as_tensor(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def textured(h, w, seed, scale=6):
    rng = np.random.default_rng(seed)
    small = rng.uniform(30, 225, (h // scale + 2, w // scale + 2)).astype(np.float32)
    return ndi.zoom(small, scale, order=3)[:h, :w].astype(np.float32)


# ---------------------------------------------------------------------------
# GFTT detection
# ---------------------------------------------------------------------------


def test_gftt_detection_matches_jax():
    img = textured(240, 320, seed=5, scale=5)
    rng = np.random.default_rng(6)
    ex_uv = np.stack([rng.uniform(0, 320, 40), rng.uniform(0, 240, 40)], -1).astype(np.float32)
    ex_mask = rng.uniform(size=40) > 0.3
    kw = dict(quality_level=0.001, min_distance=20.0, nr_horizontal_bins=7,
              nr_vertical_bins=5, do_subpixel=True)
    juv, jok = jdet.detect_features(jnp.asarray(img), jnp.asarray(ex_uv), jnp.asarray(ex_mask), 64, **kw)
    tuv, tok = tdet.detect_features(T(img), T(ex_uv), T(ex_mask), 64, **kw)
    np.testing.assert_array_equal(N(tok), np.asarray(jok))
    assert N(tok).sum() > 20
    m = N(tok)
    # Same candidates in the same order; the sub-pixel step differs only by
    # float32 rounding of its 21x21 sums (1e-3 px).
    np.testing.assert_allclose(N(tuv)[m], np.asarray(juv)[m], atol=1e-3)


# ---------------------------------------------------------------------------
# stereo matching
# ---------------------------------------------------------------------------


def test_match_stereo_matches_jax():
    left = textured(240, 320, seed=7, scale=4)
    right = ndi.shift(left, (0, -9.4), order=3, mode="nearest").astype(np.float32)
    rng = np.random.default_rng(8)
    uv = np.stack([rng.uniform(30, 300, 48), rng.uniform(10, 230, 48)], -1).astype(np.float32)
    valid = rng.uniform(size=48) > 0.1
    kw = dict(templ_cols=31, templ_rows=11, max_disparity=64, min_point_dist=0.5,
              max_point_dist=30.0, tolerance=0.15)
    ju, jd, jok = jmatch(jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv), jnp.asarray(valid),
                         fx=jnp.float32(450.0), baseline=jnp.float32(0.11), **kw)
    tu, td, tok = tmatch(T(left), T(right), T(uv), T(valid),
                         fx=torch.tensor(450.0), baseline=torch.tensor(0.11), **kw)
    np.testing.assert_array_equal(N(tok), np.asarray(jok))
    m = N(tok)
    assert m.sum() > 30
    # SSD from a convolution summed in another order: the parabola vertex
    # moves by < 1e-2 px.
    np.testing.assert_allclose(N(tu)[m], np.asarray(ju)[m], atol=1e-2)
    np.testing.assert_allclose(N(td)[m], np.asarray(jd)[m], rtol=1e-3)


# ---------------------------------------------------------------------------
# RANSAC (hypothesis indices injected) and stereo voting
# ---------------------------------------------------------------------------


def _scene(n, seed):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], -1)
    return pts.astype(np.float32), rng


def test_ransac_2pt_mono_matches_jax_with_injected_indices():
    pts, rng = _scene(120, 9)
    R = np.asarray(jgeo.so3_exp(jnp.array([0.02, -0.03, 0.01])))
    t = np.array([0.3, 0.1, -0.2], np.float32)
    p_cur = (pts - t) @ R
    f_ref = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    f_cur = p_cur / np.linalg.norm(p_cur, axis=-1, keepdims=True)
    out = rng.choice(120, 30, replace=False)
    bad = rng.normal(size=(30, 3)) + [0, 0, 5]
    f_cur[out] = bad / np.linalg.norm(bad, axis=-1, keepdims=True)
    mask = rng.uniform(size=120) > 0.1
    key = jax.random.PRNGKey(3)
    idx = np.asarray(jransac._sample_indices(key, 128, 2, 120, jnp.asarray(mask, jnp.float32)))
    jt, jinl, jn = jransac.ransac_2pt_mono(jnp.asarray(f_ref), jnp.asarray(f_cur.astype(np.float32)),
                                          jnp.asarray(mask), jnp.asarray(R), key,
                                          n_hyp=128, threshold=1e-6)
    tt, tinl, tn = transac.ransac_2pt_mono(T(f_ref), T(f_cur.astype(np.float32)), T(mask), T(R),
                                          n_hyp=128, threshold=1e-6, indices=T(idx))
    np.testing.assert_array_equal(N(tinl), np.asarray(jinl))
    assert int(tn) == int(jn)
    # Smallest eigenvector of a 3x3 inlier scatter matrix (eigh in float32).
    np.testing.assert_allclose(N(tt), np.asarray(jt), atol=1e-4)
    # The generator path draws valid indices only.
    g = torch.Generator().manual_seed(0)
    drawn = transac._sample_indices(g, 64, 2, 120, T(mask).float())
    assert N(mask)[N(drawn)].all()


def test_voting_1pt_stereo_matches_jax():
    pts, rng = _scene(80, 10)
    R = np.asarray(jgeo.so3_exp(jnp.array([0.01, 0.02, -0.01])))
    t = np.array([0.2, -0.05, 0.1], np.float32)
    p_cur = ((pts - t) @ R).astype(np.float32)
    p_cur[:12] += rng.normal(0, 1.0, (12, 3)).astype(np.float32)
    fx = fy = 450.0
    cx, cy, b = 160.0, 120.0, 0.11

    def uvd(p):
        return np.stack([fx * p[:, 0] / p[:, 2] + cx, fx * (p[:, 0] - b) / p[:, 2] + cx,
                         fy * p[:, 1] / p[:, 2] + cy], -1).astype(np.float32)

    u_ref, u_cur = uvd(pts), uvd(p_cur)
    mask = rng.uniform(size=80) > 0.1
    jc_ref = jransac.stereo_point_cov_from_rect(fx, fy, cx, cy, b, jnp.asarray(u_ref))
    jc_cur = jransac.stereo_point_cov_from_rect(fx, fy, cx, cy, b, jnp.asarray(u_cur))
    tc_ref = transac.stereo_point_cov_from_rect(fx, fy, cx, cy, b, T(u_ref))
    tc_cur = transac.stereo_point_cov_from_rect(fx, fy, cx, cy, b, T(u_cur))
    np.testing.assert_allclose(N(tc_ref), np.asarray(jc_ref), rtol=1e-4, atol=1e-9)
    jt, jinl, jn = jransac.voting_1pt_stereo(jnp.asarray(pts), jnp.asarray(p_cur), jc_ref, jc_cur,
                                            jnp.asarray(mask), jnp.asarray(R))
    tt, tinl, tn = transac.voting_1pt_stereo(T(pts), T(p_cur), tc_ref, tc_cur, T(mask), T(R))
    np.testing.assert_array_equal(N(tinl), np.asarray(jinl))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(N(tt), np.asarray(jt), atol=1e-4)


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------


def test_triangulation_matches_jax():
    rng = np.random.default_rng(11)
    K, L = 5, 64
    R_w_cam = np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(0, 0.05, (K, 3)).astype(np.float32))))
    t_w_cam = np.stack([np.linspace(0, 0.8, K), np.zeros(K), np.zeros(K)], -1).astype(np.float32)
    pw = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(3, 9, L)], -1)
    fx = fy = 450.0
    cx, cy, b = 160.0, 120.0, 0.11
    pc = np.einsum("kji,lkj->lki", R_w_cam, pw[:, None, :] - t_w_cam[None])
    obs = np.stack([fx * pc[..., 0] / pc[..., 2] + cx, fx * (pc[..., 0] - b) / pc[..., 2] + cx,
                    fy * pc[..., 1] / pc[..., 2] + cy], -1)
    obs = (obs + rng.normal(0, 0.3, obs.shape)).astype(np.float32)
    obs[:6, :, 1] = np.nan  # mono observations
    obs[6:10] += rng.normal(0, 20.0, (4, K, 3)).astype(np.float32)  # outliers
    mask = rng.uniform(size=(L, K)) > 0.25
    kw = dict(fx=fx, fy=fy, cx=cx, cy=cy, baseline=b, newest_idx=K - 1,
              landmark_distance_threshold=20.0)
    jp, jok, jerr = jtri(jnp.asarray(R_w_cam), jnp.asarray(t_w_cam), jnp.asarray(obs), jnp.asarray(mask), **kw)
    tp, tok, terr = ttri(T(R_w_cam), T(t_w_cam), T(obs), T(mask), **kw)
    np.testing.assert_array_equal(N(tok), np.asarray(jok))
    m = N(tok)
    assert m.sum() > 30
    # Closed-form normal equations + 2 Gauss-Newton steps in float32:
    # millimetre agreement on points 3-9 m away.
    np.testing.assert_allclose(N(tp)[m], np.asarray(jp)[m], atol=2e-3)
    np.testing.assert_allclose(N(terr)[m], np.asarray(jerr)[m], atol=1e-2)


# ---------------------------------------------------------------------------
# Import hygiene: the port and chip_smoke.py need nothing the card's
# machine lacks, and never import the JAX package.
# ---------------------------------------------------------------------------


def test_port_imports_no_jax_flax_yaml_cv2():
    code = r"""
import importlib, importlib.util, pkgutil, sys
for m in ("jax", "flax", "yaml", "cv2", "matplotlib"):
    sys.modules[m] = None
import kimera_vio_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kimera_vio_tpu_torch.__path__, "kimera_vio_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m == "kimera_vio_tpu" or m.startswith("kimera_vio_tpu.")]
assert not bad, bad
new = {"__main__", "config.flags", "config.params", "dataprovider.png", "dataprovider.euroc",
       "native", "utils.prefetch", "pipeline.stereo_pipeline", "dataprovider.kitti",
       "dataprovider.live", "utils.debug_images", "utils.raster", "visualizer.visualizer",
       "playground", "parallel", "parallel.fleet"}
missing = {n for n in new if "kimera_vio_tpu_torch." + n not in names}
assert not missing, missing
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.strip().splitlines()[-1]) >= 26


def test_port_public_names_import_without_jax():
    """The names the port mirrors from the JAX package's public API
    (geometry, types, camera, triangulation, logger) import with jax and
    flax blocked, and none of them pulls in the JAX package."""
    code = r"""
import importlib, sys
for m in ("jax", "flax", "yaml", "cv2", "matplotlib"):
    sys.modules[m] = None
names = {
    "common.geometry": ["vee", "se3_compose", "se3_inverse", "se3_transform", "se3_retract",
                        "rotation_between", "normalize_rotation"],
    "common.types": ["ImuBias.as_vector", "NavState.identity", "VioNavState.identity",
                     "ImuBlock.capacity", "TrackedFeatures.capacity"],
    "frontend.camera": ["PinholeCamera.K", "StereoCamera.project_rect", "SeparableRemap"],
    "ops.triangulation": ["triangulate_rays"],
    "utils.logger": ["MesherLogger.close"],
}
n = 0
for mod, attrs in names.items():
    m = importlib.import_module("kimera_vio_tpu_torch." + mod)
    for a in attrs:
        obj = m
        for part in a.split("."):
            obj = getattr(obj, part)
        n += 1
bad = [m for m in sys.modules if m == "kimera_vio_tpu" or m.startswith("kimera_vio_tpu.")]
assert not bad, bad
print(n)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.strip().splitlines()[-1]) == 17
