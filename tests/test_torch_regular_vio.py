"""RegularVIO of the port (backend/regular_vio.py and the pipeline's
`_regular_refine`) against the JAX package, on the CPU.

Module parity, inputs made with numpy from seeds:

  * `point_plane_blocks` and `parallel_plane_blocks` (with and without the
    distance row) on random planes, points and pairs, invalid entries
    included: within 1e-5 (float32 round-off of a few products);
  * the closed-form helpers that replace the JAX package's autodiff and
    `jnp.linalg.inv`: the projection Jacobians shared with the smoother
    (`smoother._projection_blocks`) and the parallel-plane Jacobian
    through the retraction against `torch.func.jacfwd` of the same
    residuals, the 3x3 inverse against `torch.linalg.inv` (relative 1e-4:
    adjugate against LU in float32);
  * `regular_smart_factor_blocks` and `regular_backend_solve` on the plane
    scene of tests/test_regular_vio.py:53 (landmarks on z = 6 under pixel
    noise, a 6-state window filled by the JAX smoother and carried into
    the port with `convert.state_from_numpy` / `planes_from_numpy`), with
    and without a parallel-plane pair: each block of the normal equations
    within 1e-4 of its largest entry (measured up to 3.4e-5, in the
    gradients, where the plain smoother's own blocks already differ from
    the JAX ones by 2.4e-5: float32 sums with cancellation, in another
    order); the solved window and planes within 1e-4;
  * the pipeline's `_regular_refine` on the mesh of
    tests/test_pipeline_wiring.py:207 (landmarks on z = 1), twice: the same
    tracker slots and hits, window and plane states within 1e-4.

The slice's runs against the JAX runs: tests/test_torch_mesher_runs.py
(`run()`) and tests/test_torch_mesher_chunked.py (`run_chunked`).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_smoother as ts
from kimera_vio_tpu.backend import regular_vio as jrv
from kimera_vio_tpu.backend import smoother as jsm
from kimera_vio_tpu.common.types import NavState as JNavState
from kimera_vio_tpu.dataprovider import synthetic as jsyn
from kimera_vio_tpu.mesher.mesher import Mesh3D as JMesh3D
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.backend import regular_vio as trv
from kimera_vio_tpu_torch.backend import smoother as tsm
from kimera_vio_tpu_torch.convert import planes_from_numpy, state_from_numpy
from kimera_vio_tpu_torch.dataprovider import synthetic as tsyn
from kimera_vio_tpu_torch.mesher.mesher import Mesh3D
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from tests.test_torch_backend import to_np



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.as_tensor(np.array(x))


def port_cfg(jcfg) -> tsm.BackendConfig:
    """The port's BackendConfig with the values of a JAX one."""
    ints = {"nr_states", "max_landmarks", "gn_iters", "min_obs_for_triangulation",
            "mono_norm_type", "stereo_norm_type"}
    return tsm.BackendConfig(**{
        f.name: int(getattr(jcfg, f.name)) if f.name in ints else T(getattr(jcfg, f.name))
        for f in dataclasses.fields(tsm.BackendConfig)})


def unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def random_planes(rng, P=4):
    n = unit(rng.normal(size=(P, 3)))
    n[0] = unit(np.array([0.95, 0.1, 0.2]))  # the basis' other helper axis
    return n, rng.uniform(-2, 2, P).astype(np.float32), np.array([True, True, False, True])[:P]


def test_point_plane_blocks_match_jax():
    rng = np.random.default_rng(0)
    n, d, m = random_planes(rng)
    pts = rng.uniform(-3, 3, (32, 3)).astype(np.float32)
    ok = rng.uniform(size=32) > 0.2
    assoc = rng.integers(-1, 4, 32).astype(np.int32)
    jout = jrv.point_plane_blocks(jrv.PlaneStates(normal=jnp.asarray(n), d=jnp.asarray(d),
                                                  mask=jnp.asarray(m)),
                                  jnp.asarray(pts), jnp.asarray(ok), jnp.asarray(assoc),
                                  jnp.float32(0.1))
    tout = trv.point_plane_blocks(trv.PlaneStates(normal=T(n), d=T(d), mask=T(m)), T(pts), T(ok),
                                  T(assoc), T(np.float32(0.1)))
    for a, b, name in zip(tout, jout, ("r", "J_pt", "J_plane", "w")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("with_dist", [False, True])
def test_parallel_plane_blocks_match_jax(with_dist):
    rng = np.random.default_rng(1)
    n, d, m = random_planes(rng)
    n[1] = unit(n[0] + 0.05 * rng.normal(size=3))
    n[3] = unit(-n[0] + 0.05 * rng.normal(size=3))
    pairs = np.array([[0, 1], [0, 3], [1, 2], [3, -1], [1, 3]], np.int32)
    pm = np.array([True, True, True, True, False])
    md = rng.uniform(-1, 1, 5).astype(np.float32) if with_dist else None
    jp = jrv.PlaneStates(normal=jnp.asarray(n), d=jnp.asarray(d), mask=jnp.asarray(m))
    jout = jrv.parallel_plane_blocks(jp, jnp.asarray(pairs), jnp.asarray(pm),
                                     None if md is None else jnp.asarray(md))
    tout = trv.parallel_plane_blocks(trv.PlaneStates(normal=T(n), d=T(d), mask=T(m)), T(pairs),
                                     T(pm), None if md is None else T(md))
    assert np.asarray(jout[3]).tolist() == [1.0, 1.0, 0.0, 0.0, 0.0]
    for a, b, name in zip(tout, jout, ("r", "J1", "J2", "w")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)


def test_parallel_plane_jacobian_matches_jacfwd():
    """The closed-form derivative through n1's retraction against
    `torch.func.jacfwd` of the port's own residual, on both branches of
    the tangent basis and for a normal a little off unit length."""
    rng = np.random.default_rng(2)
    n1s = [unit(rng.normal(size=3)) for _ in range(4)] + [unit(np.array([0.97, 0.2, 0.1]))]
    n1s.append((1.02 * n1s[0]).astype(np.float32))
    for n1 in n1s:
        n1 = T(n1)
        n2 = T(unit(n1.numpy() + 0.1 * rng.normal(size=3)))

        def e1(dl):
            n1p = n1 + trv.plane_tangent_basis(n1) @ dl
            n1p = n1p / torch.clamp(torch.linalg.norm(n1p), min=1e-9)
            return trv.plane_tangent_basis(n1p).T @ n2 / 0.1

        want = torch.func.jacfwd(e1)(torch.zeros(2))
        _, J1, _ = trv.parallel_plane_residual(n1, T(np.float32(0.0)), n2, T(np.float32(0.0)),
                                               sigma_n=0.1)
        np.testing.assert_allclose(J1[:, :2].numpy(), want.numpy(), atol=1e-4)


def test_projection_jacobians_match_jacfwd():
    """The smoother's closed-form reprojection Jacobians (shared by the
    smart factors and RegularVIO) against `torch.func.jacfwd` of the JAX
    package's per-observation residual (regular_vio.py:219-234), with a
    mono observation's uR row zeroed."""
    rng = np.random.default_rng(3)
    jcfg = jsm.BackendConfig(nr_states=3, max_landmarks=5)
    cfg = port_cfg(jcfg)
    cfg.R_b_cam = T(np.asarray(ts.geo.so3_exp(jnp.asarray([0.02, -0.01, 0.03]))))
    cfg.t_b_cam = T(np.array([0.05, -0.02, 0.01], np.float32))
    win = tsm.Window.empty(3, device="cpu")
    win.rot = torch.stack([T(np.asarray(ts.geo.so3_exp(jnp.asarray(rng.normal(0, 0.05, 3),
                                                                   jnp.float32))))
                           for _ in range(3)])
    win.pos = T(rng.normal(0, 0.2, (3, 3)).astype(np.float32))
    pts = T(np.stack([rng.uniform(-1, 1, 5), rng.uniform(-1, 1, 5), rng.uniform(3, 6, 5)],
                     -1).astype(np.float32))
    obs = T(rng.uniform(100, 400, (5, 3, 3)).astype(np.float32))
    obs[1, 2, 1] = float("nan")
    r, F, E, stereo_ok = tsm._projection_blocks(cfg, win, pts, obs)
    assert not bool(stereo_ok[2, 1])

    def residual(dpose, dpoint, Rk, pk, meas, point, mono):
        R = Rk @ tsm.geo.so3_exp(dpose[0:3])
        p = pk + dpose[3:6]
        R_wc = R @ cfg.R_b_cam
        pc = R_wc.T @ (point + dpoint - (p + R @ cfg.t_b_cam))
        pred = torch.stack([cfg.fx * pc[0] / pc[2] + cfg.cx,
                            cfg.fx * (pc[0] - cfg.baseline) / pc[2] + cfg.cx,
                            cfg.fy * pc[1] / pc[2] + cfg.cy])
        res = (pred - torch.where(torch.isfinite(meas), meas, meas[0])) / cfg.smart_noise_sigma
        return res * torch.tensor([1.0, 0.0 if mono else 1.0, 1.0])

    z6, z3 = torch.zeros(6), torch.zeros(3)
    for k in range(3):
        for lm in range(5):
            args = (win.rot[k], win.pos[k], obs[lm, k], pts[lm], lm == 1 and k == 2)
            np.testing.assert_allclose(r[:, k, lm].numpy(), residual(z6, z3, *args).numpy(),
                                       rtol=1e-5, atol=1e-3)
            Fk = torch.func.jacfwd(lambda dp: residual(dp, z3, *args))(z6)
            Ek = torch.func.jacfwd(lambda dq: residual(z6, dq, *args))(z3)
            scale = float(Fk.abs().max())
            np.testing.assert_allclose(F[:, :, k, lm].numpy(), Fk.numpy(), atol=1e-5 * scale)
            np.testing.assert_allclose(E[:, :, k, lm].numpy(), Ek.numpy(), atol=1e-5 * scale)


def test_inv3_matches_linalg_inv():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(64, 3, 5))
    H = np.einsum("lia,lja->lij", A, A) + 1e-6 * np.eye(3)
    H[0] = 1e-6 * np.eye(3)  # an unobserved landmark's block
    H[1] = np.diag([1e4, 3.0, 0.5])
    H = H.astype(np.float32)
    got = tsm._inv3_sym(T(H).permute(1, 2, 0)).permute(2, 0, 1)
    want = torch.linalg.inv(T(H))
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((got - want).abs() / scale).max()) < 1e-4


@pytest.fixture(scope="module")
def plane_scene():
    """tests/test_regular_vio.py:53's scene: the JAX window after 6
    keyframes past landmarks on z = 6 (0.4 px pixel noise), its config,
    two plane slots (z = 6 and a parallel z = 0 slot) and the association."""
    K, L, n_kf, n_lmk = 6, 128, 6, 60
    cfg = jsm.BackendConfig(nr_states=K, max_landmarks=L, gn_iters=2)
    rng = np.random.default_rng(0)
    lmk_w = np.stack([rng.uniform(-3, 7, n_lmk), rng.uniform(-2.5, 2.5, n_lmk),
                      np.full(n_lmk, 6.0)], -1).astype(np.float32)
    vel = np.array([1.0, 0, 0], np.float32)
    win = jsm.bootstrap(cfg, jsm.Window.empty(K),
                        JNavState(rot=jnp.eye(3), pos=jnp.zeros(3), vel=jnp.asarray(vel)),
                        jnp.zeros(6), jnp.float32(0.0))
    lmk = jsm.LandmarkTable.empty(L, K)
    pad = L - n_lmk
    meas_ids = jnp.asarray(np.concatenate([np.arange(n_lmk, dtype=np.int32),
                                           np.full(pad, -1, np.int32)]))
    pim = ts.constant_velocity_pim(vel)
    step = jax.jit(lambda w, l, st, mu, mm: jsm.backend_step(
        cfg, w, l, pim=pim, stamp=st, meas_ids=meas_ids, meas_uvd=mu, meas_mask=mm,
        status=jnp.int32(jsm.STATUS_VALID)))
    for k in range(n_kf):
        uvd, vis = ts.project_stereo(cfg, np.eye(3), vel * k * 0.2, lmk_w)
        uvd = uvd + rng.normal(0, 0.4, uvd.shape).astype(np.float32)
        mu = jnp.asarray(np.concatenate([uvd, np.zeros((pad, 3), np.float32)]))
        mm = jnp.asarray(np.concatenate([vis, np.zeros(pad, bool)]))
        if k == 0:
            lmk = jsm.update_landmarks(lmk, meas_ids, mu, mm, jnp.int32(0))
            continue
        win, lmk, _ = step(win, lmk, jnp.float32(k * 0.2), mu, mm)
    planes = {"normal": np.array([[0.0, 0.0, 1.0], unit(np.array([0.02, -0.01, 1.0]))],
                                 np.float32),
              "d": np.array([6.0, 0.0], np.float32), "mask": np.array([True, True])}
    assoc = np.concatenate([np.zeros(n_lmk, np.int32), np.full(pad, -1, np.int32)])
    assoc[::7] = -1
    return cfg, win, lmk, planes, assoc


def _port_state(plane_scene):
    cfg, win, lmk, planes, assoc = plane_scene
    twin, tlmk, _ = state_from_numpy(to_np(win), to_np(lmk), device="cpu")
    return port_cfg(cfg), twin, tlmk, planes_from_numpy(planes, device="cpu"), T(assoc)


def _jax_planes(planes):
    return jrv.PlaneStates(**{k: jnp.asarray(v) for k, v in planes.items()})


def test_regular_smart_factor_blocks_match_jax(plane_scene):
    cfg, win, lmk, planes, assoc = plane_scene
    jout = jax.jit(functools.partial(jrv.regular_smart_factor_blocks, cfg))(
        win, lmk, _jax_planes(planes), jnp.asarray(assoc), jnp.float32(0.05))
    tcfg, twin, tlmk, tplanes, tassoc = _port_state(plane_scene)
    tout = trv.regular_smart_factor_blocks(tcfg, twin, tlmk, tplanes, tassoc,
                                           T(np.float32(0.05)))
    names = ("H_pose", "g_pose", "H_plane", "g_plane", "H_cross")
    for a, b, name in zip(tout[:5], jout[:5], names):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max(), err_msg=name)
    np.testing.assert_array_equal(tout[6].numpy(), np.asarray(jout[6]))
    np.testing.assert_allclose(tout[5].numpy(), np.asarray(jout[5]), atol=1e-4)


@pytest.mark.parametrize("pairs", [None, [[0, 1], [-1, -1]]], ids=["no_pairs", "parallel_pair"])
def test_regular_backend_solve_matches_jax(plane_scene, pairs):
    cfg, win, lmk, planes, assoc = plane_scene
    kw, tkw = {}, {}
    if pairs is not None:
        p = np.asarray(pairs, np.int32)
        kw = dict(parallel_pairs=jnp.asarray(p), parallel_pair_mask=jnp.asarray(p[:, 0] >= 0))
        tkw = dict(parallel_pairs=T(p), parallel_pair_mask=T(p[:, 0] >= 0))
    jw, jp, (jpts, jok) = jrv.regular_backend_solve(cfg, win, lmk, _jax_planes(planes),
                                                     jnp.asarray(assoc), jnp.float32(0.05),
                                                     gn_iters=2, **kw)
    tcfg, twin, tlmk, tplanes, tassoc = _port_state(plane_scene)
    tw, tp, (tpts, tok) = trv.regular_backend_solve(tcfg, twin, tlmk, tplanes, tassoc,
                                                    T(np.float32(0.05)), gn_iters=2, **tkw)
    for k in ("rot", "pos", "vel", "bias"):
        np.testing.assert_allclose(getattr(tw, k).numpy(), np.asarray(getattr(jw, k)), atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(tp.normal.numpy(), np.asarray(jp.normal), atol=1e-4)
    np.testing.assert_allclose(tp.d.numpy(), np.asarray(jp.d), atol=1e-4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # The refine moved the planes and kept the plane and the trajectory.
    assert abs(float(tp.d[0]) - 6.0) < 0.1 and float(tp.normal[0, 2]) > 0.99
    np.testing.assert_allclose(tw.pos[tw.n - 1].numpy(), [1.0, 0.0, 0.0], atol=0.05)


def _pipelines():
    jp = jsyn.synthetic_params(nr_states=8, max_features=96, max_landmarks=128)
    jp.pipeline.backend_type = 1
    tp = tsyn.synthetic_params(nr_states=8, max_features=96, max_landmarks=128)
    tp.pipeline.backend_type = 1
    jpipe = JPipeline(jp, parallel_run=False, enable_mesher=True)
    tpipe = StereoImuPipeline(tp, parallel_run=False, device="cpu", enable_mesher=True)
    assert jpipe.use_regular_vio and tpipe.use_regular_vio
    tpipe._setup_mesher(True)
    return jpipe, tpipe


def test_regular_refine_matches_jax():
    """The pipeline's refine (segmentation, association, landmark slots,
    the joint solve, the write-back) on tests/test_pipeline_wiring.py:207's
    mesh, twice: the second associates with the first's slot."""
    jpipe, tpipe = _pipelines()
    K, L = 8, 128
    jcfg = jpipe.backend_cfg
    win = jsm.bootstrap(jcfg, jsm.Window.empty(K),
                        JNavState(rot=jnp.eye(3), pos=jnp.zeros(3), vel=jnp.zeros(3)),
                        jnp.zeros(6), jnp.float32(0.0))
    rng = np.random.default_rng(0)
    n = 60
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                    np.full(n, 1.0) + rng.normal(0, 0.002, n)], -1).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    tris_idx = np.stack([ids[:-2], ids[1:-1], ids[2:]], -1)
    lmk = jsm.LandmarkTable.empty(L, K)
    lmk = lmk.replace(ids=lmk.ids.at[:n].set(jnp.asarray(ids)),
                      pts=lmk.pts.at[:n].set(jnp.asarray(pts)),
                      pts_ok=lmk.pts_ok.at[:n].set(True))
    twin, tlmk, _ = state_from_numpy(to_np(win), to_np(lmk), device="cpu")
    jw, tw = win, twin
    for _ in range(2):
        jw2 = jpipe._regular_refine(jw, lmk, JMesh3D(lmk_ids=tris_idx, vertices=pts[tris_idx]), {})
        tw2 = tpipe._regular_refine(tw, tlmk, Mesh3D(lmk_ids=tris_idx, vertices=pts[tris_idx]))
        assert jw2 is not jw and tw2 is not tw
        jw, tw = jw2, tw2
    jt, tt = jpipe._plane_tracker, tpipe._plane_tracker
    np.testing.assert_array_equal(tt.hits, jt.hits)
    np.testing.assert_array_equal(tt.active, jt.active)
    assert tt.hits.max() == 2
    np.testing.assert_allclose(tt.normals, jt.normals, atol=1e-4)
    np.testing.assert_allclose(tt.ds, jt.ds, atol=1e-4)
    for k in ("rot", "pos", "vel", "bias"):
        np.testing.assert_allclose(getattr(tw, k).numpy(), np.asarray(getattr(jw, k)), atol=1e-4,
                                   err_msg=k)
