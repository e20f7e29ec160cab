"""Loop closure through the port's pipeline against the JAX pipeline, on
the CPU.

The orbit: the 6-DoF synthetic provider in orbit mode (a 2 s period, 72
frames at 20 fps, 16 keyframes, seven loops) at 320x240 (fx 300, the
textured plane 3 m away), pixel and IMU noise as
tests/test_pipeline_e2e.py:352-368, a 5-state window with 64 features,
and LcdParams cut for a short run (128 LCD features, a 5-keyframe recent
window, one temporal match). The smallest orbit of this kind that closes
a loop has 44 frames (one loop); 72 frames give seven, across both laps.

Like with like: the JAX `run()` tracks with its gather LK
(`KIMERA_LK_IMPL=gather`, as tests/test_torch_pipeline.py explains), and
the parity runs of the port track with the same rule: the port's tracker
with the gather tracker's level plan (`klt_track_lk(search_rows=None)`,
no search window on any level). They check the port's sequential `run()`
and `run_chunked(collect_aux=True)`: the same keyframe stamps, the same
loop pairs, loop poses within 1e-4, PGO positions within 1e-4 m. Each
side draws its own RANSAC samples; the loop poses converge through the
Huber refinement regardless (they agree to ~3e-7).

The port's Pallas window rule (fp32, `KIMERA_LK_IMPL=pallas`) is run too. On
frame 1 of this orbit the two JAX trackers differ by up to 16 px on 38 of
57 tracks, and most keyframes report few matches, so the estimate hangs
on which tracks survive: with the window rule the port's keyframe
positions part from the JAX gather run's from keyframe 7 on, by up to
8.6 mm at the end (from the JAX package's own Pallas tracker, with its
bf16 windows, by up to 8.3 mm), while the port with the gather rule stays
within 1.3e-5 m. That run is held to the same stamps and loop pairs and
to the JAX ATE(PGO) gate.

Also: `run_chunked` without `collect_aux` leaves the LCD out. (The fused
LCD front half of one keyframe against the JAX frontend's, LcdModule's
training path and the refusals are in tests/test_torch_loopclosure.py.)
"""

import functools
import warnings

import numpy as np
import pytest
import torch

from kimera_vio_tpu.dataprovider import synthetic as jsyn
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.dataprovider import synthetic as tsyn
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.ops.lk_kernel import klt_track_lk
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.utils.logger import compute_ate

W, H, FX, N_FRAMES, PERIOD_S = 320, 240, 300.0, 72, 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def orbit(mod, n_frames=N_FRAMES):
    """(params, provider) of the orbit from `mod`, either package's
    dataprovider.synthetic."""
    w = 2 * np.pi / PERIOD_S
    noise = mod._NoiseModel(imu_rate=200.0, pixel_noise_std=0.3, acc_noise_density=2.0e-3,
                            gyro_noise_density=1.6968e-4, seed=3)
    params = mod.synthetic_params(width=W, height=H, fx=FX, nr_states=5, max_features=64,
                                  max_landmarks=96)
    params.lcd.nfeatures = 128
    params.lcd.recent_frames_window = 5
    params.lcd.min_temporal_matches = 1
    prov = mod.SyntheticPlanar6DofProvider(
        n_frames=n_frames, width=W, height=H, fx=FX, plane_z=3.0, noise=noise,
        trans_amp=(0.8, 0.4, 0.2), rot_amp=(0.05, 0.06, 0.08), trans_freq=(w, w, w),
        rot_freq=(w, w, w))
    return params, prov


@pytest.fixture
def gather_lk(monkeypatch):
    """The port's frontend tracks with the gather tracker's level plan,
    the rule of the JAX run (KIMERA_LK_IMPL chooses it for the port's
    pipelines built in the test, as for the JAX run's)."""
    monkeypatch.setenv("KIMERA_LK_IMPL", "gather")
    monkeypatch.setattr(vision_frontend, "klt_track_lk",
                        functools.partial(klt_track_lk, search_rows=None))


@pytest.fixture(scope="module")
def jax_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KIMERA_LK_IMPL", "gather")
        params, prov = orbit(jsyn)
        pipe = JPipeline(params, parallel_run=False, enable_lcd=True)
        out = pipe.run(prov)
    return out, pipe.lcd_result


def _pairs(result):
    return [(l.query_id, l.match_id) for l in result["loops"]]


def _check_against_jax(out, result, jax_run, prov, poses=True):
    jout, jres = jax_run
    assert out.stamps_ns == jout.stamps_ns
    assert result is not None and len(result["loops"]) >= 3
    assert _pairs(result) == _pairs(jres)
    assert result["stamps"] == jres["stamps"] == out.stamps_ns[1:]
    if poses:
        np.testing.assert_allclose(np.stack(out.positions), np.stack(jout.positions), atol=1e-4)
        np.testing.assert_allclose(result["pos"], np.asarray(jres["pos"]), atol=1e-4)
        for a, b in zip(jres["loops"], result["loops"]):
            np.testing.assert_allclose(b.t_match_query, a.t_match_query, atol=1e-4)
            np.testing.assert_allclose(b.R_match_query, a.R_match_query, atol=1e-4)
    # The JAX pipeline's LCD gate (tests/test_pipeline_e2e.py:391).
    gt = prov.ground_truth
    ate_vio = compute_ate(np.array(out.stamps_ns), np.stack(out.positions), gt.stamps_ns,
                          gt.positions, align=False)["rmse"]
    ate_pgo = compute_ate(np.array(result["stamps"]), result["pos"], gt.stamps_ns, gt.positions,
                          align=False)["rmse"]
    assert ate_pgo <= 1.25 * ate_vio + 1e-4, (ate_pgo, ate_vio)


def test_run_matches_jax(jax_run, gather_lk, tmp_path):
    params, prov = orbit(tsyn)
    pipe = StereoImuPipeline(params, output_path=str(tmp_path), parallel_run=False,
                             enable_lcd=True, device="cpu")
    out = pipe.run(prov)
    _check_against_jax(out, pipe.lcd_result, jax_run, prov)
    traj = (tmp_path / "traj_pgo.csv").read_text().splitlines()
    assert traj[0] == "#timestamp,x,y,z,qw,qx,qy,qz"
    assert len(traj) == out.n_keyframes  # every keyframe after the bootstrap
    rows = np.loadtxt(tmp_path / "traj_pgo.csv", delimiter=",", comments="#", ndmin=2)
    np.testing.assert_allclose(rows[:, 1:4], pipe.lcd_result["pos"], atol=1e-6)
    loops = (tmp_path / "output_lcd_result.csv").read_text().splitlines()
    assert loops[0] == "#query_kf,match_kf,isLoop"
    assert loops[1:] == [f"{q},{m},1" for q, m in _pairs(pipe.lcd_result)]
    assert pipe.stats.get("lcd pgo [ms]").count == 1


def test_run_chunked_collect_aux_matches_jax(jax_run, gather_lk):
    params, prov = orbit(tsyn)
    pipe = StereoImuPipeline(params, enable_lcd=True, device="cpu")
    out = pipe.run_chunked(prov, chunk_size=8, collect_aux=True)
    _check_against_jax(out, pipe.lcd_result, jax_run, prov)


def test_run_with_the_window_rule_closes_the_same_loops(jax_run, monkeypatch):
    """The port's Pallas window rule (KIMERA_LK_IMPL=pallas): the same
    stamps and loop pairs as the JAX gather run and the JAX ATE(PGO) gate
    (positions part by mm here; see the module docstring)."""
    monkeypatch.setenv("KIMERA_LK_IMPL", "pallas")
    params, prov = orbit(tsyn)
    pipe = StereoImuPipeline(params, parallel_run=False, enable_lcd=True, device="cpu")
    out = pipe.run(prov)
    _check_against_jax(out, pipe.lcd_result, jax_run, prov, poses=False)


def test_run_chunked_without_collect_aux_skips_the_lcd(monkeypatch):
    """As in the JAX package: loop closure on, collect_aux off -> a
    warning, the trajectory, no LCD result, and no LCD features
    extracted in the keyframe branch (the JAX run's minimal chunks)."""
    params, prov = orbit(tsyn, n_frames=10)
    pipe = StereoImuPipeline(params, enable_lcd=True, device="cpu")
    extracted = []
    orig = pipe.frontend._lcd_extract
    monkeypatch.setattr(pipe.frontend, "_lcd_extract",
                        lambda *a: extracted.append(1) or orig(*a))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = pipe.run_chunked(prov, chunk_size=4)
    assert any("collect_aux" in str(w.message) for w in caught)
    assert out.n_frames == 10 and out.n_keyframes >= 2 and pipe.lcd_result is None
    assert not extracted
