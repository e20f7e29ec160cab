"""The port's run modes on the CPU, on EuRoC-format folders: the parallel
mode and `run_chunked` against the sequential `run()`, the staged buffer
of `run_chunked`, the float32 time rebase, and the backend-health stop.
(`run()` against the JAX `run()` on the same folder is in
tests/test_torch_cli.py, beside the JAX CLI run it shares.)

Between the port's own modes the comparison is exact: they run the same
frame step on the same frames, IMU blocks and float32 stamps. The rebase
twins keep the JAX tests' 1e-3 m (tests/test_rebase.py): a rebase changes
the float32 stamps' last bits.
"""

import importlib.util
import os
import threading

import cv2
import numpy as np
import pytest
import torch

from kimera_vio_tpu.config import flags as jflags
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.backend import smoother as sm
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.config.params import VioParams
from kimera_vio_tpu_torch.dataprovider.euroc import EurocDataProvider
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SIZE = dict(width=320, height=240)
CAP = dict(max_features=64, max_landmarks=96, nr_states=5)
N_FRAMES = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the test workers
    share the machine's cores, and a thread per core in each worker
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def moving(tmp_path_factory):
    """The test_torch_pipeline sequence (2.25 px a frame) as a EuRoC folder."""
    root = tmp_path_factory.mktemp("moving")
    prov = SyntheticStereoProvider(n_frames=N_FRAMES, vx=0.5, **SIZE)
    chip_smoke.write_euroc(str(root), prov, lambda path, img: cv2.imwrite(path, img))
    chip_smoke.write_params_folder(synthetic_params(**SIZE, **CAP), str(root / "params"))
    return str(root)


def _params(root):
    params = VioParams.from_folder(os.path.join(root, "params"))
    params.max_features, params.max_landmarks = CAP["max_features"], CAP["max_landmarks"]
    return params


def _run(root, mode, provider=None, **kw):
    pipe = StereoImuPipeline(_params(root), parallel_run=(mode == "parallel"), device="cpu")
    provider = provider or EurocDataProvider(root, max_imu_per_frame=32)
    if mode.startswith("chunked"):
        return pipe, pipe.run_chunked(provider, **kw)
    return pipe, pipe.run(provider)


def _same(a, b):
    assert a.n_frames == b.n_frames and a.n_keyframes == b.n_keyframes
    assert a.stamps_ns == b.stamps_ns
    for f in ("positions", "quats_wxyz", "velocities", "biases"):
        np.testing.assert_array_equal(np.stack(getattr(a, f)), np.stack(getattr(b, f)), err_msg=f)


@pytest.fixture(scope="module")
def sequential(moving):
    pipe, out = _run(moving, "sequential")
    assert out.n_frames == N_FRAMES and out.n_keyframes >= 3
    assert "readback [ms]" not in pipe.stats.tags()  # published at each keyframe
    return out


@pytest.mark.parametrize("mode", ["parallel", "chunked_many", "chunked_one"])
def test_modes_give_the_sequential_trajectory(moving, sequential, mode):
    """Parallel run() and run_chunked, in one 4-frame super-batch per copy
    or in a single super-batch, equal the sequential run() exactly."""
    kw = {"chunked_many": dict(chunk_size=4, super_batch_bytes=1),
          "chunked_one": dict(chunk_size=4)}.get(mode, {})
    pipe, out = _run(moving, mode, **kw)
    _same(out, sequential)
    if mode == "parallel":
        assert "VioFrontend Frame Rate [ms]" not in pipe.stats.tags()
        return
    wire = pipe.stats.get("stage wire [MB]")
    assert wire.count == (-(-(N_FRAMES - 1) // 4) if mode == "chunked_many" else 1)
    raw_mb = (min(4, N_FRAMES - 1) * 2 * 240 * 320 + 4 * 32 * 8 * 4) / 1e6  # uint8 frames
    if mode == "chunked_many":
        assert wire.vmax == pytest.approx(raw_mb, rel=1e-6)
    assert pipe.stats.get("readback [ms]").count == 1


def test_stage_packs_frames_and_imu_blocks(moving):
    """One staged super-batch holds the provider's frames and the packets'
    IMU blocks bit for bit: frames, then the (F, B*8) IMU rows at a
    16-byte aligned offset."""
    pipe = StereoImuPipeline(_params(moving), device="cpu")
    provider = EurocDataProvider(moving, max_imu_per_frame=32)
    batch = list(provider.frames())[1:6]
    staged = pipe._stage(provider, batch, None)
    assert staged.parts["aux"][0] % 16 == 0 and staged.aux_shape == (5, 32 * 8)
    frames, aux = pipe._materialize(staged)
    assert frames.dtype == torch.uint8 and frames.shape == (5, 2, 240, 320)
    for i, p in enumerate(batch):
        np.testing.assert_array_equal(frames[i, 0].numpy(), provider.load_image(p["left_path"]))
        np.testing.assert_array_equal(frames[i, 1].numpy(), provider.load_image(p["right_path"]))
        blk = p["imu"]
        want = np.concatenate([blk.acc.numpy().ravel(), blk.gyr.numpy().ravel(),
                               blk.dt.numpy(), blk.mask.numpy().astype(np.float32)])
        np.testing.assert_array_equal(aux[i].numpy(), want)


class _FailingProvider(EurocDataProvider):
    """Decoding the image of frame 6 fails."""

    def load_image(self, path):
        if path == self.frame_paths[6]:
            raise OSError(f"cannot decode {path}")
        return super().load_image(path)


@pytest.mark.parametrize("mode", ["parallel", "chunked"])
def test_decode_error_surfaces_and_threads_end(moving, mode):
    """An image that fails to decode on the prefetch or stager thread
    raises in the caller, and the thread ends."""
    provider = _FailingProvider(moving, max_imu_per_frame=32)
    provider.frame_paths = [p["left_path"] for p in provider.frames()]
    before = set(threading.enumerate())
    with pytest.raises(OSError, match="cannot decode"):
        _run(moving, mode, provider=provider, **({"chunk_size": 2, "super_batch_bytes": 1}
                                                 if mode == "chunked" else {}))
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]


# ---------------------------------------------------------------------------
# Rebase twins (tests/test_rebase.py:47 and :69)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rebase_rig():
    params = synthetic_params(width=160, height=120, fx=120.0, max_features=64,
                              max_landmarks=64, nr_states=5)
    params.frontend.klt_max_level = 2
    params.frontend.templ_cols = 31
    params.frontend.templ_rows = 7
    pipe = StereoImuPipeline(params, parallel_run=False, device="cpu")
    # 5 s: the forced rebase (due from 4.5 s on) fires in both modes.
    prov = SyntheticStereoProvider(n_frames=100, vx=0.5, width=160, height=120, fx=120.0)
    return pipe, prov


def _set_rebase(pipe, interval, margin):
    pipe._rebase_interval_s = interval
    pipe._rebase_margin_s = margin
    pipe._n_rebases = 0


@pytest.mark.parametrize("mode", ["run", "run_chunked"])
def test_rebase_is_output_neutral(rebase_rig, mode):
    pipe, prov = rebase_rig
    go = pipe.run if mode == "run" else (lambda p: pipe.run_chunked(p, chunk_size=8,
                                                                     super_batch_bytes=1))
    _set_rebase(pipe, 256.0, 128.0)
    base = go(prov)
    assert pipe._n_rebases == 0
    _set_rebase(pipe, 2.0, 2.5)  # window span ~1 s < margin
    reb = go(prov)
    assert pipe._n_rebases >= 1
    _set_rebase(pipe, 256.0, 128.0)
    assert reb.n_keyframes == base.n_keyframes and reb.stamps_ns == base.stamps_ns
    np.testing.assert_allclose(np.stack(reb.positions), np.stack(base.positions), atol=1e-3)


# ---------------------------------------------------------------------------
# Backend-health stop
# ---------------------------------------------------------------------------

RECOVERIES = [0, 1, 1, 0, 1, 1, 0, 1, 1, 1, 0, 1]


def test_health_stop_matches_jax(monkeypatch, moving):
    monkeypatch.setenv("KIMERA_MAX_CONSECUTIVE_BACKEND_FAILURES", "3")
    assert jflags.get_flag("max_consecutive_backend_failures") == 3
    assert flags.get_flag("max_consecutive_backend_failures") == 3
    jparams = __import__("kimera_vio_tpu.config.params", fromlist=["VioParams"]).VioParams
    jp = jparams.from_folder(os.path.join(moving, "params"))
    sides = {"jax": JPipeline(jp, parallel_run=False),
             "port": StereoImuPipeline(_params(moving), device="cpu")}
    stops = {}
    for name, pipe in sides.items():
        for k, n in enumerate(RECOVERIES):
            pipe._note_backend_health(n)
            if not pipe.backend_healthy:
                stops[name] = k
                break
    assert stops == {"jax": 9, "port": 9}
    assert sides["port"].stats.get("backend_recoveries [#]").count == 7


@pytest.mark.parametrize("mode", ["sequential", "parallel", "chunked"])
def test_health_stop_ends_the_run(moving, monkeypatch, mode):
    """A backend that needs its recovery path on every keyframe stops the
    run after `max_consecutive_backend_failures` keyframes, and the
    prefetch / stager thread ends."""
    monkeypatch.setenv("KIMERA_MAX_CONSECUTIVE_BACKEND_FAILURES", "2")
    real = sm.backend_step

    def failing(*a, **kw):
        win, lmk, out = real(*a, **kw)
        return win, lmk, {**out, "n_recovered": 1}

    monkeypatch.setattr(sm, "backend_step", failing)
    before = set(threading.enumerate())
    pipe, out = _run(moving, mode, **({"chunk_size": 2, "super_batch_bytes": 1}
                                        if mode == "chunked" else {}))
    assert not pipe.backend_healthy
    assert out.n_keyframes == 1 + 2  # the bootstrap, then two failing solves
    assert out.n_frames < N_FRAMES
    assert pipe.stats.get("backend_recoveries [#]").count == 2
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]
