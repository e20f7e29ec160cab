"""The mesher and RegularVIO through the port's `run_chunked(collect_aux=
True)` and its CLI (`--enable_mesher`), on the CPU.

Like with like against the JAX `run_chunked(collect_aux=True,
chunk_size=8)` on the noise-free near plane of
tests/test_torch_mesher_runs.py (41 frames: five whole chunks, so the
JAX package pads no chunk): both feed each chunk's keyframes to the
mesher and RegularVIO right after the chunk, against the window as it
stands then, which goes on into the next chunk. The same keyframe
stamps, positions within 1e-3 m (measured 6e-7 m), the same tracker hits
and active slots, plane states within 1e-4.

The port's own runs: on the noisy near plane, `run_chunked` against
`run()` holds the JAX gate of tests/test_regular_vio.py:324 (the same
keyframe count, ATE(chunked) <= 1.3 ATE(run) + 1e-3 m); without
RegularVIO the mesher only reads the keyframes, so `run()` and
`run_chunked` write the same PLY bytes although they feed it at other
times; the CLI with `--enable_mesher` on a stereo EuRoC-format folder
whose params say `backend_type: 1` writes one PLY per keyframe after the
bootstrap in each mode and refines through RegularVIO.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from kimera_vio_tpu.dataprovider import synthetic as jsyn
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch import __main__ as tcli
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.dataprovider import synthetic as tsyn
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.ops.lk_kernel import klt_track_lk
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from tests.test_torch_mesher_runs import ate, near_plane
from tests.test_torch_variants import _jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_flags():
    """The CLI sets flags in the process-wide registry; undo that."""
    saved = {k: f.value for k, f in flags._REGISTRY.items()}
    yield
    for k, v in saved.items():
        flags._REGISTRY[k].value = v


def test_run_chunked_matches_jax(monkeypatch):
    monkeypatch.setenv("KIMERA_LK_IMPL", "gather")
    params, prov = near_plane(jsyn, noise=False)
    jpipe = JPipeline(params, parallel_run=True, enable_mesher=True)
    jout = jpipe.run_chunked(prov, chunk_size=8, collect_aux=True)
    monkeypatch.setattr(vision_frontend, "klt_track_lk",
                        functools.partial(klt_track_lk, search_rows=None))
    monkeypatch.setattr(transac, "_sample_indices", _jax_draws)
    params, prov = near_plane(tsyn, noise=False)
    pipe = StereoImuPipeline(params, device="cpu", enable_mesher=True)
    out = pipe.run_chunked(prov, chunk_size=8, collect_aux=True)
    assert out.n_frames == jout.n_frames == 41
    assert out.stamps_ns == jout.stamps_ns and out.n_keyframes >= 8
    np.testing.assert_allclose(np.stack(out.positions), np.stack(jout.positions), atol=1e-3)
    t, j = pipe._plane_tracker, jpipe._plane_tracker
    assert t.hits.max() >= 5
    np.testing.assert_array_equal(t.hits, j.hits)
    np.testing.assert_array_equal(t.active, j.active)
    np.testing.assert_allclose(t.normals, j.normals, atol=1e-4)
    np.testing.assert_allclose(t.ds, j.ds, atol=1e-4)


def test_noisy_run_chunked_holds_the_jax_gate():
    params, prov = near_plane(tsyn, noise=True)
    out_run = StereoImuPipeline(params, parallel_run=False, device="cpu",
                                enable_mesher=True).run(prov)
    pipe = StereoImuPipeline(params, device="cpu", enable_mesher=True)
    out_chunk = pipe.run_chunked(prov, chunk_size=8, collect_aux=True)
    assert out_chunk.n_keyframes == out_run.n_keyframes
    a_run, a_chunk = ate(out_run, prov), ate(out_chunk, prov)
    assert a_chunk <= a_run * 1.3 + 1e-3, (a_chunk, a_run)
    assert pipe._plane_tracker.hits.max() >= 5


def test_mesher_alone_writes_the_same_plys_in_both_modes(tmp_path):
    params, prov = near_plane(tsyn, noise=True, regular=False)
    StereoImuPipeline(params, parallel_run=False, device="cpu", enable_mesher=True,
                      output_path=str(tmp_path / "run")).run(prov)
    StereoImuPipeline(params, device="cpu", enable_mesher=True,
                      output_path=str(tmp_path / "chunked")).run_chunked(
        prov, chunk_size=8, collect_aux=True)
    names = sorted(os.listdir(tmp_path / "run" / "mesh"))
    assert len(names) >= 8 and sorted(os.listdir(tmp_path / "chunked" / "mesh")) == names
    for name in names:
        assert (tmp_path / "chunked" / "mesh" / name).read_bytes() == \
            (tmp_path / "run" / "mesh" / name).read_bytes()


@pytest.fixture(scope="module")
def mesher_folders(tmp_path_factory):
    """The noisy near plane (25 frames) as a EuRoC folder and a params
    folder with backend_type 1."""
    root = tmp_path_factory.mktemp("mesher_cli")
    params, prov = near_plane(tsyn, noise=True)
    prov = tsyn.SyntheticStereoProvider(n_frames=25, vx=0.25, depth=1.8, noise=prov.noise,
                                        width=320, height=240, fx=240.0)
    chip_smoke.write_euroc(str(root), prov)
    chip_smoke.write_params_folder(params, str(root / "params"))
    return {"data": str(root), "params": str(root / "params")}


@pytest.mark.parametrize("extra", [[], ["--parallel_run", "0"], ["--chunked", "--chunk_size", "8"]],
                         ids=["parallel", "sequential", "chunked"])
def test_cli_enable_mesher_writes_one_ply_per_keyframe(mesher_folders, tmp_path, extra, capsys,
                                                       monkeypatch):
    refines = []
    orig = StereoImuPipeline._regular_refine
    monkeypatch.setattr(StereoImuPipeline, "_regular_refine",
                        lambda self, *a: refines.append(1) or orig(self, *a))
    assert tcli.main(["--params_folder", mesher_folders["params"], "--dataset_path",
                      mesher_folders["data"], "--device", "cpu", "--enable_mesher",
                      "--max_features", "96", "--max_landmarks", "128", "--log_output",
                      "--output_path", str(tmp_path)] + extra) == 0
    n_kf = int(capsys.readouterr().out.split("keyframes=")[1].split()[0])
    plys = sorted(os.listdir(tmp_path / "mesh"))
    assert n_kf >= 4 and plys == [f"mesh_{k:05d}.ply" for k in range(n_kf - 1)]
    meshes = [chip_smoke.read_ply(str(tmp_path / "mesh" / name)) for name in plys]
    assert max(len(f) for _, f in meshes) >= 20  # read_ply checks the vertices and faces
    assert len(refines) == n_kf - 1
