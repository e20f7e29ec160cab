"""`python -m kimera_vio_tpu_torch` against `python -m kimera_vio_tpu` on
the same EuRoC-format folder and params folder, on the CPU; the port's
`run()` on that folder against the JAX run the JAX CLI made; and the
options the port refuses.

The JAX side tracks with its gather LK (`KIMERA_LK_IMPL=gather`), as
tests/test_torch_pipeline.py explains, and so does its tolerance: the same
keyframe stamps, positions within 1e-3 m, rotations within 1e-3 rad.
"""

import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch

from kimera_vio_tpu import __main__ as jcli
from kimera_vio_tpu.config import flags as jflags
from kimera_vio_tpu_torch import __main__ as tcli
from kimera_vio_tpu_torch.common.geometry import quat_to_rot, so3_log
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
CAPS = ["--max_features", "64", "--max_landmarks", "96"]
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


@pytest.fixture(autouse=True)
def _restore_flags():
    """The CLIs set flags in process-wide registries; undo that."""
    saved = [(reg, {k: f.value for k, f in reg._REGISTRY.items()}) for reg in (flags, jflags)]
    yield
    for reg, values in saved:
        for k, v in values.items():
            reg._REGISTRY[k].value = v


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    params = synthetic_params(**SIZE, max_features=64, max_landmarks=96, nr_states=5)
    params.pipeline.parallel_run = True  # the reference EuRoC default
    prov = SyntheticStereoProvider(n_frames=N_FRAMES, **SIZE)
    chip_smoke.write_euroc(str(root), prov, lambda path, img: cv2.imwrite(path, img))
    chip_smoke.write_params_folder(params, str(root / "params"))
    mono = root / "params_mono"
    chip_smoke.write_params_folder(params, str(mono))
    os.remove(mono / "RightCameraParams.yaml")
    return {"data": str(root), "params": str(root / "params"), "mono": str(mono),
            "gt": prov.ground_truth, "root": root}


def _read_traj(path):
    rows = np.loadtxt(path, delimiter=",", comments="#", ndmin=2)
    return rows[:, 0].astype(np.int64).tolist(), rows[:, 1:4], rows[:, 4:8]


@pytest.fixture(scope="module")
def jax_traj(folders):
    """The JAX CLI's run on the folders (traj_vio.csv)."""
    out = str(folders["root"] / "jax_out")
    saved = {k: f.value for k, f in jflags._REGISTRY.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KIMERA_LK_IMPL", "gather")
        try:
            assert jcli.main(["--params_folder", folders["params"], "--dataset_path",
                              folders["data"], "--log_output", "--output_path", out] + CAPS) == 0
        finally:
            for k, v in saved.items():
                jflags._REGISTRY[k].value = v
    return _read_traj(os.path.join(out, "traj_vio.csv"))


def _close(stamps, pos, quat, ref):
    assert stamps == ref[0]
    assert len(stamps) >= 3
    np.testing.assert_allclose(pos, ref[1], atol=1e-3)
    Rt = quat_to_rot(torch.as_tensor(np.asarray(quat, np.float32)))
    Rj = quat_to_rot(torch.as_tensor(np.asarray(ref[2], np.float32)))
    assert float(torch.linalg.norm(so3_log(Rj.transpose(-1, -2) @ Rt), dim=-1).max()) < 1e-3


@pytest.mark.parametrize("mode", ["run", "chunked"])
def test_cli_matches_jax_cli(folders, jax_traj, tmp_path, mode, capsys):
    args = ["--params_folder", folders["params"], "--dataset_path", folders["data"],
            "--device", "cpu", "--log_output", "--output_path", str(tmp_path)] + CAPS
    assert tcli.main(args + (["--chunked", "--chunk_size", "4"] if mode == "chunked" else [])) == 0
    printed = capsys.readouterr().out
    assert f"frames={N_FRAMES} keyframes={len(jax_traj[0])} wall=" in printed
    assert "Statistics" in printed
    _close(*_read_traj(tmp_path / "traj_vio.csv"), jax_traj)
    for name in ("output_frontend_stats.csv", "output_timingOverall.csv", "output_backendTiming.csv"):
        assert (tmp_path / name).exists()


def test_run_on_euroc_folder_matches_jax_run(folders, jax_traj):
    """The port's sequential run() on the port's provider against the JAX
    run() on the JAX provider (the run the JAX CLI made)."""
    params = VioParams.from_folder(folders["params"])
    params.max_features, params.max_landmarks = 64, 96
    out = StereoImuPipeline(params, parallel_run=False, device="cpu").run(
        EurocDataProvider(folders["data"], max_imu_per_frame=params.max_imu_per_frame))
    assert out.n_frames == N_FRAMES
    _close(out.stamps_ns, np.stack(out.positions), np.stack(out.quats_wxyz), jax_traj)
    gt = folders["gt"]
    err = np.stack(out.positions) - gt.positions[np.searchsorted(gt.stamps_ns, out.stamps_ns)]
    assert np.sqrt((err ** 2).sum(1).mean()) < 0.05


def test_cli_frame_window(folders, capsys):
    """--initial_k with skip_n_start_frames / skip_n_end_frames, as the
    JAX CLI composes them: frames [1 + 2, 12 - 3)."""
    assert tcli.main(["--params_folder", folders["params"], "--dataset_path", folders["data"],
                      "--device", "cpu", "--initial_k", "1", "--gflag", "skip_n_start_frames=2",
                      "--gflag", "skip_n_end_frames=3"] + CAPS) == 0
    assert "frames=6 " in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["--use_lcd"], ["--gflag", "use_lcd=1"], ["--use_lcd", "--chunked", "--chunk_size", "4"],
], ids=["use_lcd", "gflag_use_lcd", "use_lcd_chunked"])
def test_cli_use_lcd_writes_the_pgo_logs(folders, tmp_path, extra):
    """Loop closure through the CLI (the default parallel run(), or
    --chunked, which collects the LCD rows): traj_pgo.csv holds every
    keyframe after the bootstrap, output_lcd_result.csv its header (this
    short straight sequence closes no loop)."""
    assert tcli.main(["--params_folder", folders["params"], "--dataset_path", folders["data"],
                      "--device", "cpu", "--log_output", "--output_path", str(tmp_path)]
                     + CAPS + extra) == 0
    stamps, _, _ = _read_traj(tmp_path / "traj_vio.csv")
    assert len(stamps) >= 3  # LcdModule.finish needs two keyframes after the bootstrap
    pgo_stamps, pgo_pos, _ = _read_traj(tmp_path / "traj_pgo.csv")
    assert pgo_stamps == stamps[1:]
    assert np.isfinite(pgo_pos).all()
    assert (tmp_path / "output_lcd_result.csv").read_text().splitlines()[0] == "#query_kf,match_kf,isLoop"


@pytest.mark.parametrize("extra", [
    ["--enable_mesher"], ["--visualize"], ["--do_fine_imu_camera_temporal_sync"],
    ["--gflag", "visualize=true"], ["mono"],
], ids=lambda e: e[-1])
def test_unported_options_raise(folders, extra):
    params = folders["mono"] if extra == ["mono"] else folders["params"]
    args = ["--params_folder", params, "--dataset_path", folders["data"], "--device", "cpu"]
    with pytest.raises(NotImplementedError):
        tcli.main(args + ([] if extra == ["mono"] else extra))


def test_unknown_gflag_exits(folders):
    with pytest.raises(SystemExit, match="no_such_flag"):
        tcli.main(["--params_folder", folders["params"], "--dataset_path", folders["data"],
                   "--device", "cpu", "--gflag", "no_such_flag=1"])


def test_cli_defaults_to_the_card(folders):
    """Without --device the CLI asks for CUDA and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--params_folder", folders["params"], "--dataset_path", folders["data"]])
