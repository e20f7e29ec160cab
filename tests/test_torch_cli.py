"""`python -m kimera_vio_tpu_torch` against `python -m kimera_vio_tpu` on
the same EuRoC-format folder and params folder, on the CPU — the stereo
params folder and a mono one (no RightCameraParams.yaml: the mono
pipeline; the JAX CLI's mono route raises before it runs, so there the
port's CLI is held against that route's pipeline run directly); the port's `run()` on that folder against the JAX run the JAX
CLI made; `--visualize` and the one route the port refuses (the mesher
on a mono folder); and the options `run_chunked` refuses, as the JAX one
does.

The JAX side tracks with its gather LK (`KIMERA_LK_IMPL=gather`), as
tests/test_torch_pipeline.py explains, and so does its tolerance: the same
keyframe stamps, positions within 1e-3 m, rotations within 1e-3 rad. The
mono runs, whose only geometry is the 2-pt mono RANSAC, have the port
track with the gather tracker's level plan and draw the JAX package's
hypotheses (tests/test_torch_variants.py::_jax_draws).
"""

import dataclasses
import functools
import importlib.util
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from kimera_vio_tpu import __main__ as jcli
from kimera_vio_tpu.config import flags as jflags
from kimera_vio_tpu.config.params import VioParams as JVioParams
from kimera_vio_tpu.dataprovider.euroc import EurocDataProvider as JEurocDataProvider
from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.pipeline.mono_pipeline import MonoImuPipeline as JMonoPipeline
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch import __main__ as tcli
from kimera_vio_tpu_torch.common.geometry import quat_to_rot, so3_log
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.config.params import VioParams
from kimera_vio_tpu_torch.convert import vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.odometry import OdometryBuffer
from kimera_vio_tpu_torch.dataprovider.euroc import EurocDataProvider
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.ops.lk_kernel import klt_track_lk
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
_spec = importlib.util.spec_from_file_location(
    "torch_variants", os.path.join(REPO, "tests", "test_torch_variants.py"))
_tv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tv)

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


def test_cli_frame_window_ignores_blank_rows(folders, tmp_path, capsys):
    """The same window on a copy of the folder whose cam0/data.csv ends in
    a blank line: still frames [1 + 2, 12 - 3). The JAX CLI counts the
    blank row as a frame (kimera_vio_tpu/__main__.py:125) and would end
    the window one frame later; the port counts only the rows that name an
    image."""
    shutil.copytree(os.path.join(folders["data"], "mav0"), tmp_path / "mav0")
    cam_csv = tmp_path / "mav0" / "cam0" / "data.csv"
    text = cam_csv.read_text()
    cam_csv.write_text(text if text.endswith("\n") else text + "\n")
    with open(cam_csv, "a") as fh:
        fh.write("\n")
    assert tcli.main(["--params_folder", folders["params"], "--dataset_path", str(tmp_path),
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
    ["--enable_mesher"], ["--visualize"], ["--gflag", "visualize=true"],
], ids=lambda e: e[-1])
def test_unported_options_raise(folders, tmp_path, monkeypatch, extra):
    """--enable_mesher on the mono params folder raises (the mono pipeline
    has no mesher; on a stereo folder it runs,
    tests/test_torch_mesher_chunked.py). --visualize and --gflag
    visualize=true, which used to raise, now run the visualizer in the
    default parallel run(): its display (writing every keyframe here,
    `save_every` 1) leaves a point cloud PLY per keyframe after the
    bootstrap and the trajectory images under <output_path>/viz, without
    --log_output."""
    params = folders["mono"] if extra == ["--enable_mesher"] else folders["params"]
    args = ["--params_folder", params, "--dataset_path", folders["data"], "--device", "cpu"]
    if extra == ["--enable_mesher"]:
        with pytest.raises(NotImplementedError):
            tcli.main(args + extra)
        return
    from kimera_vio_tpu_torch.pipeline import stereo_pipeline
    from kimera_vio_tpu_torch.visualizer.visualizer import FileDisplay

    monkeypatch.setattr(stereo_pipeline, "make_display",
                        lambda display_type, path: FileDisplay(path, save_every=1))
    assert tcli.main(args + CAPS + extra + ["--output_path", str(tmp_path)]) == 0
    files = sorted(os.listdir(tmp_path / "viz"))
    plys = [f for f in files if f.startswith("pointcloud")]
    pngs = [f for f in files if f.startswith("trajectory")]
    assert len(plys) >= 2 and plys == [f"pointcloud_{k:06d}.ply" for k in range(1, len(plys) + 1)]
    assert pngs == [f"trajectory_{k:06d}.png" for k in range(2, len(plys) + 1)]
    assert not (tmp_path / "traj_vio.csv").exists()  # no --log_output


@pytest.fixture(scope="module")
def jax_mono_traj(folders):
    """The JAX mono route on the mono params folder (traj_vio.csv). The JAX
    CLI picks MonoImuPipeline for it but passes `enable_mesher`, which that
    class does not take (kimera_vio_tpu/__main__.py:145, a TypeError), so
    the reference is the route's params, provider and pipeline built as
    the CLI builds them, run sequentially."""
    out = str(folders["root"] / "jax_mono_out")
    params = JVioParams.from_folder(folders["mono"])
    params.max_features, params.max_landmarks = 64, 96
    assert params.right_cam is None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KIMERA_LK_IMPL", "gather")
        JMonoPipeline(params, output_path=out, parallel_run=False).run(JEurocDataProvider(
            folders["data"], max_imu_per_frame=params.max_imu_per_frame,
            equalize=params.frontend.equalize_image))
    return _read_traj(os.path.join(out, "traj_vio.csv"))


@pytest.mark.parametrize("mode", ["sequential", "parallel", "chunked"])
def test_mono_cli_matches_jax_cli(folders, jax_mono_traj, tmp_path, mode, capsys, monkeypatch):
    monkeypatch.setattr(vision_frontend, "klt_track_lk",
                        functools.partial(klt_track_lk, search_rows=None))
    monkeypatch.setattr(transac, "_sample_indices", _tv._jax_draws)
    runs = []
    orig = StereoImuPipeline._drive
    monkeypatch.setattr(StereoImuPipeline, "_drive",
                        lambda self, *a, **k: runs.append(type(self).__name__) or orig(self, *a, **k))
    extra = {"sequential": ["--parallel_run", "0"], "parallel": [],
             "chunked": ["--chunked", "--chunk_size", "4"]}[mode]
    assert tcli.main(["--params_folder", folders["mono"], "--dataset_path", folders["data"],
                      "--device", "cpu", "--log_output", "--output_path", str(tmp_path)]
                     + CAPS + extra) == 0
    assert runs == ["MonoImuPipeline"]
    assert f"frames={N_FRAMES} keyframes={len(jax_mono_traj[0])} wall=" in capsys.readouterr().out
    _close(*_read_traj(tmp_path / "traj_vio.csv"), jax_mono_traj)


def test_cli_fine_time_alignment_runs(folders, capsys):
    """--do_fine_imu_camera_temporal_sync: the aligner runs with the 3-pt
    solver; this rotation-free sequence gives it no excitation, so no
    estimate lands and every frame is published (the JAX smoke,
    tests/test_pipeline_wiring.py:164)."""
    made = []
    orig = StereoImuPipeline.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        made.append(self)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StereoImuPipeline, "__init__", init)
        assert tcli.main(["--params_folder", folders["params"], "--dataset_path", folders["data"],
                          "--device", "cpu", "--do_fine_imu_camera_temporal_sync"] + CAPS) == 0
    assert f"frames={N_FRAMES} " in capsys.readouterr().out
    assert not made[0].frontend_cfg.use_1point_stereo
    assert made[0].time_shift_estimate_s is None


def _refused_setup(option):
    jp = j_synthetic_params(**SIZE, max_features=64, max_landmarks=96, nr_states=5)
    if option == "online_init":
        jp.backend.auto_initialize = 2
    tp = vio_params_from_dict(dataclasses.asdict(jp))
    jprov, tprov = JProvider(n_frames=4, **SIZE), SyntheticStereoProvider(n_frames=4, **SIZE)
    if option == "ext_odometry":
        jprov.odometry, tprov.odometry = object(), OdometryBuffer()
    return jp, tp, jprov, tprov


@pytest.mark.parametrize("option", ["fine_time_alignment", "online_init", "ext_odometry"])
def test_run_chunked_refuses_as_jax(option):
    """run_chunked refuses fine time alignment, online initialization and
    external odometry, with the JAX package's messages' subject."""
    jp, tp, jprov, tprov = _refused_setup(option)
    flag = option == "fine_time_alignment"
    jflags.set_flag("do_fine_imu_camera_temporal_sync", flag)
    flags.set_flag("do_fine_imu_camera_temporal_sync", flag)
    words = {"fine_time_alignment": "time alignment", "online_init": "online initialization",
             "ext_odometry": "external odometry"}[option]
    with pytest.raises(NotImplementedError, match=words):
        JPipeline(jp, parallel_run=False).run_chunked(jprov)
    with pytest.raises(NotImplementedError, match=words):
        StereoImuPipeline(tp, device="cpu").run_chunked(tprov)


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
