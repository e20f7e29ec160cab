"""The port's KITTI raw provider against the JAX package's.

  * Twins of tests/test_kitti.py:63 (sub-second timestamps), :74 (packets
    of the random-stereo fixture) and :93 (that fixture through a
    pipeline run from the IMU attitude), and of
    tests/test_misc_modules.py:79 (the miniature layout with 6-decimal
    OXTS stamps). Both providers read the same folders: stamps, paths,
    right-frame pairing and IMU blocks equal exactly; the port's images
    equal `cv2.imread(path, IMREAD_GRAYSCALE)`.
  * Run parity at an odd width: a synthetic KITTI folder at 311x94 (the
    size of a KITTI odometry image's pyramid level 2; 10 Hz frames, 100 Hz
    OXTS rows, fx 180, baseline 0.537 m, 5 m depth) written by
    chip_smoke.write_kitti, with the source's ground truth attached on
    both sides (its stamps moved to the folder's clock), through the JAX
    and the port's `StereoImuPipeline.run()`, JAX and port alike tracking
    with the gather rule and the port drawing the JAX RANSAC hypotheses
    (tests/test_torch_variants.py): the same keyframe stamps, positions
    within 1e-3 m, and the JAX tests' ATE gate, 0.05 m.
"""

import dataclasses
import functools
import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch

from kimera_vio_tpu.dataprovider.euroc import GroundTruth as JGroundTruth
from kimera_vio_tpu.dataprovider.kitti import KittiDataProvider as JKitti
from kimera_vio_tpu.dataprovider.kitti import _parse_timestamps as j_parse
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.convert import vio_params_from_dict
from kimera_vio_tpu_torch.dataprovider.euroc import GroundTruth
from kimera_vio_tpu_torch.dataprovider.kitti import KittiDataProvider, _parse_timestamps
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.ops import ransac as transac
from kimera_vio_tpu_torch.ops.lk_kernel import klt_track_lk
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.utils.logger import compute_ate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke", "chip_smoke.py")
_jkitti_tests = _load("jax_test_kitti", os.path.join("tests", "test_kitti.py"))
_tv = _load("torch_variants", os.path.join("tests", "test_torch_variants.py"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors (the test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_packets(jprov, tprov):
    jpk, tpk = list(jprov.frames()), list(tprov.frames())
    assert len(tpk) == len(jpk) >= 3
    for a, b in zip(jpk, tpk):
        assert {k: a[k] for k in a if k != "imu"} == {k: b[k] for k in b if k != "imu"}
        assert (a["imu"] is None) == (b["imu"] is None)
        if a["imu"] is not None:
            for f in ("acc", "gyr", "dt", "mask"):
                np.testing.assert_array_equal(getattr(b["imu"], f).numpy(),
                                              np.asarray(getattr(a["imu"], f)), err_msg=f)
        for key in ("left_path", "right_path"):
            img = tprov.load_image(b[key])
            assert img.dtype == np.uint8
            np.testing.assert_array_equal(img, cv2.imread(b[key], cv2.IMREAD_GRAYSCALE))
    return tpk


def test_parse_timestamps_subsecond(tmp_path):
    p = tmp_path / "timestamps.txt"
    p.write_text("2011-09-26 13:02:25.964389445\n2011-09-26 13:02:26.064389445\n\n")
    t = _parse_timestamps(str(p))
    assert t.dtype == np.int64
    np.testing.assert_array_equal(t, j_parse(str(p)))
    # 100 ms apart, ns resolution preserved to float64 precision.
    assert abs((t[1] - t[0]) - 100_000_000) < 1000


def test_kitti_provider_packets(tmp_path):
    h, w = _jkitti_tests._write_kitti_fixture(str(tmp_path))
    prov = KittiDataProvider(str(tmp_path))
    packets = _assert_same_packets(JKitti(str(tmp_path)), prov)
    assert len(packets) == 4
    assert packets[0]["imu"] is None
    for p in packets[1:]:
        m = p["imu"].mask.numpy()
        assert m.sum() >= 8  # ~10 samples per 100 ms at 100 Hz
        np.testing.assert_allclose(p["imu"].acc.numpy()[m][:, 2], 9.81, atol=1e-6)
    assert prov.load_image(packets[0]["left_path"]).shape == (h, w)
    assert "right_path" in packets[0]
    assert prov.ground_truth is None and len(prov) == 4


def test_kitti_through_pipeline_step(tmp_path):
    """The random-stereo fixture bootstraps from the IMU attitude (no
    ground truth) and runs fused steps."""
    h, w = _jkitti_tests._write_kitti_fixture(str(tmp_path))
    params = synthetic_params(width=w, height=h, fx=100.0, baseline=0.54, max_features=64,
                              max_landmarks=96, nr_states=4)
    out = StereoImuPipeline(params, parallel_run=False, device="cpu").run(
        KittiDataProvider(str(tmp_path)))
    assert out.n_frames >= 2
    assert out.n_keyframes >= 1
    assert np.isfinite(np.stack(out.positions)).all()


def test_kitti_provider(tmp_path):
    """tests/test_misc_modules.py:79's miniature layout (stamps with 6
    decimals, OXTS starting before the first frame)."""
    rng = np.random.default_rng(0)
    n_frames, n_oxts = 4, 40
    for cam in ["image_00", "image_01"]:
        os.makedirs(tmp_path / cam / "data")
        with open(tmp_path / cam / "timestamps.txt", "w") as f:
            for k in range(n_frames):
                f.write(f"2011-09-26 13:02:{10 + k:02d}.000000000\n")
        for k in range(n_frames):
            cv2.imwrite(str(tmp_path / cam / "data" / f"{k:010d}.png"),
                        rng.integers(0, 255, (128, 256), dtype=np.uint8))
    os.makedirs(tmp_path / "oxts" / "data")
    with open(tmp_path / "oxts" / "timestamps.txt", "w") as f:
        for k in range(n_oxts):
            f.write(f"2011-09-26 13:02:{9.5 + 0.1 * k:09.6f}\n")
    for k in range(n_oxts):
        row = np.zeros(30)
        row[11:14] = [0.1, 0.0, 9.81]
        row[17:20] = [0.0, 0.0, 0.01]
        np.savetxt(tmp_path / "oxts" / "data" / f"{k:010d}.txt", row[None])
    p = KittiDataProvider(str(tmp_path))
    packets = _assert_same_packets(JKitti(str(tmp_path)), p)
    assert packets[1]["imu"] is not None
    assert packets[1]["imu"].mask.numpy().sum() >= 1
    assert p.load_image(packets[0]["left_path"]).shape == (128, 256)


# ---------------------------------------------------------------------------
# Run parity at 311x94
# ---------------------------------------------------------------------------

ODD = dict(width=311, height=94, fx=180.0, baseline=0.537)
N_FRAMES = 12


def _source():
    return SyntheticStereoProvider(n_frames=N_FRAMES, fps=10.0, imu_rate=100.0, vx=1.0, depth=5.0,
                                   **ODD)


def _params():
    p = j_synthetic_params(**ODD, nr_states=5, max_features=64, max_landmarks=96)
    p.frontend.klt_max_level = 2
    p.frontend.templ_cols = 31
    p.frontend.templ_rows = 7
    return p, vio_params_from_dict(dataclasses.asdict(p))


def _attach_gt(prov, src, cls):
    """The source's ground truth on the folder's clock (the parsed stamps
    are the date's midnight plus the time of day written)."""
    gt = src.ground_truth
    offset = int(prov.left_stamps[0]) - int(src.left_stamps[0])
    prov.ground_truth = cls(stamps_ns=gt.stamps_ns + offset, positions=gt.positions,
                            quats_wxyz=gt.quats_wxyz, velocities=gt.velocities,
                            gyro_bias=gt.gyro_bias, accel_bias=gt.accel_bias)
    return offset


@pytest.fixture(scope="module")
def odd_folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti311"))
    src = _source()
    written = chip_smoke.write_kitti(root, src)
    return root, src, written


@pytest.fixture(scope="module")
def jax_odd_run(odd_folder):
    root, src, _ = odd_folder
    jp, _ = _params()
    jprov = JKitti(root)
    _attach_gt(jprov, src, JGroundTruth)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KIMERA_LK_IMPL", "gather")
        return JPipeline(jp, parallel_run=False).run(jprov)


def test_kitti_run_matches_jax_odd_width(odd_folder, jax_odd_run, monkeypatch):
    root, src, written = odd_folder
    monkeypatch.setattr(vision_frontend, "klt_track_lk", functools.partial(klt_track_lk,
                                                                           search_rows=None))
    monkeypatch.setattr(transac, "_sample_indices", _tv._jax_draws)
    _, tp = _params()
    prov = KittiDataProvider(root)
    offset = _attach_gt(prov, src, GroundTruth)
    # The folder holds the source exactly: stamps on its clock, the IMU
    # samples, the images rounded to uint8.
    np.testing.assert_array_equal(prov.left_stamps - offset, src.left_stamps)
    np.testing.assert_array_equal(prov.imu_sync.t - offset, src.imu_sync.t)
    np.testing.assert_array_equal(prov.imu_sync.acc, src.imu_sync.acc)
    for path, img in written[:2]:
        np.testing.assert_array_equal(prov.load_image(path), img)
    assert prov.load_image(written[0][0]).shape == (94, 311)
    out = StereoImuPipeline(tp, parallel_run=False, device="cpu").run(prov)
    jout = jax_odd_run
    assert out.n_frames == jout.n_frames == N_FRAMES
    assert out.stamps_ns == jout.stamps_ns
    assert out.n_keyframes >= 3
    np.testing.assert_allclose(np.stack(out.positions), np.stack(jout.positions), atol=1e-3)
    gt = prov.ground_truth
    ate = compute_ate(np.array(out.stamps_ns), np.stack(out.positions), gt.stamps_ns,
                      gt.positions, align=False)
    assert ate["rmse"] < 0.05, ate
