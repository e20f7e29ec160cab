"""The port's stereo-inertial `run()` against the JAX pipeline, end to end.

Same synthetic sequence (320x240, 12 frames, exact ground truth) through
the JAX `StereoImuPipeline.run()` and the port's on the CPU. The JAX side
tracks with its gather LK (`KIMERA_LK_IMPL=gather`), the tracker with the
same contract as `klt_track_pallas` that runs on the CPU at this speed;
the port tracks with its LK level function under the Pallas window rule
(`KIMERA_LK_IMPL=pallas` when its pipeline is built: the variable chooses
the tracker of both packages' stereo pipelines).

Tolerance: the same keyframe stamps, positions within 1e-3 m, rotations
within 1e-3 rad. Not tighter because (1) the window rule makes the port
drop a few tracks near the image border that the gather tracker keeps,
which changes the landmark set a little, and (2) float32 sums run in
another order throughout (pyramids, LK windows, the normal equations).
"""

import os

import numpy as np
import pytest
import torch

from kimera_vio_tpu.dataprovider.synthetic import SyntheticStereoProvider as JProvider
from kimera_vio_tpu.dataprovider.synthetic import synthetic_params as j_synthetic_params
from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline as JPipeline
from kimera_vio_tpu_torch.backend import smoother as sm
from kimera_vio_tpu_torch.common.geometry import quat_to_rot, so3_log
from kimera_vio_tpu_torch.common.types import ImuBias, TrackedFeatures
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.frontend import imu_frontend as imu
from kimera_vio_tpu_torch.frontend.camera import PinholeCamera, StereoCamera
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.playground import visualize_gt_data
from kimera_vio_tpu_torch.utils.logger import compute_ate

SIZE = dict(width=320, height=240)
CAP = dict(max_features=64, max_landmarks=96, nr_states=5)
N_FRAMES = 12


def test_run_matches_jax_pipeline(monkeypatch, tmp_path):
    monkeypatch.setenv("KIMERA_LK_IMPL", "gather")
    jout = JPipeline(j_synthetic_params(**SIZE, **CAP), parallel_run=False).run(
        JProvider(n_frames=N_FRAMES, **SIZE)
    )
    provider = SyntheticStereoProvider(n_frames=N_FRAMES, **SIZE)
    monkeypatch.setenv("KIMERA_LK_IMPL", "pallas")
    pipe = StereoImuPipeline(synthetic_params(**SIZE, **CAP), output_path=str(tmp_path), device="cpu")
    assert pipe.frontend_cfg.lk_impl == "pallas"
    tout = pipe.run(provider)

    assert tout.n_frames == jout.n_frames == N_FRAMES
    assert tout.stamps_ns == jout.stamps_ns
    assert tout.n_keyframes == len(tout.stamps_ns) >= 3
    np.testing.assert_allclose(np.stack(tout.positions), np.stack(jout.positions), atol=1e-3)
    Rt = quat_to_rot(torch.as_tensor(np.stack(tout.quats_wxyz)))
    Rj = quat_to_rot(torch.as_tensor(np.stack(jout.quats_wxyz)))
    ang = torch.linalg.norm(so3_log(Rj.transpose(-1, -2) @ Rt), dim=-1)
    assert float(ang.max()) < 1e-3, ang
    # The JAX end-to-end gate (tests/test_pipeline_e2e.py): ATE < 5 cm.
    gt = provider.ground_truth
    ate = compute_ate(np.array(tout.stamps_ns), np.stack(tout.positions),
                      gt.stamps_ns, gt.positions, align=False)
    assert ate["rmse"] < 0.05, ate
    # traj_vio.csv in the reference's 17-column schema, one row a keyframe.
    lines = (tmp_path / "traj_vio.csv").read_text().splitlines()
    assert lines[0] == "#timestamp,x,y,z,qw,qx,qy,qz,vx,vy,vz,bgx,bgy,bgz,bax,bay,baz"
    assert len(lines) == tout.n_keyframes + 1
    assert all(len(row.split(",")) == 17 for row in lines[1:])


def test_pipeline_refuses_cuda_without_a_card():
    """The default device is CUDA; without a card construction raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        StereoImuPipeline(synthetic_params(**SIZE, **CAP))


_PARAMS = synthetic_params(**SIZE, **CAP)
_CONSTRUCTORS = {
    "PinholeCamera.from_params": lambda: PinholeCamera.from_params(_PARAMS.left_cam),
    "StereoCamera.from_params": lambda: StereoCamera.from_params(_PARAMS.left_cam, _PARAMS.right_cam),
    "PimParams.from_params": lambda: imu.PimParams.from_params(_PARAMS.imu),
    "Pim.zero": lambda: imu.Pim.zero(),
    "BackendConfig.from_params": lambda: sm.BackendConfig.from_params(
        _PARAMS.backend, _PARAMS.imu,
        StereoCamera.from_params(_PARAMS.left_cam, _PARAMS.right_cam, device="cpu")),
    "Window.empty": lambda: sm.Window.empty(3),
    "LandmarkTable.empty": lambda: sm.LandmarkTable.empty(8, 3),
    "ImuBias.zero": lambda: ImuBias.zero(),
    "TrackedFeatures.empty": lambda: TrackedFeatures.empty(8),
    "visualize_gt_data": lambda: visualize_gt_data("no_such_dataset"),
}


@pytest.mark.parametrize("name", list(_CONSTRUCTORS))
def test_public_constructors_default_to_the_card(name):
    """Every public constructor defaults to CUDA: without a card it raises
    unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        _CONSTRUCTORS[name]()


def test_pipeline_refuses_unported_options(tmp_path, monkeypatch):
    """Nothing is refused any more (every frontend type, pose source and
    initialization mode builds, as before): with the `visualize` flag, the
    last option the pipeline used to refuse, `run()` feeds each keyframe
    after the bootstrap to the visualizer, and its file display (here
    writing every keyframe, `save_every` 1) writes the landmark cloud as a
    PLY and, from the second keyframe on, the trajectory image under
    <output>/viz."""
    from kimera_vio_tpu_torch.config import flags
    from kimera_vio_tpu_torch.dataprovider.png import decode_png_rgb8
    from kimera_vio_tpu_torch.pipeline import stereo_pipeline
    from kimera_vio_tpu_torch.visualizer.visualizer import FileDisplay

    params = synthetic_params(**SIZE, **CAP)
    params.backend.auto_initialize = 2
    StereoImuPipeline(params, device="cpu")
    monkeypatch.setattr(stereo_pipeline, "make_display",
                        lambda display_type, path: FileDisplay(path, save_every=1))
    flags.set_flag("visualize", True)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the machine's cores
    try:
        pipe = StereoImuPipeline(synthetic_params(**SIZE, **CAP), output_path=str(tmp_path),
                                 device="cpu")
        out = pipe.run(SyntheticStereoProvider(n_frames=N_FRAMES, **SIZE))
    finally:
        flags.set_flag("visualize", False)
        torch.set_num_threads(n_threads)
    assert pipe.enable_visualizer
    n = out.n_keyframes - 1
    assert n >= 2
    files = sorted(os.listdir(tmp_path / "viz"))
    assert [f for f in files if f.startswith("trajectory")] == [
        f"trajectory_{k:06d}.png" for k in range(2, n + 1)]
    assert [f for f in files if f.startswith("pointcloud")] == [
        f"pointcloud_{k:06d}.ply" for k in range(1, n + 1)]
    head = (tmp_path / "viz" / f"pointcloud_{n:06d}.ply").read_text().splitlines()
    n_pts = int(head[2].split()[-1])
    assert n_pts > 0 and len(head) == 7 + n_pts
    assert decode_png_rgb8(str(tmp_path / "viz" / f"trajectory_{n:06d}.png")).shape == (480, 480, 3)
