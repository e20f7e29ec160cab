"""The generator: periodic, its IMU consistent with its poses, its images
consistent with the reference's geometry; and the reference's own
arithmetic."""

import numpy as np
import pytest
import torch

import harness
import reference
import scene as scene_mod
import tiny

SPEC = harness.load_spec(tiny.ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]


def _scene(cell, seed=7, size=True):
    cfg = harness.config_of(SPEC, harness.cell_entry(SPEC, cell), tiny.ROOT)
    if size:
        cfg["camera"].update(tiny.TINY_CAMERA)
    wl = harness.workload_of(cell)
    return scene_mod.Scene(scene_mod.Rig.from_config(cfg), wl["motion"], seed,
                           torch.device("cpu"))


@pytest.mark.parametrize("cell", CELLS)
def test_trajectory_and_imu_are_periodic(cell):
    scn = _scene(cell)
    T = scn.traj.period_s
    t = np.linspace(0.0, T, 37)
    for f in (scn.traj.pos, scn.traj.vel, scn.traj.rot):
        np.testing.assert_allclose(f(t).numpy(), f(t + T).numpy(), atol=1e-9)
    acc, gyr = scn.imu_period()
    n = len(acc)
    a2, g2 = scn.traj.imu(np.arange(n) / scn.rig.imu_rate + T)
    np.testing.assert_allclose(acc, a2, atol=2e-4)
    np.testing.assert_allclose(gyr, g2, atol=2e-5)


@pytest.mark.parametrize("cell", CELLS)
def test_imu_integrates_to_the_poses(cell):
    """Integrating the gyro and accelerometer samples of one period (the
    midpoint rule) follows the trajectory's attitude and position."""
    scn = _scene(cell)
    acc, gyr = scn.imu_period()
    dt = 1.0 / scn.rig.imu_rate
    R = scn.traj.rot(0.0).numpy()
    p, v = scn.traj.pos(0.0).numpy(), scn.traj.vel(0.0).numpy()
    acc_m, gyr_m = scn.traj.imu(np.arange(len(acc)) * dt + dt / 2)
    for j in range(int(round(1.0 / dt))):  # the first second
        w = gyr_m[j] * dt
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        dR = np.eye(3) + (np.sin(th) / th if th else 1.0) * K + \
            ((1 - np.cos(th)) / th**2 if th else 0.5) * K @ K
        R_mid = R @ (np.eye(3) + 0.5 * K)
        a_w = R_mid @ acc_m[j] + scene_mod.GRAVITY
        p = p + v * dt + 0.5 * a_w * dt**2
        v = v + a_w * dt
        R = R @ dR
    t = 1.0
    assert np.abs(R - scn.traj.rot(t).numpy()).max() < 1e-4
    assert np.linalg.norm(p - scn.traj.pos(t).numpy()) < 2e-3
    assert np.linalg.norm(v - scn.traj.vel(t).numpy()) < 2e-3
    # the samples of a frame's IMU block: the previous frame's stamp to its own
    a, g, dts, mask = scn.imu_block_arrays(3, acc, gyr, 16)
    r = scn.imu_per_frame
    assert mask.sum() == r and np.allclose(dts[:r], dt) and not dts[r:].any()
    np.testing.assert_array_equal(a[:r], acc[2 * r + 1:3 * r + 1])


def test_images_agree_with_the_reference_geometry():
    """A textured patch moves where the reference says it moves: between
    two frames of the flight (LK truth), and from the left to the right
    image (stereo truth)."""
    scn = _scene("euroc_stereo.fleet8", size=False)
    rig = scn.rig
    ka, kb = 10, 11
    a = scn.render(np.array([ka, kb]), right=False)
    right = scn.render(np.array([ka]), right=True)[0]
    sa, sb = scn.state(scn.frame_time(ka)), scn.state(scn.frame_time(kb))
    uv = np.array([[200.0, 150.0], [400.0, 300.0], [600.0, 200.0]])
    want, inside = reference.lk_truth(uv, sa, sb, rig, scn.plane_z)
    assert bool(inside.all())
    uR = reference.stereo_truth(uv[:, 0], uv[:, 1], sa, rig, scn.plane_z)

    def patch(img, u, v, r=6):
        ys = torch.arange(-r, r + 1, dtype=torch.float64) + v
        xs = torch.arange(-r, r + 1, dtype=torch.float64) + u
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grid = torch.stack([gx / (img.shape[1] - 1) * 2 - 1, gy / (img.shape[0] - 1) * 2 - 1], -1)
        return torch.nn.functional.grid_sample(img[None, None].double(), grid[None],
                                               align_corners=True)[0, 0]

    def best(img, p0, u, v):
        """The offset (du, dv) within 1.5 px, in 0.1 px steps, where img's
        patch matches p0 best."""
        offs = np.arange(-1.5, 1.51, 0.1)
        err = [[float(((patch(img, u + du, v + dv) - p0) ** 2).mean()) for du in offs]
               for dv in offs]
        j, i = np.unravel_index(int(np.argmin(err)), (len(offs), len(offs)))
        return offs[i], offs[j]

    for i in range(3):
        p0 = patch(a[0], *uv[i])
        assert np.hypot(*best(a[1], p0, *want[i].tolist())) <= 0.15
        assert np.hypot(*best(right, p0, float(uR[i]), uv[i][1])) <= 0.15


def test_seed_changes_texture_and_phase_not_the_trajectory():
    s1, s2 = _scene("euroc_stereo.fleet8", 1), _scene("euroc_stereo.fleet8", 2)
    assert not torch.equal(s1.texture, s2.texture)
    assert torch.equal(s1.texture, _scene("euroc_stereo.fleet8", 1).texture)
    t = np.linspace(0, 10, 11)
    np.testing.assert_array_equal(s1.traj.pos(t).numpy(), s2.traj.pos(t).numpy())


def test_relative_pose_and_rotation_angle():
    Ra, pa = scene_mod.Trajectory(harness.workload_of("euroc_stereo.fleet8")["motion"]).rot(1.0), \
        torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)
    dR, dp = reference.relative(Ra, pa, Ra, pa + Ra[:, 0])
    assert reference.rot_angle(dR) < 1e-12
    np.testing.assert_allclose(dp.numpy(), [1.0, 0.0, 0.0], atol=1e-12)
    c, s = np.cos(1e-6), np.sin(1e-6)
    assert abs(reference.rot_angle(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])) - 1e-6) < 1e-15
