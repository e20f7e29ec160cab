"""`correct` comes out false when the timed path is broken underneath: a
run of the small copy on the CPU (the harness's look for a card skipped,
the program's LK counters counted on the plain trackers), once sound and
once for each fault a cell can have. These cells run on one chip, so
there is no exchange between chips to leave out."""

import pytest
import torch

import tiny

FLEET = "euroc_stereo.fleet8"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"), streams=4)


@pytest.fixture(autouse=True)
def counted(monkeypatch):
    tiny.count_cpu_launches(monkeypatch)


def stale_keyframes(pipe, fleet):
    """The keyframe step returns its state unchanged: the window and
    landmarks as they came in, the newest state as the keyframe's."""
    orig = pipe._keyframe_half

    def keyframe_half(fe_state, win, lmk, fe_out, stamp_s, ext_odom=None):
        fe_state, _, _, fe_out, bout = orig(fe_state, win, lmk, fe_out, stamp_s, ext_odom)
        n = max(int(win.n) - 1, 0)
        bout = dict(bout, rot=win.rot[n], pos=win.pos[n], vel=win.vel[n], bias=win.bias[n])
        return fe_state, win, lmk, fe_out, bout

    pipe._keyframe_half = keyframe_half


def stale_tracks(pipe, fleet):
    """The tracker returns its state unchanged: every keypoint where the
    prediction put it, untracked."""
    from kimera_vio_tpu_torch.frontend import vision_frontend as vf

    orig = vf.klt_track_cached_lk

    def track(templates, cur_pyr, init_pts, valid, **kw):
        _, ok = orig(templates, cur_pyr, init_pts, valid, **kw)
        return init_pts.clone(), ok

    pytest.MonkeyPatch().setattr(vf, "klt_track_cached_lk", track)


def shifted_tracks(pipe, fleet):
    """An answer altered where it is produced: every tracked keypoint two
    pixels to the right of where the tracker put it."""
    from kimera_vio_tpu_torch.frontend import vision_frontend as vf

    orig = vf.klt_track_cached_lk

    def track(*a, **kw):
        pts, ok = orig(*a, **kw)
        return pts + torch.tensor([2.0, 0.0]), ok

    pytest.MonkeyPatch().setattr(vf, "klt_track_cached_lk", track)


def half_the_streams(pipe, fleet):
    """Half of the batch left out: the fleet's batched tracker tracks the
    first half of its streams; the rest keep their predictions."""
    from kimera_vio_tpu_torch.frontend import vision_frontend as vf

    orig = vf.klt_track_cached_lk

    def track(templates, cur_pyr, init_pts, valid, **kw):
        pts, ok = orig(templates, cur_pyr, init_pts, valid, **kw)
        half = pts.shape[0] // 2
        return torch.cat([pts[:half], init_pts[half:]]), ok

    pytest.MonkeyPatch().setattr(vf, "klt_track_cached_lk", track)


def recovering_solves(pipe, fleet):
    """Every keyframe's solve reports the smoother's recovery path (as a
    system that has lost positive definiteness does)."""
    orig = pipe._keyframe_half

    def keyframe_half(*a, **kw):
        *rest, bout = orig(*a, **kw)
        return (*rest, dict(bout, n_recovered=1))

    pipe._keyframe_half = keyframe_half


@pytest.fixture
def restore_frontend():
    from kimera_vio_tpu_torch.frontend import vision_frontend as vf

    saved = vf.klt_track_cached_lk
    yield
    vf.klt_track_cached_lk = saved


@pytest.mark.parametrize("cell", [FLEET])
def test_sound_runs_are_correct(root, cell):
    result, nums = tiny.run(root, cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell, fault, fails", [
    (FLEET, stale_keyframes, "lmk_px"),
    (FLEET, stale_tracks, "lk_px"),
    (FLEET, shifted_tracks, "lk_px"),
    (FLEET, half_the_streams, "lk_px"),
    (FLEET, recovering_solves, "recoveries"),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_path_is_not_correct(root, restore_frontend, cell, fault, fails):
    result, nums = tiny.run(root, cell, faults=fault)
    assert not result["correct"]
    c = result["checks"][fails]
    assert c["value"] is None or c["value"] > c["limit"], result["checks"]
