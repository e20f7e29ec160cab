"""The port's feature-track overlays (`log_frontend_images`) and PNG writer
against the JAX package and OpenCV.

  * `save_feature_track_overlay` on the same image, keypoints, ids, masks
    and previous-keyframe ids: the port's PNG and the JAX package's (drawn
    and written by OpenCV) decode to the same pixels, tolerance 0. The
    fixtures put points on and just outside every image edge, with ids of
    -1, masked slots and float gray levels outside 0..255.
  * OpenCV's stencils in utils/raster.py: radius-3 circles, 5 px tilted
    crosses and lines (clipped where an end point leaves the image), pixel
    for pixel against `cv2.circle`, `cv2.drawMarker` and `cv2.line`.
  * `encode_png` round trips: 8-bit gray, 16-bit gray and 8-bit RGB, each
    row filter and the cycling rows, against `cv2.imread`, and the port's
    own RGB decoder.
  * The run twin of tests/test_misc_modules.py:138 (160x120, 14 frames)
    in the sequential and parallel `run()` and in
    `run_chunked(collect_aux=True)`: one overlay per keyframe after the
    bootstrap, 120x160x3, with coloured pixels, the same bytes in all
    three modes; and a warning where `run_chunked` would drop them.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from kimera_vio_tpu.utils.debug_images import save_feature_track_overlay as j_overlay
from kimera_vio_tpu_torch.config import flags
from kimera_vio_tpu_torch.dataprovider import png
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.utils import raster
from kimera_vio_tpu_torch.utils.debug_images import feature_track_overlay, save_feature_track_overlay


def _overlay_inputs(seed: int, H: int = 60, W: int = 90, N: int = 120):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-40.0, 300.0, (H, W)).astype(np.float32)
    uv = np.stack([rng.uniform(-3, W + 3, N), rng.uniform(-3, H + 3, N)], -1).astype(np.float32)
    # Points on and just inside every edge, and half-pixel centres.
    uv[:8] = [[0, 0], [W - 0.5, 0], [W - 0.51, H - 0.49], [0, H - 0.5], [1.5, 2.5],
              [W - 1e-3, 7.5], [4.5, H - 1e-3], [2.49, 0.51]]
    ids = rng.integers(-1, 80, N).astype(np.int32)
    mask = rng.uniform(size=N) < 0.7
    prev = rng.choice(80, 30, replace=False)
    return img, uv, ids, mask, prev


@pytest.mark.parametrize("seed,prev_none", [(0, False), (1, False), (2, True)])
def test_overlay_matches_jax(tmp_path, seed, prev_none):
    img, uv, ids, mask, prev = _overlay_inputs(seed)
    prev = None if prev_none else prev
    jpath, tpath = str(tmp_path / "j" / "o.png"), str(tmp_path / "t" / "o.png")
    j_overlay(img, uv, ids, mask, prev, jpath)
    save_feature_track_overlay(img, uv, ids, mask, prev, tpath)
    want = cv2.imread(jpath)  # BGR
    got = cv2.imread(tpath)
    assert want.shape == got.shape == img.shape + (3,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.decode_png_rgb8(tpath), want[..., ::-1])
    np.testing.assert_array_equal(feature_track_overlay(img, uv, ids, mask, prev), want[..., ::-1])
    drawn = (want[..., 0] != want[..., 1]) | (want[..., 1] != want[..., 2])
    assert drawn.sum() > 200


def test_overlay_write_error_raises(tmp_path):
    """Where cv2.imwrite returns False, the port raises."""
    img, uv, ids, mask, prev = _overlay_inputs(0)
    (tmp_path / "file").write_text("")
    with pytest.raises(OSError):
        save_feature_track_overlay(img, uv, ids, mask, prev, str(tmp_path / "file" / "o.png"))


def test_raster_stencils_match_opencv():
    rng = np.random.default_rng(3)
    for _ in range(400):
        H, W = (int(v) for v in rng.integers(4, 24, 2))
        c = tuple(int(v) for v in rng.integers(-4, [W + 4, H + 4]))
        want = np.zeros((H, W, 3), np.uint8)
        got = want.copy()
        cv2.circle(want, c, 3, (0, 200, 0), 1)
        raster.stamp(got, c, raster.CIRCLE_R3, (0, 200, 0))
        cv2.drawMarker(want, c, (0, 0, 220), cv2.MARKER_TILTED_CROSS, 5, 1)
        raster.stamp(got, c, raster.TILTED_CROSS_5, (0, 0, 220))
        p1 = tuple(int(v) for v in rng.integers(-12, [W + 12, H + 12]))
        p2 = tuple(int(v) for v in rng.integers(-12, [W + 12, H + 12]))
        cv2.line(want, p1, p2, (255, 80, 0), 1)
        raster.draw_line(got, p1, p2, (255, 80, 0))
        np.testing.assert_array_equal(got, want, err_msg=f"{W}x{H} c {c} line {p1} {p2}")


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb"])
def test_encode_png_round_trip(tmp_path, kind):
    rng = np.random.default_rng(5)
    shape = {"gray8": (23, 31), "gray16": (23, 31), "rgb": (23, 31, 3)}[kind]
    img = rng.integers(0, 65536 if kind == "gray16" else 256, shape).astype(
        np.uint16 if kind == "gray16" else np.uint8)
    for ft in (None, 0, 1, 2, 3, 4):
        path = str(tmp_path / f"{kind}_{ft}.png")
        png.write_png(path, img, ft)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if kind == "rgb":
            want = want[..., ::-1]
            np.testing.assert_array_equal(png.decode_png_rgb8(path), img)
        else:
            np.testing.assert_array_equal(png.decode_png_gray(path), img)
        assert want.dtype == img.dtype
        np.testing.assert_array_equal(want, img)
    with pytest.raises(TypeError):
        png.encode_png(img.astype(np.float32))


# ---------------------------------------------------------------------------
# log_frontend_images through the run modes (tests/test_misc_modules.py:138)
# ---------------------------------------------------------------------------

SIZE = dict(width=160, height=120, fx=120.0)


def _params():
    p = synthetic_params(**SIZE, max_features=64, max_landmarks=64, nr_states=5)
    p.frontend.klt_max_level = 2
    p.frontend.templ_cols = 31
    p.frontend.templ_rows = 7
    return p


def _run(mode: str, out_dir: str):
    flags.set_flag("log_frontend_images", True)
    try:
        pipe = StereoImuPipeline(_params(), output_path=out_dir, parallel_run=mode == "parallel",
                                 device="cpu")
        prov = SyntheticStereoProvider(n_frames=14, vx=0.5, **SIZE)
        if mode == "chunked":
            return pipe.run_chunked(prov, chunk_size=4, collect_aux=True)
        return pipe.run(prov)
    finally:
        flags.set_flag("log_frontend_images", False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors (the test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequential(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("seq")
    return _run("sequential", str(out_dir)), out_dir


@pytest.mark.parametrize("mode", ["sequential", "parallel", "chunked"])
def test_frontend_debug_imagery(sequential, tmp_path, mode):
    seq_out, seq_dir = sequential
    out, out_dir = (seq_out, seq_dir) if mode == "sequential" else (_run(mode, str(tmp_path)), tmp_path)
    pngs = sorted((out_dir / "frontend_images").glob("*.png"))
    # Every fused-step keyframe gets an overlay (the bootstrap frame has none).
    assert len(pngs) == out.n_keyframes - 1 >= 1
    assert [p.stem for p in pngs] == sorted(str(s) for s in out.stamps_ns[1:])
    vis = cv2.imread(str(pngs[0]))
    assert vis.shape == (120, 160, 3)
    assert (vis[..., 0] != vis[..., 1]).any() or (vis[..., 1] != vis[..., 2]).any()
    # Green (tracked since the previous keyframe) appears from the second
    # overlay on; the first keyframe's ids are all new (blue).
    rgb = [png.decode_png_rgb8(str(p)) for p in pngs]
    assert not (rgb[0] == (0, 200, 0)).all(-1).any() and (rgb[0] == (0, 80, 255)).all(-1).any()
    if len(rgb) > 1:
        assert (rgb[1] == (0, 200, 0)).all(-1).any()
    for p in pngs:  # the same overlays whatever the mode
        assert p.read_bytes() == (seq_dir / "frontend_images" / p.name).read_bytes()


def test_chunked_without_collect_aux_warns(tmp_path):
    flags.set_flag("log_frontend_images", True)
    try:
        pipe = StereoImuPipeline(_params(), output_path=str(tmp_path), device="cpu")
        with pytest.warns(UserWarning, match="log_frontend_images"):
            pipe.run_chunked(SyntheticStereoProvider(n_frames=6, vx=0.5, **SIZE), chunk_size=4)
    finally:
        flags.set_flag("log_frontend_images", False)
    assert not os.path.exists(tmp_path / "frontend_images")
