"""The port's readers against the JAX package's, which use PyYAML and
OpenCV (both are test dependencies): the OpenCV-FileStorage YAML subset
(`load_opencv_yaml` vs `_load_opencv_yaml`), `VioParams.from_folder`, the
PNG decoder (C++ and plain) and histogram equalisation vs OpenCV, and
`EurocDataProvider` vs the JAX provider on a written `mav0` folder.

Every comparison is exact: the same dict, the same field values, the same
bytes, the same packets.
"""

import dataclasses
import importlib.util
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from kimera_vio_tpu.config import params as jparams
from kimera_vio_tpu.dataprovider.euroc import EurocDataProvider as JEuroc
from kimera_vio_tpu_torch.config import params as tparams
from kimera_vio_tpu_torch.dataprovider import png
from kimera_vio_tpu_torch.dataprovider.euroc import EurocDataProvider
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# ---------------------------------------------------------------------------
# YAML subset
# ---------------------------------------------------------------------------

REFERENCE_STYLE = """%YAML:1.0
#--------------------------------------------------------------------------
# Sensor extrinsics wrt. the body-frame.
#--------------------------------------------------------------------------
camera_id: left_cam
T_BS: !!opencv-matrix
  rows: 4
  cols: 4
  dt: d
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radtan # radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
2d2d_algorithm: 0
gyroscope_noise_density: 1.6968e-04     # [ rad / s / sqrt(Hz) ]
imu_integration_sigma: 1e-8
accelerometer_random_walk: 3.0000e-3
n_gravity: [0.0, 0.0, -9.81]
useRANSAC: 1
flag_true: true
flag_off: off
nothing:
hash_value: a#b
quoted: "a # not a comment"
single: 'left cam'
empty_list: []
trailing: [1, 2,
  3, ]
signed: -7
plus: +3
neg_float: -0.5
dot_float: .25
exp_no_dot: 1E5
upper_exp: 1.0E-3
inf_value: -.inf
"""


def test_yaml_subset_matches_pyyaml(tmp_path):
    path = tmp_path / "Ref.yaml"
    path.write_text(REFERENCE_STYLE)
    got = tparams.load_opencv_yaml(str(path))
    want = jparams._load_opencv_yaml(str(path))
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    for key in ("T_BS", "intrinsics", "distortion_coefficients", "trailing"):
        assert [type(v) for v in np.ravel(got[key]["data"] if key == "T_BS" else got[key])] == \
            [type(v) for v in np.ravel(want[key]["data"] if key == "T_BS" else want[key])]


@pytest.mark.parametrize("text", [
    "a: 1\n- b\n",  # block sequence
    "a:\n  b:\n    c: 1\n",  # two levels of maps
    "a: &x 1\n",  # anchor
    "a: {b: 1}\n",  # flow map
    "a: [[1, 2], [3]]\n",  # nested flow list
    "a: 0x1F\n",  # hex int
    "a: 012\n",  # octal int
    "a: 1_000\n",  # underscored int
    "a: 2020-01-01\n",  # date
    "a:\tb\n",  # tab
    "a: [1, 2\n",  # unclosed flow list
    "123: x\n",  # integer key
    "a: |\n  text\n",  # block scalar
    "a: 1\n  b: 2\n",  # indented line under a scalar
    "a: b: c\n",  # mapping value in a scalar
], ids=lambda t: repr(t)[:18])
def test_yaml_subset_refuses_the_rest(tmp_path, text):
    path = tmp_path / "Bad.yaml"
    path.write_text("%YAML:1.0\n# header\n" + text)
    with pytest.raises(tparams.YamlSubsetError, match=r"Bad\.yaml:\d+"):
        tparams.load_opencv_yaml(str(path))


def _fields_equal(a, b, where=""):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _fields_equal(x, y, f"{where}{f.name}.")
        elif isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray) and x.dtype == y.dtype, where + f.name
            np.testing.assert_array_equal(x, y, err_msg=where + f.name)
        else:
            assert type(x) is type(y) and x == y, (where + f.name, x, y)


def _tweaked_params():
    """Synthetic params with many fields off their defaults."""
    p = synthetic_params(width=320, height=240)
    p.pipeline.parallel_run = True
    p.imu.n_gravity = np.array([0.0, 0.1, -9.8])
    p.imu.imu_integration_sigma = 1e-8
    p.left_cam.distortion_model = "radial-tangential"
    p.left_cam.distortion_coeffs = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
    p.frontend.klt_max_level = 3
    p.frontend.equalize_image = True
    p.frontend.ransac_threshold_mono = 1e-6
    p.backend.nr_states = 7
    p.backend.initial_roll_pitch_sigma = 0.17
    p.lcd.refine_pose = False
    p.display.hold_2d_display = True
    return p


def test_from_folder_matches_jax(tmp_path):
    params = _tweaked_params()
    chip_smoke.write_params_folder(params, str(tmp_path))
    mine = tparams.VioParams.from_folder(str(tmp_path))
    ref = jparams.VioParams.from_folder(str(tmp_path))
    _fields_equal(mine, ref)
    mine.max_features, mine.max_landmarks = params.max_features, params.max_landmarks
    assert mine.equals(params)
    # Optional files absent: the defaults, as the JAX package gives them.
    for name in ("RightCameraParams.yaml", "LcdParams.yaml", "DisplayParams.yaml"):
        os.remove(tmp_path / name)
    _fields_equal(tparams.VioParams.from_folder(str(tmp_path)),
                  jparams.VioParams.from_folder(str(tmp_path)))


# ---------------------------------------------------------------------------
# PNG and equalisation
# ---------------------------------------------------------------------------


def _images():
    rng = np.random.default_rng(3)
    smooth = cv2.GaussianBlur(rng.uniform(0, 255, (37, 53)).astype(np.float32), (0, 0), 3)
    return {
        "noise": rng.integers(0, 256, (29, 41)).astype(np.uint8),
        "smooth": np.clip(smooth * 3 - 200, 0, 255).astype(np.uint8),
        "ramp": (np.add.outer(np.arange(40), np.arange(60)) * 3 % 256).astype(np.uint8),
        "one_row": rng.integers(0, 256, (1, 17)).astype(np.uint8),
        "one_col": rng.integers(0, 256, (13, 1)).astype(np.uint8),
    }


def _decoders(path):
    H, W, raw = png.read_png_stream(path)
    return {"native": png.decode_png_gray8(path), "plain": png.unfilter_plain(raw, H, W)}


@pytest.mark.parametrize("writer", ["cv2", "filter0", "filter1", "filter2", "filter3", "filter4",
                                    "cycling"])
def test_png_decoder_matches_opencv(tmp_path, writer):
    for name, img in _images().items():
        path = str(tmp_path / f"{name}.png")
        if writer == "cv2":
            assert cv2.imwrite(path, img)
        else:
            ft = None if writer == "cycling" else int(writer[-1])
            with open(path, "wb") as f:
                f.write(png.encode_png(img, ft))
            H, W, raw = png.read_png_stream(path)
            rows = np.frombuffer(raw, np.uint8).reshape(H, W + 1)[:, 0]
            assert (rows == (np.arange(H) % 5 if ft is None else ft)).all()
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(want, img)
        for kind, got in _decoders(path).items():
            assert got.dtype == np.uint8 and got.shape == img.shape, (kind, name)
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} {name}")


def test_png_decoder_refuses_other_pngs(tmp_path):
    rng = np.random.default_rng(0)
    cases = {
        "color.png": rng.integers(0, 256, (8, 9, 3)).astype(np.uint8),
        "gray16.png": rng.integers(0, 65536, (8, 9)).astype(np.uint16),
    }
    for name, img in cases.items():
        assert cv2.imwrite(str(tmp_path / name), img)
        with pytest.raises(png.PngFormatError, match=name):
            png.decode_png_gray8(str(tmp_path / name))
    # Interlaced (Adam7) header, and a row with filter type 5.
    good = png.encode_png(rng.integers(0, 256, (4, 6)).astype(np.uint8), 0)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    interlaced = good[:8] + chunk(b"IHDR", struct.pack(">IIBBBBB", 6, 4, 8, 0, 0, 0, 1)) + good[33:]
    (tmp_path / "adam7.png").write_bytes(interlaced)
    with pytest.raises(png.PngFormatError, match="adam7.png"):
        png.decode_png_gray8(str(tmp_path / "adam7.png"))
    bad_filter = (good[:33] + chunk(b"IDAT", zlib.compress(bytes([5] + [0] * 6) * 4))
                  + chunk(b"IEND", b""))
    (tmp_path / "filter5.png").write_bytes(bad_filter)
    with pytest.raises(png.PngFormatError, match="filter5.png"):
        png.decode_png_gray8(str(tmp_path / "filter5.png"))
    corrupt = bytearray(good)
    corrupt[40] ^= 0xFF
    (tmp_path / "crc.png").write_bytes(bytes(corrupt))
    with pytest.raises(png.PngFormatError, match="crc.png"):
        png.decode_png_gray8(str(tmp_path / "crc.png"))


def _images16():
    rng = np.random.default_rng(4)
    return {
        "noise": rng.integers(0, 65536, (29, 41)).astype(np.uint16),
        "depth_mm": (5000 + rng.integers(-400, 400, (37, 53))).astype(np.uint16),
        "ramp": (np.add.outer(np.arange(40), np.arange(60)) * 1021 % 65536).astype(np.uint16),
        "one_row": rng.integers(0, 65536, (1, 17)).astype(np.uint16),
        "one_col": rng.integers(0, 65536, (13, 1)).astype(np.uint16),
    }


@pytest.mark.parametrize("writer", ["cv2", "filter0", "filter1", "filter2", "filter3", "filter4",
                                    "cycling"])
def test_png16_decoder_matches_opencv(tmp_path, writer):
    """16-bit grayscale PNGs (RGB-D depth streams): `decode_png_gray` and
    the plain unfilter exactly as `cv2.imread(path, IMREAD_UNCHANGED)`,
    the filters working bytewise across the two bytes of a sample."""
    for name, img in _images16().items():
        path = str(tmp_path / f"{name}.png")
        if writer == "cv2":
            assert cv2.imwrite(path, img)
        else:
            ft = None if writer == "cycling" else int(writer[-1])
            with open(path, "wb") as f:
                f.write(png.encode_png(img, ft))
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert want.dtype == np.uint16
        np.testing.assert_array_equal(want, img)
        got = png.decode_png_gray(path)
        assert got.dtype == np.uint16 and got.shape == img.shape
        np.testing.assert_array_equal(got, want, err_msg=name)
        H, W, raw = png.read_png_stream(path, bit_depths=(16,))
        plain = png.unfilter_plain(raw, H, W, bpp=2).view(">u2").astype(np.uint16)
        np.testing.assert_array_equal(plain, want, err_msg=f"plain {name}")
        # 8-bit images through the same entry point.
        img8 = (img >> 8).astype(np.uint8)
        assert cv2.imwrite(path, img8)
        np.testing.assert_array_equal(png.decode_png_gray(path), img8)


def test_png_gray_decoder_refuses_colour(tmp_path):
    path = str(tmp_path / "color16.png")
    assert cv2.imwrite(path, np.zeros((4, 5, 3), np.uint16))
    with pytest.raises(png.PngFormatError, match="color16.png"):
        png.decode_png_gray(path)


@pytest.fixture(scope="module")
def rgbd_tree(tmp_path_factory):
    """tests/test_rgbd_provider.py's on-disk RGB-D tree (160x120, 16
    frames, constant 5 m depth in mm with a 60 m hole), written with this
    repository's own PNG encoder (chip_smoke.write_rgbd)."""
    base = SyntheticStereoProvider(n_frames=16, vx=0.5, width=160, height=120, fx=120.0, depth=5.0)
    root = tmp_path_factory.mktemp("rgbd_ds")
    return str(root), chip_smoke.write_rgbd(str(root), base), base


def test_rgbd_provider_matches_jax(rgbd_tree):
    """The port's RgbdDataProvider against the JAX one (cv2-decoded) on the
    same tree: the same packets and nearest-stamp depth pairing, depth
    images in metres equal to the last bit (raw * depth_factor, range
    gate to 0), cam0 images equal; and the JAX test's decode contract
    (tests/test_rgbd_provider.py:70-84)."""
    from kimera_vio_tpu.dataprovider.rgbd import RgbdDataProvider as JRgbd
    from kimera_vio_tpu_torch.dataprovider.rgbd import RgbdDataProvider

    root, _, base = rgbd_tree
    jprov = JRgbd(root, depth_factor=1e-3, max_depth=20.0)
    tprov = RgbdDataProvider(root, depth_factor=1e-3, max_depth=20.0)
    jp, tp = list(jprov.frames()), list(tprov.frames())
    assert len(tp) == len(jp) >= 14
    for a, b in zip(jp, tp):
        assert (a["stamp_ns"], a["left_path"], a["right_path"]) == (b["stamp_ns"], b["left_path"],
                                                                   b["right_path"])
        assert (a["imu"] is None) == (b["imu"] is None)
    for k in (0, 1, len(tp) - 1):
        dj, dt = jprov.load_image(jp[k]["right_path"]), tprov.load_image(tp[k]["right_path"])
        assert dt.dtype == np.float32
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(tprov.load_image(tp[k]["left_path"]),
                                      jprov.load_image(jp[k]["left_path"]))
    depth = tprov.load_image(tp[1]["right_path"])
    assert abs(float(depth[60, 80]) - base.depth) < 1e-3
    assert float(depth[5, 5]) == 0.0


def test_equalize_hist_matches_opencv():
    rng = np.random.default_rng(5)
    imgs = list(_images().values()) + [
        np.full((10, 12), 77, np.uint8),  # one level
        np.where(rng.uniform(size=(20, 20)) > 0.5, 30, 200).astype(np.uint8),  # two levels
        np.clip(rng.normal(60, 5, (480, 752)), 0, 255).astype(np.uint8),  # EuRoC-sized, dark
        rng.integers(100, 103, (64, 64)).astype(np.uint8),
    ]
    for img in imgs:
        np.testing.assert_array_equal(png.equalize_hist(img), cv2.equalizeHist(img))


# ---------------------------------------------------------------------------
# EurocDataProvider
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def euroc_folder(tmp_path_factory):
    """A written mav0 folder (cv2 PNGs) whose IMU ends at 495 ms, so the
    provider drops the frames from 500 ms on, which it does not cover."""
    root = tmp_path_factory.mktemp("euroc")
    prov = SyntheticStereoProvider(n_frames=14, width=64, height=48, fx=40.0)
    chip_smoke.write_euroc(str(root), prov, lambda path, img: cv2.imwrite(path, img))
    imu_csv = root / "mav0" / "imu0" / "data.csv"
    lines = imu_csv.read_text().splitlines()
    imu_csv.write_text("\n".join(lines[:101]) + "\n")
    return str(root)


@pytest.mark.parametrize("kw", [
    {},
    {"initial_k": 3, "final_k": 11},
    {"do_coarse_imu_camera_temporal_sync": True, "initial_k": 1},
    {"imu_time_shift_ns": 3_000_000, "max_imu_per_frame": 32},
    {"mono": True, "equalize": True},
], ids=["default", "window", "coarse_sync", "time_shift", "mono_equalized"])
def test_euroc_provider_matches_jax(euroc_folder, kw):
    mine, ref = EurocDataProvider(euroc_folder, **kw), JEuroc(euroc_folder, **kw)
    assert len(mine) == len(ref)
    for f in dataclasses.fields(ref.ground_truth):
        np.testing.assert_array_equal(getattr(mine.ground_truth, f.name),
                                      getattr(ref.ground_truth, f.name))
    got, want = list(mine.frames()), list(ref.frames())
    assert len(got) == len(want) >= 5
    if not kw:
        assert [p["index"] for p in want] == list(range(10))  # 10-13 dropped: no IMU
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            if key == "imu":
                assert (a[key] is None) == (b[key] is None)
                if a[key] is not None:
                    for f in ("acc", "gyr", "dt", "mask"):
                        np.testing.assert_array_equal(getattr(a[key], f).numpy(),
                                                      np.asarray(getattr(b[key], f)))
            else:
                assert a[key] == b[key]
        for side in ("left_path", "right_path"):
            if side in a:
                np.testing.assert_array_equal(mine.load_image(a[side]), ref.load_image(b[side]))
    assert mine.imu_timestamp_correction_ns == ref.imu_timestamp_correction_ns
