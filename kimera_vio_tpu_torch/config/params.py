"""Pipeline parameter dataclasses and the params-folder reader.

Host-side dataclasses mirroring the reference's `VioParams` aggregate
(reference src/pipeline/Pipeline-definitions.cpp:110-186): one dataclass
per params file (PipelineParams, ImuParams, Left/RightCameraParams,
FrontendParams, BackendParams, LcdParams, DisplayParams), plus the
fixed-capacity shapes that turn ragged vectors into static tensors.

`VioParams.from_folder` reads a reference-layout params folder. Its files
are OpenCV-FileStorage YAML; the JAX package reads them with PyYAML
(kimera_vio_tpu/config/params.py:34-43), which the card's machine lacks,
so `load_opencv_yaml` here reads the subset those files use and gives the
same values and types PyYAML gives. Anything outside the subset raises
with the file and line.

Every params class implements `equals()` in the spirit of the reference's
`PipelineParams::equals/print` contract
(include/kimera-vio/pipeline/PipelineParams.h).
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# OpenCV-FileStorage YAML subset
# ---------------------------------------------------------------------------

# PyYAML's YAML 1.1 resolvers for the scalars the subset takes; note that a
# float needs a dot and a signed exponent (`1e-8` stays a string, which the
# from_yaml converters turn into a float, as they do after PyYAML).
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?|\.[0-9]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
# Plain scalars PyYAML would read as something the subset does not take
# (octal / hex / binary / underscored / sexagesimal numbers, dates) or that
# start with a YAML indicator (anchors, aliases, tags, block scalars, ...).
_OUTSIDE = re.compile(
    r"[-+]?0[0-9_]+|[-+]?0[xXbBoO].*|[-+]?[0-9][0-9_]*(?:_|:)[0-9_:.]*.*"
    r"|[-+]?[0-9.]*_.*|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|[&*!|>%@`{}?\[\]\-=<].*"
)
_KEY = re.compile(r"([A-Za-z0-9_][A-Za-z0-9_.\-]*)[ ]*:(?:[ ]+(.*))?$")


class YamlSubsetError(ValueError):
    """A params file uses YAML outside the subset `load_opencv_yaml` reads."""


def _strip_comment(line: str) -> str:
    """Drop a `#` comment (at the line start or after a blank, outside
    quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or line[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str, where: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        body = tok[1:-1]
        if "\\" in body or tok[0] in body:
            raise YamlSubsetError(f"{where}: escapes in quoted scalars are not read: {tok!r}")
        return body
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.fullmatch(tok):
        return int(tok)
    if _FLOAT.fullmatch(tok):
        return float(tok)
    m = _INF.fullmatch(tok)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.fullmatch(tok):
        return math.nan
    if _OUTSIDE.fullmatch(tok) or ": " in tok or tok[0] in "\"'" or tok.endswith(":"):
        raise YamlSubsetError(f"{where}: scalar outside the subset: {tok!r}")
    return tok


def _flow_list(text: str, where: str) -> list:
    body = text.strip()
    if not (body.startswith("[") and body.endswith("]")):
        raise YamlSubsetError(f"{where}: text after a flow list: {text!r}")
    body = body[1:-1]
    if any(c in body for c in "[]{}"):
        raise YamlSubsetError(f"{where}: nested flow collections are not read")
    items = [t.strip() for t in body.split(",")]
    if items and items[-1] == "":
        items.pop()  # a trailing comma, as PyYAML allows
    if any(t == "" for t in items):
        raise YamlSubsetError(f"{where}: empty flow-list entry")
    return [_scalar(t, where) for t in items]


def load_opencv_yaml(path: str) -> dict:
    """Read an OpenCV-FileStorage YAML params file into a plain dict.

    The subset: an optional `%YAML:x.y` first line and `---`; `#` comments;
    `key: scalar` lines with PyYAML's int / float / bool / null / string
    typing; flow lists `[a, b, ...]` that may span lines; keys that start
    with a digit (`2d2d_algorithm`); and one level of indented maps, as in
    `!!opencv-matrix` nodes (`rows`, `cols`, `dt`, `data`). Anything else
    raises `YamlSubsetError` naming the file and line."""
    with open(path, "r") as f:
        lines = f.read().splitlines()
    out: dict = {}
    parent = None  # (key, indent) of the map being filled, if any
    i = 0
    if lines and re.fullmatch(r"%YAML:[\d.]+\s*", lines[0]):
        i = 1
    first = True
    while i < len(lines):
        where = f"{path}:{i + 1}"
        raw = lines[i]
        if "\t" in raw:
            raise YamlSubsetError(f"{where}: tab characters are not read")
        line = _strip_comment(raw).rstrip()
        i += 1
        if not line.strip():
            continue
        if first and line == "---":
            first = False
            continue
        first = False
        indent = len(line) - len(line.lstrip(" "))
        m = _KEY.match(line.strip())
        if not m:
            raise YamlSubsetError(f"{where}: not a `key: value` line: {raw!r}")
        key, value = m.group(1), (m.group(2) or "").strip()
        if not isinstance(_scalar(key, where), str):
            raise YamlSubsetError(f"{where}: non-string key {key!r}")
        if indent == 0:
            parent = None
            target = out
        elif parent is not None and (parent[1] is None or indent == parent[1]):
            parent = (parent[0], indent)
            target = out[parent[0]]
        else:
            raise YamlSubsetError(f"{where}: indentation outside one level of maps")
        if value.startswith("!!opencv-matrix"):
            value = value[len("!!opencv-matrix"):].strip()
        if value.startswith("["):
            text = value
            while text.count("[") > text.count("]"):
                if i >= len(lines):
                    raise YamlSubsetError(f"{where}: flow list never closed")
                text += " " + _strip_comment(lines[i]).strip()
                i += 1
            target[key] = _flow_list(text, where)
        elif value == "" and indent == 0:
            # A map follows when the next content line is indented.
            j = i
            while j < len(lines) and not _strip_comment(lines[j]).strip():
                j += 1
            nxt = lines[j] if j < len(lines) else ""
            if nxt[:1] == " ":
                target[key] = {}
                parent = (key, None)
            else:
                target[key] = None
        else:
            target[key] = _scalar(value, where)
    return out


def _mat(node: dict) -> np.ndarray:
    """Convert an OpenCV matrix node {rows, cols, data} to ndarray."""
    return np.asarray(node["data"], dtype=np.float64).reshape(
        int(node["rows"]), int(node["cols"])
    )


def _eq(a, b, tol=1e-9) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.allclose(a, b, atol=tol)
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(float(a), float(b), rel_tol=0, abs_tol=tol)
    return a == b


class ParamsBase:
    """Shared equals() mirroring reference PipelineParams::equals."""

    def equals(self, other, tol: float = 1e-9) -> bool:
        if type(self) is not type(other):
            return False
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if isinstance(a, ParamsBase):
                if not a.equals(b, tol):
                    return False
            elif not _eq(a, b, tol):
                return False
        return True


# ---------------------------------------------------------------------------
# Per-subsystem params
# ---------------------------------------------------------------------------


@dataclass
class PipelineParams(ParamsBase):
    """reference params/Euroc/PipelineParams.yaml."""

    frontend_type: int = 1  # 0 mono, 1 stereo (2 rgbd via ctor arg in ref)
    backend_type: int = 1  # 0 vanilla, 1 RegularVio
    display_type: int = 0
    parallel_run: bool = True

    @classmethod
    def from_yaml(cls, path: str) -> "PipelineParams":
        d = load_opencv_yaml(path)
        return cls(
            frontend_type=int(d.get("frontend_type", 1)),
            backend_type=int(d.get("backend_type", 1)),
            display_type=int(d.get("display_type", 0)),
            parallel_run=bool(int(d.get("parallel_run", 1))),
        )



@dataclass
class ImuParams(ParamsBase):
    """reference params/Euroc/ImuParams.yaml + ImuFrontendParams.cpp."""

    preintegration_type: int = 1  # 0 combined, 1 ImuFactor (+bias between)
    rate_hz: float = 200.0
    gyro_noise_density: float = 1.6968e-4
    gyro_random_walk: float = 1.9393e-5
    acc_noise_density: float = 2.0e-3
    acc_random_walk: float = 3.0e-2
    imu_integration_sigma: float = 1e-8
    imu_bias_init_sigma: float = 1e-3
    imu_time_shift_s: float = 0.0
    n_gravity: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, -9.81])
    )
    T_BS: np.ndarray = field(default_factory=lambda: np.eye(4))
    do_imu_rate_time_alignment: bool = True
    time_alignment_window_size_s: float = 10.0
    time_alignment_variance_threshold_scaling: float = 30.0

    @classmethod
    def from_yaml(cls, path: str) -> "ImuParams":
        d = load_opencv_yaml(path)
        return cls(
            preintegration_type=int(d.get("imu_preintegration_type", 1)),
            rate_hz=float(d.get("rate_hz", 200.0)),
            gyro_noise_density=float(d["gyroscope_noise_density"]),
            gyro_random_walk=float(d["gyroscope_random_walk"]),
            acc_noise_density=float(d["accelerometer_noise_density"]),
            acc_random_walk=float(d["accelerometer_random_walk"]),
            imu_integration_sigma=float(d.get("imu_integration_sigma", 1e-8)),
            imu_bias_init_sigma=float(d.get("imu_bias_init_sigma", 1e-3)),
            imu_time_shift_s=float(d.get("imu_time_shift", 0.0)),
            n_gravity=np.asarray(d.get("n_gravity", [0, 0, -9.81]), float),
            T_BS=_mat(d["T_BS"]) if "T_BS" in d else np.eye(4),
            do_imu_rate_time_alignment=bool(
                int(d.get("do_imu_rate_time_alignment", 0))
            ),
            time_alignment_window_size_s=float(
                d.get("time_alignment_window_size_s", 10.0)
            ),
            time_alignment_variance_threshold_scaling=float(
                d.get("time_alignment_variance_threshold_scaling", 30.0)
            ),
        )



@dataclass
class CameraParams(ParamsBase):
    """reference src/frontend/CameraParams.cpp — one physical camera."""

    camera_id: str = "cam"
    T_BS: np.ndarray = field(default_factory=lambda: np.eye(4))
    rate_hz: float = 20.0
    width: int = 752
    height: int = 480
    camera_model: str = "pinhole"  # pinhole | omni
    intrinsics: np.ndarray = field(
        default_factory=lambda: np.array([458.654, 457.296, 367.215, 248.375])
    )  # fu, fv, cu, cv
    distortion_model: str = "radial-tangential"  # radial-tangential|equidistant|none
    distortion_coeffs: np.ndarray = field(default_factory=lambda: np.zeros(4))
    # OCamCalib omni model extras (reference CameraParams.cpp:62-95).
    omni_distortion_center: np.ndarray = field(
        default_factory=lambda: np.zeros(2)
    )
    omni_affine: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0])  # c, d, e
    )

    @classmethod
    def from_yaml(cls, path: str) -> "CameraParams":
        d = load_opencv_yaml(path)
        res = d.get("resolution", [752, 480])
        return cls(
            camera_id=str(d.get("camera_id", "cam")),
            T_BS=_mat(d["T_BS"]) if "T_BS" in d else np.eye(4),
            rate_hz=float(d.get("rate_hz", 20.0)),
            width=int(res[0]),
            height=int(res[1]),
            camera_model=str(d.get("camera_model", "pinhole")),
            intrinsics=np.asarray(d["intrinsics"], float),
            distortion_model=str(d.get("distortion_model", "none")),
            distortion_coeffs=np.asarray(
                d.get("distortion_coefficients", [0, 0, 0, 0]), float
            ),
            omni_distortion_center=np.asarray(
                d.get("omni_distortion_center", [0.0, 0.0]), float
            ),
            omni_affine=np.asarray(
                d.get("omni_affine", [0.0, 0.0, 1.0]), float
            ),
        )



@dataclass
class FrontendParams(ParamsBase):
    """reference params/Euroc/FrontendParams.yaml (TrackerParams +
    FeatureDetectorParams + StereoMatchingParams + keyframe policy,
    cf. src/frontend/VisionImuFrontendParams.cpp)."""

    # KLT tracker
    klt_win_size: int = 24
    klt_max_iter: int = 30
    klt_max_level: int = 4
    klt_eps: float = 0.1
    max_feature_age: int = 25
    # Detector
    feature_detector_type: int = 3  # 0 FAST, 1 ORB, 2 AGAST, 3 GFTT
    max_features_per_frame: int = 300
    quality_level: float = 0.001
    min_distance: float = 20.0
    block_size: int = 3
    use_harris_detector: bool = False
    k: float = 0.04
    fast_thresh: int = 10
    equalize_image: bool = False
    # ANMS
    max_nr_keypoints_before_anms: int = 2000
    enable_non_max_suppression: bool = True
    # AnmsAlgorithmType (NonMaximumSuppression.h:52-60): 0 TopN, 1 BrownANMS,
    # 2 SDC, 3 KdTree, 4 RangeTree, 5 SSC, 6 Binning (the reference EuRoC
    # default, FrontendParams.yaml:40). All seven dispatch in ops/anms.py /
    # corner_detection.detect_features.
    non_max_suppression_type: int = 6
    nr_horizontal_bins: int = 7
    nr_vertical_bins: int = 5
    # Subpixel refinement
    enable_subpixel_corner_finder: bool = True
    subpix_max_iters: int = 40
    subpix_eps: float = 0.001
    subpix_window_size: int = 10
    # Stereo matching
    nominal_baseline: float = 0.11
    tolerance_template_matching: float = 0.15
    templ_cols: int = 101
    templ_rows: int = 11
    stripe_extra_rows: int = 0
    min_point_dist: float = 0.5
    max_point_dist: float = 10.0
    bidirectional_matching: bool = False
    subpixel_refinement_stereo: bool = False
    # RANSAC
    use_ransac: bool = True
    min_nr_mono_inliers: int = 10
    min_nr_stereo_inliers: int = 5
    ransac_threshold_mono: float = 1e-6
    ransac_threshold_stereo: float = 1.0
    ransac_use_1point_stereo: bool = True
    ransac_use_2point_mono: bool = True
    ransac_max_iterations: int = 100
    ransac_probability: float = 0.995
    ransac_randomize: bool = False
    # Keyframe policy
    min_intra_keyframe_time_s: float = 0.2
    max_intra_keyframe_time_s: float = 5.0
    max_disparity_since_lkf: float = 1000.0
    min_number_features: int = 0
    use_stereo_tracking: bool = True
    disparity_threshold: float = 0.5
    optical_flow_predictor_type: int = 1  # 0 static, 1 rotational
    # PnP
    use_pnp_tracking: bool = False
    min_pnp_inliers: int = 20
    ransac_threshold_pnp: float = 1.0

    @classmethod
    def from_yaml(cls, path: str) -> "FrontendParams":
        d = load_opencv_yaml(path)
        g = d.get
        return cls(
            klt_win_size=int(g("klt_win_size", 24)),
            klt_max_iter=int(g("klt_max_iter", 30)),
            klt_max_level=int(g("klt_max_level", 4)),
            klt_eps=float(g("klt_eps", 0.1)),
            max_feature_age=int(g("maxFeatureAge", 25)),
            feature_detector_type=int(g("feature_detector_type", 3)),
            max_features_per_frame=int(g("maxFeaturesPerFrame", 300)),
            quality_level=float(g("quality_level", 0.001)),
            min_distance=float(g("min_distance", 20.0)),
            block_size=int(g("block_size", 3)),
            use_harris_detector=bool(int(g("use_harris_detector", 0))),
            k=float(g("k", 0.04)),
            fast_thresh=int(g("fast_thresh", 10)),
            equalize_image=bool(int(g("equalizeImage", 0))),
            max_nr_keypoints_before_anms=int(g("max_nr_keypoints_before_anms", 2000)),
            enable_non_max_suppression=bool(int(g("enable_non_max_suppression", 1))),
            non_max_suppression_type=int(g("non_max_suppression_type", 6)),
            nr_horizontal_bins=int(g("nr_horizontal_bins", 7)),
            nr_vertical_bins=int(g("nr_vertical_bins", 5)),
            enable_subpixel_corner_finder=bool(
                int(g("enable_subpixel_corner_finder", 1))
            ),
            subpix_max_iters=int(g("max_iters", 40)),
            subpix_eps=float(g("epsilon_error", 0.001)),
            subpix_window_size=int(g("window_size", 10)),
            nominal_baseline=float(g("nominalBaseline", 0.11)),
            tolerance_template_matching=float(g("toleranceTemplateMatching", 0.15)),
            templ_cols=int(g("templ_cols", 101)),
            templ_rows=int(g("templ_rows", 11)),
            stripe_extra_rows=int(g("stripe_extra_rows", 0)),
            min_point_dist=float(g("minPointDist", 0.5)),
            max_point_dist=float(g("maxPointDist", 10.0)),
            bidirectional_matching=bool(int(g("bidirectionalMatching", 0))),
            subpixel_refinement_stereo=bool(int(g("subpixelRefinementStereo", 0))),
            use_ransac=bool(int(g("useRANSAC", 1))),
            min_nr_mono_inliers=int(g("minNrMonoInliers", 10)),
            min_nr_stereo_inliers=int(g("minNrStereoInliers", 5)),
            ransac_threshold_mono=float(g("ransac_threshold_mono", 1e-6)),
            ransac_threshold_stereo=float(g("ransac_threshold_stereo", 1.0)),
            ransac_use_1point_stereo=bool(int(g("ransac_use_1point_stereo", 1))),
            ransac_use_2point_mono=bool(int(g("ransac_use_2point_mono", 1))),
            ransac_max_iterations=int(g("ransac_max_iterations", 100)),
            ransac_probability=float(g("ransac_probability", 0.995)),
            ransac_randomize=bool(int(g("ransac_randomize", 0))),
            min_intra_keyframe_time_s=float(g("min_intra_keyframe_time", 0.2)),
            max_intra_keyframe_time_s=float(g("max_intra_keyframe_time", 5.0)),
            max_disparity_since_lkf=float(g("max_disparity_since_lkf", 1000.0)),
            min_number_features=int(g("minNumberFeatures", 0)),
            use_stereo_tracking=bool(int(g("useStereoTracking", 1))),
            disparity_threshold=float(g("disparityThreshold", 0.5)),
            optical_flow_predictor_type=int(g("optical_flow_predictor_type", 1)),
            use_pnp_tracking=bool(int(g("use_pnp_tracking", 0))),
            min_pnp_inliers=int(g("min_pnp_inliers", 20)),
            ransac_threshold_pnp=float(g("ransac_threshold_pnp", 1.0)),
        )



@dataclass
class BackendParams(ParamsBase):
    """reference params/Euroc/BackendParams.yaml
    (src/backend/VioBackendParams.cpp)."""

    backend_modality: int = 0
    # 0 = GT/default bootstrap, 1 = IMU attitude, 2 = online visual-inertial
    # alignment (reference autoInitialize enum, VioBackendParams.cpp).
    auto_initialize: int = 0
    round_on_auto_initialize: bool = False
    initial_position_sigma: float = 1e-5
    initial_roll_pitch_sigma: float = 10.0 / 180.0 * math.pi
    initial_yaw_sigma: float = 0.1 / 180.0 * math.pi
    initial_velocity_sigma: float = 1e-3
    initial_acc_bias_sigma: float = 0.1
    initial_gyro_bias_sigma: float = 0.01
    # Smart factors
    linearization_mode: int = 0
    degeneracy_mode: int = 1
    rank_tolerance: float = 1.0
    landmark_distance_threshold: float = 10.0
    outlier_rejection: float = 3.0
    retriangulation_threshold: float = 1e-3
    # Noise models
    smart_noise_sigma: float = 3.0
    mono_noise_sigma: float = 1.8
    mono_norm_type: int = 2  # 0 L2, 1 Huber, 2 Tukey
    mono_norm_param: float = 4.6851
    stereo_noise_sigma: float = 1.8
    stereo_norm_type: int = 2
    stereo_norm_param: float = 4.6851
    regularity_noise_sigma: float = 0.03
    regularity_norm_type: int = 1
    regularity_norm_param: float = 0.04
    # Between stereo factors
    add_between_stereo_factors: bool = False
    between_rotation_precision: float = 0.0
    between_translation_precision: float = 100.0
    # Optimization.
    # relinearize_threshold / relinearize_skip / wildfire_threshold /
    # use_dog_leg are iSAM2-specific knobs (gtsam ISAM2Params): parsed for
    # YAML-schema parity but inert here — the TPU smoother relinearizes
    # the whole fixed-lag window every solve (batched GN), so selective
    # relinearization thresholds and dog-leg trust regions have no analog.
    relinearize_threshold: float = 0.01
    relinearize_skip: int = 1
    zero_velocity_precision: float = 1000.0
    no_motion_position_precision: float = 1000.0
    no_motion_rotation_precision: float = 10000.0
    constant_vel_precision: float = 100.0
    num_optimize: int = 1
    nr_states: int = 25  # fixed-lag horizon, in keyframe states
    wildfire_threshold: float = 0.001
    use_dog_leg: bool = False
    pose_guess_source: int = 0  # 0 IMU, 1 MONO, 2 STEREO, 3 PNP, 4 EXT_ODOM
    mono_translation_scale_factor: float = 0.1

    @classmethod
    def from_yaml(cls, path: str) -> "BackendParams":
        d = load_opencv_yaml(path)
        g = d.get
        return cls(
            backend_modality=int(g("backend_modality", 0)),
            auto_initialize=int(g("autoInitialize", 0)),
            round_on_auto_initialize=bool(int(g("roundOnAutoInitialize", 0))),
            initial_position_sigma=float(g("initialPositionSigma", 1e-5)),
            initial_roll_pitch_sigma=float(g("initialRollPitchSigma", 0.174533)),
            initial_yaw_sigma=float(g("initialYawSigma", 0.00174533)),
            initial_velocity_sigma=float(g("initialVelocitySigma", 1e-3)),
            initial_acc_bias_sigma=float(g("initialAccBiasSigma", 0.1)),
            initial_gyro_bias_sigma=float(g("initialGyroBiasSigma", 0.01)),
            linearization_mode=int(g("linearizationMode", 0)),
            degeneracy_mode=int(g("degeneracyMode", 1)),
            rank_tolerance=float(g("rankTolerance", 1.0)),
            landmark_distance_threshold=float(g("landmarkDistanceThreshold", 10.0)),
            outlier_rejection=float(g("outlierRejection", 3.0)),
            retriangulation_threshold=float(g("retriangulationThreshold", 1e-3)),
            smart_noise_sigma=float(g("smartNoiseSigma", 3.0)),
            mono_noise_sigma=float(g("monoNoiseSigma", 1.8)),
            mono_norm_type=int(g("monoNormType", 2)),
            mono_norm_param=float(g("monoNormParam", 4.6851)),
            stereo_noise_sigma=float(g("stereoNoiseSigma", 1.8)),
            stereo_norm_type=int(g("stereoNormType", 2)),
            stereo_norm_param=float(g("stereoNormParam", 4.6851)),
            regularity_noise_sigma=float(g("regularityNoiseSigma", 0.03)),
            regularity_norm_type=int(g("regularityNormType", 1)),
            regularity_norm_param=float(g("regularityNormParam", 0.04)),
            add_between_stereo_factors=bool(int(g("addBetweenStereoFactors", 0))),
            between_rotation_precision=float(g("betweenRotationPrecision", 0.0)),
            between_translation_precision=float(
                g("betweenTranslationPrecision", 100.0)
            ),
            relinearize_threshold=float(g("relinearizeThreshold", 0.01)),
            relinearize_skip=int(g("relinearizeSkip", 1)),
            zero_velocity_precision=float(g("zero_velocity_precision", 1000.0)),
            no_motion_position_precision=float(
                g("no_motion_position_precision", 1000.0)
            ),
            no_motion_rotation_precision=float(
                g("no_motion_rotation_precision", 10000.0)
            ),
            constant_vel_precision=float(g("constant_vel_precision", 100.0)),
            num_optimize=int(g("numOptimize", 1)),
            nr_states=int(g("nr_states", 25)),
            wildfire_threshold=float(g("wildfire_threshold", 0.001)),
            use_dog_leg=bool(int(g("useDogLeg", 0))),
            pose_guess_source=int(g("pose_guess_source", 0)),
            mono_translation_scale_factor=float(
                g("mono_translation_scale_factor", 0.1)
            ),
        )



@dataclass
class LcdParams(ParamsBase):
    """reference params/Euroc/LcdParams.yaml
    (src/loopclosure/LoopClosureDetectorParams.cpp)."""

    use_nss: bool = True
    alpha: float = 0.1
    min_temporal_matches: int = 3
    recent_frames_window: int = 20
    max_db_results: int = 50
    min_nss_factor: float = 0.005
    min_matches_per_island: int = 1
    max_intraisland_gap: int = 3
    max_nrFrames_between_islands: int = 3
    max_nrFrames_between_queries: int = 2
    # Geometric verification
    geom_check: int = 1
    min_correspondences: int = 12
    ransac_threshold_mono: float = 1e-6
    ransac_inlier_threshold_mono: float = 0.5
    ransac_inlier_threshold_stereo: float = 0.3
    # Pose recovery (0 k3d3d, 1 kPnP, 2 k5ptRotOnly — reference header
    # default k3d3d, LoopClosureDetectorParams.h:81; EuRoC yaml sets 0)
    pose_recovery_type: int = 0
    between_rotation_precision: float = 10000.0
    # Optional nonlinear refinement of the recovered loop pose over the
    # inlier correspondences (reference LoopClosureDetectorParams.h:80
    # default true; refinePoses, LoopClosureDetector.cpp:979).
    refine_pose: bool = True
    lowe_ratio: float = 0.7
    # matcher_type / scale_factor / nlevels are cv::ORB + cv::DescriptorMatcher
    # construction knobs: parsed for schema parity, inert here — the TPU ORB
    # is single-scale with a fixed batched Hamming matcher (the Lowe-ratio
    # and nfeatures knobs, which change behavior, ARE consumed).
    matcher_type: int = 4
    # ORB
    nfeatures: int = 500
    scale_factor: float = 1.2
    nlevels: int = 8
    # Extension knob (no reference analog — cv::ORB has no spatial
    # suppression): minimum pixel spacing of the grid detector feeding the
    # LCD's descriptor extraction.
    min_distance: float = 12.0
    # PGO
    pgo_rot_threshold: float = 0.01
    pgo_trans_threshold: float = 0.1
    gnc_alpha: float = 0.0

    @classmethod
    def from_yaml(cls, path: str) -> "LcdParams":
        d = load_opencv_yaml(path)
        g = d.get
        kwargs = {}
        mapping = {
            "use_nss": ("use_nss", lambda v: bool(int(v))),
            "alpha": ("alpha", float),
            "min_temporal_matches": ("min_temporal_matches", int),
            "recent_frames_window": ("recent_frames_window", int),
            "max_db_results": ("max_db_results", int),
            "min_nss_factor": ("min_nss_factor", float),
            "min_matches_per_island": ("min_matches_per_island", int),
            "max_intraisland_gap": ("max_intraisland_gap", int),
            "max_nrFrames_between_islands": ("max_nrFrames_between_islands", int),
            "max_nrFrames_between_queries": ("max_nrFrames_between_queries", int),
            "geom_check": ("geom_check", int),
            "min_correspondences": ("min_correspondences", int),
            "ransac_threshold_mono": ("ransac_threshold_mono", float),
            "ransac_inlier_threshold_mono": ("ransac_inlier_threshold_mono", float),
            "ransac_inlier_threshold_stereo": (
                "ransac_inlier_threshold_stereo",
                float,
            ),
            "pose_recovery_type": ("pose_recovery_type", int),
            "refine_pose": ("refine_pose", lambda v: bool(int(v))),
            "betweenRotationPrecision": ("between_rotation_precision", float),
            "lowe_ratio": ("lowe_ratio", float),
            "matcher_type": ("matcher_type", int),
            "nfeatures": ("nfeatures", int),
            "scale_factor": ("scale_factor", float),
            "nlevels": ("nlevels", int),
            "min_distance": ("min_distance", float),
            "pgo_rot_threshold": ("pgo_rot_threshold", float),
            "pgo_trans_threshold": ("pgo_trans_threshold", float),
            "gnc_alpha": ("gnc_alpha", float),
        }
        for yaml_key, (attr, conv) in mapping.items():
            if yaml_key in d:
                kwargs[attr] = conv(d[yaml_key])
        return cls(**kwargs)



@dataclass
class DisplayParams(ParamsBase):
    """reference params/Euroc/DisplayParams.yaml (OpenCv3dDisplayParams,
    Pipeline-definitions.cpp:157-170)."""

    display_type: int = 0  # 0 OpenCV (file-backed here), 1 Pangolin
    hold_2d_display: bool = False
    hold_3d_display: bool = False

    @classmethod
    def from_yaml(cls, path: str) -> "DisplayParams":
        d = load_opencv_yaml(path)
        return cls(
            display_type=int(d.get("display_type", 0)),
            hold_2d_display=bool(int(d.get("hold_2d_display", 0))),
            hold_3d_display=bool(int(d.get("hold_3d_display", 0))),
        )



@dataclass
class OdometryParams(ParamsBase):
    """reference ExternalOdometryParams.yaml (uHumans2 trees;
    Pipeline-definitions.cpp:179-186): body-from-odometry extrinsics +
    between-factor precisions."""

    T_BS: np.ndarray = field(default_factory=lambda: np.eye(4))
    rate_hz: float = 200.0
    position_precision: float = 1.0e-3
    rotation_precision: float = 1.0e-4
    velocity_precision: float = 1.0e-2

    @classmethod
    def from_yaml(cls, path: str) -> "OdometryParams":
        d = load_opencv_yaml(path)
        return cls(
            T_BS=_mat(d["T_BS"]) if "T_BS" in d else np.eye(4),
            rate_hz=float(d.get("rate_hz", 200.0)),
            position_precision=float(d.get("odomPositionPrecision", 1e-3)),
            rotation_precision=float(d.get("odomRotationPrecision", 1e-4)),
            velocity_precision=float(d.get("odomVelPrecision", 1e-2)),
        )



@dataclass
class VioParams(ParamsBase):
    """Aggregate of all pipeline parameters, parsed from a params folder —
    the TPU-native `VioParams` (reference Pipeline-definitions.cpp:110-186).

    Also holds the framework-specific static-shape capacities that turn the
    reference's ragged vectors into fixed TPU tensor shapes.
    """

    pipeline: PipelineParams = field(default_factory=PipelineParams)
    imu: ImuParams = field(default_factory=ImuParams)
    left_cam: CameraParams = field(default_factory=CameraParams)
    right_cam: Optional[CameraParams] = None
    frontend: FrontendParams = field(default_factory=FrontendParams)
    backend: BackendParams = field(default_factory=BackendParams)
    lcd: LcdParams = field(default_factory=LcdParams)
    display: "DisplayParams" = field(default_factory=lambda: DisplayParams())
    odometry: Optional["OdometryParams"] = None

    # --- TPU static-shape capacities (not in reference; see SURVEY.md §7) ---
    max_features: int = 384  # feature slots (>= maxFeaturesPerFrame, mult of 128)
    max_imu_per_frame: int = 32  # IMU samples per camera frame (200Hz/20Hz + pad)
    max_landmarks: int = 512  # smart-landmark table in the smoother
    max_obs_per_landmark: int = 25  # = horizon length

    @classmethod
    def from_folder(cls, folder: str) -> "VioParams":
        """Parse a reference-layout params folder (e.g. params/Euroc)."""

        def p(name):
            return os.path.join(folder, name)

        pipeline = PipelineParams.from_yaml(p("PipelineParams.yaml"))
        right = None
        rpath = p("RightCameraParams.yaml")
        if os.path.exists(rpath):
            right = CameraParams.from_yaml(rpath)
        lcd = LcdParams()
        if os.path.exists(p("LcdParams.yaml")):
            lcd = LcdParams.from_yaml(p("LcdParams.yaml"))
        display = DisplayParams()
        if os.path.exists(p("DisplayParams.yaml")):
            display = DisplayParams.from_yaml(p("DisplayParams.yaml"))
        odometry = None
        if os.path.exists(p("ExternalOdometryParams.yaml")):
            odometry = OdometryParams.from_yaml(
                p("ExternalOdometryParams.yaml")
            )
        return cls(
            pipeline=pipeline,
            imu=ImuParams.from_yaml(p("ImuParams.yaml")),
            left_cam=CameraParams.from_yaml(p("LeftCameraParams.yaml")),
            right_cam=right,
            frontend=FrontendParams.from_yaml(p("FrontendParams.yaml")),
            backend=BackendParams.from_yaml(p("BackendParams.yaml")),
            lcd=lcd,
            display=display,
            odometry=odometry,
        )
