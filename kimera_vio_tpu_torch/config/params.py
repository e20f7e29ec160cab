"""Pipeline parameter dataclasses (the port's copy, without YAML parsing).

Host-side dataclasses mirroring the reference's `VioParams` aggregate
(reference src/pipeline/Pipeline-definitions.cpp:110-186): one dataclass
per params file (PipelineParams, ImuParams, Left/RightCameraParams,
FrontendParams, BackendParams, LcdParams, DisplayParams), plus the
fixed-capacity shapes that turn ragged vectors into static tensors.

Reading a reference params folder (`from_folder`, OpenCV-FileStorage
YAML) is not part of the port yet; build params in code (for example
`dataprovider.synthetic.synthetic_params`) or convert the JAX package's
params with `kimera_vio_tpu_torch.convert.vio_params_from_dict`.

Every params class implements `equals()` in the spirit of the reference's
`PipelineParams::equals/print` contract
(include/kimera-vio/pipeline/PipelineParams.h).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


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


@dataclass
class DisplayParams(ParamsBase):
    """reference params/Euroc/DisplayParams.yaml (OpenCv3dDisplayParams,
    Pipeline-definitions.cpp:157-170)."""

    display_type: int = 0  # 0 OpenCV (file-backed here), 1 Pangolin
    hold_2d_display: bool = False
    hold_3d_display: bool = False


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

