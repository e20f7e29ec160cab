"""Lightweight runtime-flag registry — the gflags tier of the config system.

The port's own copy of kimera_vio_tpu/config/flags.py: the same names,
defaults and `KIMERA_<NAME>` environment variables, so one variable
configures both packages. The reference uses a two-tier configuration:
YAML `*Params` files for the algorithmic parameters and ~80 gflags for
debug/visualization/behavior toggles (reference docs/gflags_parameters.md).
`define_*` registers a flag with a default; values resolve from (1)
explicit `set_flag` calls, (2) environment variables (`KIMERA_<NAME>`),
(3) the default. Flags of modules the port does not have yet are
registered all the same, so `--gflag` accepts every name the JAX CLI
accepts.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

_REGISTRY: dict[str, "_Flag"] = {}


@dataclass
class _Flag:
    name: str
    default: Any
    help: str
    type: type
    value: Any = None

    def get(self):
        if self.value is not None:
            return self.value
        env = os.environ.get(f"KIMERA_{self.name.upper()}")
        if env is not None:
            if self.type is bool:
                return env.lower() in ("1", "true", "yes")
            return self.type(env)
        return self.default


def _define(name, default, help_, typ):
    _REGISTRY[name] = _Flag(name, default, help_, typ)


def define_bool(name, default, help_=""):
    _define(name, default, help_, bool)


def define_int(name, default, help_=""):
    _define(name, default, help_, int)


def define_float(name, default, help_=""):
    _define(name, default, help_, float)


def define_string(name, default, help_=""):
    _define(name, default, help_, str)


def get_flag(name):
    return _REGISTRY[name].get()


def set_flag(name, value):
    _REGISTRY[name].value = value


def all_flags() -> dict:
    return {k: f.get() for k, f in sorted(_REGISTRY.items())}


# ---- core flags (mirroring reference gflags where applicable) -----------
define_bool("log_output", False, "Write CSV logs (reference --log_output)")
define_string("output_path", "./output_logs", "Log directory")
define_bool(
    "deterministic_random_number_generator", False,
    "Fix RANSAC seeds (reference Pipeline.cpp:35-40)",
)
define_int("viz_type", 2, "0 none, 1 pointcloud, 2 mesh")
define_bool("visualize", False, "Enable the visualizer module")
define_int("initial_k", 0, "First frame index (reference --initial_k)")
define_int("final_k", -1, "Last frame index, -1 = all (reference --final_k)")
define_bool("use_lcd", False, "Enable loop closure (reference --use_lcd)")
define_float(
    "max_triangle_side", 0.5, "Mesher triangle filter (reference gflag)"
)
define_bool("log_euroc_gt_data", False, "Also write GT csv when available")
define_int(
    "max_consecutive_backend_failures", 5,
    "Stop the pipeline after this many consecutive keyframe solves that "
    "needed the failure-recovery path (reference is_backend_ok_ -> "
    "graceful shutdown, Pipeline.cpp:253-269)",
)
define_int(
    "mesh_optimizer_type", 2,
    "MeshOptimizerType for depth-based mesh refinement: 0 connected, "
    "1 disconnected, 2 closed-form (default), 3 robust iterative "
    "(reference mesh/MeshOptimization-definitions.h:25-29)",
)
define_bool(
    "log_frontend_images", False,
    "Dump per-keyframe feature-track overlay PNGs under "
    "<output_path>/frontend_images (reference logFrontendImg / "
    "--visualize_feature_tracks, StereoVisionImuFrontend.cpp:540,599)",
)
define_bool(
    "do_fine_imu_camera_temporal_sync", False,
    "Run the cross-correlation IMU-camera time aligner at mission start "
    "(reference VisionImuFrontend InitialTimeAlignment state)",
)
define_bool(
    "use_dense_depth_mesh_refinement", False,
    "On stereo keyframes, compute a dense block-matching depth image "
    "(ops/stereo_matching.dense_depth — the reference's "
    "denseStereoReconstruction role, StereoMatcher.cpp:32-121) and "
    "refine the mesher's 3D mesh against it (MeshOptimization.cpp). "
    "RGB-D pipelines refine against the sensor depth instead.",
)
define_int(
    "dense_stereo_num_disparities", 64,
    "Dense block matcher disparity range (reference "
    "DenseStereoParams::num_disparities_)",
)
define_int(
    "dense_stereo_block_size", 9,
    "Dense block matcher SAD window (reference sad_window_size_)",
)

# ---- Mesher.cpp gflags (triangle filters + plane-segmentation
# histograms); defaults mirror the reference's where our geometry uses
# the same convention ----------------------------------------------------
define_float(
    "min_ratio_btw_largest_smallest_side", 0.5,
    "Triangle filter: min smallest/largest side ratio (Mesher.cpp gflag, "
    "default 0.5)",
)
define_float(
    "min_elongation_ratio", 0.5,
    "Triangle filter: min height/longest-side elongation ratio "
    "(Mesher.cpp gflag, default 0.5)",
)
define_bool(
    "reduce_mesh_to_time_horizon", True,
    "Evict mesh triangles whose landmarks left the backend time horizon "
    "(Mesher.cpp gflag reduce_mesh_to_time_horizon)",
)
define_int(
    "z_histogram_bins", 512,
    "Bins for the horizontal-plane z histogram (Mesher.cpp gflag)",
)
define_int(
    "z_histogram_min_support", 20,
    "Min votes for a z-histogram peak (Mesher.cpp gflag; reference "
    "default 50 at 2000-triangle meshes — 20 matches our smaller "
    "per-keyframe triangle budget)",
)
define_float(
    "z_histogram_min_range", -4.0,
    "Z histogram range minimum, world frame (Mesher.cpp gflag; reference "
    "-0.75 assumes its camera-up convention)",
)
define_float(
    "z_histogram_max_range", 4.0,
    "Z histogram range maximum (Mesher.cpp gflag)",
)
define_int(
    "hist_2d_theta_bins", 40,
    "Theta bins of the wall (theta, d) histogram (Mesher.cpp gflag)",
)
define_int(
    "hist_2d_distance_bins", 80,
    "Distance bins of the wall (theta, d) histogram (Mesher.cpp gflag "
    "hist_2d_distance_bins)",
)
define_int(
    "hist_2d_min_support", 20,
    "Min votes for a wall-histogram peak (Mesher.cpp gflag "
    "hist_2d_min_support)",
)
define_bool(
    "visualize_mesh_2d", False,
    "Draw the per-keyframe 2D image-plane mesh into the display "
    "artifacts (reference gflag visualize_mesh_2d / viz_type MESH2D)",
)
define_int(
    "displayed_trajectory_length", -1,
    "Trajectory widget keeps only the last N poses; -1 = all "
    "(Visualizer3D.cpp gflag, reference default 50)",
)
define_int(
    "skip_n_start_frames", 0,
    "Skip this many initial frames (reference ETH_parser.cpp gflag; "
    "composes with --initial_k)",
)
define_int(
    "skip_n_end_frames", 0,
    "Skip this many final frames (reference ETH_parser.cpp gflag; "
    "composes with --final_k)",
)

# ---- OnlineGravityAlignment.cpp / Pipeline.cpp init gflags -------------
define_int(
    "num_iterations_gravity_refinement", 4,
    "Iterations of the gravity magnitude-manifold refinement "
    "(OnlineGravityAlignment.cpp gflag, default 4)",
)
define_float(
    "gyroscope_residuals", 0.05,
    "Max allowed mean rotation residual [rad] after the estimated "
    "gyro-bias correction; above it the online init window is rejected "
    "and re-collected (OnlineGravityAlignment.cpp gflag)",
)
define_int(
    "num_frames_vio_init", 8,
    "Keyframes collected for online initialization (reference "
    "Pipeline.cpp gflag num_frames_vio_init, default 25 there — the "
    "metric stereo-VO alignment here converges from fewer)",
)
