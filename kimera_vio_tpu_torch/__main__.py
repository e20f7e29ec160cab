"""CLI entry point of the port — the reference's example binary
(`examples/KimeraVIO.cpp` / `stereoVIOEuroc`) as a module runner, with the
flags of `python -m kimera_vio_tpu` and `--device`:

    python -m kimera_vio_tpu_torch \
        --params_folder /path/to/params/Euroc \
        --dataset_path /path/to/EuRoC/V1_01_easy \
        [--initial_k 0] [--final_k -1] [--log_output] \
        [--output_path ./output_logs] [--parallel_run 1] \
        [--chunked] [--chunk_size 16] [--equalize_image] [--use_lcd] \
        [--enable_mesher] [--visualize] [--device cuda]

It runs on the card unless `--device cpu` is given. Values set here land
in the port's flag registry (config/flags.py), as env-var-set flags do.
A params folder with `frontend_type: 0` or no RightCameraParams.yaml runs
the mono pipeline (MonoImuPipeline, cam0 only). `--use_lcd` (or `--gflag
use_lcd=1`) adds loop closure and PGO (traj_pgo.csv,
output_lcd_result.csv); `--chunked` then collects the LCD's keyframe
rows. `--enable_mesher` (stereo only) runs the mesher, with RegularVIO
where the params say `backend_type: 1`; with `--log_output` each
keyframe's mesh is written as `<output_path>/mesh/mesh_NNNNN.ply`;
`--chunked` then collects the mesher's keyframe rows too.
`--do_fine_imu_camera_temporal_sync` runs the IMU-camera time aligner
first (not with `--chunked`). `--visualize` (or `--gflag visualize=1`)
writes the visualizer's PLY and PNG artifacts under
`<output_path>/viz/` in `run()` (not with `--chunked`, as in the JAX
package); `--gflag log_frontend_images=1` writes one feature-track
overlay PNG per keyframe under `<output_path>/frontend_images/`, also
with `--chunked`. `--enable_mesher` on a mono params folder raises
NotImplementedError (the mono pipeline has no mesher, as in the JAX
package). `--chunked` stages its frames in the codec that the
`KIMERA_STAGE_CODEC` environment variable names (`raw`, the default,
`delta4`, `delta4c` or `delta3`; `run_chunked`, ops/frame_codec.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m kimera_vio_tpu_torch",
        description="Kimera-VIO stereo-inertial pipeline, PyTorch / CUDA port",
    )
    ap.add_argument("--params_folder", required=True,
                    help="reference-layout params folder (e.g. params/Euroc)")
    ap.add_argument("--dataset_path", required=True,
                    help="EuRoC-format dataset root (contains mav0/)")
    ap.add_argument("--initial_k", type=int, default=0)
    ap.add_argument("--final_k", type=int, default=-1)
    ap.add_argument("--use_lcd", action="store_true")
    ap.add_argument("--visualize", action="store_true")
    ap.add_argument("--enable_mesher", action="store_true")
    ap.add_argument("--log_output", action="store_true")
    ap.add_argument("--log_euroc_gt_data", action="store_true")
    ap.add_argument("--output_path", default="./output_logs")
    ap.add_argument("--parallel_run", type=int, default=None,
                    help="override PipelineParams.parallel_run")
    ap.add_argument("--chunked", action="store_true",
                    help="offline mode: staged super-batches, one copy each "
                    "(codec: KIMERA_STAGE_CODEC, default raw)")
    ap.add_argument("--chunk_size", type=int, default=16)
    ap.add_argument("--equalize_image", action="store_true",
                    help="histogram-equalize input images (also read from "
                    "FrontendParams.yaml equalizeImage)")
    ap.add_argument("--do_fine_imu_camera_temporal_sync", action="store_true")
    ap.add_argument("--do_coarse_imu_camera_temporal_sync", action="store_true")
    ap.add_argument("--max_features", type=int, default=None)
    ap.add_argument("--max_landmarks", type=int, default=None)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    ap.add_argument(
        "--gflag", action="append", default=[], metavar="NAME=VALUE",
        help="set any registered runtime flag (the reference's gflags tier; "
        "see kimera_vio_tpu_torch/config/flags.py)",
    )
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from kimera_vio_tpu_torch import resolve_device
    from kimera_vio_tpu_torch.config import flags
    from kimera_vio_tpu_torch.config.params import VioParams
    from kimera_vio_tpu_torch.dataprovider.euroc import EurocDataProvider
    from kimera_vio_tpu_torch.pipeline.mono_pipeline import MonoImuPipeline
    from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

    device = resolve_device(args.device)
    # The pipeline's constructor reads use_lcd, visualize and
    # do_fine_imu_camera_temporal_sync.
    for name in ("use_lcd", "visualize", "log_output", "log_euroc_gt_data",
                 "do_fine_imu_camera_temporal_sync"):
        if getattr(args, name):
            flags.set_flag(name, True)
    flags.set_flag("initial_k", args.initial_k)
    flags.set_flag("final_k", args.final_k)
    flags.set_flag("output_path", args.output_path)
    for item in args.gflag:
        name, sep, raw = item.partition("=")
        if not sep or name not in flags._REGISTRY:
            known = ", ".join(sorted(flags._REGISTRY))
            raise SystemExit(f"--gflag {item!r}: unknown flag or missing '='; "
                             f"registered flags: {known}")
        typ = flags._REGISTRY[name].type
        flags.set_flag(name, raw.lower() in ("1", "true", "yes") if typ is bool else typ(raw))

    params = VioParams.from_folder(args.params_folder)
    mono = params.pipeline.frontend_type == 0 or params.right_cam is None
    if mono and args.enable_mesher:
        raise NotImplementedError("--enable_mesher: the mesher runs on stereo params folders only; "
                                  "the mono pipeline has no mesher")
    if args.max_features:
        params.max_features = args.max_features
    if args.max_landmarks:
        params.max_landmarks = args.max_landmarks

    equalize = args.equalize_image or params.frontend.equalize_image
    # skip_n_start_frames / skip_n_end_frames (reference ETH_parser.cpp
    # gflags) compose with --initial_k / --final_k.
    initial_k = flags.get_flag("initial_k") + flags.get_flag("skip_n_start_frames")
    final_k = None if flags.get_flag("final_k") < 0 else flags.get_flag("final_k")
    skip_end = flags.get_flag("skip_n_end_frames")
    if skip_end:
        if final_k is None:
            cam_csv = os.path.join(args.dataset_path, "mav0", "cam0", "data.csv")
            if not os.path.exists(cam_csv):
                cam_csv = os.path.join(args.dataset_path, "cam0", "data.csv")
            with open(cam_csv) as fh:
                final_k = sum(1 for row in fh if row.strip() and row[0] != "#")
        final_k = max(initial_k, final_k - skip_end)
    provider = EurocDataProvider(
        args.dataset_path, initial_k=initial_k, final_k=final_k,
        max_imu_per_frame=params.max_imu_per_frame, equalize=equalize,
        do_coarse_imu_camera_temporal_sync=args.do_coarse_imu_camera_temporal_sync, mono=mono,
    )
    pipe = (MonoImuPipeline if mono else StereoImuPipeline)(
        params,
        output_path=args.output_path if flags.get_flag("log_output") else None,
        parallel_run=bool(args.parallel_run) if args.parallel_run is not None else None,
        device=device,
        **({} if mono else {"enable_mesher": args.enable_mesher}),
    )

    t0 = time.perf_counter()
    if args.chunked:
        out = pipe.run_chunked(provider, chunk_size=args.chunk_size, verbose=args.verbose,
                               collect_aux=(args.enable_mesher or pipe.enable_lcd
                                            or bool(flags.get_flag("log_frontend_images"))))
    else:
        out = pipe.run(provider, verbose=args.verbose)
    wall = time.perf_counter() - t0

    fps = out.n_frames / max(wall, 1e-9)
    print(f"frames={out.n_frames} keyframes={out.n_keyframes} wall={wall:.2f}s fps={fps:.1f}")
    print(pipe.stats.print_table())
    if flags.get_flag("log_output"):
        pipe.stats.write_timing_csv(args.output_path, wall * 1e3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
