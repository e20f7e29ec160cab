#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (kimera_vio_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from csrc/ (nvcc, sm_90a), holds
each against its plain PyTorch version on the card, drives the port's
stereo-inertial `StereoImuPipeline.run()` on the synthetic 752x480
sequence (80 frames), its CLI, loop closure, its variants (mono,
RGB-D, online initialization, pose sources, time alignment), the
mesher with RegularVIO, the options it used to refuse, the KITTI and
live providers, the debug overlays, the visualizer and the playground,
a fleet of eight streams through one batched frame step, the staging
codecs of the CLI's --chunked mode, LK windows wider than 54 px, the
fleet over a (data, model) mesh of devices and a distorted rig's
rectification, all with the default LK
tracker (the JAX package's `lk_impl="matmul"`: `lk_cache_build_kernel`
at each keyframe, `lk_cached_kernel` at each frame), then
the pyramid trackers' run paths under KIMERA_LK_IMPL, and checks the
results. Every failure ends the run with a non-zero exit code and no result line. Printed, in order: the
card's name and power limit, the build, the kernel comparison, the main
path, the phases' lines, one JSON line with the kernel table, and last
the JSON result line.

Phases:
  1. kernel: the LK pyramid kernel (`lk_pyramid_cuda`, one launch per
     frame) vs its plain version `track_pyramid(lk_level_plain, ...)` on
     the same CUDA tensors, at the main path's shapes (a 752x480
     keyframe-to-frame pair of the synthetic sequence, 5 levels, 256
     detected keypoints, win 24, 30 iterations, 56-row search window), at
     1241x376 (KITTI-sized, where level 0 takes the reference's gather
     kernel) and, for the kernel's generic instantiation, at 752x480 with
     win 31 and a 64-row search window (its top level is skipped). Same
     float32 arithmetic in the same term order, only the window sums
     differ in order: median and max |d| < 0.01 px over the keypoints
     both track, and the same `ok` for every keypoint. Printed per level: mean and max
     Gauss-Newton steps; and the launch's time with no Gauss-Newton step.
     Then (`cached_phase`) the default tracker's two kernels against
     their plain versions on the same CUDA tensors: the keyframe half,
     `lk_cache_build_kernel` (`lk_cache_build_cuda`, one launch a
     keyframe), against `optical_flow.build_lk_templates` (tmpl, gx and
     gy bit for bit, inv* within 1e-5 relative, `good_g` identical); the
     frame half, `lk_cached_kernel` (`lk_cached_cuda`, one launch per
     frame), against `optical_flow.track_cached` on the plain cache, and
     fed the kernel's cache against fed the plain one; at the main path's
     shapes (752x480, win 24), 1241x376, 752x480 at win 53, 61, 101 and
     151, at win 231 (the global route: no patch fits in shared memory),
     and B = 4 streams in one launch of each against plain per stream and
     four single launches bit for bit. Gates: the same `ok` for every
     keypoint, median and max |d| < 0.01 px over the keypoints both
     track, each row's launch plan (route, shared memory, keypoints a
     block) the one `lk.cached_plan` gives, every route covered, and the
     warp route at 752x480 / 1241x376 / B = 4 (24 px); each row's build
     launch plan (route, strips, items a block, threads, shared memory,
     staged rows) the one `lk.build_plan` gives: 24 px with its rows
     stored directly, some wide row of several strips with its rows staged
     in shared memory. More builds of the 752x480 keyframe against plain
     reach the build kernel's other branches: from the full-image
     gradients (`prev_grads`, "lk_cache_build grads"), at win 20 and 41
     (rows stored directly, one and two strips), at win 241 (level 0 only,
     nine strips, staged) and at win 470 (level 0 only, 17 strips: the
     wide route, one warp sweeps two), each plan gated to its shape.
     One `[cached]` line per row: route, shared memory, per-level steps,
     graph-replay ms, no-step ms, us a step on the longest chain, eager ms
     of `klt_track_cached_lk`, plain ms and the bound (`cached_work`);
     the build's graph-replay ms, eager ms of `build_lk_templates_lk`,
     plain ms and bound (`cached_build_work`).
  2. main path: launch counter set to 0, the sequential `run()`
     (`parallel_run=False`, which times frame and keyframe steps apart)
     on the card at the full configuration (752x480, 256 features,
     10-keyframe horizon, 384 landmarks, 80 frames); the counter must
     equal the tracked frames (one launch each, every one
     `lk_cached_kernel`'s on its warp route), the trajectory must be
     finite and within the JAX package's ATE gate (rmse < 0.05 m,
     tests/test_pipeline_e2e.py:35). Phases 3-11 run the same default
     tracker: "LK launches" below counts `lk_cached_kernel`'s and the
     pyramid kernels' launches together, and every run of phases 2-11
     gates `lk_cache_build_kernel`'s launches equal to the caches the
     frontend built on the card (`lk_launches`), with no plain build
     there. Phase 2 prints the cache build's ms a keyframe (launch +
     kernel, CUDA events around each build), and on a line of its own
     each keyframe's `n_mono_inliers` (the 2-pt mono RANSAC's count).
  3. cli: phase 2's sequence written as a EuRoC `mav0` folder (PNGs from
     the package's encoder, dataprovider/png.py, whose rows cycle through
     all five PNG filters; CSVs with repr floats) and phase 2's params as a
     reference-format YAML params folder (parallel_run: 1). Exact gates
     first: `VioParams.from_folder` equals the params, and every decoded
     PNG equals the array written. Then `python -m kimera_vio_tpu_torch`
     in-process (`__main__.main`) in three modes: (a) the default, the
     parallel `run()`; (b) `--chunked --chunk_size 16`; (c)
     `--parallel_run 0`, the sequential `run()`. Gates per mode: LK
     launches = tracked frames, ATE rmse < 0.05 m, phase 2's keyframe
     stamps, positions within 1e-3 m of phase 2's. One `[cli]` line per
     mode: frames/s, wall, PNG decode ms per image, stage h2d ms and wire
     MB per super-batch, readback.
  4. lcd: loop closure at full width. The 6-DoF synthetic orbit of
     tests/test_pipeline_e2e.py:336-392 (752x480, 240 frames, three laps
     of 4 s, pixel and IMU noise; 10-keyframe horizon, 128 features, 192
     landmarks; LcdParams defaults: 500 LCD features, the packaged
     4096-leaf vocabulary tree) written as a EuRoC folder, then the CLI
     with --use_lcd in three modes: (a) --parallel_run 0, the sequential
     `run()`; (b) the parallel `run()`; (c) --chunked --chunk_size 16,
     `run_chunked(collect_aux=True)`. Gates per run: LK launches = tracked
     frames, at least one verified loop, ATE(PGO) <= 1.25 ATE(VIO) +
     1e-4 m (tests/test_pipeline_e2e.py:391), traj_pgo.csv one row per
     LCD keyframe, output_lcd_result.csv one row per loop; across runs:
     the same loop pairs, PGO positions within 1e-3 m; and the card's
     `orb_descriptors` on the first LCD keyframe against the port's CPU
     run on the same image and keypoints: >= 99.5 % of bits equal. Before
     the runs, one `[lcd]` line of the first and second call times of the
     solvers and the sampler verification calls (the one-time cost of a
     process's first verification). One `[lcd]` line per run: LCD extract
     ms per keyframe (CUDA events around the keyframe branch's fused
     front half), BoW + query ms per keyframe and verify ms per
     candidate (host clock; verification ends in host reads; the mean,
     the first candidate alone, the mean of the others, the median), PGO
     ms and its node count K, frames/s beside phase 2's; then the card's
     time of orb_descriptors and of its orientation moments. Then
     a 300-keyframe LcdModule pass at 752x480 (the large-map harness of
     tests/test_lcd_large_map.py, there at 320x240): recall, precision
     and the PGO ms at K=300; gates: 300 keyframes in the database, at
     least one loop.
  5. variants: the other frontends, initializations and pose sources at
     phase 2's configuration, each run sequentially with the LK counter
     set to 0 just before, gated on LK launches == tracked frames (frames
     fed minus bootstraps) and a finite trajectory; one `[variants]` line
     each (frames fed and published, frames/s beside phase 2's, keyframe
     step ms, ATE). (a) Mono: phase 2's sequence as a EuRoC folder and a
     mono params folder (no RightCameraParams.yaml), the CLI in three
     modes (--parallel_run 0, the parallel run(), --chunked); gates: the
     MonoImuPipeline ran, ATE < 0.05 m (tests/test_pipeline_e2e.py:201),
     the same keyframe stamps and positions within 1e-3 m across modes.
     (b) RGB-D: phase 2's left images and a 16-bit depth stream (5 m in
     mm, a 60 m hole) through RgbdDataProvider (depth PNGs decoded exact)
     and RgbdImuPipeline.run(); ATE < 0.05 m (:232). (c) autoInitialize
     2: fewer frames published than fed, the final velocity within 0.1
     m/s of the truth (tests/test_pipeline_wiring.py:140). (d)
     between-stereo factors with the STEREO guess, (e) PnP tracking with
     the PnP guess (accepted guesses counted), (f) external odometry from
     the ground truth (its factors in the window): ATE < 0.06 m
     (tests/test_pipeline_wiring.py:62, :73, :85, :203). (g)
     --do_fine_imu_camera_temporal_sync on phase 4's orbit (120 frames):
     with the reference's variance gate no estimate lands and every frame
     is published; with the gate scaled to 1 an estimate lands, within
     TIME_SYNC_GATE_S, and the estimator restarts.
  6. mesher: the mesher and RegularVIO at phase 2's width (256 features,
     10-keyframe horizon, 384 landmarks) on the noisy near plane of
     tests/test_regular_vio.py:240-252 (752x480, 80 frames, vx 0.25 m/s,
     a plane 1.8 m ahead, pixel and IMU noise; minPointDist 0.3), its
     images rounded to uint8 as the EuRoC folder of (b) holds them. First
     one `[mesher]` line of the first and second call times of a batched
     3x3 `torch.linalg.inv` and of the closed-form inverse RegularVIO
     uses (relative difference gated at 1e-4). (a) Sequential `run()`
     with backend_type 0 and no mesher, then backend_type 1 with the
     mesher and an output path; gates: LK launches == tracked frames,
     ATE < 0.05 m, a plane slot hit on >= 5 keyframes, ATE(regular) <=
     1.2 ATE(plain) + 5e-4 m (tests/test_regular_vio.py:274), one PLY per
     keyframe after the bootstrap, each parsed back. (b) The scene as a
     EuRoC folder and a params folder with backend_type 1, the CLI with
     --enable_mesher in three modes (parallel, --parallel_run 0,
     --chunked --chunk_size 16); gates: LK launches == tracked frames,
     the PLYs, (a)'s keyframe stamps and positions within 1e-3 m
     (parallel and sequential), (a)'s keyframe count and ATE <= 1.3
     ATE(run) + 1e-3 m (chunked, tests/test_regular_vio.py:324). (c)
     Sequential `run()` with use_dense_depth_mesh_refinement; gates: ATE
     < 0.05 m, and the first keyframe's dense depth on the card against
     the same function on the CPU: valid masks equal on >= 99.5 % of the
     pixels, depth within 1e-3 m where both are valid. One `[mesher]`
     line per run: frames/s beside phase 2's, keyframe step ms, per
     keyframe mesher / RegularVIO refine / dense depth ms (host clock
     around work that ends in `torch.cuda.synchronize`), triangles and
     active planes at the end, plane hits.
  7. options: what the port used to refuse. First the main kernel's time
     beside its 0.04017 ms at commit b6f00a3, before the wide
     instantiation was added. (1) The kernel's wide instantiation
     (33-54 px) against the plain version, phase 1's gate (median and max
     |d| < 0.01 px, the same `ok`), each launch's time and bound printed:
     752x480 at win 41 and win 54 with the 56-row window rule (at 54 that
     rule admits only keypoints whose search window is clamped at the
     image edge, so the positions are compared over every valid
     keypoint), at win 41 and 54 with the gather rule (search_rows=None,
     every level an XLA level), and 1241x376 at win 41. (2) Sequential
     `run()` at phase 2's configuration (752x480, 256 features,
     10-keyframe horizon, 384 landmarks, 80 frames), the LK counter set to
     0 before each: (a) imu_preintegration_type 0, the Combined IMU
     factor; (b) FAST + SSC (ANMS type 5); (c) ORB + Brown ANMS (1); (d)
     GFTT with Harris + SDC (2); (e) enable_non_max_suppression 0 (TopN);
     (f) klt_win_size 41; (g) the Combined factor through the CLI's
     --chunked mode on phase 3's sequence and params folder. Gates: LK
     launches = tracked frames, a finite trajectory, at least one
     keyframe, ATE < 0.05 m for (a), (f) and (g)
     (tests/test_imu_frontend.py:379, tests/test_pipeline_e2e.py:35); one
     `[options]` line per run (frames/s, keyframe step ms, ATE, and the
     ANMS ms per keyframe by host clock around each ANMS call, the device
     synchronised: the greedy passes of types 2-5 run on the host). (3)
     `state_covariance(return_ok=True)` of phase 2's pipeline: ok, finite,
     symmetric, positive diagonal; its ms. (4) The omni camera on the
     card from inline OCamCalib parameters: 4096 pixels through
     omni_backproject_normalized and omni_project back within 1e-3 px,
     and the 1280x960 rectification map built on the card equal to the
     CPU's within 1e-3 px.
  8. host modules. (a) KITTI at full width: a synthetic 1241x376 sequence
     (KITTI odometry's size, fx 718.856, baseline 0.537 m; 40 frames at
     10 Hz, 100 Hz IMU, 15 m ahead at 2 m/s) written as a KITTI raw folder
     (`write_kitti`: PNGs, datetime timestamps, OXTS rows), read back
     exactly (stamps on the folder's clock, OXTS rows, every PNG), then
     `KittiDataProvider` through the sequential `run()` at phase 2's
     capacities, twice. With the source's ground truth attached: every
     launch `lk_cached_kernel`'s on its warp route, LK launches = tracked
     frames, ATE rmse < 0.05 m, the keyframe stamps of the source run
     directly (images rounded to uint8) and positions within 1e-3 m of
     it. Without ground truth (the IMU-attitude bootstrap): LK launches =
     tracked frames, finite poses, at least one keyframe. One `[kitti]`
     line per run: frames/s beside phase 2's, frame and keyframe step ms,
     ATE, and the kernel's in-run launch-and-kernel ms per frame (CUDA
     events around the kernel's wrapper: the host's launch path falls
     between them). A third run with ground truth, under `torch.profiler`,
     reads the kernel's device time per launch from the trace; one more
     `[kitti]` line puts it beside phase 1's graph-replay time of the
     1241x376 pair. Phase 12 runs the same under "pallas" (B1 at level 0).
     (b) Live: phase 2's sequence replayed through `LiveDataProvider` on a
     feeder thread into the sequential `run()`, phase 2's ground truth
     attached (its bootstrap): phase 2's keyframe stamps, positions within
     1e-3 m, LK launches = tracked frames; and `stop()` with a frame that
     can never sync: `frames()` returns within 5 s (a watchdog join). (c)
     `log_frontend_images` at phase 2's configuration in the sequential
     and parallel `run()` and `run_chunked(collect_aux=True)`: one
     480x752 RGB PNG per fused-step keyframe, each with coloured pixels,
     phase 2's keyframe stamps; `visualize` + `visualize_mesh_2d` with the
     mesher on phase 6's near plane, the display writing every 4th
     keyframe (the pipeline's default, every 10th, writes once in 17):
     per written keyframe a point cloud and a mesh PLY (parsed back) and a
     trajectory PNG, and a mesh2d PNG with green edges where the map
     carries the mesher's image-plane mesh (at least one);
     `visualize_gt_data` on phase 3's EuRoC folder: one trajectory PNG
     per shown pose after the first. One
     `[aux]` line per run: frames/s beside phase 2's (the host cost of
     the writes).
  9. fleet: `FleetVio` (parallel/fleet.py), B streams through one batched
     frame step. (a) The kernel's stream axis: B = 4 streams of phase 2's
     752x480 sequence (stream b: frames b -> b+4, 256 detected keypoints)
     and of phase 8a's 1241x376 sequence (frames b -> b+1; level 0 in B1's
     gather mode), each in ONE launch against the plain version per
     stream (phase 1's gate) and against four single-stream launches bit
     for bit, and the same for B = 8 streams at 752x480 (the fleet run's
     launch shape, 2,048 blocks); graph-replay ms per launch and per stream-frame at B = 1, 4
     and 8 (752x480) beside the bound at B (the streams' `lk_work`
     summed) and the plain version over the same streams. (b) Eight
     distinct streams at phase 2's configuration (752x480, 256 features,
     10-keyframe horizon, 384 landmarks), 40 frames each, vx 0.3-1.0 m/s
     at 15-25 frames/s (so the streams keyframe at different frames),
     each bootstrapped at its ground truth; every stream also alone
     through the single-stream `_init_stream` + `_step` on the card.
     Gates: LK launches = fleet frames (39, not 8 x 39); per stream and
     frame the single-stream run's keyframe flag and position within 1e-3
     m; ATE < 0.05 m per stream; at least one frame mixing keyframing and
     tracking streams; final positions apart. (c) The same at B = 4, 2, 1
     (the first B streams). One `[fleet]` line per run: stream-frames/s,
     the batched frame step ms on fleet frames without a keyframe and the
     keyframe ms per keyframing stream (host clock, each step ending in
     `torch.cuda.synchronize`), phase 2's frames/s beside them.
 10. codecs and wide windows. (a) The CLI's --chunked --chunk_size 16
     under KIMERA_STAGE_CODEC = raw, delta4, delta4c and delta3, first on
     phase 3's EuRoC folder (0.5 m/s: ~81 % of the temporal deltas escape,
     so every codec declines every super-batch to raw, the JAX package's
     chain), then on a folder of the same scene at 0.05 m/s (CODEC_VX:
     ~1.2 % escape, every super-batch in the codec named). Gates per run:
     phase 3's (LK launches = tracked frames, ATE < 0.05 m, traj_vio.csv),
     the codec each super-batch landed on, and the keyframe stamps,
     positions and quaternions of raw staging's run bit for bit. Then, per
     codec, the slow folder's first super-batch staged by the pipeline's
     own stager in the codec and in raw and decoded on the card: frames
     equal byte for byte, IMU rows bit for bit. One `[codec]` line per
     codec: super-batches, wire MB, stager ms (PNG decode, encode, pack)
     and copy ms per super-batch, the first super-batch's decode ms (CUDA
     events, mean of 5), frames/s beside raw's. (b) The kernel's `lk_wide`
     mode (the gather rule over 54 px: `lk_wide_kernel`, one thread-block
     cluster per keypoint) against the plain version, phase 1's gate, at
     752x480 win 61, 101, 151 and 401 (the global route) and 1241x376 win
     61, keypoints more than win/2 + 2 px inside; per row its graph-replay ms, no-step ms, longest
     chain of steps and us a step on it, bound and plain ms, and the plan
     the launcher reported (route, cluster size, threads and band rows per
     block, shared memory, clusters the card holds at once). Gates: every
     launch of a row through the route of `lk.wide_plan(win, opt-in
     bytes)`, a cluster of two or more blocks, the report equal to that
     plan, and the routes over the rows those wide_plan gives (ptxas
     registers and spills at the build); B = 4 streams at win 61 in one
     launch against plain per stream and four single launches bit for bit;
     a sequential `run()` at phase 2's configuration with klt_win_size 61
     under the default tracker (gates: LK launches = tracked frames, every
     launch `lk_cached_kernel`'s at 61 px on `lk.cached_route`'s route, ATE < 0.05
     m; phase 12 runs it under "gather"). One `[wide]` line per row and
     run.
 11. mesh: `FleetVio` over a (data, model) mesh, the counterpart of the
     JAX package's __graft_entry__.dryrun_multichip. Phase 9's first
     four streams and configuration (752x480, 256 features, 10-keyframe
     horizon, 384 landmarks, 40 frames) on `devices=[cuda:0] * 4,
     model_shards=2`: two data rows of two streams, each stream's
     landmark table in two shards of 192 rows; where the machine has two
     or more cards, also on the real cards, a (D, 1) mesh and, where D >=
     4, a (D/2, 2) mesh (D = 4 where there are four, else 2). Gates per
     run: LK launches = fleet frames x data rows, each device counting one
     launch per fleet frame for each row it leads
     (`lk_cached_cuda.launches_by_device`); the keyframe flags of phase
     9's B = 4 one-device run, positions within 1e-4 m of it, each
     stream's landmark ids equal to its ids there on every frame up to the
     first on which its frontend gave other keypoints (the batched frame
     step's arithmetic depends on the row's batch size, and model shards
     sum the smart-factor system in another order; through the bias fed
     back to the frontend a track can flip); the single-stream runs'
     keyframe flags and positions within 1e-3 m (phase 9's, reused); ATE
     < 0.05 m per stream. On a mesh with model shards also the model axis
     on identical inputs (`shard_check`): each stream of phase 9's final
     B = 4 state, its table split over the last mesh row's devices, with
     its last keyframe's measurements (every other id made new): the
     table after `update_landmarks` and `shift_landmarks` equal to the
     plain table's bit for bit, the Gauss-Newton system within 1e-5 of
     its largest entry. One `[mesh]` line per run: the mesh's devices,
     each card's name and power limit, stream-frames/s beside phase 9's
     at B = 4, the batched frame step ms and keyframe ms per keyframing
     stream (as phase 9), and the ms per keyframe of the smoother's
     cross-shard copies and sums (CUDA events around each call). Then
     the same four streams on `devices=[cuda:0] * 10, model_shards=5`,
     where 5 does not divide the 384 landmarks: as in the JAX fleet the
     tables stay whole. Gates: each row's table a plain LandmarkTable on
     the row's first device, 78 LK launches on cuda:0, phase 9's B = 4
     keyframe flags, positions and landmark ids bit for bit (rows change
     no bit), ATE < 0.05 m. Last, B = 4 on one device with the three
     switches whose outputs the fleet returns (`use_lcd`,
     `do_fine_imu_camera_temporal_sync`, `auto_initialize: 2`), and each
     of the four streams alone (B = 1, the same switches). Gates: the 28
     output keys of the JAX fleet's fused step under those switches, every
     switched field finite, LK launches = fleet frames, ATE < 0.05 m, LCD
     features and a visual rotation on keyframes, and each stream's
     switched fields equal to its B = 1 run's on every frame up to the
     first on which its keypoints differ (the LCD fields bit for bit: they
     read the stream's images only; the rest within 1e-4: the batched
     preintegration sums in another order). One `[mesh]` and one `[fleet]`
     line.
 12. legacy trackers: the port's pyramid trackers on run paths, chosen by
     KIMERA_LK_IMPL as in the JAX package. Phase 2's 80-frame run under
     "pallas" (B2 on every level: every launch `lk_pyramid_kernel<24,
     56, 24>`'s, launches = tracked frames, ATE < 0.05 m), phase 8's KITTI
     run with ground truth under "pallas" (level 0 in B1's gather mode, its
     gates and its profiled device time) and phase 10's 61 px run under
     "gather" (every launch through `lk_wide_kernel` on wide_plan's
     plan). One `[legacy]`, `[kitti]` and `[wide]` line per run. Every
     kernel of the table must have launched on a run path.
 13. distorted rig: the keyframe branch's rectification where it is not
     the identity. The frontend rectifies with `SeparableRemap`, the JAX
     package's fixed-map remap (a vertical then a horizontal 2-tap pass).
     (a) On the synthetic 752x480 rig with EuRoC cam0 / cam1's
     radial-tangential coefficients, on it with an equidistant set, and
     on phase 7's omni camera (1280x960): the card's `_remap_left` /
     `_remap_right` against the CPU port's on the same uint8 images,
     within 1e-3 gray levels (omni: against the CPU port's remap of the
     card's own map, the map being built on the card; and against the CPU
     frontend within twice the maps' gap times the image's largest step).
     (b) Phase 2's 80-frame sequential `run()` on the radial-tangential
     rig through the default tracker; gates: LK launches = tracked frames,
     cache builds = the caches the frontend built, finite poses, at least
     one keyframe, one left and one right separable remap per cache built.
     No ATE gate: the synthetic images are undistorted, which the
     distorted model does not fit. (c) One keyframe's two rectifications
     on that rig, the separable remap against the 4-tap gather on the same
     maps, graph replay (CUDA events, 200 replays) and eager, in turns.
     (d) The 2-pt mono RANSAC's guard on the card: `ransac_2pt_mono` on
     CUDA tensors of 256 matches (phase 2's features), one injected draw
     at a time. On low-parallax bearings (|n| ~ 1e-3, noisy, so proper
     hypotheses keep few inliers) every repeated-index draw and every
     draw of two matches with parallel normals scores 0; on a
     well-conditioned fixture (gross outliers, 10 % of the mask off) each
     proper draw's count equals the CPU port's, and a batch mixing them
     with repeated draws gives the CPU port's count and inliers and its t
     within 1e-5. (b) prints each keyframe's `n_mono_inliers` on a line
     of its own. One `[distorted]` line per rig, run, timing and gate.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kimera_vio_tpu_torch import __main__ as cli
from kimera_vio_tpu_torch.common.geometry import quat_to_rot, so3_exp
from kimera_vio_tpu_torch.common.types import (
    ImuBlock,
    replace,
    stack_trees,
    tree_map,
    unstack_trees,
)
from kimera_vio_tpu_torch.config import flags as cli_flags
from kimera_vio_tpu_torch.config.params import VioParams
from kimera_vio_tpu_torch.dataprovider import png
from kimera_vio_tpu_torch.dataprovider.euroc import EurocDataProvider, GroundTruth
from kimera_vio_tpu_torch.dataprovider.synthetic import (
    SyntheticPlanar6DofProvider,
    SyntheticStereoProvider,
    _NoiseModel,
    synthetic_params,
)
from kimera_vio_tpu_torch.frontend.camera import StereoCamera, remap_bilinear
from kimera_vio_tpu_torch.frontend import vision_frontend
from kimera_vio_tpu_torch.frontend.vision_frontend import StereoFrontend
from kimera_vio_tpu_torch.loopclosure import orb
from kimera_vio_tpu_torch.loopclosure.lcd import LcdConfig
from kimera_vio_tpu_torch.ops import anms
from kimera_vio_tpu_torch.ops import corner_detection as det
from kimera_vio_tpu_torch.ops import lk_kernel as lk
from kimera_vio_tpu_torch.ops import optical_flow as of
from kimera_vio_tpu_torch.pipeline.lcd_module import LcdModule
from kimera_vio_tpu_torch.pipeline import stereo_pipeline
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.utils.logger import compute_ate
from kimera_vio_tpu_torch.visualizer.visualizer import FileDisplay

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
WIN, MAX_ITER, EPS, MIN_EIG, SEARCH_ROWS = 24, 30, 0.1, 1e-4, 56
LK_KW = dict(win=WIN, max_iter=MAX_ITER, eps=EPS, min_eig_thresh=MIN_EIG, search_rows=SEARCH_ROWS)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 200) -> float:
    """Device time of fn() replayed from a CUDA graph: the kernels' time
    without the host's launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def _tile_pixels(shape, corners, win: int) -> int:
    """Distinct pixels of an (H, W) plane covered by (win+1)^2 tiles whose
    origins are floor(corner - (win-1)/2), clipped to the plane."""
    H, W = shape
    if corners.shape[0] == 0:
        return 0
    a = torch.arange(win + 1, device=corners.device)
    o = torch.floor(corners - (win - 1) * 0.5).long()
    rows = (o[:, 1:2] + a).clamp(0, H - 1)
    cols = (o[:, 0:1] + a).clamp(0, W - 1)
    mask = torch.zeros(H * W, dtype=torch.bool, device=corners.device)
    mask[(rows[:, :, None] * W + cols[:, None, :]).flatten()] = True
    return int(mask.sum())


def lk_bound_ms(levels, n_kpts: int, win: int = WIN) -> tuple[float, str]:
    """Least time the card could take for one frame's LK levels, from this
    run's data: bytes over HBM bandwidth vs float32 operations over the
    float32 peak, whichever is larger (`lk_work`)."""
    return bound_ms(*lk_work(levels, n_kpts, win))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what bounds it): bytes over HBM bandwidth or float32 operations
    over the float32 peak, whichever takes longer."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lk_work(levels, n_kpts: int, win: int = WIN) -> tuple[int, float]:
    """(bytes, float32 operations) of one frame's LK levels, from this run's
    data.

    Bytes, each read once: per level, the distinct prev, gx and gy pixels
    under the valid keypoints' (win+1)^2 template tiles, and the distinct
    cur pixels under the tile that each keypoint taking a step there
    samples first (its later samples are not counted, so this is a floor);
    the keypoints' inputs and outputs once. Operations: per valid keypoint
    and window pixel, 27 of setup (three 4-tap blends, the G sums); per
    Gauss-Newton step and pixel, 17 (two y-lerps, an x-lerp, the
    residual, two multiply-adds)."""
    npx = win * win
    nbytes = n_kpts * (2 + 2 + 1) * 4 + n_kpts * (2 + 1 + len(levels)) * 4
    flops = 0.0
    for lv in levels:
        valid = lv["valid"]
        stepped = lv["iters"] > 0
        nbytes += 3 * 4 * _tile_pixels(lv["shape"], lv["base"][valid], win)
        nbytes += 4 * _tile_pixels(lv["shape"], lv["start"][stepped], win)
        flops += int(valid.sum()) * npx * 27 + int(lv["iters"].sum()) * npx * 17
    return nbytes, flops


def compare_lk(prev_pyr, cur_pyr, pts, valid, label: str, over_valid: bool = False,
               **kw) -> dict:
    """Kernel vs plain version on the same CUDA tensors; returns the
    errors, per-level steps, times and the bound. The positions are
    compared over the keypoints both track, or with `over_valid` over
    every valid keypoint (for a window rule that tracks none)."""
    kw = {**LK_KW, **kw}
    grads = [of._grad(p) for p in prev_pyr]
    args = (prev_pyr, cur_pyr, grads, pts, pts, valid)
    seen = []  # each tracked level's inputs, for the bound

    def level_seen(prev, gx, gy, cur, base, start, valid, **lkw):
        out = lk.lk_level_plain(prev, gx, gy, cur, base, start, valid, **lkw)
        seen.append({"base": base, "start": start, "valid": valid})
        return out

    out_k, ok_k, it_k = lk.lk_pyramid_cuda(*args, **kw)
    out_p, ok_p, lv_p = lk.track_pyramid(level_seen, prev_pyr, cur_pyr, pts, pts,
                                         valid, grads, **kw)
    torch.cuda.synchronize()
    agree = float((ok_k == ok_p).float().mean())
    both = ok_k & ok_p
    d = torch.linalg.norm(out_k - out_p, dim=-1)[valid if over_valid else both]
    if not over_valid and int(both.sum()) < 0.5 * pts.shape[0]:
        raise AssertionError(f"{label}: only {int(both.sum())} keypoints tracked by both")
    median, max_err = float(d.median()), float(d.max())
    # Same float32 math, different summation order of the window sums: the
    # median within 0.01 px, and every keypoint too; the same `ok` for every
    # keypoint (stricter than the >= 98 % agreement the port is held to).
    if not (median < 0.01 and max_err < 0.01 and agree == 1.0):
        raise AssertionError(f"{label}: median {median} px, max {max_err} px, "
                             f"ok agreement {agree}")

    levels = []
    for lv, inp in zip(lv_p, seen):
        steps = it_k[:, lv["level"]]
        levels.append({**lv, **inp, "iters": steps, "plain_iters": lv["iters"]})
    # ms: device time of one frame's kernel launch (graph replay); beside
    # it the same launch with no Gauss-Newton step (staging, template and G
    # on every level) and the eager time of the whole tracker entry point,
    # host work included.
    ms = graph_ms(lambda: lk.lk_pyramid_cuda(*args, **kw))
    ms_no_steps = graph_ms(lambda: lk.lk_pyramid_cuda(*args, **{**kw, "max_iter": 0}))
    chain = int(it_k.sum(dim=1).max())
    eager_ms = time_ms(lambda: lk.klt_track_lk(prev_pyr, cur_pyr, pts, pts, valid,
                                               prev_grads=grads, device=pts.device, **kw), reps=50)
    plain_ms = time_ms(lambda: lk.track_pyramid(lk.lk_level_plain, prev_pyr, cur_pyr, pts, pts,
                                                valid, grads, **kw), reps=3, warmup=1)
    bound_ms, bound_by = lk_bound_ms(levels, pts.shape[0], kw["win"])
    res = {
        "label": label, "win": kw["win"], "search_rows": kw["search_rows"],
        "compared_over": "valid" if over_valid else "tracked by both",
        "launches_per_frame": 1, "tracked": int(ok_k.sum()),
        "ok_agreement": agree, "median_abs_err": median, "max_abs_err": max_err,
        "ms": ms, "ms_no_steps": ms_no_steps, "max_chain_steps": chain,
        "us_per_step_on_longest_chain": 1e3 * (ms - ms_no_steps) / max(chain, 1),
        "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "levels": [{
            "level": lv["level"], "shape": lv["shape"], "mode": lv["mode"],
            "mean_steps": float(lv["iters"].float().mean()), "max_steps": int(lv["iters"].max()),
            "plain_mean_steps": float(lv["plain_iters"].float().mean()),
            "plain_max_steps": int(lv["plain_iters"].max()),
        } for lv in levels],
    }
    log(f"[kernel] {json.dumps(res)}")
    return res


def main_lk_inputs(dev):
    """The main path's LK inputs: keyframe -> frame+4 of the synthetic
    752x480 sequence, 5-level pyramids, 256 detected keypoints. Returns
    (prev_pyr, cur_pyr, keypoints, valid)."""
    prov = SyntheticStereoProvider(n_frames=8, vx=0.5)
    img0 = torch.from_numpy(prov.load_image(("left", 0))).to(dev)
    img4 = torch.from_numpy(prov.load_image(("left", 4))).to(dev)
    empty_uv = torch.zeros((256, 2), device=dev)
    uv, valid = det.detect_features(img0, empty_uv, torch.zeros(256, dtype=torch.bool, device=dev), 256)
    return of.build_pyramid(img0, 4), of.build_pyramid(img4, 4), uv, valid


def kernel_phase(dev) -> dict:
    """Main-path shapes (and the generic instantiation on them); plus a
    1241x376 pair."""
    prev_pyr, cur_pyr, uv, valid = main_lk_inputs(dev)
    main = compare_lk(prev_pyr, cur_pyr, uv, valid, "752x480")
    generic = compare_lk(prev_pyr, cur_pyr, uv, valid, "752x480 generic", win=31, search_rows=64)
    if [lv["mode"] for lv in generic["levels"]][0] != "xla" or len(generic["levels"]) != 4:
        raise AssertionError("752x480 with win 31 should skip its top level")

    kitti = compare_lk(*kitti_lk_inputs(dev), "1241x376")
    if kitti["levels"][-1]["mode"] != "gather":
        raise AssertionError("1241x376 level 0 should take the gather-kernel window rule")
    main["kitti"] = kitti
    return main


# ---------------------------------------------------------------------------
# Phase 1 (b): lk_cached_kernel, the default tracker (lk_impl="matmul")
# ---------------------------------------------------------------------------

CACHED_KW = dict(win=WIN, max_iter=MAX_ITER, eps=EPS)
SLACK = of.SLACK


# The template caches built since `reset_lk_counts`: by the frontend
# (`build_lk_templates_lk`, with each build's CUDA events), and by the
# plain `optical_flow.build_lk_templates` on the card.
CACHE_BUILDS = {"frontend": 0, "plain": 0, "events": []}


def _count_cache_builds() -> None:
    """Wrap the frontend's cache build and the plain build (once) so that
    they count their calls into CACHE_BUILDS (the plain one its calls on
    CUDA tensors)."""
    if getattr(vision_frontend.build_lk_templates_lk, "counted", False):
        return
    entry, plain = vision_frontend.build_lk_templates_lk, of.build_lk_templates

    def frontend_build(prev_pyr, prev_pts, valid, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = entry(prev_pyr, prev_pts, valid, **kw)
        end.record()
        CACHE_BUILDS["frontend"] += 1
        CACHE_BUILDS["events"].append((start, end))
        return out

    def plain_build(prev_pyr, prev_pts, valid, **kw):
        CACHE_BUILDS["plain"] += prev_pts.device.type == "cuda"
        return plain(prev_pyr, prev_pts, valid, **kw)

    frontend_build.counted = True
    vision_frontend.build_lk_templates_lk = frontend_build
    of.build_lk_templates = plain_build


def reset_lk_counts() -> None:
    """Set the LK wrappers' launch counters to 0 (the pyramid and wide
    kernels count on `lk_pyramid_cuda`, the default tracker's on
    `lk_cached_cuda`, its cache builds on `lk_cache_build_cuda`), and the
    cache builds' counts."""
    _count_cache_builds()
    for fn in (lk.lk_pyramid_cuda, lk.lk_cached_cuda):
        fn.launches = 0
        fn.launches_by_device.clear()
    lk.lk_cache_build_cuda.launches = 0
    CACHE_BUILDS.update(frontend=0, plain=0, events=[])


def lk_launches() -> int:
    """LK kernel launches since `reset_lk_counts`, whatever the tracker.
    Gates the cache builds since then too: one `lk_cache_build_kernel`
    launch for each cache the frontend built on the card, no plain build
    on the card."""
    builds = lk.lk_cache_build_cuda.launches
    if builds != CACHE_BUILDS["frontend"] or CACHE_BUILDS["plain"]:
        raise AssertionError(f"{builds} lk_cache_build launches for {CACHE_BUILDS['frontend']} "
                             f"caches the frontend built; {CACHE_BUILDS['plain']} plain builds "
                             f"on the card")
    return lk.lk_pyramid_cuda.launches + lk.lk_cached_cuda.launches


def cache_build_ms() -> list[float]:
    """Each frontend cache build's ms since `reset_lk_counts` (CUDA events
    around `build_lk_templates_lk`: the host's launch path and the kernel)."""
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in CACHE_BUILDS["events"]]


def lk_launches_by_device() -> dict:
    return dict(lk.lk_pyramid_cuda.launches_by_device + lk.lk_cached_cuda.launches_by_device)


@contextlib.contextmanager
def lk_impl(name: str | None):
    """KIMERA_LK_IMPL set to `name` (None: unset, the default tracker) for
    the pipelines built inside."""
    old = os.environ.pop("KIMERA_LK_IMPL", None)
    if name is not None:
        os.environ["KIMERA_LK_IMPL"] = name
    try:
        yield
    finally:
        os.environ.pop("KIMERA_LK_IMPL", None)
        if old is not None:
            os.environ["KIMERA_LK_IMPL"] = old


def _patch_pixels(shape, seeds, win: int) -> int:
    """Distinct pixels of an (H, W) plane under the (S, S) search patches,
    S = win + 2 slack + 2, that `lk_cached_kernel` stages at `seeds`
    (origins clamped as the reference clamps them, pixels clipped to the
    plane)."""
    H, W = shape
    if seeds.shape[0] == 0:
        return 0
    S = win + 2 * SLACK + 2
    a = torch.arange(S, device=seeds.device)
    o = torch.floor(seeds - (win - 1) * 0.5).long() - (SLACK + 1)
    rows = (o[:, 1:2].clamp(-S, H) + a).clamp(0, H - 1)
    cols = (o[:, 0:1].clamp(-S, W) + a).clamp(0, W - 1)
    mask = torch.zeros(H * W, dtype=torch.bool, device=seeds.device)
    mask[(rows[:, :, None] * W + cols[:, None, :]).flatten()] = True
    return int(mask.sum())


def cached_work(levels, n_kpts: int, n_levels: int, win: int) -> tuple[int, float]:
    """(bytes, float32 operations) of one frame of `lk_cached_kernel`, from
    this run's data. Bytes, each read once: the keypoints in (seed, flag)
    and out (point, flag, steps per level); per tracked level each
    keypoint's template gate, and for each keypoint taking a step there
    its template, gx and gy windows and inverse gradient matrix, and the
    distinct current-level pixels under those keypoints' search patches.
    Operations: 17 per step and window pixel (two y-lerps, an x-lerp, the
    residual, two multiply-adds), as `lk_work` counts the other kernel's
    steps; the cache needs no setup here."""
    npx = win * win
    nbytes = n_kpts * (8 + 1) + n_kpts * (8 + 1 + 4 * n_levels)
    flops = 0.0
    for lv in levels:
        stepped = lv["iters"] > 0
        nbytes += n_kpts + int(stepped.sum()) * (12 * npx + 12)
        nbytes += 4 * _patch_pixels(lv["shape"], lv["seeds"][stepped], win)
        flops += int(lv["iters"].sum()) * npx * 17
    return nbytes, flops


@contextlib.contextmanager
def seen_cached_levels():
    """Record each tracked level of the plain version: its shape, the seeds
    its patches are cut at and the steps each keypoint took (flattened
    over streams)."""
    seen, orig = [], of._iterate_level_cached

    def level(T, cur_img, cur_pts, *a, **kw):
        out = orig(T, cur_img, cur_pts, *a, **kw)
        seen.append({"shape": tuple(cur_img.shape[-2:]), "seeds": cur_pts.reshape(-1, 2),
                     "iters": out[3].reshape(-1)})
        return out

    of._iterate_level_cached = level
    try:
        yield seen
    finally:
        of._iterate_level_cached = orig


def _cached_route_of(call) -> tuple:
    """Run call() and return (its result, the route its launch took)."""
    before = collections.Counter(lk.lk_cached_cuda.routes)
    out = call()
    diff = lk.lk_cached_cuda.routes - before
    if sum(diff.values()) != 1:
        raise AssertionError(f"expected one lk_cached launch, got routes {dict(diff)}")
    return out, next(iter(diff))


def _build_patch_pixels(shape, corners, win: int, grads: bool = False) -> int:
    """Distinct pixels of an (H, W) plane under the (win + 4)^2 patches
    that `lk_cache_build_kernel` reads at `corners` (a level's keypoints;
    origins clamped as the reference clamps them, pixels clipped to the
    plane), or with `grads` under the (win + 1)^2 cells each window blends
    from a given plane."""
    H, W = shape
    if corners.shape[0] == 0:
        return 0
    # Cells read, the reference's patch side and its padding.
    side, St, pad = (win + 1, win + 2, win + 4) if grads else (win + 4, win + 4, win + 6)
    a = torch.arange(side, device=corners.device)
    t = torch.floor(corners - (win - 1) * 0.5).long() - (0 if grads else 1)
    rows = (t[:, 1:2].clamp(-pad, H + pad - St) + a).clamp(0, H - 1)
    cols = (t[:, 0:1].clamp(-pad, W + pad - St) + a).clamp(0, W - 1)
    mask = torch.zeros(H * W, dtype=torch.bool, device=corners.device)
    mask[(rows[:, :, None] * W + cols[:, None, :]).flatten()] = True
    return int(mask.sum())


def cached_build_work(prev_pyr, pts, win: int, grads: bool = False) -> tuple[int, float]:
    """(bytes, float32 operations) of one keyframe's `lk_cache_build_kernel`
    launch, from this run's data. Bytes, each once: the keypoints and
    flags in; per level a window fits in (per stream), the distinct
    keyframe pixels under the keypoints' (win + 4)^2 patches (with `grads`,
    those of the image, gx and gy planes under the (win + 1)^2 cells each
    window blends), and out the template, gx and gy windows, the inverse
    matrix and the gate. Operations per keypoint and level: the Scharr x
    and y correlations on the (win + 2)^2 cells (11 each; none with
    `grads`), and per window pixel three y-then-x blends (9 each) and the
    three gradient products and sums (6)."""
    npx = win * win
    planes = [p if p.dim() == 3 else p[None] for p in prev_pyr]
    pts = pts if pts.dim() == 3 else pts[None]
    B, N = pts.shape[0], pts.shape[1]
    nbytes, flops = B * N * (8 + 1), 0.0
    for lvl, img in enumerate(planes):
        if min(img.shape[-2:]) < win + 2:
            continue
        for b in range(B):
            nbytes += (3 if grads else 1) * 4 * _build_patch_pixels(
                img.shape[-2:], pts[b] / 2.0 ** lvl, win, grads)
        nbytes += B * N * (4 * 3 * npx + 4 * 3 + 1)
        flops += B * N * ((0 if grads else 2 * 11 * (win + 2) ** 2) + npx * (3 * 9 + 6))
    return nbytes, flops


def check_cache(built, plain, label: str) -> dict:
    """The kernel's cache against the plain one: tmpl, gx and gy bit for
    bit, `good_g` identical, inv00 / inv01 / inv11 within 1e-5 of the
    level's largest |plain| over the gated keypoints (the gradient sums are
    added in another order). Returns the largest |kernel - plain| over
    tmpl, gx and gy (`max_abs_err`, as measured) and the largest relative
    error of the inverses."""
    if len(built) != len(plain):
        raise AssertionError(f"{label}: {len(built)} cache levels, plain {len(plain)}")
    inv_err, max_err = 0.0, 0.0
    for lvl, (a, b) in enumerate(zip(built, plain)):
        if (a is None) != (b is None):
            raise AssertionError(f"{label}: level {lvl} built {a is not None}, plain {b is not None}")
        if a is None:
            continue
        for key in ("tmpl", "gx", "gy"):
            max_err = max(max_err, float((a[key] - b[key]).abs().max()))
        for key in ("tmpl", "gx", "gy", "good_g"):
            if not torch.equal(a[key], b[key]):
                d = (a[key].float() - b[key].float()).abs().max()
                raise AssertionError(f"{label}: level {lvl} {key} differs from plain by {float(d)}")
        good = b["good_g"]
        for key in ("inv00", "inv01", "inv11"):
            ref = b[key][good]
            if ref.numel():
                err = float((a[key][good] - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
                inv_err = max(inv_err, err)
    if not inv_err < 1e-5:
        raise AssertionError(f"{label}: inverse gradient matrices {inv_err} from plain (relative)")
    return {"cache_bit_identical": True, "max_abs_err": max_err, "inv_max_rel_err": inv_err}


def build_plan_report(label: str, win: int, grads: bool) -> dict:
    """The last cache build's launch report, gated equal to the Python twin
    of the launcher's plan (`lk.build_plan` under this card's opt-in
    shared memory): its route, plan and shared memory."""
    rep = lk.lk_cache_build_cuda.report
    want = lk.build_plan(win, rep.get("optin", -1), grads)
    if rep.get("plan") != want or rep["smem"] != want.smem:
        raise AssertionError(f"{label}: the build's launch plan {rep}, expected {want}")
    return {"route": want.route, "plan": want._asdict(), "smem_bytes": rep["smem"]}


def compare_build(prev_pyr, pts, valid, plain, label: str, win: int, prev_grads=None) -> tuple:
    """lk_cache_build_kernel vs the plain cache `plain` (check_cache); its
    launch plan (`build_plan_report`), graph-replay ms, the eager ms of
    `build_lk_templates_lk` (the host's launch path), the plain version's
    eager ms and the bound (`cached_build_work`). Returns (the kernel's
    cache, the numbers)."""
    kw = dict(win=win, min_eig_thresh=MIN_EIG, prev_grads=prev_grads)
    built = lk.lk_cache_build_cuda(prev_pyr, pts, valid, **kw)
    torch.cuda.synchronize()
    res = check_cache(built, plain, label)
    res.update(build_plan_report(label, win, prev_grads is not None))
    b_ms, b_by = bound_ms(*cached_build_work(prev_pyr, pts, win, prev_grads is not None))
    res.update(
        ms=graph_ms(lambda: lk.lk_cache_build_cuda(prev_pyr, pts, valid, **kw)),
        eager_ms=time_ms(lambda: lk.build_lk_templates_lk(prev_pyr, pts, valid,
                                                          device=pts.device, **kw), reps=20),
        plain_ms=time_ms(lambda: of.build_lk_templates(prev_pyr, pts, valid, **kw), reps=10),
        bound_ms=b_ms, bound_by=b_by)
    return built, res


def _check_tracks(label: str, a: tuple, b: tuple, n_kpts: int, min_both: float) -> tuple:
    """Two trackers' (pts, ok): the same `ok` for every keypoint; median
    and max |d| < 0.01 px over the keypoints both track (at least
    `min_both` of them). Returns (median, max)."""
    (out_a, ok_a), (out_b, ok_b) = a[:2], b[:2]
    agree = float((ok_a == ok_b).float().mean())
    both = ok_a & ok_b
    if int(both.sum()) < max(1, min_both * n_kpts):
        raise AssertionError(f"{label}: only {int(both.sum())} keypoints tracked by both")
    d = torch.linalg.norm(out_a - out_b, dim=-1)[both]
    median, max_err = float(d.median()), float(d.max())
    # Same float32 math in the same term order; only the window sums are
    # added in another order.
    if not (median < 0.01 and max_err < 0.01 and agree == 1.0):
        raise AssertionError(f"{label}: median {median} px, max {max_err} px, "
                             f"ok agreement {agree}")
    return median, max_err


def compare_cached(prev_pyr, cur_pyr, pts, init, valid, label: str, win: int = WIN,
                   min_both: float = 0.5) -> dict:
    """The default tracker's two kernels against their plain versions on
    the same CUDA tensors: lk_cache_build_kernel against
    `optical_flow.build_lk_templates` (`compare_build`), then
    lk_cached_kernel against `optical_flow.track_cached` on the plain
    cache, and the kernel fed the kernel's cache against it fed the plain
    one (`_check_tracks`). Returns the errors, steps, the launch plan, the
    times and the bounds."""
    kw = dict(CACHED_KW, win=win)
    templates = of.build_lk_templates(prev_pyr, pts, valid, win=win)
    built, build = compare_build(prev_pyr, pts, valid, templates, label, win)
    (out_k, ok_k, it_k), route = _cached_route_of(
        lambda: lk.lk_cached_cuda(templates, cur_pyr, init, valid, **kw))
    report = dict(lk.lk_cached_cuda.report[route])
    with seen_cached_levels() as seen:
        out_p, ok_p, it_p = of.track_cached(templates, cur_pyr, init, valid, **kw)
    out_b = lk.lk_cached_cuda(built, cur_pyr, init, valid, **kw)
    torch.cuda.synchronize()
    n_kpts = pts.shape[-2]
    median, max_err = _check_tracks(label, (out_k, ok_k), (out_p, ok_p), n_kpts, min_both)
    _, max_built = _check_tracks(f"{label} (the kernel's cache)", out_b, (out_k, ok_k), n_kpts,
                                 min_both)
    n = len(cur_pyr)
    res = {"label": label, "win": win, "route": route, "smem_bytes": report["smem"],
           "keypoints_a_block": report["warps"],
           "levels_tracked": sum(t is not None for t in templates),
           "launches_per_frame": 1, "tracked": int(ok_k.sum()), "ok_agreement": 1.0,
           "median_abs_err": median, "max_abs_err": max_err,
           "max_abs_err_kernel_cache_vs_plain_cache": max_built,
           "levels": [{"level": lvl, "shape": list(cur_pyr[lvl].shape[-2:]),
                       "mean_steps": float(it_k[..., lvl].float().mean()),
                       "max_steps": int(it_k[..., lvl].max()),
                       "plain_mean_steps": float(it_p[..., lvl].float().mean()),
                       "plain_max_steps": int(it_p[..., lvl].max())}
                      for lvl in range(n - 1, -1, -1) if templates[lvl] is not None]}
    # ms: device time of one frame's launch (graph replay); beside it the
    # launch with no Gauss-Newton step (patch staging on every level), the
    # eager time of the tracker entry point and the plain version.
    ms = graph_ms(lambda: lk.lk_cached_cuda(templates, cur_pyr, init, valid, **kw))
    ms_no_steps = graph_ms(lambda: lk.lk_cached_cuda(templates, cur_pyr, init, valid,
                                                     **{**kw, "max_iter": 0}))
    chain = int(it_k.reshape(-1, n).sum(-1).max())
    plain_ms = time_ms(lambda: of.track_cached(templates, cur_pyr, init, valid, **kw),
                       reps=3, warmup=1)
    eager_ms = time_ms(lambda: lk.klt_track_cached_lk(templates, cur_pyr, init, valid,
                                                      device=pts.device, **kw), reps=50)
    b_ms, b_by = bound_ms(*cached_work(seen, int(valid.numel()), n, win))
    res.update(ms=ms, ms_no_steps=ms_no_steps, max_chain_steps=chain,
               us_per_step_on_longest_chain=1e3 * (ms - ms_no_steps) / max(chain, 1),
               eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, build=build)
    log(f"[cached] {json.dumps(res)}")
    return res


def compare_cached_streams(inp: dict, n_streams: int, label: str) -> dict:
    """ONE launch of each kernel for n_streams streams: the cache build of
    the stacked keyframes against the plain cache per stream and against
    n_streams single-stream builds, bit for bit; the tracker on the
    stacked cache against the plain version per stream (phase 1's gate)
    and against n_streams single-stream launches, bit for bit."""
    prev = [p[:n_streams] for p in inp["prev"]]
    cur = [c[:n_streams] for c in inp["cur"]]
    pts, valid = inp["pts"][:n_streams], inp["valid"][:n_streams]
    per = [of.build_lk_templates([p[b] for p in prev], pts[b], valid[b])
           for b in range(n_streams)]
    stacked = stack_trees(per)
    built = lk.lk_cache_build_cuda(prev, pts, valid, win=WIN, min_eig_thresh=MIN_EIG)
    build = check_cache(built, stacked, f"{label} build")
    build.update(build_plan_report(f"{label} build", WIN, False))
    for b in range(n_streams):
        single = lk.lk_cache_build_cuda([p[b] for p in prev], pts[b], valid[b], win=WIN,
                                        min_eig_thresh=MIN_EIG)
        for lvl, (x, y) in enumerate(zip(single, built)):
            if (x is None) != (y is None) or (
                    x is not None and not all(torch.equal(x[k], y[k][b]) for k in x)):
                raise AssertionError(f"{label}: stream {b}'s cache from the batched build differs "
                                     f"from its own at level {lvl}")
    b_ms, b_by = bound_ms(*cached_build_work(prev, pts, WIN))
    build.update(equal_to_single_launches=True,
                 ms=graph_ms(lambda: lk.lk_cache_build_cuda(prev, pts, valid, win=WIN,
                                                            min_eig_thresh=MIN_EIG)),
                 bound_ms=b_ms, bound_by=b_by)
    (out_k, ok_k, it_k), route = _cached_route_of(
        lambda: lk.lk_cached_cuda(stacked, cur, pts, valid, **CACHED_KW))
    d, agree, both_n, work = [], [], 0, [0, 0.0]
    for b in range(n_streams):
        cur_b = [c[b] for c in cur]
        single = lk.lk_cached_cuda(per[b], cur_b, pts[b], valid[b], **CACHED_KW)
        if not (torch.equal(single[0], out_k[b]) and torch.equal(single[1], ok_k[b])
                and torch.equal(single[2], it_k[b])):
            raise AssertionError(f"{label}: stream {b}'s batched launch differs from its own")
        with seen_cached_levels() as seen:
            out_p, ok_p, _ = of.track_cached(per[b], cur_b, pts[b], valid[b], **CACHED_KW)
        # The launch's bound: the streams' work summed.
        w = cached_work(seen, int(valid[b].numel()), len(cur), WIN)
        work = [work[0] + w[0], work[1] + w[1]]
        both = ok_k[b] & ok_p
        both_n += int(both.sum())
        d.append(torch.linalg.norm(out_k[b] - out_p, dim=-1)[both])
        agree.append(float((ok_k[b] == ok_p).float().mean()))
    d = torch.cat(d)
    if both_n < 0.5 * n_streams * pts.shape[1]:
        raise AssertionError(f"{label}: only {both_n} keypoints tracked by both")
    median, max_err = float(d.median()), float(d.max())
    if not (median < 0.01 and max_err < 0.01 and min(agree) == 1.0):
        raise AssertionError(f"{label}: median {median} px, max {max_err} px, "
                             f"ok agreement {min(agree)}")
    ms = graph_ms(lambda: lk.lk_cached_cuda(stacked, cur, pts, valid, **CACHED_KW))
    report = lk.lk_cached_cuda.report[route]
    b_ms, b_by = bound_ms(*work)
    res = {"label": label, "win": WIN, "streams": n_streams, "launches": 1, "route": route,
           "smem_bytes": report["smem"], "keypoints_a_block": report["warps"],
           "levels_tracked": sum(t is not None for t in stacked), "tracked": int(ok_k.sum()),
           "median_abs_err": median, "max_abs_err": max_err, "ok_agreement": min(agree),
           "equal_to_single_launches": True, "ms": ms, "ms_per_stream_frame": ms / n_streams,
           "bound_ms": b_ms, "bound_by": b_by, "build": build}
    log(f"[cached] {json.dumps(res)}")
    return res


def cached_phase(dev) -> dict:
    """Phase 1 (b): lk_cache_build_kernel and lk_cached_kernel against
    their plain versions at the main path's shapes (752x480, win 24), at
    1241x376, at 53, 61, 101 and 151 px, at 231 px (the global route: no
    patch fits in shared memory), and with four streams in one launch.
    Gates each row's launch plan to `lk.cached_plan`, every route covered,
    and the warp route on the 24 px rows."""
    optin = optin_bytes(dev)
    prev_pyr, cur_pyr, uv, valid = main_lk_inputs(dev)
    rows = {"752x480": compare_cached(prev_pyr, cur_pyr, uv, uv, valid, "752x480")}
    kprev, kcur, kpts, kvalid = kitti_lk_inputs(dev)
    rows["1241x376"] = compare_cached(kprev, kcur, kpts, kpts, kvalid, "1241x376")
    for win in (53, 61, 101, 151):
        rows[f"752x480 win {win}"] = compare_cached(prev_pyr, cur_pyr, uv, uv, valid,
                                                    f"752x480 win {win}", win=win, min_both=0.25)
    rows["752x480 win 231"] = compare_cached(prev_pyr, cur_pyr, uv, uv, valid, "752x480 win 231",
                                             win=231, min_both=0.02)
    rows["752x480 B=4"] = compare_cached_streams(fleet_lk_inputs(dev, 4), 4, "752x480 B=4")
    for label, r in rows.items():
        want = lk.cached_plan(r["win"], optin)
        got = (r["route"], r["keypoints_a_block"], r["smem_bytes"])
        if got != tuple(want):
            raise AssertionError(f"{label}: launch plan {got}, expected {tuple(want)} under "
                                 f"{optin} B opt-in")
    if {r["route"] for r in rows.values()} != set(lk.CACHED_ROUTES):
        raise AssertionError(f"the rows do not cover every route: {[r['route'] for r in rows.values()]}")
    for label in ("752x480", "1241x376", "752x480 B=4"):
        if rows[label]["route"] != "lk_cached warp":
            raise AssertionError(f"{label}: route {rows[label]['route']}, not the warp route")
    # The build's plans: the compiled-in 24 px unstaged, and a wide row of
    # several strips with its rows staged in shared memory.
    plans = {label: r["build"]["plan"] for label, r in rows.items()}
    if plans["752x480"]["staged"] or not any(p["strips"] > 1 and p["staged"]
                                             for p in plans.values()):
        raise AssertionError(f"the build rows' plans {plans}")
    return rows


def build_branch_phase(dev) -> dict:
    """Phase 1 (c): the build kernel's branches that the cached rows do not
    reach, against the plain build (`compare_build`) on the 752x480
    keyframe: the cache resampled from full-image gradients (`prev_grads`,
    each level's Scharr planes); windows of 20 and 41 px (the instantiation
    of any window under 48 px but 24: rows stored directly, four one-strip
    items a block at 20 px, two two-strip items at 41 px); a window of 241
    px (level 0 only), the widest window of a cached row's; and one of 470
    px (level 0 only): 17 strips, more than an item has warps, so the wide
    route, whose first warp sweeps strips 0 and 16. Each row's plan as
    `lk.build_plan` gives, and gated to the shape named here."""
    prev_pyr, _, uv, valid = main_lk_inputs(dev)
    grads = [of._grad(p) for p in prev_pyr]
    sweep, rows = "lk_cache_build sweep", {}
    # (label, win, gradients, the plan's (route, strips, items, threads, staged)
    # under the H100's opt-in, levels built)
    cases = (("752x480 prev_grads", WIN, grads, ("lk_cache_build grads", 1, 1, 128, False), 5),
             ("752x480 win 20", 20, None, (sweep, 1, 4, 128, False), 5),
             ("752x480 win 41", 41, None, (sweep, 2, 2, 128, False), 4),
             ("752x480 win 241", 241, None, (sweep, 9, 1, 288, True), 1),
             ("752x480 win 470", 470, None, ("lk_cache_build wide", 17, 1, 512, False), 1))
    for label, win, g, shape, n_levels in cases:
        plain = of.build_lk_templates(prev_pyr, uv, valid, win=win, min_eig_thresh=MIN_EIG,
                                      prev_grads=g)
        _, rows[label] = compare_build(prev_pyr, uv, valid, plain, label, win, prev_grads=g)
        rows[label].update(label=label, win=win, levels_built=sum(t is not None for t in plain))
        del plain
        log(f"[cache build] {json.dumps(rows[label])}")
        plan = rows[label]["plan"]
        got = (rows[label]["route"], plan["strips"], plan["items"], plan["threads"],
               plan["staged"])
        if got != shape or rows[label]["levels_built"] != n_levels:
            raise AssertionError(f"{label}: plan {got} over {rows[label]['levels_built']} "
                                 f"levels, expected {shape} over {n_levels}")
    return rows


def kitti_lk_inputs(dev, margin: float = 14.0):
    """A KITTI-sized (1241x376) textured pair shifted by 9.6 px, 5-level
    pyramids and 256 random keypoints `margin` px inside the image.
    Returns (prev_pyr, cur_pyr, keypoints, valid)."""
    rng = np.random.default_rng(7)
    H, W = 376, 1241
    import scipy.ndimage as ndi

    tex = ndi.zoom(rng.uniform(30, 225, (H // 6 + 2, (W + 40) // 6 + 2)).astype(np.float32), 6, order=3)
    a = torch.from_numpy(np.ascontiguousarray(tex[:H, :W])).to(dev)
    b = torch.from_numpy(np.ascontiguousarray(0.4 * tex[:H, 9 : W + 9] + 0.6 * tex[:H, 10 : W + 10])).to(dev)
    pts = torch.from_numpy(np.stack([rng.uniform(margin, W - margin, 256),
                                     rng.uniform(margin, H - margin, 256)], -1)
                           .astype(np.float32)).to(dev)
    return (of.build_pyramid(a, 4), of.build_pyramid(b, 4), pts,
            torch.ones(256, dtype=torch.bool, device=dev))


def record_keyframe_inliers(pipe) -> list:
    """Each keyframe's `n_mono_inliers` of `pipe`'s runs, in order (the
    frame step looked up at each call, so that `counted_steps` still
    counts it)."""
    rows = []

    def step(*a, **kw):
        res = type(pipe)._step(pipe, *a, **kw)
        if res[4] is not None:
            rows.append(int(res[3]["n_mono_inliers"]))
        return res

    pipe._step = step
    return rows


def path_phase(dev) -> dict:
    params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    # Warm-up (CUDA context, cuBLAS/cuSOLVER handles, kernel library).
    StereoImuPipeline(params, parallel_run=False, device=dev).run(
        SyntheticStereoProvider(n_frames=6, vx=0.5))
    provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
    pipe = StereoImuPipeline(params, parallel_run=False, device=dev)
    kf_inliers = record_keyframe_inliers(pipe)
    torch.cuda.synchronize()
    reset_lk_counts()
    lk.lk_cached_cuda.routes.clear()
    t0 = time.perf_counter()
    out = pipe.run(provider)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lk_launches()
    builds = lk.lk_cache_build_cuda.launches
    build_ms = cache_build_ms()
    tracked = out.n_frames - 1  # the first frame initializes, the rest track
    if launches != tracked or builds < 1:
        raise AssertionError(f"LK kernel launches {launches} != {tracked} tracked frames, "
                             f"or no cache build ({builds})")
    # The default tracker: every launch lk_cached_kernel's, on its warp route;
    # one cache build at the first frame and at each keyframe after it.
    if (lk.lk_cached_cuda.launches != tracked
            or dict(lk.lk_cached_cuda.routes) != {"lk_cached warp": tracked}):
        raise AssertionError(f"main path: {lk.lk_cached_cuda.launches} lk_cached launches, "
                             f"routes {dict(lk.lk_cached_cuda.routes)}")
    est = np.stack(out.positions)
    if est.shape != (out.n_keyframes, 3) or not np.isfinite(est).all():
        raise AssertionError("trajectory not finite or of the wrong shape")
    gt = provider.ground_truth
    ate = compute_ate(np.array(out.stamps_ns), est, gt.stamps_ns, gt.positions, align=False)
    if not ate["rmse"] < 0.05:
        raise AssertionError(f"ATE rmse {ate['rmse']} m >= 0.05 m")
    step = pipe.stats.get("vio_step [ms]")
    res = {
        "frames": out.n_frames, "keyframes": out.n_keyframes, "ate_rmse_m": ate["rmse"],
        "wall_s": wall, "frames_per_s": out.n_frames / wall,
        "step_ms_mean": step.total / step.count,
        "frame_ms_mean": pipe.stats.get("VioFrontend Frame Rate [ms]").total
        / pipe.stats.get("VioFrontend Frame Rate [ms]").count,
        "keyframe_ms_mean": pipe.stats.get("VioFrontend Keyframe Rate [ms]").total
        / pipe.stats.get("VioFrontend Keyframe Rate [ms]").count,
        "lk_launches": launches, "lk_impl": pipe.frontend_cfg.lk_impl,
        "lk_launches_by_route": dict(lk.lk_cached_cuda.routes),
        "cache_builds": builds,
        "cache_build_ms_per_keyframe": float(np.mean(build_ms)),
        "cache_build_ms_median": float(np.median(build_ms)),
    }
    log(f"[path] keyframe n_mono_inliers {json.dumps(kf_inliers)}")
    log(f"[path] {json.dumps(res)}")
    res["stamps_ns"], res["positions"], res["pipe"] = out.stamps_ns, est, pipe
    return res


# ---------------------------------------------------------------------------
# Phase 3: the CLI on a EuRoC-format folder
# ---------------------------------------------------------------------------


def to_uint8(img: np.ndarray) -> np.ndarray:
    """The synthetic provider renders float32 gray levels; a PNG holds them
    rounded to uint8."""
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _write_cam(mav0: str, cam: str, stamps, images, write_png) -> list:
    """One EuRoC camera folder (data.csv and PNGs); returns (path, array)
    pairs."""
    os.makedirs(os.path.join(mav0, cam, "data"), exist_ok=True)
    written = []
    with open(os.path.join(mav0, cam, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for stamp, img in zip(stamps, images):
            path = os.path.join(mav0, cam, "data", f"{stamp}.png")
            write_png(path, img)
            written.append((path, img))
            f.write(f"{stamp},{stamp}.png\n")
    return written


def _write_imu_gt(mav0: str, provider) -> None:
    """imu0/data.csv and the ground truth of `provider`, floats as repr."""
    sync = provider.imu_sync
    os.makedirs(os.path.join(mav0, "imu0"))
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],w_RS_S_z [rad s^-1],"
                "a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],a_RS_S_z [m s^-2]\n")
        for t, g, a in zip(sync.t, sync.gyr, sync.acc):
            f.write(",".join([str(int(t))] + [repr(float(v)) for v in (*g, *a)]) + "\n")
    gt = provider.ground_truth
    os.makedirs(os.path.join(mav0, "state_groundtruth_estimate0"))
    with open(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,v_x,v_y,v_z,b_w_x,b_w_y,b_w_z,"
                "b_a_x,b_a_y,b_a_z\n")
        for i, t in enumerate(gt.stamps_ns):
            vals = (*gt.positions[i], *gt.quats_wxyz[i], *gt.velocities[i], *gt.gyro_bias[i],
                    *gt.accel_bias[i])
            f.write(",".join([str(int(t))] + [repr(float(v)) for v in vals]) + "\n")


def write_euroc(root: str, provider, write_png=None) -> list:
    """Write `provider`'s sequence as a EuRoC `mav0` folder under `root`:
    cam0/cam1 PNGs and data.csv, imu0/data.csv and the ground truth, floats
    as repr. Returns the uint8 images written, as (path, array) pairs."""
    mav0 = os.path.join(root, "mav0")
    written = []
    for cam, kind in (("cam0", "left"), ("cam1", "right")):
        images = (to_uint8(provider.load_image((kind, k))) for k in range(len(provider.left_stamps)))
        written += _write_cam(mav0, cam, provider.left_stamps, images, write_png or png.write_png)
    _write_imu_gt(mav0, provider)
    return written


def write_rgbd(root: str, provider) -> list:
    """`provider`'s sequence as an RGB-D tree under `root`
    (dataprovider/rgbd.py): cam0 8-bit PNGs, depth0 16-bit PNGs of the
    scene's constant depth in millimetres with a 10x10 hole of 60 m in the
    top-left corner (beyond any range gate), imu0 and the ground truth.
    Returns the images written, as (path, array) pairs."""
    mav0 = os.path.join(root, "mav0")
    n = len(provider.left_stamps)
    written = _write_cam(mav0, "cam0", provider.left_stamps,
                         (to_uint8(provider.load_image(("left", k))) for k in range(n)), png.write_png)
    depth_mm = np.full((provider.height, provider.width), round(provider.depth * 1000.0), np.uint16)
    depth_mm[:10, :10] = 60000
    written += _write_cam(mav0, "depth0", provider.left_stamps, (depth_mm for _ in range(n)),
                          png.write_png)
    _write_imu_gt(mav0, provider)
    return written


#: Time of day of a synthetic KITTI folder's first stamp (any stamp on a
#: 5 ms grid after it parses back to the exact ns, checked in phase 8)
KITTI_DAY, KITTI_TOD_NS = "2011-09-26", (13 * 3600 + 2 * 60 + 25) * 10**9


def _kitti_stamps(path: str, stamps_ns) -> None:
    """A KITTI timestamps.txt: each stamp after KITTI_TOD_NS as
    "YYYY-MM-DD hh:mm:ss.fffffffff", written from the integers."""
    with open(path, "w") as f:
        for t in stamps_ns:
            s, ns = divmod(KITTI_TOD_NS + int(t), 10**9)
            f.write(f"{KITTI_DAY} {s // 3600:02d}:{s // 60 % 60:02d}:{s % 60:02d}.{ns:09d}\n")


def write_kitti(root: str, provider) -> list:
    """`provider`'s sequence as a KITTI raw folder under `root`
    (dataprovider/kitti.py): image_00 / image_01 8-bit PNGs of the images
    rounded to uint8 and their timestamps, oxts/timestamps.txt and one
    30-column OXTS row per IMU sample (accelerations in columns 11-13,
    angular rates in 17-19, the rest 0; floats as %.18e). Returns the
    images written, as (path, array) pairs."""
    written = []
    n = len(provider.left_stamps)
    for cam, kind in (("image_00", "left"), ("image_01", "right")):
        os.makedirs(os.path.join(root, cam, "data"))
        _kitti_stamps(os.path.join(root, cam, "timestamps.txt"), provider.left_stamps)
        for k in range(n):
            path = os.path.join(root, cam, "data", f"{k:010d}.png")
            img = to_uint8(provider.load_image((kind, k)))
            png.write_png(path, img)
            written.append((path, img))
    sync = provider.imu_sync
    os.makedirs(os.path.join(root, "oxts", "data"))
    _kitti_stamps(os.path.join(root, "oxts", "timestamps.txt"), sync.t)
    row = np.zeros((1, 30))
    for i in range(len(sync.t)):
        row[0, 11:14], row[0, 17:20] = sync.acc[i], sync.gyr[i]
        np.savetxt(os.path.join(root, "oxts", "data", f"{i:010d}.txt"), row)
    return written


# Params dataclass field -> key of the reference's YAML files, the inverse
# of each from_yaml (kimera_vio_tpu_torch/config/params.py).
YAML_KEYS = {
    "PipelineParams.yaml": ("pipeline", {k: k for k in (
        "frontend_type", "backend_type", "display_type", "parallel_run")}),
    "ImuParams.yaml": ("imu", {
        "preintegration_type": "imu_preintegration_type", "rate_hz": "rate_hz",
        "gyro_noise_density": "gyroscope_noise_density",
        "gyro_random_walk": "gyroscope_random_walk",
        "acc_noise_density": "accelerometer_noise_density",
        "acc_random_walk": "accelerometer_random_walk",
        "imu_integration_sigma": "imu_integration_sigma",
        "imu_bias_init_sigma": "imu_bias_init_sigma", "imu_time_shift_s": "imu_time_shift",
        "n_gravity": "n_gravity", "T_BS": "T_BS",
        "do_imu_rate_time_alignment": "do_imu_rate_time_alignment",
        "time_alignment_window_size_s": "time_alignment_window_size_s",
        "time_alignment_variance_threshold_scaling": "time_alignment_variance_threshold_scaling"}),
    "LeftCameraParams.yaml": ("left_cam", None),
    "RightCameraParams.yaml": ("right_cam", None),
    "FrontendParams.yaml": ("frontend", {
        "klt_win_size": "klt_win_size", "klt_max_iter": "klt_max_iter",
        "klt_max_level": "klt_max_level", "klt_eps": "klt_eps", "max_feature_age": "maxFeatureAge",
        "feature_detector_type": "feature_detector_type",
        "max_features_per_frame": "maxFeaturesPerFrame", "quality_level": "quality_level",
        "min_distance": "min_distance", "block_size": "block_size",
        "use_harris_detector": "use_harris_detector", "k": "k", "fast_thresh": "fast_thresh",
        "equalize_image": "equalizeImage",
        "max_nr_keypoints_before_anms": "max_nr_keypoints_before_anms",
        "enable_non_max_suppression": "enable_non_max_suppression",
        "non_max_suppression_type": "non_max_suppression_type",
        "nr_horizontal_bins": "nr_horizontal_bins", "nr_vertical_bins": "nr_vertical_bins",
        "enable_subpixel_corner_finder": "enable_subpixel_corner_finder",
        "subpix_max_iters": "max_iters", "subpix_eps": "epsilon_error",
        "subpix_window_size": "window_size", "nominal_baseline": "nominalBaseline",
        "tolerance_template_matching": "toleranceTemplateMatching",
        "templ_cols": "templ_cols", "templ_rows": "templ_rows",
        "stripe_extra_rows": "stripe_extra_rows", "min_point_dist": "minPointDist",
        "max_point_dist": "maxPointDist", "bidirectional_matching": "bidirectionalMatching",
        "subpixel_refinement_stereo": "subpixelRefinementStereo", "use_ransac": "useRANSAC",
        "min_nr_mono_inliers": "minNrMonoInliers", "min_nr_stereo_inliers": "minNrStereoInliers",
        "ransac_threshold_mono": "ransac_threshold_mono",
        "ransac_threshold_stereo": "ransac_threshold_stereo",
        "ransac_use_1point_stereo": "ransac_use_1point_stereo",
        "ransac_use_2point_mono": "ransac_use_2point_mono",
        "ransac_max_iterations": "ransac_max_iterations",
        "ransac_probability": "ransac_probability", "ransac_randomize": "ransac_randomize",
        "min_intra_keyframe_time_s": "min_intra_keyframe_time",
        "max_intra_keyframe_time_s": "max_intra_keyframe_time",
        "max_disparity_since_lkf": "max_disparity_since_lkf",
        "min_number_features": "minNumberFeatures", "use_stereo_tracking": "useStereoTracking",
        "disparity_threshold": "disparityThreshold",
        "optical_flow_predictor_type": "optical_flow_predictor_type",
        "use_pnp_tracking": "use_pnp_tracking", "min_pnp_inliers": "min_pnp_inliers",
        "ransac_threshold_pnp": "ransac_threshold_pnp"}),
    "BackendParams.yaml": ("backend", {
        "backend_modality": "backend_modality", "auto_initialize": "autoInitialize",
        "round_on_auto_initialize": "roundOnAutoInitialize",
        "initial_position_sigma": "initialPositionSigma",
        "initial_roll_pitch_sigma": "initialRollPitchSigma", "initial_yaw_sigma": "initialYawSigma",
        "initial_velocity_sigma": "initialVelocitySigma",
        "initial_acc_bias_sigma": "initialAccBiasSigma",
        "initial_gyro_bias_sigma": "initialGyroBiasSigma",
        "linearization_mode": "linearizationMode", "degeneracy_mode": "degeneracyMode",
        "rank_tolerance": "rankTolerance",
        "landmark_distance_threshold": "landmarkDistanceThreshold",
        "outlier_rejection": "outlierRejection",
        "retriangulation_threshold": "retriangulationThreshold",
        "smart_noise_sigma": "smartNoiseSigma", "mono_noise_sigma": "monoNoiseSigma",
        "mono_norm_type": "monoNormType", "mono_norm_param": "monoNormParam",
        "stereo_noise_sigma": "stereoNoiseSigma", "stereo_norm_type": "stereoNormType",
        "stereo_norm_param": "stereoNormParam", "regularity_noise_sigma": "regularityNoiseSigma",
        "regularity_norm_type": "regularityNormType",
        "regularity_norm_param": "regularityNormParam",
        "add_between_stereo_factors": "addBetweenStereoFactors",
        "between_rotation_precision": "betweenRotationPrecision",
        "between_translation_precision": "betweenTranslationPrecision",
        "relinearize_threshold": "relinearizeThreshold", "relinearize_skip": "relinearizeSkip",
        "zero_velocity_precision": "zero_velocity_precision",
        "no_motion_position_precision": "no_motion_position_precision",
        "no_motion_rotation_precision": "no_motion_rotation_precision",
        "constant_vel_precision": "constant_vel_precision", "num_optimize": "numOptimize",
        "nr_states": "nr_states", "wildfire_threshold": "wildfire_threshold",
        "use_dog_leg": "useDogLeg", "pose_guess_source": "pose_guess_source",
        "mono_translation_scale_factor": "mono_translation_scale_factor"}),
    "LcdParams.yaml": ("lcd", {
        "use_nss": "use_nss", "alpha": "alpha", "min_temporal_matches": "min_temporal_matches",
        "recent_frames_window": "recent_frames_window", "max_db_results": "max_db_results",
        "min_nss_factor": "min_nss_factor", "min_matches_per_island": "min_matches_per_island",
        "max_intraisland_gap": "max_intraisland_gap",
        "max_nrFrames_between_islands": "max_nrFrames_between_islands",
        "max_nrFrames_between_queries": "max_nrFrames_between_queries",
        "geom_check": "geom_check", "min_correspondences": "min_correspondences",
        "ransac_threshold_mono": "ransac_threshold_mono",
        "ransac_inlier_threshold_mono": "ransac_inlier_threshold_mono",
        "ransac_inlier_threshold_stereo": "ransac_inlier_threshold_stereo",
        "pose_recovery_type": "pose_recovery_type", "refine_pose": "refine_pose",
        "between_rotation_precision": "betweenRotationPrecision", "lowe_ratio": "lowe_ratio",
        "matcher_type": "matcher_type", "nfeatures": "nfeatures", "scale_factor": "scale_factor",
        "nlevels": "nlevels", "min_distance": "min_distance",
        "pgo_rot_threshold": "pgo_rot_threshold", "pgo_trans_threshold": "pgo_trans_threshold",
        "gnc_alpha": "gnc_alpha"}),
    "DisplayParams.yaml": ("display", {k: k for k in (
        "display_type", "hold_2d_display", "hold_3d_display")}),
}


def _yaml_value(key: str, v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return f"{key}: {int(v)}"
    if isinstance(v, np.ndarray) and v.ndim == 2:
        rows = [", ".join(repr(float(x)) for x in r) for r in v]
        data = (",\n         ").join(rows)
        return (f"{key}: !!opencv-matrix\n  rows: {v.shape[0]}\n  cols: {v.shape[1]}\n"
                f"  dt: d\n  data: [{data}]")
    if isinstance(v, np.ndarray):
        return f"{key}: [{', '.join(repr(float(x)) for x in v)}]"
    if isinstance(v, float):
        return f"{key}: {float(v)!r}"
    return f"{key}: {v}"


def write_params_folder(params: VioParams, folder: str) -> None:
    """Write `params` as a reference-layout folder of OpenCV-FileStorage
    YAML files (`%YAML:1.0`, comments, opencv-matrix nodes, multi-line
    flow lists) that `VioParams.from_folder` reads back to equal values."""
    os.makedirs(folder, exist_ok=True)
    for name, (attr, keys) in YAML_KEYS.items():
        sub = getattr(params, attr)
        if sub is None:
            continue
        if keys is None:  # a camera
            lines = [f"camera_id: {sub.camera_id}", _yaml_value("T_BS", sub.T_BS),
                     _yaml_value("rate_hz", float(sub.rate_hz)),
                     f"resolution: [{sub.width}, {sub.height}]",
                     f"camera_model: {sub.camera_model}",
                     _yaml_value("intrinsics", sub.intrinsics) + " # fu, fv, cu, cv",
                     f"distortion_model: {sub.distortion_model}",
                     _yaml_value("distortion_coefficients", sub.distortion_coeffs),
                     _yaml_value("omni_distortion_center", sub.omni_distortion_center),
                     _yaml_value("omni_affine", sub.omni_affine)]
        else:
            lines = [_yaml_value(key, getattr(sub, field)) for field, key in keys.items()]
        with open(os.path.join(folder, name), "w") as f:
            f.write("%YAML:1.0\n# " + name + ", written by chip_smoke.py\n" + "\n".join(lines) + "\n")


@contextlib.contextmanager
def recording_pipeline():
    """Record, per pipeline run: the pipeline, its output and wall time."""
    rec = {"runs": []}
    orig = {n: getattr(StereoImuPipeline, n) for n in ("run", "run_chunked")}

    def wrap_run(name):
        def run(self, *a, **kw):
            t0 = time.perf_counter()
            out = orig[name](self, *a, **kw)
            torch.cuda.synchronize()
            rec["runs"].append({"pipe": self, "out": out, "wall": time.perf_counter() - t0})
            return out
        return run

    StereoImuPipeline.run, StereoImuPipeline.run_chunked = wrap_run("run"), wrap_run("run_chunked")
    try:
        yield rec
    finally:
        for n, f in orig.items():
            setattr(StereoImuPipeline, n, f)


def cli_main(args: list) -> int:
    """`python -m kimera_vio_tpu_torch` in-process. The CLI sets flags in
    the process-wide registry (use_lcd, log_output, output_path, ...);
    they are restored afterwards, so that no later phase runs with them."""
    saved = {name: f.value for name, f in cli_flags._REGISTRY.items()}
    try:
        return cli.main(args)
    finally:
        for name, value in saved.items():
            cli_flags._REGISTRY[name].value = value

def check_cli_run(mode: str, rec: dict, rc: int, launches: int, gt, out_dir: str) -> dict:
    """Gates every CLI run passes: one run, LK launches = tracked frames,
    a finite trajectory within the ATE gate, traj_vio.csv with every
    keyframe. Returns the run's numbers."""
    if rc != 0 or len(rec["runs"]) != 1:
        raise AssertionError(f"{mode}: main returned {rc} after {len(rec['runs'])} runs")
    run = rec["runs"][0]
    pipe, out = run["pipe"], run["out"]
    tracked = out.n_frames - 1
    est = np.stack(out.positions)
    if launches != tracked:
        raise AssertionError(f"{mode}: LK launches {launches} != {tracked} tracked frames")
    if not np.isfinite(est).all():
        raise AssertionError(f"{mode}: trajectory not finite")
    ate = compute_ate(np.array(out.stamps_ns), est, gt.stamps_ns, gt.positions, align=False)
    if not ate["rmse"] < 0.05:
        raise AssertionError(f"{mode}: ATE rmse {ate['rmse']} m >= 0.05 m")
    with open(os.path.join(out_dir, "traj_vio.csv")) as f:
        if len(f.read().splitlines()) != out.n_keyframes + 1:
            raise AssertionError(f"{mode}: traj_vio.csv does not hold every keyframe")
    row = {"mode": mode, "frames": out.n_frames, "keyframes": out.n_keyframes,
           "wall_s": run["wall"], "frames_per_s": out.n_frames / run["wall"],
           "ate_rmse_m": ate["rmse"], "lk_launches": launches,
           "parallel_run": pipe.parallel_run}
    for tag in ("stage h2d [ms]", "stage wire [MB]", "stage encode [ms]", "readback [ms]"):
        a = pipe.stats.get(tag)
        row[tag] = a.total / a.count if a.count else None
    row["super_batches"] = pipe.stats.get("stage wire [MB]").count
    return row


def run_cli(mode: str, args: list, gt, out_dir: str):
    """`python -m kimera_vio_tpu_torch` in-process with the LK counter
    set to 0 just before; returns (numbers, the output)."""
    with recording_pipeline() as rec:
        reset_lk_counts()
        rc = cli_main(args + ["--log_output", "--output_path", out_dir])
        launches = lk_launches()
    return check_cli_run(mode, rec, rc, launches, gt, out_dir), rec["runs"][0]["out"]


def write_folders(root: str, provider, params: VioParams) -> tuple[str, str, float]:
    """The EuRoC folder and params folder of one sequence, with the exact
    gates: params read back equal, every PNG decodes to the array written.
    Returns (dataset, params folder, PNG decode ms per image)."""
    data, pfolder = os.path.join(root, "euroc"), os.path.join(root, "params")
    written = write_euroc(data, provider)
    write_params_folder(params, pfolder)
    back = VioParams.from_folder(pfolder)
    # Capacities are no params-file keys; the CLI takes them as flags.
    back.max_features, back.max_landmarks = params.max_features, params.max_landmarks
    if not back.equals(params):
        raise AssertionError("VioParams.from_folder differs from the params written")
    reader = EurocDataProvider(data)
    t0 = time.perf_counter()
    for p, img in written:
        if not np.array_equal(reader.load_image(p), img):
            raise AssertionError(f"decoded PNG differs from the array written: {p}")
    return data, pfolder, (time.perf_counter() - t0) * 1e3 / len(written)


def cli_phase(dev, path: dict, work: str) -> dict:
    """Phase 3 (see the module docstring). The EuRoC folder stays under
    `work` for phases 8 and 10 (`path["euroc"]`, its params folder
    `path["euroc_params"]` and ground truth `path["gt"]`)."""
    params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    params.pipeline.parallel_run = True  # the reference EuRoC default
    caps = ["--max_features", "256", "--max_landmarks", "384", "--device", dev.type]
    res = {}
    tmp = os.path.join(work, "cli")
    provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
    data, pfolder, png_ms = write_folders(os.path.join(tmp, "path"), provider, params)
    path["euroc"], path["euroc_params"], path["gt"] = data, pfolder, provider.ground_truth
    log(f"[cli] params folder and 160 PNGs exact; PNG decode {png_ms:.3f} ms per image")
    base = ["--params_folder", pfolder, "--dataset_path", data] + caps
    for mode, extra in (("run", []), ("chunked", ["--chunked", "--chunk_size", "16"]),
                        ("sequential", ["--parallel_run", "0"])):
        row, out = run_cli(mode, base + extra, provider.ground_truth, os.path.join(tmp, mode))
        if mode != "chunked" and row["parallel_run"] != (mode == "run"):
            raise AssertionError(f"{mode}: parallel_run is {row['parallel_run']}")
        if out.stamps_ns != path["stamps_ns"]:
            raise AssertionError(f"{mode}: keyframe stamps differ from phase 2's")
        row["max_abs_dpos_vs_path_m"] = float(np.abs(np.stack(out.positions) - path["positions"]).max())
        if not row["max_abs_dpos_vs_path_m"] < 1e-3:
            raise AssertionError(f"{mode}: positions differ from phase 2's by "
                                 f"{row['max_abs_dpos_vs_path_m']} m")
        row["png_decode_ms_per_image"] = png_ms
        res[mode] = row
        log(f"[cli] {json.dumps(row)}")
    return res


# ---------------------------------------------------------------------------
# Phase 4: loop closure and PGO
# ---------------------------------------------------------------------------


def orbit_provider(n_frames: int = 240) -> SyntheticPlanar6DofProvider:
    """The loop fixture of tests/test_pipeline_e2e.py:336-392: 752x480,
    one 4 s period on every axis (an exact orbit), three laps at 20 fps."""
    w = 2 * np.pi / 4.0
    noise = _NoiseModel(imu_rate=200.0, pixel_noise_std=0.3, acc_noise_density=2.0e-3,
                        gyro_noise_density=1.6968e-4, seed=3)
    return SyntheticPlanar6DofProvider(n_frames=n_frames, noise=noise, trans_amp=(0.8, 0.4, 0.2),
                                       rot_amp=(0.05, 0.06, 0.08), trans_freq=(w, w, w),
                                       rot_freq=(w, w, w))


@contextlib.contextmanager
def timed_lcd_extract():
    """CUDA events around every call of the keyframe branch's fused LCD
    front half; yields the (start, end) pairs."""
    events = []
    orig = StereoFrontend._lcd_extract

    def timed(self, left_rect, right_rect):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(self, left_rect, right_rect)
        end.record()
        events.append((start, end))
        return out

    StereoFrontend._lcd_extract = timed
    try:
        yield events
    finally:
        StereoFrontend._lcd_extract = orig


def _mean(pipe, tag):
    a = pipe.stats.get(tag)
    return a.total / a.count if a.count else None


def _verify_split(pipe) -> dict:
    """The per-candidate verification times split: the first candidate
    of the run alone, the mean of the others and the median of all
    (None where the statistics window no longer holds every sample)."""
    a = pipe.stats.get("lcd verify [ms]")
    if not a.count or a.count != len(a.samples):
        return {"verify_ms_first": None, "verify_ms_mean_after_first": None,
                "verify_ms_median": None}
    s = a.samples
    return {"verify_ms_first": s[0],
            "verify_ms_mean_after_first": float(np.mean(s[1:])) if len(s) > 1 else None,
            "verify_ms_median": float(np.median(s))}


def linalg_first_use_ms(dev) -> dict:
    """Host time, ending in a sync, of the first and the second call in
    this process of each batched solver and sampler that loop
    verification calls (ops/ransac.py: eigh, svd, det, multinomial on a
    seeded generator) at verification's shapes: what a process pays once
    on its first verification."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randn(128, 9, 9, device=dev)
    calls = {"eigh_128x9x9": lambda: torch.linalg.eigh(a @ a.transpose(-1, -2)),
             "eigh_9x9": lambda: torch.linalg.eigh(a[0] @ a[0].T),
             "svd_128x3x3": lambda: torch.linalg.svd(a[:, :3, :3]),
             "svd_3x3": lambda: torch.linalg.svd(a[0, :3, :3]),
             "det_128x3x3": lambda: torch.linalg.det(a[:, :3, :3]),
             "multinomial_generator": lambda: torch.multinomial(
                 torch.ones(500, device=dev), 1024, replacement=True, generator=gen)}
    out = {}
    for name, fn in calls.items():
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - tic) * 1e3)
        out[name] = times
    return out


def run_cli_lcd(mode: str, args: list, gt, out_dir: str, phase2_fps: float) -> tuple[dict, dict]:
    """The CLI with --use_lcd, LK counter set to 0 just before; gates one
    run. Returns (numbers, lcd_result)."""
    with recording_pipeline() as rec, timed_lcd_extract() as events:
        reset_lk_counts()
        rc = cli_main(args + ["--log_output", "--output_path", out_dir])
        launches = lk_launches()
    if rc != 0 or len(rec["runs"]) != 1:
        raise AssertionError(f"lcd {mode}: main returned {rc} after {len(rec['runs'])} runs")
    run = rec["runs"][0]
    pipe, out = run["pipe"], run["out"]
    if launches != out.n_frames - 1:
        raise AssertionError(f"lcd {mode}: LK launches {launches} != {out.n_frames - 1} tracked frames")
    res = pipe.lcd_result
    if res is None or not res["loops"]:
        raise AssertionError(f"lcd {mode}: no loop verified")
    est = np.stack(out.positions)
    if not (np.isfinite(est).all() and np.isfinite(res["pos"]).all()):
        raise AssertionError(f"lcd {mode}: trajectory not finite")
    ate_vio = compute_ate(np.array(out.stamps_ns), est, gt.stamps_ns, gt.positions, align=False)["rmse"]
    ate_pgo = compute_ate(np.array(res["stamps"]), res["pos"], gt.stamps_ns, gt.positions,
                          align=False)["rmse"]
    if not ate_pgo <= 1.25 * ate_vio + 1e-4:
        raise AssertionError(f"lcd {mode}: ATE(PGO) {ate_pgo} m > 1.25 ATE(VIO) {ate_vio} m + 1e-4")
    with open(os.path.join(out_dir, "traj_pgo.csv")) as f:
        n_pgo = len(f.read().splitlines()) - 1
    with open(os.path.join(out_dir, "output_lcd_result.csv")) as f:
        n_loops = len(f.read().splitlines()) - 1
    if n_pgo != len(res["stamps"]) or n_pgo != out.n_keyframes - 1:
        raise AssertionError(f"lcd {mode}: traj_pgo.csv has {n_pgo} rows for "
                             f"{out.n_keyframes - 1} LCD keyframes")
    if n_loops != len(res["loops"]):
        raise AssertionError(f"lcd {mode}: output_lcd_result.csv has {n_loops} rows for "
                             f"{len(res['loops'])} loops")
    extract_ms = [a.elapsed_time(b) for a, b in events]
    if len(extract_ms) != out.n_keyframes - 1:
        raise AssertionError(f"lcd {mode}: {len(extract_ms)} LCD extractions for "
                             f"{out.n_keyframes - 1} keyframes")
    row = {"mode": mode, "frames": out.n_frames, "keyframes": out.n_keyframes,
           "loops": len(res["loops"]), "wall_s": run["wall"],
           "frames_per_s": out.n_frames / run["wall"], "phase2_frames_per_s_without_lcd": phase2_fps,
           "ate_vio_m": ate_vio, "ate_pgo_m": ate_pgo, "lk_launches": launches,
           "lcd_extract_ms_per_keyframe": float(np.mean(extract_ms)),
           "lcd_extract_ms_max": float(np.max(extract_ms)),
           "bow_query_ms_per_keyframe": _mean(pipe, "lcd bow+query [ms]"),
           "verify_ms_per_candidate": _mean(pipe, "lcd verify [ms]"), **_verify_split(pipe),
           "verify_ms_max": pipe.stats.get("lcd verify [ms]").vmax,
           "candidates": pipe.stats.get("lcd verify [ms]").count,
           "pgo_ms": _mean(pipe, "lcd pgo [ms]"), "pgo_K": len(res["stamps"]),
           "parallel_run": pipe.parallel_run}
    log(f"[lcd] {json.dumps(row)}")
    return row, res


def orb_card_vs_cpu(data: str, stamp_ns: int) -> dict:
    """Share of equal descriptor bits between the card's orb_descriptors
    and the port's CPU run on the same image (the first LCD keyframe's
    left PNG; the synthetic rig needs no rectification) and keypoints;
    and the card's time of orb_descriptors and of its orientation
    moments (`centroid_moments`, one add per patch pixel) on them."""
    img = EurocDataProvider(data).load_image(os.path.join(data, "mav0", "cam0", "data",
                                                          f"{stamp_ns}.png"))
    dev = torch.device("cuda")
    left = torch.from_numpy(img).to(dev, torch.float32)
    uv, ok = det.detect_features(left, torch.zeros((8, 2), device=dev),
                                 torch.zeros(8, dtype=torch.bool, device=dev), 500,
                                 min_distance=12.0, do_subpixel=False)
    d_card, _, ok_card = orb.orb_descriptors(left, uv, ok)
    d_cpu, _, ok_cpu = orb.orb_descriptors(left.cpu(), uv.cpu(), ok.cpu())
    if not torch.equal(ok_card.cpu(), ok_cpu):
        raise AssertionError("ORB ok masks differ between the card and the CPU")
    keep = ok_cpu.numpy()
    bits = [np.unpackbits(d.cpu().numpy()[keep].view(np.uint8), axis=1) for d in (d_card, d_cpu)]
    patch = orb.patches(left, uv)
    return {"orb_bits_equal_card_vs_cpu": float((bits[0] == bits[1]).mean()),
            "orb_keypoints": int(ok.shape[0]),
            "orb_descriptors_ms": time_ms(lambda: orb.orb_descriptors(left, uv, ok), 20),
            "orb_centroid_moments_ms": time_ms(lambda: orb.centroid_moments(patch), 20)}


def large_map_pass(dev) -> dict:
    """300 keyframes of a three-lap 6-DoF orbit through LcdModule at
    752x480 (tests/test_lcd_large_map.py at full width): recall and
    precision against the analytic poses, the PGO at K=300."""
    n_kf, period, fps = 300, 100, 20.0
    f = 2.0 * np.pi * fps / period
    prov = SyntheticPlanar6DofProvider(
        n_frames=n_kf, fps=fps, plane_z=3.0, trans_amp=(0.8, 0.4, 0.2), rot_amp=(0.05, 0.07, 0.3),
        trans_freq=(f, 2 * f, 3 * f), rot_freq=(f, 2 * f, f), trans_phase=(0.0, 1.0, 0.4),
        rot_phase=(0.3, 0.0, 0.7))
    params = synthetic_params()
    stereo = StereoCamera.from_params(params.left_cam, params.right_cam, dev)
    cfg = LcdConfig(recent_frames_window=30, min_temporal_matches=1, alpha=0.1, min_inliers=20,
                    arun_threshold_m=0.10, n_features=256)
    mod = LcdModule(stereo, cfg=cfg, device=dev)
    gt = prov.ground_truth
    rots = [quat_to_rot(torch.as_tensor(q, dtype=torch.float64)).numpy() for q in gt.quats_wxyz]
    fired = []
    t0 = time.perf_counter()
    for k in range(n_kf):
        res = mod.add_keyframe(prov.load_image(("left", k)), prov.load_image(("right", k)),
                               rots[k].astype(np.float32), gt.positions[k].astype(np.float32),
                               int(gt.stamps_ns[k]))
        if res is not None:
            fired.append(res)
    wall = time.perf_counter() - t0
    if mod.lcd.n_kf != n_kf:
        raise AssertionError(f"large map: {mod.lcd.n_kf} keyframes in the database, not {n_kf}")
    if not fired:
        raise AssertionError("large map: no loop fired")
    t1 = time.perf_counter()
    result = mod.finish()
    finish_ms = (time.perf_counter() - t1) * 1e3

    def pose_err(r):
        q, m = r.query_id, r.match_id
        best = (np.inf, np.inf)
        for Rgt, tgt in ((rots[q].T @ rots[m], rots[q].T @ (gt.positions[m] - gt.positions[q])),
                         (rots[m].T @ rots[q], rots[m].T @ (gt.positions[q] - gt.positions[m]))):
            ang = np.arccos(np.clip((np.trace(Rgt.T @ r.R_match_query) - 1) / 2, -1, 1))
            best = min(best, (ang, np.linalg.norm(r.t_match_query - tgt)))
        return best

    # A loop is right when its pose is (0.10 rad, 0.15 m); recall counts the
    # revisit queries (laps 2-3) that fired a right loop.
    right = [e[0] < 0.10 and e[1] < 0.15 for e in map(pose_err, fired)]
    hit = {r.query_id for r, ok in zip(fired, right) if ok}
    row = {"keyframes": n_kf, "fired": len(fired), "precision": sum(right) / len(fired),
           "recall": len([q for q in range(period, n_kf) if q in hit]) / (n_kf - period),
           "pgo_ms_K300": finish_ms, "pgo_K": len(result["stamps"]),
           "wall_s": wall, "ms_per_keyframe": wall * 1e3 / n_kf}
    log(f"[lcd] {json.dumps(row)}")
    return row


def lcd_phase(dev, path: dict) -> dict:
    params = synthetic_params(nr_states=10, max_features=128, max_landmarks=192)
    params.pipeline.parallel_run = True  # the reference EuRoC default
    caps = ["--max_features", "128", "--max_landmarks", "192", "--device", dev.type, "--use_lcd"]
    res = {"runs": {}}
    with tempfile.TemporaryDirectory(prefix="kimera_lcd_") as tmp:
        provider = orbit_provider()
        data, pfolder, png_ms = write_folders(os.path.join(tmp, "orbit"), provider, params)
        log(f"[lcd] params folder and 480 PNGs exact; PNG decode {png_ms:.3f} ms per image")
        base = ["--params_folder", pfolder, "--dataset_path", data] + caps
        first_use = linalg_first_use_ms(dev)
        log(f"[lcd] {json.dumps({'linalg_first_use_ms_first_second': first_use})}")
        results = {}
        for mode, extra in (("sequential", ["--parallel_run", "0"]), ("run", []),
                            ("chunked", ["--chunked", "--chunk_size", "16"])):
            row, results[mode] = run_cli_lcd(mode, base + extra, provider.ground_truth,
                                             os.path.join(tmp, mode), path["frames_per_s"])
            res["runs"][mode] = row
        ref = results["sequential"]
        pairs = [(l.query_id, l.match_id) for l in ref["loops"]]
        dpgo = {}
        for mode, r in results.items():
            if [(l.query_id, l.match_id) for l in r["loops"]] != pairs:
                raise AssertionError(f"lcd {mode}: loop pairs differ from the sequential run's")
            dpgo[mode] = float(np.abs(r["pos"] - ref["pos"]).max())
            if not dpgo[mode] < 1e-3:
                raise AssertionError(f"lcd {mode}: PGO positions differ from the sequential run's "
                                     f"by {dpgo[mode]} m")
        orb_row = orb_card_vs_cpu(data, ref["stamps"][0])
        log(f"[lcd] {json.dumps({'max_abs_dpgo_vs_sequential_m': dpgo, **orb_row, 'loop_pairs': pairs})}")
        if not orb_row["orb_bits_equal_card_vs_cpu"] >= 0.995:
            raise AssertionError(f"ORB bits card vs CPU: {orb_row['orb_bits_equal_card_vs_cpu']} < 0.995")
    res["large_map"] = large_map_pass(dev)
    return res


# ---------------------------------------------------------------------------
# Phase 5: the variants (mono, RGB-D, online init, pose sources, time sync)
# ---------------------------------------------------------------------------

#: Time sync on phase 4's orbit (IMU and camera on one clock: true offset
#: 0). With the reference's variance gate (scaling 30) the noisy gyro
#: signal never clears it and no estimate lands, as in a CPU rehearsal of
#: the JAX package on the orbit (scripts/rehearse_time_sync.py); with the gate scaled to 1
#: an estimate lands once half the 10 s window is full and the estimator
#: restarts. The estimate's gate: one keyframe interval, the resolution of
#: a visual rotation signal sampled at keyframes.
TIME_SYNC_GATE_S = 0.25
TIME_SYNC_FRAMES = 120  # the aligner first tries at 5 s (100 frames)


class Prerendered:
    """A synthetic provider with every image rendered before the run, so
    that a run's wall time holds no host rendering (the 6-DoF provider
    renders each image by ray-plane intersection on the host)."""

    def __init__(self, provider):
        self.ground_truth, self.imu_sync = provider.ground_truth, provider.imu_sync
        self.packets = list(provider.frames())
        self.images = {p[k]: provider.load_image(p[k]) for p in self.packets
                       for k in ("left_path", "right_path")}

    def frames(self):
        return iter(self.packets)

    def load_image(self, key):
        return self.images[key]


@contextlib.contextmanager
def counted_steps():
    """Count the frames a run feeds the pipeline: those it tracks (calls
    of `_step`, each one LK launch) and those that bootstrap it (one, or
    two after a time-alignment restart)."""
    rec = {"steps": 0, "bootstraps": 0}
    orig_step, orig_boot = StereoImuPipeline._step, StereoImuPipeline._bootstrap

    def step(self, *a, **kw):
        rec["steps"] += 1
        return orig_step(self, *a, **kw)

    def boot(self, *a, **kw):
        rec["bootstraps"] += 1
        return orig_boot(self, *a, **kw)

    StereoImuPipeline._step, StereoImuPipeline._bootstrap = step, boot
    try:
        yield rec
    finally:
        StereoImuPipeline._step, StereoImuPipeline._bootstrap = orig_step, orig_boot


def run_variant(name: str, make_pipe, provider, gt, phase2_fps: float, ate_gate: float | None,
                extra=None) -> tuple[dict, object, object]:
    """One sequential run() of a variant, the LK counter set to 0 just
    before; gates LK launches == tracked frames, a finite trajectory and
    the ATE gate. Returns (numbers, output, pipeline)."""
    pipe = make_pipe()
    with counted_steps() as rec:
        torch.cuda.synchronize()
        reset_lk_counts()
        t0 = time.perf_counter()
        out = pipe.run(provider)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lk_launches()
    if launches != rec["steps"]:
        raise AssertionError(f"{name}: LK launches {launches} != {rec['steps']} tracked frames")
    est = np.stack(out.positions)
    if not np.isfinite(est).all():
        raise AssertionError(f"{name}: trajectory not finite")
    ate = compute_ate(np.array(out.stamps_ns), est, gt.stamps_ns, gt.positions, align=False)["rmse"]
    if ate_gate is not None and not ate < ate_gate:
        raise AssertionError(f"{name}: ATE rmse {ate} m >= {ate_gate} m")
    kf = pipe.stats.get("VioFrontend Keyframe Rate [ms]")
    fed = rec["steps"] + rec["bootstraps"]
    row = {"variant": name, "frames_fed": fed, "frames": out.n_frames, "bootstraps": rec["bootstraps"],
           "keyframes": out.n_keyframes, "wall_s": wall, "frames_per_s": fed / wall,
           "path_frames_per_s": phase2_fps, "keyframe_step_ms": kf.total / kf.count if kf.count else None,
           "ate_rmse_m": ate, "ate_gate_m": ate_gate, "lk_launches": launches, **(extra or {})}
    return row, out, pipe


def variants_phase(dev, path: dict) -> dict:
    """Phase 5 (see the module docstring)."""
    from kimera_vio_tpu_torch.dataprovider.odometry import OdometryBuffer
    from kimera_vio_tpu_torch.dataprovider.rgbd import RgbdDataProvider
    from kimera_vio_tpu_torch.pipeline.rgbd_pipeline import RgbdImuPipeline

    fps2 = path["frames_per_s"]
    res = {}

    def params(**backend):
        p = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
        for k, v in backend.items():
            setattr(p.backend if hasattr(p.backend, k) else p.frontend, k, v)
        return p

    def emit(row):
        res[row["variant"]] = row
        log(f"[variants] {json.dumps(row)}")

    with tempfile.TemporaryDirectory(prefix="kimera_variants_") as tmp:
        # Mono through the CLI, three modes, on phase 2's sequence as a
        # EuRoC folder and a mono params folder (no RightCameraParams.yaml).
        provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
        p = params()
        p.pipeline.parallel_run = True
        data, pfolder, png_ms = write_folders(os.path.join(tmp, "mono"), provider, p)
        os.remove(os.path.join(pfolder, "RightCameraParams.yaml"))
        if VioParams.from_folder(pfolder).right_cam is not None:
            raise AssertionError("mono params folder still holds a right camera")
        base = ["--params_folder", pfolder, "--dataset_path", data, "--max_features", "256",
                "--max_landmarks", "384", "--device", dev.type]
        outs = {}
        for mode, extra in (("sequential", ["--parallel_run", "0"]), ("run", []),
                            ("chunked", ["--chunked", "--chunk_size", "16"])):
            with recording_pipeline() as rec:
                reset_lk_counts()
                rc = cli_main(base + extra + ["--log_output", "--output_path", os.path.join(tmp, mode)])
                launches = lk_launches()
            row = check_cli_run(f"mono {mode}", rec, rc, launches, provider.ground_truth,
                                os.path.join(tmp, mode))
            if type(rec["runs"][0]["pipe"]).__name__ != "MonoImuPipeline":
                raise AssertionError(f"mono {mode}: the CLI ran {type(rec['runs'][0]['pipe']).__name__}")
            outs[mode] = rec["runs"][0]["out"]
            kf = rec["runs"][0]["pipe"].stats.get("VioFrontend Keyframe Rate [ms]")
            emit({"variant": f"mono_cli_{mode}", **row, "path_frames_per_s": fps2,
                  "keyframe_step_ms": kf.total / kf.count if kf.count else None,
                  "ate_gate_m": 0.05, "png_decode_ms_per_image": png_ms})
        ref = outs["sequential"]
        for mode, out in outs.items():
            d = float(np.abs(np.stack(out.positions) - np.stack(ref.positions)).max()) \
                if out.stamps_ns == ref.stamps_ns else None
            if d is None or not d < 1e-3:
                raise AssertionError(f"mono {mode}: keyframes differ from the sequential run's ({d})")
            res[f"mono_cli_{mode}"]["max_abs_dpos_vs_sequential_m"] = d
        log(f"[variants] {json.dumps({m: res[f'mono_cli_{m}']['max_abs_dpos_vs_sequential_m'] for m in outs})}")

        # RGB-D: phase 2's left images and a 16-bit depth stream (5 m in mm,
        # a 60 m hole) through RgbdDataProvider.
        written = write_rgbd(os.path.join(tmp, "rgbd"), provider)
        rgbd = RgbdDataProvider(os.path.join(tmp, "rgbd"), depth_factor=1e-3, max_depth=20.0)
        for path_, img in written[-2:]:
            if not np.array_equal(rgbd.load_image(path_), img.astype(np.float32) * np.float32(1e-3)
                                  * (img < 20000)):
                raise AssertionError(f"depth PNG decodes differently: {path_}")
        row, _, _ = run_variant("rgbd", lambda: RgbdImuPipeline(params(), parallel_run=False, device=dev),
                                rgbd, provider.ground_truth, fps2, 0.05)
        emit(row)

    gt = SyntheticStereoProvider(n_frames=80, vx=0.5).ground_truth
    # Online initialization (autoInitialize: 2, num_frames_vio_init 8).
    row, out, _ = run_variant(
        "online_init", lambda: StereoImuPipeline(params(auto_initialize=2), parallel_run=False, device=dev),
        SyntheticStereoProvider(n_frames=80, vx=0.5), gt, fps2, None)
    v_err = float(np.abs(np.asarray(out.velocities[-1]) - gt.velocities[-1]).max())
    row.update(init_frames=row["frames_fed"] - out.n_frames + 1, final_velocity_err_m_s=v_err)
    if not (1 < out.n_frames < row["frames_fed"] and v_err < 0.1):
        raise AssertionError(f"online init: {out.n_frames} of {row['frames_fed']} frames published, "
                             f"final velocity off by {v_err} m/s")
    emit(row)
    # Between-stereo factors with the STEREO guess; PnP tracking with the
    # PnP guess; external odometry from the ground truth.
    row, _, _ = run_variant(
        "between_stereo_guess", lambda: StereoImuPipeline(params(
            add_between_stereo_factors=True, between_translation_precision=100.0, pose_guess_source=2),
            parallel_run=False, device=dev),
        SyntheticStereoProvider(n_frames=80, vx=0.5), gt, fps2, 0.06)
    emit(row)
    accepted = []
    orig = StereoImuPipeline._pnp_pose

    def pnp(self, *a):
        R, t, ok = orig(self, *a)
        accepted.append(ok)
        return R, t, ok
    StereoImuPipeline._pnp_pose = pnp
    try:
        row, _, _ = run_variant(
            "pnp_guess", lambda: StereoImuPipeline(params(
                use_pnp_tracking=True, min_pnp_inliers=10, pose_guess_source=3),
                parallel_run=False, device=dev),
            SyntheticStereoProvider(n_frames=80, vx=0.5), gt, fps2, 0.06)
    finally:
        StereoImuPipeline._pnp_pose = orig
    row["pnp_guesses_accepted"] = int(sum(bool(a) for a in accepted))
    row["pnp_keyframes"] = len(accepted)
    emit(row)
    odo_prov = SyntheticStereoProvider(n_frames=80, vx=0.5)
    buf = OdometryBuffer()
    for i, t in enumerate(gt.stamps_ns):
        buf.add(int(t), quat_to_rot(torch.as_tensor(np.asarray(gt.quats_wxyz[i], np.float32))).numpy(),
                gt.positions[i])
    odo_prov.odometry = buf
    row, _, pipe = run_variant(
        "ext_odometry", lambda: StereoImuPipeline(params(), parallel_run=False, device=dev),
        odo_prov, gt, fps2, 0.06)
    if not bool(pipe._last_win.ext_valid.any()):
        raise AssertionError("ext_odometry: no odometry factor in the window")
    emit(row)
    # Fine IMU-camera time alignment on phase 4's orbit (3-pt stereo): the
    # reference's variance gate, then the gate scaled to 1.
    orbit = Prerendered(orbit_provider(n_frames=TIME_SYNC_FRAMES))
    aligner_ms = []
    orig_feed = StereoImuPipeline._feed_aligner

    def feed(self, *a):
        tic = time.perf_counter()
        try:
            return orig_feed(self, *a)
        finally:
            aligner_ms.append((time.perf_counter() - tic) * 1e3)
    for name, scaling in (("time_sync_orbit", None), ("time_sync_orbit_gate1", 1.0)):
        p = synthetic_params(nr_states=10, max_features=128, max_landmarks=192)
        if scaling is not None:
            p.imu.time_alignment_variance_threshold_scaling = scaling
        cli_flags.set_flag("do_fine_imu_camera_temporal_sync", True)
        StereoImuPipeline._feed_aligner = feed
        aligner_ms.clear()
        try:
            row, out, pipe = run_variant(
                name, lambda: StereoImuPipeline(p, parallel_run=False, device=dev),
                orbit, orbit.ground_truth, fps2, None)
        finally:
            cli_flags.set_flag("do_fine_imu_camera_temporal_sync", False)
            StereoImuPipeline._feed_aligner = orig_feed
        est = pipe.time_shift_estimate_s
        row.update(variance_threshold_scaling=p.imu.time_alignment_variance_threshold_scaling,
                   time_shift_estimate_s=est, time_shift_gate_s=TIME_SYNC_GATE_S,
                   three_point_stereo=not pipe.frontend_cfg.use_1point_stereo,
                   aligner_feed_ms_total=float(np.sum(aligner_ms)),
                   aligner_feed_ms_max=float(np.max(aligner_ms)))
        emit(row)
        if not row["three_point_stereo"]:
            raise AssertionError(f"{name}: the 3-pt stereo solver was not forced")
        if scaling is None and (est is not None or out.n_frames != TIME_SYNC_FRAMES):
            raise AssertionError(f"{name}: estimate {est} s, {out.n_frames} frames published; the "
                                 "variance gate should withhold it on this orbit")
        if scaling is not None and (est is None or not abs(est) <= TIME_SYNC_GATE_S
                                    or not 1 < out.n_frames < TIME_SYNC_FRAMES):
            raise AssertionError(f"{name}: estimate {est} s (gate +-{TIME_SYNC_GATE_S} s), "
                                 f"{out.n_frames} frames published after the restart")
    return res


# ---------------------------------------------------------------------------
# Phase 6: the mesher and RegularVIO
# ---------------------------------------------------------------------------

#: The noisy near plane of tests/test_regular_vio.py:240-252 at the bench
#: width: a textured plane 1.8 m ahead, 0.25 m/s, pixel and IMU noise.
MESHER_NOISE = dict(imu_rate=200.0, pixel_noise_std=0.5, acc_noise_density=2e-3,
                    gyro_noise_density=1.6968e-4, seed=5)


class Quantized:
    """A synthetic provider whose images are rounded to uint8, as its EuRoC
    folder's PNGs hold them: a run on it and the CLI on the folder see the
    same pixels."""

    def __init__(self, provider):
        self.base = provider
        self.ground_truth, self.imu_sync = provider.ground_truth, provider.imu_sync
        self.left_stamps = provider.left_stamps

    def frames(self):
        return self.base.frames()

    def load_image(self, key):
        return to_uint8(self.base.load_image(key))


def near_plane_provider() -> Quantized:
    """The scene with the IMU blocks' capacity of the params (32 samples;
    the provider's default is 16), as the CLI's EuRoC provider takes it:
    the card sums the zero-padded blocks in an order that depends on their
    length, which alone moves this noisy scene's keyframes by ~1 mm."""
    return Quantized(SyntheticStereoProvider(
        n_frames=80, vx=0.25, depth=1.8, noise=_NoiseModel(**MESHER_NOISE),
        max_imu_per_frame=near_plane_params(1).max_imu_per_frame))


def near_plane_params(backend_type: int) -> VioParams:
    p = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    p.pipeline.backend_type = backend_type
    p.frontend.min_point_dist = 0.3
    return p


def inv3_first_use_ms(dev) -> dict:
    """Host time, ending in a sync, of the first and second call in this
    process of a batched 3x3 `torch.linalg.inv` at RegularVIO's shape (384
    landmark blocks) and of the closed-form inverse the port uses there
    (`smoother._inv3_sym`), and their largest relative difference."""
    from kimera_vio_tpu_torch.backend.smoother import _inv3_sym

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    a = torch.randn(384, 3, 5, device=dev, generator=g)
    H = a @ a.transpose(-1, -2) + 1e-6 * torch.eye(3, device=dev)
    out = {}
    for name, fn in (("linalg_inv_384x3x3", lambda: torch.linalg.inv(H)),
                     ("closed_form_384x3x3", lambda: _inv3_sym(H.permute(1, 2, 0)).permute(2, 0, 1))):
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - tic) * 1e3)
        out[name] = times
    ref = torch.linalg.inv(H)
    rel = ((_inv3_sym(H.permute(1, 2, 0)).permute(2, 0, 1) - ref).abs()
           / ref.abs().amax(dim=(1, 2), keepdim=True)).max()
    out["closed_form_max_rel_diff"] = float(rel)
    if not out["closed_form_max_rel_diff"] < 1e-4:
        raise AssertionError(f"closed-form 3x3 inverse off by {rel} (relative)")
    return out


@contextlib.contextmanager
def timed_mesher():
    """Per keyframe, the host time of the mesher (Delaunay, filter,
    horizon), the RegularVIO refine and the dense depth, each ending in
    `torch.cuda.synchronize`."""
    from kimera_vio_tpu_torch.mesher.mesher import Mesher

    rec = {"mesher": [], "refine": [], "dense_depth": [], "first_pair": None}
    orig = {"mesher": Mesher.spin_once, "refine": StereoImuPipeline._regular_refine,
            "dense_depth": StereoImuPipeline._dense_depth_for_kf}

    def timed(name):
        def fn(self, *a, **kw):
            if name == "dense_depth" and rec["first_pair"] is None:
                rec["first_pair"] = a[:2]
            torch.cuda.synchronize()
            tic = time.perf_counter()
            res = orig[name](self, *a, **kw)
            torch.cuda.synchronize()
            rec[name].append((time.perf_counter() - tic) * 1e3)
            return res
        return fn

    Mesher.spin_once = timed("mesher")
    StereoImuPipeline._regular_refine = timed("refine")
    StereoImuPipeline._dense_depth_for_kf = timed("dense_depth")
    try:
        yield rec
    finally:
        Mesher.spin_once = orig["mesher"]
        StereoImuPipeline._regular_refine = orig["refine"]
        StereoImuPipeline._dense_depth_for_kf = orig["dense_depth"]


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3), faces (F, 3)) of an ASCII PLY as MesherLogger
    writes it; raises where it does not parse."""
    with open(path) as f:
        lines = f.read().splitlines()
    nv, nf = int(lines[2].split()[-1]), int(lines[6].split()[-1])
    if lines[:2] != ["ply", "format ascii 1.0"] or lines[8] != "end_header" \
            or len(lines) != 9 + nv + nf:
        raise AssertionError(f"{path}: not a MesherLogger PLY")
    v = np.array([[float(x) for x in ln.split()] for ln in lines[9:9 + nv]]).reshape(nv, 3)
    f = np.array([[int(x) for x in ln.split()] for ln in lines[9 + nv:]]).reshape(nf, 4)
    if not (np.isfinite(v).all() and (f[:, 0] == 3).all() and (f[:, 1:] < max(nv, 1)).all()):
        raise AssertionError(f"{path}: bad vertices or faces")
    return v, f[:, 1:]


def check_plys(name: str, out_dir: str, n_keyframes: int) -> dict:
    """One PLY per keyframe after the bootstrap, each parsed back."""
    mesh_dir = os.path.join(out_dir, "mesh")
    names = sorted(os.listdir(mesh_dir))
    if names != [f"mesh_{k:05d}.ply" for k in range(n_keyframes - 1)]:
        raise AssertionError(f"{name}: {len(names)} PLYs for {n_keyframes} keyframes")
    faces = [len(read_ply(os.path.join(mesh_dir, n))[1]) for n in names]
    if not max(faces) > 0:
        raise AssertionError(f"{name}: every mesh is empty")
    return {"plys": len(names), "triangles_last": faces[-1], "triangles_max": max(faces)}


def mesher_row(name: str, pipe, out, wall: float, launches: int, tracked: int, gt, fps2: float,
               rec: dict | None) -> dict:
    est = np.stack(out.positions)
    if launches != tracked:
        raise AssertionError(f"{name}: LK launches {launches} != {tracked} tracked frames")
    if not np.isfinite(est).all():
        raise AssertionError(f"{name}: trajectory not finite")
    ate = compute_ate(np.array(out.stamps_ns), est, gt.stamps_ns, gt.positions, align=False)["rmse"]
    if not ate < 0.05:
        raise AssertionError(f"{name}: ATE rmse {ate} m >= 0.05 m")
    kf = pipe.stats.get("VioFrontend Keyframe Rate [ms]")
    row = {"run": name, "frames": out.n_frames, "keyframes": out.n_keyframes, "wall_s": wall,
           "frames_per_s": out.n_frames / wall, "path_frames_per_s": fps2,
           "keyframe_step_ms": kf.total / kf.count if kf.count else None, "ate_rmse_m": ate,
           "lk_launches": launches, "regular_vio": pipe.use_regular_vio}
    if rec is not None:
        for k in ("mesher", "refine", "dense_depth"):
            row[f"{k}_ms_per_keyframe"] = float(np.mean(rec[k])) if rec[k] else None
            row[f"{k}_calls"] = len(rec[k])
    if pipe._mesher is not None:
        row["horizon_triangles_end"] = pipe._mesher.horizon_mesh().n_triangles
    if pipe._plane_tracker is not None:
        row["active_planes_end"] = int(pipe._plane_tracker.active.sum())
        row["plane_hits"] = pipe._plane_tracker.hits.tolist()
    return row


def run_mesher(dev, name: str, params, provider, fps2: float, out_dir: str | None,
               enable_mesher: bool = True) -> tuple[dict, object, object, dict]:
    """One sequential run(), the LK counter set to 0 just before."""
    pipe = StereoImuPipeline(params, parallel_run=False, device=dev,
                             enable_mesher=enable_mesher, output_path=out_dir)
    with counted_steps() as steps, timed_mesher() as rec:
        torch.cuda.synchronize()
        reset_lk_counts()
        t0 = time.perf_counter()
        out = pipe.run(provider)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lk_launches()
    row = mesher_row(name, pipe, out, wall, launches, steps["steps"], provider.ground_truth, fps2,
                     rec if enable_mesher else None)
    return row, out, pipe, rec


def dense_depth_card_vs_cpu(pipe, pair) -> dict:
    """The first keyframe's dense depth on CUDA tensors against the same
    function on CPU copies of its rectified pair; its card time."""
    from kimera_vio_tpu_torch.ops.stereo_matching import dense_depth

    left, right = pair
    lr = remap_bilinear(left, pipe._dense_maps[0])
    rr = remap_bilinear(right, pipe._dense_maps[1])
    fp = pipe.params.frontend
    kw = dict(fx=float(pipe.stereo.fx), baseline=float(pipe.stereo.baseline),
              min_depth=float(fp.min_point_dist), max_depth=float(fp.max_point_dist),
              num_disparities=int(cli_flags.get_flag("dense_stereo_num_disparities")),
              block_size=int(cli_flags.get_flag("dense_stereo_block_size")))
    d_card = dense_depth(lr, rr, **kw).cpu()
    d_cpu = dense_depth(lr.cpu(), rr.cpu(), **kw)
    agree = float(((d_card > 0) == (d_cpu > 0)).float().mean())
    both = (d_card > 0) & (d_cpu > 0)
    err = float((d_card - d_cpu).abs()[both].max()) if bool(both.any()) else 0.0
    res = {"valid_agreement": agree, "max_abs_depth_diff_m": err,
           "valid_share": float((d_card > 0).float().mean()),
           "card_ms": time_ms(lambda: dense_depth(lr, rr, **kw), reps=10)}
    if not (agree >= 0.995 and err <= 1e-3 and res["valid_share"] > 0.05):
        raise AssertionError(f"dense depth card vs CPU: {res}")
    return res


def mesher_phase(dev, path: dict) -> dict:
    """Phase 6 (see the module docstring)."""
    fps2 = path["frames_per_s"]
    res = {"inv3_first_use_ms": inv3_first_use_ms(dev)}
    log(f"[mesher] {json.dumps(res)}")
    with tempfile.TemporaryDirectory(prefix="kimera_mesher_") as tmp:
        provider = near_plane_provider()
        gt = provider.ground_truth
        # (a) the plain backend, then RegularVIO with the mesher.
        plain, _, _, _ = run_mesher(dev, "run_plain", near_plane_params(0), provider, fps2, None,
                                    enable_mesher=False)
        log(f"[mesher] {json.dumps(plain)}")
        reg_dir = os.path.join(tmp, "run_regular")
        reg, out_reg, pipe, _ = run_mesher(dev, "run_regular", near_plane_params(1), provider, fps2,
                                           reg_dir)
        reg.update(check_plys("run_regular", reg_dir, out_reg.n_keyframes))
        if not max(reg["plane_hits"]) >= 5:
            raise AssertionError(f"run_regular: plane hits {reg['plane_hits']}")
        if not reg["ate_rmse_m"] <= 1.2 * plain["ate_rmse_m"] + 5e-4:
            raise AssertionError(f"ATE regular {reg['ate_rmse_m']} > 1.2 x plain "
                                 f"{plain['ate_rmse_m']} + 5e-4")
        log(f"[mesher] {json.dumps(reg)}")
        res["run_plain"], res["run_regular"] = plain, reg

        # (b) the CLI with --enable_mesher on the same scene as a EuRoC folder.
        p = near_plane_params(1)
        p.pipeline.parallel_run = True
        data, pfolder, png_ms = write_folders(os.path.join(tmp, "cli"), provider, p)
        base = ["--params_folder", pfolder, "--dataset_path", data, "--max_features", "256",
                "--max_landmarks", "384", "--device", dev.type, "--enable_mesher"]
        for mode, extra in (("cli_parallel", []), ("cli_sequential", ["--parallel_run", "0"]),
                            ("cli_chunked", ["--chunked", "--chunk_size", "16"])):
            out_dir = os.path.join(tmp, mode)
            with recording_pipeline() as rec_runs, timed_mesher() as rec:
                reset_lk_counts()
                rc = cli_main(base + extra + ["--log_output", "--output_path", out_dir])
                launches = lk_launches()
            if rc != 0 or len(rec_runs["runs"]) != 1:
                raise AssertionError(f"{mode}: main returned {rc} after {len(rec_runs['runs'])} runs")
            run = rec_runs["runs"][0]
            row = mesher_row(mode, run["pipe"], run["out"], run["wall"], launches,
                             run["out"].n_frames - 1, gt, fps2, rec)
            row.update(check_plys(mode, out_dir, run["out"].n_keyframes))
            row["png_decode_ms_per_image"] = png_ms
            out = run["out"]
            if mode == "cli_chunked":
                if out.n_keyframes != out_reg.n_keyframes or \
                        not row["ate_rmse_m"] <= 1.3 * reg["ate_rmse_m"] + 1e-3:
                    raise AssertionError(f"{mode}: {out.n_keyframes} keyframes (run: "
                                         f"{out_reg.n_keyframes}), ATE {row['ate_rmse_m']} vs "
                                         f"run {reg['ate_rmse_m']}")
            else:
                if out.stamps_ns != out_reg.stamps_ns:
                    raise AssertionError(f"{mode}: keyframe stamps differ from run_regular's")
                d = float(np.abs(np.stack(out.positions) - np.stack(out_reg.positions)).max())
                row["max_abs_dpos_vs_run_m"] = d
                if not d < 1e-3:
                    raise AssertionError(f"{mode}: positions differ from run_regular's by {d} m")
            log(f"[mesher] {json.dumps(row)}")
            res[mode] = row

        # (c) RegularVIO with the mesh refined against dense stereo depth.
        cli_flags.set_flag("use_dense_depth_mesh_refinement", True)
        try:
            dense, _, pipe, rec = run_mesher(dev, "run_dense_depth", near_plane_params(1), provider,
                                             fps2, None)
        finally:
            cli_flags.set_flag("use_dense_depth_mesh_refinement", False)
        if not dense["dense_depth_calls"] > 0:
            raise AssertionError("run_dense_depth: no dense depth computed")
        dense["dense_depth_card_vs_cpu"] = dense_depth_card_vs_cpu(pipe, rec["first_pair"])
        log(f"[mesher] {json.dumps(dense)}")
        res["run_dense_depth"] = dense
    return res


# ---------------------------------------------------------------------------
# Phase 7: the options the port used to refuse
# ---------------------------------------------------------------------------

# The <24, 56> kernel time per 752x480 frame at commit b6f00a3, before the
# wide instantiation was added (chip_smoke phase 1 on an H100 80GB HBM3 at
# 700 W), printed beside this run's.
MAIN_KERNEL_MS_BEFORE_WIDE = 0.04017

# Inline OCamCalib parameters of a 1280x960 fisheye (the z-polynomial
# a0..a4, decreasing and positive out to the image corners; the
# distortion centre; the affine [c, d, e]); no pinhole intrinsics.
OMNI = dict(camera_model="omni", width=1280, height=960, intrinsics=np.zeros(0),
            distortion_model="omni",
            distortion_coeffs=np.array([310.0, 0.0, -1.1e-3, 2.5e-7, -4.0e-10]),
            omni_distortion_center=np.array([641.3, 478.6]),
            omni_affine=np.array([-3.0e-4, 2.0e-4, 0.9996]))


@contextlib.contextmanager
def timed_anms():
    """Host-clock time of every ANMS call (types 0-5), the device
    synchronised before and after: the greedy passes run on the host."""
    rec = {"calls": 0, "ms": 0.0}
    orig = anms.suppress_non_max

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep = orig(*a, **kw)
        torch.cuda.synchronize()
        rec["ms"] += (time.perf_counter() - t0) * 1e3
        rec["calls"] += 1
        return keep

    anms.suppress_non_max = timed
    try:
        yield rec
    finally:
        anms.suppress_non_max = orig


def omni_on_card(dev) -> dict:
    """The omni camera on the card: pixels -> omni_backproject_normalized
    -> points -> omni_project round trip, and the rectification map built
    with the camera on the card against the one built on the CPU."""
    from kimera_vio_tpu_torch.config.params import CameraParams
    from kimera_vio_tpu_torch.frontend import camera as cam_mod
    from scipy.spatial.transform import Rotation

    p = CameraParams(**OMNI)
    cam = cam_mod.PinholeCamera.from_params(p, device=dev)
    cam_cpu = cam_mod.PinholeCamera.from_params(p, device="cpu")
    rng = np.random.default_rng(5)
    r, a = rng.uniform(5.0, 420.0, 4096), rng.uniform(0, 2 * np.pi, 4096)
    uv = torch.from_numpy((np.stack([r * np.cos(a), r * np.sin(a)], -1)
                           + OMNI["omni_distortion_center"]).astype(np.float32)).to(dev)
    depth = torch.from_numpy(rng.uniform(1.0, 8.0, 4096).astype(np.float32)).to(dev)
    xy = cam_mod.omni_backproject_normalized(cam, uv)
    pts = torch.cat([xy, torch.ones_like(xy[:, :1])], -1) * depth[:, None]
    uv2, ok = cam_mod.omni_project(cam, pts)
    torch.cuda.synchronize()
    err = float(torch.linalg.norm(uv2 - uv, dim=-1).max())
    if not (bool(ok.all()) and err < 1e-3):
        raise AssertionError(f"omni round trip: max {err} px, all inside {bool(ok.all())}")
    pin = synthetic_params(width=1280, height=960, fx=400.0)
    R = Rotation.from_rotvec([0.01, -0.02, 0.015]).as_matrix().astype(np.float32)
    maps = {}
    for name, c, d in (("card", cam, dev), ("cpu", cam_cpu, torch.device("cpu"))):
        st = StereoCamera.from_params(pin.left_cam, pin.right_cam, device=d)
        maps[name] = cam_mod.rectification_map(st, c, torch.from_numpy(R).to(d))
    map_err = float(np.abs(maps["card"] - maps["cpu"]).max())
    if not map_err < 1e-3:
        raise AssertionError(f"omni rectification map card vs CPU: max {map_err} px")
    return {"omni_round_trip_max_px": err, "omni_points": 4096, "omni_map_card_vs_cpu_max_px": map_err}


def options_phase(dev, path: dict, kern: dict) -> dict:
    """Phase 7 (see the module docstring)."""
    fps2 = path["frames_per_s"]
    res = {"main_kernel_ms": kern["ms"], "main_kernel_ms_at_b6f00a3": MAIN_KERNEL_MS_BEFORE_WIDE}
    log(f"[options] {json.dumps(res)}")
    # (1) the wide windows, kernel against the plain version.
    prev_pyr, cur_pyr, uv, valid = main_lk_inputs(dev)
    wide = {}
    # At win 54 the 56-row window rule admits a keypoint only where its
    # search window is clamped at the image edge (its first check needs
    # floor(frac(y) + 28 - 26.5) <= 56 - 54 - 2), as in the Pallas tracker:
    # positions are compared over every valid keypoint there.
    for label, kw in (("752x480 win 41", dict(win=41)),
                      ("752x480 win 54", dict(win=54, over_valid=True)),
                      ("752x480 win 41 gather rule", dict(win=41, search_rows=None)),
                      ("752x480 win 54 gather rule", dict(win=54, search_rows=None))):
        wide[label] = compare_lk(prev_pyr, cur_pyr, uv, valid, label, **kw)
    for label in ("752x480 win 41 gather rule", "752x480 win 54 gather rule"):
        if any(lv["mode"] != "xla" for lv in wide[label]["levels"]):
            raise AssertionError(f"{label}: the gather rule tracks every level as an XLA level")
    wide["1241x376 win 41"] = compare_lk(*kitti_lk_inputs(dev, margin=30.0), "1241x376 win 41",
                                         win=41)
    res["wide"] = wide

    # (2) runs at phase 2's width, each with the LK counter set to 0.
    provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
    gt = provider.ground_truth
    runs = {
        "a_combined_imu": (dict(imu=dict(preintegration_type=0)), 0.05),
        "b_fast_ssc": (dict(frontend=dict(feature_detector_type=0, non_max_suppression_type=5)), None),
        "c_orb_brown": (dict(frontend=dict(feature_detector_type=1, non_max_suppression_type=1)), None),
        "d_harris_sdc": (dict(frontend=dict(use_harris_detector=True, non_max_suppression_type=2)),
                         None),
        "e_topn": (dict(frontend=dict(enable_non_max_suppression=False)), None),
        "f_klt_win_41": (dict(frontend=dict(klt_win_size=41)), 0.05),
    }
    for name, (over, gate) in runs.items():
        p = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
        for group, fields in over.items():
            for k, v in fields.items():
                setattr(getattr(p, group), k, v)
        with timed_anms() as rec:
            row, out, pipe = run_variant(name, lambda: StereoImuPipeline(p, parallel_run=False,
                                                                         device=dev),
                                         provider, gt, fps2, gate)
        if out.n_keyframes < 1:
            raise AssertionError(f"{name}: no keyframe")
        cfg = pipe.frontend_cfg
        row.update(detector_type=cfg.detector_type, anms_type=cfg.anms_type, klt_win=cfg.klt_win,
                   combined_pim=pipe.backend_cfg.combined_pim, anms_calls=rec["calls"],
                   anms_ms_per_keyframe=rec["ms"] / rec["calls"] if rec["calls"] else None)
        res[name] = row
        log(f"[options] {json.dumps(row)}")
    # (g) the Combined factor through the CLI's chunked mode.
    p = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    p.pipeline.parallel_run = True
    p.imu.preintegration_type = 0
    with tempfile.TemporaryDirectory(prefix="kimera_options_") as tmp:
        data, pfolder, _ = write_folders(os.path.join(tmp, "path"), provider, p)
        args = ["--params_folder", pfolder, "--dataset_path", data, "--max_features", "256",
                "--max_landmarks", "384", "--device", dev.type, "--chunked", "--chunk_size", "16"]
        with recording_pipeline() as rec:
            reset_lk_counts()
            rc = cli_main(args + ["--log_output", "--output_path", os.path.join(tmp, "out")])
            launches = lk_launches()
        row = check_cli_run("g_combined_cli_chunked", rec, rc, launches, gt, os.path.join(tmp, "out"))
        if not rec["runs"][0]["pipe"].backend_cfg.combined_pim:
            raise AssertionError("g_combined_cli_chunked: the params folder did not set the flag")
    res["g_combined_cli_chunked"] = row
    log(f"[options] {json.dumps(row)}")

    # (3) state_covariance after phase 2's run.
    pipe = path["pipe"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cov, ok = pipe.state_covariance(return_ok=True)
    cov_ms = (time.perf_counter() - t0) * 1e3
    if not (ok and cov.shape == (15, 15) and np.isfinite(cov).all()
            and np.array_equal(cov, cov.T) and (np.diag(cov) > 0).all()):
        raise AssertionError(f"state_covariance: ok {ok}, diag {np.diag(cov)}")
    res["state_covariance"] = {"ms": cov_ms, "ok": ok, "pos_sigma_m": np.sqrt(np.diag(cov)[3:6]).tolist()}
    log(f"[options] {json.dumps(res['state_covariance'])}")

    # (4) the omni camera on the card.
    res["omni"] = omni_on_card(dev)
    log(f"[options] {json.dumps(res['omni'])}")
    return res


# ---------------------------------------------------------------------------
# Phase 8: the last host modules (KITTI, live, overlays, visualizer)
# ---------------------------------------------------------------------------

#: KITTI odometry's image size and calibration (sequences 00-02: fx 718.856,
#: baseline 0.537 m), 10 Hz frames and 100 Hz OXTS; a scene 15 m ahead at
#: 2 m/s: 25.7 px of disparity, 9.6 px of flow a frame
#: the visualizer run's display cadence (phase 8 (c))
VIZ_SAVE_EVERY = 4

KITTI = dict(width=1241, height=376, fx=718.856, baseline=0.537, fps=10.0, imu_rate=100.0,
             depth=15.0, vx=2.0, n_frames=40)


def kitti_params() -> VioParams:
    return synthetic_params(width=KITTI["width"], height=KITTI["height"], fx=KITTI["fx"],
                            baseline=KITTI["baseline"], nr_states=10, max_features=256,
                            max_landmarks=384)


@contextlib.contextmanager
def timed_lk(name: str = "lk_pyramid_cuda"):
    """Wrap the LK wrapper `lk.<name>` (`lk_pyramid_cuda`, or the default
    tracker's `lk_cached_cuda`) for one run: CUDA events around each call
    (the kernel's in-run time, launch included), the last call's level
    shapes and window rule, and per (win, search_rows) its calls
    (search_rows "cached" for the default tracker). The launch and route
    counters then live on the wrapper (the kernel's wrapper adds to
    `lk.<name>.launches`, `.launches_by_device` and `.routes`, the
    module's name); they start at 0."""
    rec = {"events": [], "rules": collections.Counter()}
    orig = getattr(lk, name)
    cached = name == "lk_cached_cuda"

    def wrapped(first, second, *a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(first, second, *a, **kw)
        end.record()
        rec["events"].append((start, end))
        rule = "cached" if cached else kw["search_rows"]
        # The planes: lk_pyramid_cuda's prev_pyr, lk_cached_cuda's cur_pyr.
        rec.update(shapes=[tuple(p.shape) for p in (second if cached else first)],
                   win=kw["win"], search_rows=rule)
        rec["rules"][(kw["win"], rule)] += 1
        return out

    wrapped.launches, wrapped.routes, wrapped.report = 0, collections.Counter(), {}
    wrapped.launches_by_device = collections.Counter()
    setattr(lk, name, wrapped)
    try:
        yield rec
    finally:
        setattr(lk, name, orig)
        rec["launches"], rec["routes"] = wrapped.launches, wrapped.routes
        rec["report"] = wrapped.report
    torch.cuda.synchronize()
    rec["ms"] = [s.elapsed_time(e) for s, e in rec["events"]]


def shifted_gt(gt, offset_ns: int) -> GroundTruth:
    """A ground truth with its stamps moved by `offset_ns`."""
    return GroundTruth(stamps_ns=gt.stamps_ns + offset_ns, positions=gt.positions,
                       quats_wxyz=gt.quats_wxyz, velocities=gt.velocities,
                       gyro_bias=gt.gyro_bias, accel_bias=gt.accel_bias)


def run_counted(pipe, provider, entry: str = "run", **kw) -> dict:
    """One run with the LK counter set to 0 just before; gates LK launches
    == tracked frames and a finite trajectory. Returns the run's numbers,
    output and wall time."""
    with counted_steps() as steps:
        torch.cuda.synchronize()
        reset_lk_counts()
        t0 = time.perf_counter()
        out = getattr(pipe, entry)(provider, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lk_launches()
    if launches != steps["steps"]:
        raise AssertionError(f"LK launches {launches} != {steps['steps']} tracked frames")
    est = np.stack(out.positions)
    if not (out.n_keyframes >= 1 and np.isfinite(est).all()):
        raise AssertionError("no keyframe or a trajectory not finite")
    return {"out": out, "wall": wall, "launches": launches, "fed": steps["steps"] + steps["bootstraps"]}


def kitti_phase(dev, path: dict, graph_ms: float, work: str, impl: str | None = None) -> dict:
    """Phase 8 (a) (see the module docstring) with the default tracker
    (`lk_cached_kernel`), or with `impl` "pallas" phase 12's runs of B1 at
    level 0 (with ground truth, and under the profiler; not the run
    without); `graph_ms` is phase 1's graph-replay ms of that kernel at
    1241x376."""
    from kimera_vio_tpu_torch.dataprovider.kitti import KittiDataProvider

    src = SyntheticStereoProvider(**KITTI)
    root = os.path.join(work, "kitti" if impl is None else f"kitti_{impl}")
    t0 = time.perf_counter()
    written = write_kitti(root, src)
    write_s = time.perf_counter() - t0
    prov = KittiDataProvider(root)
    offset = int(prov.left_stamps[0]) - int(src.left_stamps[0])
    if not (np.array_equal(prov.left_stamps - offset, src.left_stamps)
            and np.array_equal(prov.imu_sync.t - offset, src.imu_sync.t)
            and np.array_equal(prov.imu_sync.acc, src.imu_sync.acc)
            and np.array_equal(prov.imu_sync.gyr, src.imu_sync.gyr)):
        raise AssertionError("KITTI folder: stamps or OXTS rows do not read back exactly")
    t0 = time.perf_counter()
    for p, img in written:
        if not np.array_equal(prov.load_image(p), img):
            raise AssertionError(f"KITTI folder: decoded PNG differs from the array written: {p}")
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(written)
    params = kitti_params()
    wrapper = "lk_pyramid_cuda" if impl == "pallas" else "lk_cached_cuda"
    with lk_impl(impl):
        # The source run directly, images rounded as the PNGs hold them.
        ref = run_counted(StereoImuPipeline(params, parallel_run=False, device=dev),
                          Quantized(src))
    res = {}
    runs = [("gt", shifted_gt(src.ground_truth, offset))] + ([("no_gt", None)] if impl is None
                                                             else [])
    for name, gt in runs:
        prov = KittiDataProvider(root)
        prov.ground_truth = gt
        with lk_impl(impl):
            pipe = StereoImuPipeline(params, parallel_run=False, device=dev)
        with timed_lk(wrapper) as rec:
            r = run_counted(pipe, prov)
        out = r["out"]
        if impl == "pallas":
            plan = lk.level_table(rec["shapes"], rec["win"], rec["search_rows"])
            modes = {lv.level: lv.mode for lv in plan}
            if modes[0] != "gather":
                raise AssertionError(f"KITTI {name}: level 0 is {modes[0]}, not the gather mode (B1)")
        else:
            modes = {lvl: "cached" for lvl in range(len(rec["shapes"]))}
            if dict(rec["routes"]) != {"lk_cached warp": r["launches"]}:
                raise AssertionError(f"KITTI {name}: lk_cached routes {dict(rec['routes'])}")
        if rec["launches"] != r["launches"] or len(rec["rules"]) != 1:
            raise AssertionError(f"KITTI: the timed wrapper missed launches, or they took "
                                 f"several rules: {dict(rec['rules'])}")
        kf = pipe.stats.get("VioFrontend Keyframe Rate [ms]")
        fr = pipe.stats.get("VioFrontend Frame Rate [ms]")
        row = {"run": name, "shape": [KITTI["height"], KITTI["width"]], "frames": out.n_frames,
               "keyframes": out.n_keyframes, "lk_launches": r["launches"],
               "level_modes": [modes[k] for k in sorted(modes)], "wall_s": r["wall"],
               "frames_per_s": r["fed"] / r["wall"], "path_frames_per_s": path["frames_per_s"],
               "frame_step_ms": fr.total / fr.count if fr.count else None,
               "keyframe_step_ms": kf.total / kf.count if kf.count else None,
               "lk_impl": impl or "matmul", "kernel": wrapper,
               "lk_launch_and_kernel_ms_per_frame": float(np.mean(rec["ms"])),
               "lk_launch_and_kernel_ms_median": float(np.median(rec["ms"])),
               "lk_graph_ms_phase1": graph_ms}
        if gt is not None:
            est = np.stack(out.positions)
            row["ate_rmse_m"] = compute_ate(np.array(out.stamps_ns), est, gt.stamps_ns,
                                            gt.positions, align=False)["rmse"]
            if not row["ate_rmse_m"] < 0.05:
                raise AssertionError(f"KITTI: ATE rmse {row['ate_rmse_m']} m >= 0.05 m")
            if [t - offset for t in out.stamps_ns] != ref["out"].stamps_ns:
                raise AssertionError("KITTI: keyframe stamps differ from the source run's")
            row["max_abs_dpos_vs_source_m"] = float(np.abs(est - np.stack(ref["out"].positions)).max())
            if not row["max_abs_dpos_vs_source_m"] < 1e-3:
                raise AssertionError(f"KITTI: positions differ from the source run's by "
                                     f"{row['max_abs_dpos_vs_source_m']} m")
            row.update(write_s=write_s, png_decode_ms_per_image=decode_ms,
                       source_frames_per_s=ref["fed"] / ref["wall"])
        res[name] = row
        log(f"[kitti] {json.dumps(row)}")
    res["profile"] = kitti_kernel_profile(dev, params, root, shifted_gt(src.ground_truth, offset),
                                          graph_ms, impl)
    return res


def kitti_kernel_profile(dev, params, root: str, gt, graph_ms: float,
                         impl: str | None = None) -> dict:
    """The KITTI run with ground truth once more, under `torch.profiler`:
    the LK kernel's device time per launch (B1's under "pallas",
    lk_cached_kernel's by default), read from the trace's kernel events.
    Its launches must equal the run's; a trace without device events
    leaves the time null ("not measured")."""
    from torch.profiler import ProfilerActivity, profile

    from kimera_vio_tpu_torch.dataprovider.kitti import KittiDataProvider

    prov = KittiDataProvider(root)
    prov.ground_truth = gt
    with lk_impl(impl):
        pipe = StereoImuPipeline(params, parallel_run=False, device=dev)
    # lk_cached_kernel's routes are two kernels: lk_cached_kernel and
    # lk_cached_warp_kernel.
    kernel = "lk_pyramid_kernel" if impl == "pallas" else "lk_cached"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = run_counted(pipe, prov)
    # The trace's raw events: `prof.events()` would first turn all of them
    # (~140k kernels and their host ops) into Python objects, ~100 s.
    dev_events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
    us = [e.duration_ns() * 1e-3 for e in dev_events if kernel in e.name()]
    if us and len(us) != r["launches"]:
        raise AssertionError(f"KITTI profile: {len(us)} kernel events for {r['launches']} launches")
    row = {"run": "gt_profiled", "kernel": kernel, "lk_launches": r["launches"],
           "device_events": len(dev_events), "kernel_events": len(us),
           "kernel_ms_per_frame": float(np.mean(us)) * 1e-3 if us else None,
           "kernel_ms_median": float(np.median(us)) * 1e-3 if us else None,
           "kernel_ms_max": float(np.max(us)) * 1e-3 if us else None,
           "graph_ms_phase1": graph_ms, "wall_s_profiled": r["wall"]}
    log(f"[kitti] {json.dumps(row)}")
    return row


def live_phase(dev, path: dict) -> dict:
    """Phase 8 (b) (see the module docstring)."""
    import threading

    from kimera_vio_tpu_torch.dataprovider.live import LiveDataProvider, replay

    provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
    live = LiveDataProvider(stereo=True, max_queued_frames=128)
    live.ground_truth = provider.ground_truth  # phase 2's bootstrap
    params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    pipe = StereoImuPipeline(params, parallel_run=False, device=dev)
    feeder = threading.Thread(target=replay, args=(provider, live), daemon=True)
    feeder.start()
    r = run_counted(pipe, live)
    feeder.join(timeout=30.0)
    out = r["out"]
    if feeder.is_alive() or live.dropped_frames or live.dropped_imu:
        raise AssertionError(f"live: feeder alive {feeder.is_alive()}, dropped frames "
                             f"{live.dropped_frames}, IMU {live.dropped_imu}")
    if out.stamps_ns != path["stamps_ns"]:
        raise AssertionError("live: keyframe stamps differ from phase 2's")
    dpos = float(np.abs(np.stack(out.positions) - path["positions"]).max())
    if not dpos < 1e-3:
        raise AssertionError(f"live: positions differ from phase 2's by {dpos} m")
    # stop() with a frame that can never sync (no right frame, no IMU past
    # it): frames() must drop it and return.
    MS = 1_000_000
    stuck = LiveDataProvider(stereo=True)
    for t in range(0, 120, 5):
        stuck.push_imu(t * MS, (0.0, 0.0, 9.81), (0.0, 0.0, 0.0))
    img = np.zeros((8, 8), np.uint8)
    for t in (50, 100):
        stuck.push_right_frame(t * MS, img)
        stuck.push_left_frame(t * MS, img)
    stuck.push_left_frame(200 * MS, img)
    got = []
    consumer = threading.Thread(target=lambda: got.extend(stuck.frames(timeout_s=0.05)),
                                daemon=True)
    consumer.start()
    deadline = time.monotonic() + 5.0
    while len(got) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    t0 = time.perf_counter()
    stuck.stop()
    consumer.join(timeout=5.0)
    if consumer.is_alive() or len(got) != 2 or stuck.dropped_frames != 1:
        raise AssertionError(f"live: frames() after stop(): returned {not consumer.is_alive()}, "
                             f"{len(got)} packets, {stuck.dropped_frames} dropped")
    row = {"frames": out.n_frames, "keyframes": out.n_keyframes, "lk_launches": r["launches"],
           "wall_s": r["wall"], "frames_per_s": r["fed"] / r["wall"],
           "path_frames_per_s": path["frames_per_s"], "max_abs_dpos_vs_path_m": dpos,
           "stop_returned_s": time.perf_counter() - t0}
    log(f"[live] {json.dumps(row)}")
    return row


def aux_phase(dev, path: dict, work: str) -> dict:
    """Phase 8 (c) (see the module docstring)."""
    from kimera_vio_tpu_torch.playground import visualize_gt_data

    res = {}
    params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    cli_flags.set_flag("log_frontend_images", True)
    try:
        for mode in ("sequential", "parallel", "chunked"):
            out_dir = os.path.join(work, f"overlays_{mode}")
            pipe = StereoImuPipeline(params, output_path=out_dir, parallel_run=mode == "parallel",
                                     device=dev)
            provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
            r = (run_counted(pipe, provider, "run_chunked", chunk_size=16, collect_aux=True)
                 if mode == "chunked" else run_counted(pipe, provider))
            out = r["out"]
            names = sorted(os.listdir(os.path.join(out_dir, "frontend_images")))
            if names != sorted(f"{t}.png" for t in out.stamps_ns[1:]):
                raise AssertionError(f"overlays {mode}: {len(names)} PNGs for "
                                     f"{out.n_keyframes - 1} fused-step keyframes")
            for n in names:
                img = png.decode_png_rgb8(os.path.join(out_dir, "frontend_images", n))
                if img.shape != (480, 752, 3) or not (img[..., 0] != img[..., 1]).any():
                    raise AssertionError(f"overlays {mode}: {n} is {img.shape} or gray")
            if out.stamps_ns != path["stamps_ns"]:
                raise AssertionError(f"overlays {mode}: keyframe stamps differ from phase 2's")
            row = {"run": f"overlays_{mode}", "pngs": len(names), "lk_launches": r["launches"],
                   "wall_s": r["wall"], "frames_per_s": r["fed"] / r["wall"],
                   "path_frames_per_s": path["frames_per_s"]}
            res[row["run"]] = row
            log(f"[aux] {json.dumps(row)}")
    finally:
        cli_flags.set_flag("log_frontend_images", False)

    # The visualizer with the mesher on phase 6's near plane. Its display
    # writes every VIZ_SAVE_EVERY-th keyframe (the pipeline's writes every
    # 10th: one write in this run's 17 keyframes); which maps carry the
    # image-plane mesh is recorded (the mesher has none on a keyframe
    # whose keypoints match no triangulated landmark).
    out_dir = os.path.join(work, "viz_run")
    carried = []
    orig_make, orig_spin = stereo_pipeline.make_display, FileDisplay.spin_once

    def spin(self, widgets):
        carried.append(widgets.mesh_2d is not None)
        orig_spin(self, widgets)

    stereo_pipeline.make_display = lambda kind, path: FileDisplay(path, save_every=VIZ_SAVE_EVERY)
    FileDisplay.spin_once = spin
    cli_flags.set_flag("visualize", True)
    cli_flags.set_flag("visualize_mesh_2d", True)
    try:
        pipe = StereoImuPipeline(near_plane_params(1), output_path=out_dir, parallel_run=False,
                                 device=dev, enable_mesher=True)
        r = run_counted(pipe, near_plane_provider())
    finally:
        stereo_pipeline.make_display, FileDisplay.spin_once = orig_make, orig_spin
        cli_flags.set_flag("visualize", False)
        cli_flags.set_flag("visualize_mesh_2d", False)
    disp = pipe._display
    saved = list(range(disp.save_every, disp._count + 1, disp.save_every))
    files = sorted(os.listdir(disp.dir))
    m2d = [f for f in files if f.startswith("mesh2d_")]
    if disp._count != r["out"].n_keyframes - 1 or len(carried) != disp._count or not saved:
        raise AssertionError(f"visualizer: {disp._count} keyframes shown")
    for kind, ext in (("pointcloud", "ply"), ("mesh", "ply"), ("trajectory", "png")):
        if [f for f in files if f.startswith(kind + "_")] != [f"{kind}_{k:06d}.{ext}" for k in saved]:
            raise AssertionError(f"visualizer: {kind} files {files}")
    if not m2d or m2d != [f"mesh2d_{k:06d}.png" for k in saved if carried[k - 1]]:
        raise AssertionError(f"visualizer: mesh2d files {m2d}, carried {carried}")
    for k in saved:
        read_ply(os.path.join(disp.dir, f"mesh_{k:06d}.ply"))
        lines = open(os.path.join(disp.dir, f"pointcloud_{k:06d}.ply")).read().splitlines()
        if lines[6] != "end_header" or len(lines) != 7 + int(lines[2].split()[-1]):
            raise AssertionError(f"visualizer: pointcloud_{k:06d}.ply does not parse")
        if png.decode_png_rgb8(os.path.join(disp.dir, f"trajectory_{k:06d}.png")).shape != (480, 480, 3):
            raise AssertionError("visualizer: trajectory image")
    for f in m2d:
        img = png.decode_png_rgb8(os.path.join(disp.dir, f))
        if img.shape != (480, 752, 3) or not (img == (0, 255, 0)).all(-1).any():
            raise AssertionError(f"visualizer: {f} has no mesh edge")
    row = {"run": "visualizer_mesher", "keyframes_shown": disp._count, "save_every": disp.save_every,
           "saved": len(saved), "mesh2d": len(m2d), "maps_with_mesh_2d": sum(carried), "lk_launches": r["launches"], "wall_s": r["wall"],
           "frames_per_s": r["fed"] / r["wall"], "path_frames_per_s": path["frames_per_s"]}
    res[row["run"]] = row
    log(f"[aux] {json.dumps(row)}")

    # visualize_gt_data on phase 3's EuRoC folder.
    out_dir = os.path.join(work, "playground")
    t0 = time.perf_counter()
    visualize_gt_data(path["euroc"], out_dir, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    n_poses = len(range(0, len(EurocDataProvider(path["euroc"]).ground_truth.stamps_ns), 10))
    names = sorted(os.listdir(out_dir))
    if names != [f"trajectory_{k:06d}.png" for k in range(2, n_poses + 1)]:
        raise AssertionError(f"playground: {names}")
    res["playground"] = {"run": "playground", "pngs": len(names), "ms": ms}
    log(f"[aux] {json.dumps(res['playground'])}")
    return res


# ---------------------------------------------------------------------------
# Phase 9: the fleet
# ---------------------------------------------------------------------------

# Eight streams (vx m/s, frames/s): the rates differ so that under the
# default keyframe policy (a keyframe once 0.2 s have passed) the streams
# keyframe at different frames; 16 IMU samples a block hold 200 Hz down to
# 12.5 frames/s.
FLEET_STREAMS = ((0.3, 20.0), (0.4, 15.0), (0.5, 25.0), (0.6, 16.0),
                 (0.7, 20.0), (0.8, 18.0), (0.9, 25.0), (1.0, 15.0))
FLEET_FRAMES = 40
FLEET_SWEEP = (1, 2, 4, 8)


def fleet_lk_inputs(dev, n_streams: int, kitti: bool = False) -> dict:
    """One keyframe -> frame pair per stream, stream b the sequence
    shifted by b frames: phase 2's 752x480 sequence, frames b -> b+4 (as
    `main_lk_inputs`), or phase 8a's 1241x376 KITTI sequence, frames b ->
    b+1 (its 9.6 px a frame); 5-level pyramids and 256 keypoints detected
    on frame b. Returns the stacked (B, ...) pyramids, gradients,
    keypoints and flags."""
    gap = 1 if kitti else 4
    prov = (SyntheticStereoProvider(**{**KITTI, "n_frames": n_streams + gap}) if kitti
            else SyntheticStereoProvider(n_frames=n_streams + gap, vx=0.5))
    prev, cur, pts, valid = [], [], [], []
    for b in range(n_streams):
        img0 = torch.from_numpy(prov.load_image(("left", b))).to(dev)
        img1 = torch.from_numpy(prov.load_image(("left", b + gap))).to(dev)
        uv, ok = det.detect_features(img0, torch.zeros((256, 2), device=dev),
                                     torch.zeros(256, dtype=torch.bool, device=dev), 256)
        prev.append(of.build_pyramid(img0, 4))
        cur.append(of.build_pyramid(img1, 4))
        pts.append(uv)
        valid.append(ok)
    prev = [torch.stack(lv) for lv in zip(*prev)]
    return {"prev": prev, "cur": [torch.stack(lv) for lv in zip(*cur)],
            "grads": [of._grad(p) for p in prev], "pts": torch.stack(pts),
            "valid": torch.stack(valid)}


def _first(inp: dict, n: int) -> tuple:
    """The lk_pyramid_cuda arguments of the first n streams."""
    return ([p[:n] for p in inp["prev"]], [c[:n] for c in inp["cur"]],
            [(gx[:n], gy[:n]) for gx, gy in inp["grads"]], inp["pts"][:n], inp["pts"][:n],
            inp["valid"][:n])


def plain_stream_work(args: tuple, kw: dict = LK_KW) -> tuple:
    """One stream's lk_pyramid_cuda arguments (2-D planes) through the
    plain version: (pts, ok, levels with the inputs `lk_work` counts)."""
    seen = []

    def level_seen(prev, gx, gy, cur, base, start, valid, **lkw):
        out = lk.lk_level_plain(prev, gx, gy, cur, base, start, valid, **lkw)
        seen.append({"base": base, "start": start, "valid": valid})
        return out

    prev, cur, grads, pts, init, valid = args
    out, ok, lv = lk.track_pyramid(level_seen, prev, cur, pts, init, valid, grads, **kw)
    return out, ok, [{**level, **s} for level, s in zip(lv, seen)]


def compare_fleet_lk(inp: dict, n_streams: int, label: str, kw: dict = LK_KW) -> dict:
    """ONE launch for n_streams streams against the plain version per
    stream (phase 1's gate: median and max |d| < 0.01 px over the
    keypoints both track, the same `ok`), and against n_streams
    single-stream launches bit for bit."""
    args = _first(inp, n_streams)
    out_k, ok_k, it_k = lk.lk_pyramid_cuda(*args, **kw)
    per_stream = unstack_trees(args, n_streams)
    singles = [lk.lk_pyramid_cuda(*a, **kw) for a in per_stream]
    d, agree, modes, tracked_both = [], [], None, 0
    for b in range(n_streams):
        out_p, ok_p, levels = plain_stream_work(per_stream[b], kw)
        modes = [lv["mode"] for lv in levels]
        both = ok_k[b] & ok_p
        tracked_both += int(both.sum())
        d.append(torch.linalg.norm(out_k[b] - out_p, dim=-1)[both])
        agree.append(float((ok_k[b] == ok_p).float().mean()))
        single = singles[b]
        if not (torch.equal(single[0], out_k[b]) and torch.equal(single[1], ok_k[b])
                and torch.equal(single[2], it_k[b])):
            raise AssertionError(f"{label}: stream {b}'s batched launch differs from its own")
    d = torch.cat(d)
    if tracked_both < 0.5 * n_streams * inp["pts"].shape[1]:
        raise AssertionError(f"{label}: only {tracked_both} keypoints tracked by both")
    median, max_err = float(d.median()), float(d.max())
    if not (median < 0.01 and max_err < 0.01 and min(agree) == 1.0):
        raise AssertionError(f"{label}: median {median} px, max {max_err} px, "
                             f"ok agreement {min(agree)}")
    return {"label": label, "streams": n_streams, "launches": 1, "tracked": int(ok_k.sum()),
            "median_abs_err": median, "max_abs_err": max_err, "ok_agreement": min(agree),
            "equal_to_single_launches": True, "level_modes": modes}


def fleet_kernel_rows(inp: dict) -> dict:
    """Graph-replay ms of one launch at B = 1, 4 and 8, per launch and per
    stream-frame, beside the bound at B (the streams' `lk_work` summed)
    and the plain version over the same B streams (one eager call of
    `track_pyramid` on the stacked inputs)."""
    n = inp["pts"].shape[0]
    work = [lk_work(plain_stream_work(a)[2], inp["pts"].shape[1])
            for a in unstack_trees(_first(inp, n), n)]
    rows = {}
    for n in (1, 4, 8):
        args = _first(inp, n)
        ms = graph_ms(lambda: lk.lk_pyramid_cuda(*args, **LK_KW))
        plain = time_ms(lambda: lk.track_pyramid(lk.lk_level_plain, args[0], args[1], args[3],
                                                 args[4], args[5], args[2], **LK_KW),
                        reps=3, warmup=1)
        b_ms, b_by = bound_ms(sum(w[0] for w in work[:n]), sum(w[1] for w in work[:n]))
        rows[n] = {"streams": n, "ms": ms, "ms_per_stream_frame": ms / n, "bound_ms": b_ms,
                   "bound_by": b_by, "plain_ms": plain}
        log(f"[fleet] {json.dumps({'run': 'kernel 752x480', **rows[n]})}")
    return rows


def fleet_streams(dev, n_frames: int = FLEET_FRAMES, size: dict | None = None) -> list:
    """Per stream of FLEET_STREAMS: its provider, its frames on the card
    (left, right, IMU block, float32 seconds since its first frame, stamp
    ns) and its ground-truth state at its first frame."""
    out = []
    for vx, fps in FLEET_STREAMS:
        prov = SyntheticStereoProvider(n_frames=n_frames, vx=vx, fps=fps, **(size or {}))
        packets = list(prov.frames())
        s0 = packets[0]["stamp_ns"]
        frames = [(torch.from_numpy(prov.load_image(p["left_path"])).to(dev),
                   torch.from_numpy(prov.load_image(p["right_path"])).to(dev),
                   None if p["imu"] is None else ImuBlock(
                       *(getattr(p["imu"], f).to(dev) for f in ("acc", "gyr", "dt", "mask"))),
                   float(np.float32((p["stamp_ns"] - s0) * 1e-9)), p["stamp_ns"])
                  for p in packets]
        out.append({"provider": prov, "frames": frames})
    return out


def fleet_gold(dev, params, streams: list) -> list:
    """Each stream alone on the card: `_init_stream` at its ground truth,
    then the single-stream `_step` per frame. Per stream: the keyframe
    flags and the positions per frame (the backend's on keyframes, the
    newest window slot's otherwise, as the fleet reports them)."""
    pipe = StereoImuPipeline(params, parallel_run=False, device=dev)
    for st in streams:
        frames = st["frames"]
        st["nav"], st["bias"] = pipe._bootstrap_state(st["provider"], frames[0][4], None)
        fe, win, lmk = pipe._init_stream(frames[0][0], frames[0][1], 0.0, st["nav"], st["bias"])
        flags, pos = [], []
        for left, right, blk, stamp, _ in frames[1:]:
            fe, win, lmk, fo, bout = pipe._step(fe, win, lmk, left, right, blk, stamp)
            flags.append(bool(fo["is_keyframe"]))
            pos.append((bout["pos"] if bout else win.pos[max(win.n - 1, 0)]).clone())
        st["gold_kf"] = np.array(flags)
        st["gold_pos"] = torch.stack(pos).cpu().numpy()
    return streams


def fleet_run(dev, params, streams: list, n_streams: int, path_fps: float, devices=None,
              model_shards: int = 1, gold: bool = True, label: str = "") -> tuple[dict, dict]:
    """The first n_streams streams through FleetVio on a mesh (`devices`
    reshaped to rows of `model_shards`; one device, `dev`, by default),
    every step ending in `torch.cuda.synchronize` of every device of the
    mesh, the LK counters set to 0 just before. Gates: one LK launch per
    data row per fleet frame, each on its row's first device; per stream
    and frame the single-stream run's keyframe flag and position within
    1e-3 m (unless `gold` is false: a configuration the single-stream
    runs did not run); ATE < 0.05 m per stream; at least one frame that
    mixes keyframing and tracking streams (B > 1); final positions apart
    (B > 1). Returns (row, {per frame: keyframe flags, positions, landmark
    ids, keypoint ids and every output; the final state, the backend
    configuration and the mesh})."""
    from kimera_vio_tpu_torch.parallel import FleetVio

    sel = streams[:n_streams]
    n_frames = len(sel[0]["frames"])
    fleet = FleetVio(params, n_streams, devices=devices or [dev], model_shards=model_shards)
    cards = sorted({d for row in fleet.mesh for d in row}, key=str)
    name = f"fleet B={n_streams}" + (
        f" mesh {len(fleet.mesh)}x{len(fleet.mesh[0])} on {','.join(map(str, cards))}"
        if devices else "") + label
    state = fleet.init(torch.stack([st["frames"][0][0] for st in sel]),
                       torch.stack([st["frames"][0][1] for st in sel]),
                       stack_trees([st["nav"] for st in sel]),
                       torch.stack([st["bias"] for st in sel]))
    inputs = []
    for k in range(1, n_frames):
        fr = [st["frames"][k] for st in sel]
        inputs.append((torch.stack([f[0] for f in fr]), torch.stack([f[1] for f in fr]),
                       stack_trees([f[2] for f in fr]), [f[3] for f in fr]))
    kf, pos, ids, step_ms, outs = [], [], [], [], []
    for d in cards:
        torch.cuda.synchronize(d)
    reset_lk_counts()
    t0 = time.perf_counter()
    for args in inputs:
        tic = time.perf_counter()
        state, out = fleet.step(state, *args)
        for d in cards:
            torch.cuda.synchronize(d)
        step_ms.append((time.perf_counter() - tic) * 1e3)
        kf.append(out["is_keyframe"])
        pos.append(out["pos"])
        ids.append((out["lmk_ids"], torch.where(out["kp_mask"], out["kp_ids"], -1)))
        outs.append(out)
    wall = time.perf_counter() - t0
    launches = lk_launches()
    by_device = lk_launches_by_device()
    want = collections.Counter(str(row[0]) for row in fleet.mesh)
    want = {d: c * (n_frames - 1) for d, c in want.items()}
    if launches != (n_frames - 1) * len(fleet.mesh) or by_device != want:
        raise AssertionError(f"{name}: LK launches {launches} ({by_device}) != "
                             f"{n_frames - 1} fleet frames x {len(fleet.mesh)} data rows ({want})")
    kf = np.stack(kf)  # (frames, B)
    pos = torch.stack(pos).cpu().numpy()  # (frames, B, 3)
    n_kf = kf.sum(1)
    mixed = int(((n_kf > 0) & (n_kf < n_streams)).sum())
    ate, max_dpos = [], 0.0
    for b, st in enumerate(sel):
        if gold and not np.array_equal(kf[:, b], st["gold_kf"]):
            raise AssertionError(f"{name}: stream {b}'s keyframe flags differ from its "
                                 "single-stream run")
        if gold:
            max_dpos = max(max_dpos, float(np.abs(pos[:, b] - st["gold_pos"]).max()))
        stamps = [st["frames"][0][4]] + [st["frames"][k + 1][4] for k in np.flatnonzero(kf[:, b])]
        est = np.concatenate([st["nav"].pos.cpu().numpy()[None], pos[kf[:, b], b]])
        gt = st["provider"].ground_truth
        ate.append(compute_ate(np.array(stamps), est, gt.stamps_ns, gt.positions,
                               align=False)["rmse"])
    if not max_dpos < 1e-3:
        raise AssertionError(f"{name}: positions {max_dpos} m from the single-stream runs'")
    if not (np.isfinite(pos).all() and max(ate) < 0.05):
        raise AssertionError(f"{name}: ATE rmse {ate} (gate 0.05 m)")
    if n_streams > 1:
        final = pos[-1]
        apart = min(float(np.linalg.norm(final[i] - final[j]))
                    for i in range(n_streams) for j in range(i + 1, n_streams))
        if mixed < 1 or not apart > 1e-3:
            raise AssertionError(f"{name}: {mixed} mixed frames, final positions "
                                 f"{apart} m apart")
    step_ms = np.array(step_ms)
    track_ms = float(step_ms[n_kf == 0].mean())
    kf_ms = float(np.mean((step_ms[n_kf > 0] - track_ms) / n_kf[n_kf > 0]))
    row = {"run": name, "streams": n_streams, "frames": n_frames,
           "mesh": [[str(d) for d in r] for r in fleet.mesh],
           "lk_launches": launches, "lk_launches_by_device": by_device,
           "keyframes": int(n_kf.sum()), "mixed_frames": mixed,
           "ate_rmse_m": ate, "max_abs_dpos_vs_single_m": max_dpos if gold else None,
           "wall_s": wall,
           "stream_frames_per_s": n_streams * (n_frames - 1) / wall,
           "frame_step_ms": track_ms, "keyframe_ms_per_stream": kf_ms,
           "path_frames_per_s": path_fps}
    return row, {"kf": kf, "pos": pos,
                 "lmk_ids": torch.stack([i for i, _ in ids]).cpu().numpy(),
                 "kp_ids": torch.stack([k for _, k in ids]).cpu().numpy(),
                 "state": state, "cfg": fleet._pipe.backend_cfg, "mesh": fleet.mesh,
                 "outs": outs}


def fleet_phase(dev, path: dict, n_frames: int = FLEET_FRAMES, size: dict | None = None) -> dict:
    """Phase 9 (see the module docstring). Keeps, for phase 11, the
    configuration, the streams with their single-stream runs, and each
    fleet run's trajectory."""
    res = {}
    if size is None:  # the kernel rows need the card's full-size frames
        inp = fleet_lk_inputs(dev, 8)
        res["kernel"] = compare_fleet_lk(inp, 4, "752x480")
        # B = 8: the launch shape of the fleet run below (2,048 blocks).
        res["kernel8"] = compare_fleet_lk(inp, 8, "752x480 B=8")
        res["kitti"] = compare_fleet_lk(fleet_lk_inputs(dev, 4, kitti=True), 4, "1241x376")
        if res["kitti"]["level_modes"][-1] != "gather":
            raise AssertionError("1241x376 level 0 should take the gather mode (B1)")
        for r in (res["kernel"], res["kernel8"], res["kitti"]):
            log(f"[fleet] {json.dumps({'run': 'kernel vs plain', **r})}")
        res["rows"] = fleet_kernel_rows(inp)
    params = (synthetic_params(**size, nr_states=10, max_features=256, max_landmarks=384)
              if size else synthetic_params(nr_states=10, max_features=256, max_landmarks=384))
    streams = fleet_gold(dev, params, fleet_streams(dev, n_frames, size))
    res["runs"], res["traj"] = {}, {}
    for n in sorted(FLEET_SWEEP, reverse=True):
        res["runs"][n], res["traj"][n] = fleet_run(dev, params, streams, n, path["frames_per_s"])
        log(f"[fleet] {json.dumps(res['runs'][n])}")
    res["params"], res["streams"] = params, streams
    return res


# ---------------------------------------------------------------------------
# Phase 11: the fleet's data x model mesh
# ---------------------------------------------------------------------------

MESH_STREAMS = 4
UNEVEN_SHARDS = 5  # does not divide the 384 landmarks: the tables stay whole
SWITCH_FLAGS = ("use_lcd", "do_fine_imu_camera_temporal_sync")
SWITCHED_KEYS = ("lcd_uv", "lcd_ok", "lcd_desc", "lcd_versors", "lcd_pts3", "vis_rot_angle",
                 "init_R_rel_body", "init_t_rel_body", "init_pim_delta_R", "init_pim_delta_v",
                 "init_pim_delta_p", "init_pim_dR_dbg")
# The JAX fleet's outputs under the three switches (its fused step's
# frame_out, kimera_vio_tpu/pipeline/stereo_pipeline.py:744-787).
FLEET_OUT_KEYS = ("is_keyframe", "n_tracked", "median_disparity", "n_mono_inliers",
                  "n_stereo_inliers", "rot", "pos", "vel", "bias", "lmk_points", "lmk_valid",
                  "lmk_ids", "kp_uv", "kp_ids", "kp_mask", "n_recovered") + SWITCHED_KEYS


@contextlib.contextmanager
def timed_shard_ops():
    """The smoother's cross-shard work timed: `_shard_inputs` (the
    configuration and window copied to a shard's device) and
    `_sum_partials` (the partial systems copied to the row's device and
    summed) wrapped in CUDA events on the device each ends on. Yields the
    list of (start, end) event pairs."""
    from kimera_vio_tpu_torch.backend import smoother as sm

    events = []
    orig = sm._shard_inputs, sm._sum_partials

    def timed(fn, dev_arg):
        def run(*args):
            with torch.cuda.device(args[dev_arg]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
            events.append((start, end))
            return out
        return run

    sm._shard_inputs, sm._sum_partials = timed(orig[0], 2), timed(orig[1], 1)
    try:
        yield events
    finally:
        sm._shard_inputs, sm._sum_partials = orig


def shard_check(cfg, state, devices: list) -> dict:
    """The model axis on identical inputs: each stream of a one-device
    fleet's final state, its landmark table split over `devices` (a mesh
    row; the window copied to its first device) against the plain table.
    Measurements: the stream's last keyframe's (its frontend's keypoint
    ids and stereo measurements), every other id made new so that free
    rows are taken, into the newest slot. Gates: `update_landmarks` and
    `shift_landmarks` gathered equal to the plain table's bit for bit; the
    Gauss-Newton system and gradient assembled 1 cm off the window's
    states within 1e-5 of their largest entries (the smart-factor sum in
    another order)."""
    from kimera_vio_tpu_torch.backend import smoother as sm

    to = devices[0]
    cfg = tree_map(lambda x: x.to(to), cfg)  # the first row's, on another card than `to`
    fields = ("ids", "obs_uvd", "obs_mask", "pts", "pts_ok")
    n = state.win.rot.shape[0]
    rel = {"H": 0.0, "g": 0.0}
    new_ids = 0
    for win, lmk, fe in zip(*(unstack_trees(t, n) for t in (state.win, state.lmk,
                                                            state.fe_state))):
        win, lmk = (tree_map(lambda x: x.to(to), t) for t in (win, lmk))
        sharded = sm.shard_landmarks(lmk, devices)
        ids = fe.lkf_features.ids.to(to)
        ids = torch.where((torch.arange(ids.shape[0], device=to) % 2 == 1) & (ids >= 0),
                          ids + 1_000_000, ids)
        meas = (ids, fe.lkf_uvd.to(to), fe.lkf_uvd_mask.to(to) & (ids >= 0))
        new_ids += int((meas[2] & ~torch.isin(ids, lmk.ids)).sum())
        slot = max(win.n - 1, 0)
        pairs = [(sm.update_landmarks(lmk, *meas, slot), sm.update_landmarks(sharded, *meas, slot))]
        pairs.append(tuple(sm.shift_landmarks(t) for t in pairs[0]))
        for plain, split in pairs:
            for f in fields:
                if not torch.equal(getattr(split, f).to(to), getattr(plain, f)):
                    raise AssertionError(f"shard check on {devices}: {f} differs from the "
                                         "plain table's")
        # 1 cm off the solution, so that the gradient is not the noise
        # around zero of a converged window.
        win = replace(win, pos=win.pos + 0.01)
        H, g, _ = sm._assemble(cfg, win, lmk)
        Hs, gs, _ = sm._assemble(cfg, win, sharded)
        rel["H"] = max(rel["H"], float((Hs - H).abs().max() / H.abs().max()))
        rel["g"] = max(rel["g"], float((gs - g).abs().max() / g.abs().max()))
    if not max(rel.values()) < 1e-5:
        raise AssertionError(f"shard check on {devices}: system off by {rel} of its largest entry")
    return {"streams": n, "new_ids": new_ids, "tables_equal": True,
            "max_rel_dH": rel["H"], "max_rel_dg": rel["g"]}


def mesh_phase(dev, path: dict, fleet_res: dict, cards: list, meshes=None,
               switched: bool = True) -> dict:
    """Phase 11 (see the module docstring). `cards`: nvidia-smi's name and
    power limit line of each card, by index; `meshes`: (devices,
    model_shards) pairs, by default the module docstring's; `switched`:
    also the switched-output run (`switched_fleet`). Each run's `[mesh]`
    line is printed after `shard_check` and before the run's other gates
    are checked."""
    params, streams = fleet_res["params"], fleet_res["streams"]
    one = fleet_res["traj"][MESH_STREAMS]
    one_row = fleet_res["runs"][MESH_STREAMS]
    if meshes is None:
        meshes = [([dev] * 4, 2), ([dev] * 10, UNEVEN_SHARDS)]
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:  # real cards as well: a (D, 1) mesh, and (D/2, 2) where D >= 4
            real = [torch.device("cuda", i) for i in range(4 if n_cards >= 4 else 2)]
            meshes += [(real, 1)] + ([(real, 2)] if len(real) >= 4 else [])
    res = {}
    for devices, model_shards in meshes:
        split = model_shards > 1 and params.max_landmarks % model_shards == 0
        with timed_shard_ops() as events:
            row, traj = fleet_run(dev, params, streams, MESH_STREAMS, path["frames_per_s"],
                                  devices=devices, model_shards=model_shards)
        name = row["run"]
        dpos = np.abs(traj["pos"] - one["pos"]).max(axis=(1, 2))  # per frame
        ids_diff = traj["lmk_ids"] != one["lmk_ids"]  # (frames, B, L)
        kp_diff = (traj["kp_ids"] != one["kp_ids"]).any(axis=2)  # (frames, B)
        # Per stream, the frames on which its frontend gave the one-device
        # run's keypoints; until then its landmark ids must agree. The
        # batched frame step's float arithmetic depends on the row's batch
        # size (phase 9: each stream within ~2e-6 m of its single-stream
        # run), and model shards sum the smart-factor system in another
        # order, which the bias fed back to the frontend carries on: the
        # states part in the last bits, and a track can flip, from which
        # frame on that stream's keypoints, and so its landmark ids, differ.
        same_input = [int(np.argmax(kp_diff[:, b])) if kp_diff[:, b].any() else len(kp_diff)
                      for b in range(MESH_STREAMS)]
        table = (shard_check(traj["cfg"], one["state"], [torch.device(d) for d in row["mesh"][-1]])
                 if split else None)
        whole = None if split or model_shards == 1 else whole_tables(traj)
        shard_ms = sum(start.elapsed_time(end) for start, end in events)
        used = sorted({d for r in row["mesh"] for d in r})
        row.update({
            "cards": {d: cards[torch.device(d).index or 0] for d in used},
            "keyframe_flags_equal_one_device": bool(np.array_equal(traj["kf"], one["kf"])),
            "max_abs_dpos_vs_one_device_m": float(dpos.max()),
            "first_frame_dpos_nonzero": int(np.argmax(dpos > 0)) if (dpos > 0).any() else None,
            "frames_with_the_same_keypoints": same_input,
            "shard_check": table,
            "whole_tables": whole,
            "lmk_ids_entries_differing": int(ids_diff.sum()),
            "one_device_stream_frames_per_s": one_row["stream_frames_per_s"],
            "one_device_frame_step_ms": one_row["frame_step_ms"],
            "one_device_keyframe_ms_per_stream": one_row["keyframe_ms_per_stream"],
            "shard_calls": len(events),
            "shard_copy_sum_ms_per_keyframe": shard_ms / row["keyframes"]})
        log(f"[mesh] {json.dumps(row)}")
        if not row["keyframe_flags_equal_one_device"]:
            raise AssertionError(f"{name}: keyframe flags differ from the one-device fleet's")
        if not dpos.max() < 1e-4:
            raise AssertionError(f"{name}: positions {dpos.max()} m from the one-device fleet's")
        if any(ids_diff[:k, b].any() for b, k in enumerate(same_input)):
            raise AssertionError(f"{name}: landmark ids differ from the one-device fleet's "
                                 f"while the keypoints agree ({same_input} frames)")
        if whole is not None and not (whole["plain_on_first_device"] and dpos.max() == 0
                                      and not ids_diff.any()):
            raise AssertionError(f"{name}: tables {whole}, positions {dpos.max()} m and "
                                 f"{int(ids_diff.sum())} landmark ids from the one-device "
                                 "fleet's (its model axis holds nothing: bit for bit)")
        res[name] = row
    if switched:
        res["switched"] = switched_fleet(dev, path, fleet_res)
    return res


def whole_tables(traj: dict) -> dict:
    """A mesh whose model axis does not divide the landmark count: whether
    each row's final table is a plain LandmarkTable with every leaf on the
    row's first device."""
    from kimera_vio_tpu_torch.backend import smoother as sm

    ok = []
    for row, devs in zip(traj["state"].rows, traj["mesh"]):
        leaves = [getattr(row.lmk, f.name) for f in dataclasses.fields(sm.LandmarkTable)]
        ok.append(type(row.lmk) is sm.LandmarkTable
                  and all(x.device == devs[0] for x in leaves))
    return {"rows": len(ok), "plain_on_first_device": all(ok)}


@contextlib.contextmanager
def fleet_switches():
    """The two flags among the three switches whose outputs the fleet
    returns (`auto_initialize` is a parameter), reset on the way out."""
    try:
        for name in SWITCH_FLAGS:
            cli_flags.set_flag(name, True)
        yield
    finally:
        for name in SWITCH_FLAGS:
            cli_flags.set_flag(name, False)


def switched_fleet(dev, path: dict, fleet_res: dict) -> dict:
    """Phase 11's last run (see the module docstring): the fleet at B = 4
    on one device with use_lcd, do_fine_imu_camera_temporal_sync and
    auto_initialize 2, against each stream alone through a B = 1 fleet with
    the same switches."""
    streams = fleet_res["streams"][:MESH_STREAMS]
    params = copy.deepcopy(fleet_res["params"])
    params.backend.auto_initialize = 2
    with fleet_switches():
        row, traj = fleet_run(dev, params, streams, MESH_STREAMS, path["frames_per_s"],
                              gold=False, label=" switched")
        alone = [fleet_run(dev, params, [st], 1, path["frames_per_s"], gold=False,
                           label=f" switched stream {b} alone")[1]
                 for b, st in enumerate(streams)]
    name = row["run"]
    outs = traj["outs"]
    keys = sorted(outs[0])
    if keys != sorted(FLEET_OUT_KEYS):
        raise AssertionError(f"{name}: outputs {keys} != the JAX fleet's {sorted(FLEET_OUT_KEYS)}")
    new = {k: torch.stack([o[k] for o in outs]) for k in SWITCHED_KEYS}  # (frames, B, ...)
    finite = all(bool(torch.isfinite(v).all()) for v in new.values() if v.is_floating_point())
    kf = torch.as_tensor(traj["kf"], device=new["lcd_ok"].device)
    lcd_kf = int(new["lcd_ok"].any(-1)[kf].sum())
    rot_kf = int((new["vis_rot_angle"][kf] > 0).sum())
    same, max_d, frames_held = True, {k: 0.0 for k in SWITCHED_KEYS}, []
    for b, one in enumerate(alone):
        kp_diff = (traj["kp_ids"][:, b] != one["kp_ids"][:, 0]).any(-1)
        upto = int(np.argmax(kp_diff)) if kp_diff.any() else len(kp_diff)
        frames_held.append(upto)
        for k in SWITCHED_KEYS:
            a = new[k][:upto, b]
            ref = torch.stack([o[k][0] for o in one["outs"][:upto]]) if upto else a
            d = float((a.double() - ref.double()).abs().max()) if upto else 0.0
            max_d[k] = max(max_d[k], d)
            same &= d == 0 if k.startswith("lcd_") else d < 1e-4
    one_row = fleet_res["runs"][MESH_STREAMS]
    row.update({
        "switches": list(SWITCH_FLAGS) + ["auto_initialize=2"],
        "output_keys": len(keys), "switched_fields_finite": finite,
        "keyframes_with_lcd_features": lcd_kf, "keyframes_with_visual_rotation": rot_kf,
        "frames_held_to_alone": frames_held, "max_abs_diff_vs_alone": max_d,
        "one_device_stream_frames_per_s": one_row["stream_frames_per_s"],
        "one_device_frame_step_ms": one_row["frame_step_ms"],
        "one_device_keyframe_ms_per_stream": one_row["keyframe_ms_per_stream"]})
    log(f"[fleet] {json.dumps(row)}")
    if not finite:
        raise AssertionError(f"{name}: a switched output is not finite")
    if lcd_kf < row["keyframes"] or rot_kf == 0:
        raise AssertionError(f"{name}: LCD features on {lcd_kf} of {row['keyframes']} "
                             f"keyframes, a visual rotation on {rot_kf}")
    if not same:
        raise AssertionError(f"{name}: switched fields differ from the streams' runs alone "
                             f"(max |d| {max_d}, over {frames_held} frames)")
    return row


# ---------------------------------------------------------------------------
# Phase 10: the staging codecs and LK windows wider than 54 px
# ---------------------------------------------------------------------------

CODECS = ("raw", "delta4", "delta4c", "delta3")
#: The codecs' own sequence: phase 2's 752x480 scene at 0.05 m/s (0.225 px
#: of flow a frame), where ~1.2 % of the temporal deltas escape delta4's
#: nibbles (MicroEuroc: ~0.9 %, kimera_vio_tpu/ops/frame_codec.py:7-8). On
#: phase 3's sequence (0.5 m/s, 2.25 px a frame) ~81 % escape: every codec
#: declines it and stages raw.
CODEC_VX = 0.05
CHUNK = 16
SUPER_BATCH_BYTES = 32 * 1024 * 1024  # run_chunked's default
#: lk_wide's rows: the shared route at 61-151 px; at 401 px (level 0 only:
#: 480 >= 403) no band fits shared memory, so the global route runs.
WIDE_WINS = ((61, "752x480"), (101, "752x480"), (151, "752x480"), (61, "1241x376"),
             (401, "752x480"))
#: What each phase 10 (b) row prints on its [wide] line.
WIDE_KEYS = ("label", "win", "launcher_route", "clusters", "threads", "band_rows", "smem_bytes",
             "active_clusters", "launches_through_route", "tracked", "median_abs_err",
             "max_abs_err", "ms", "ms_no_steps", "max_chain_steps",
             "us_per_step_on_longest_chain", "plain_ms", "bound_ms", "bound_by")


@contextlib.contextmanager
def stage_codec(codec: str):
    """KIMERA_STAGE_CODEC set to `codec` for the block, then restored."""
    old = os.environ.get("KIMERA_STAGE_CODEC")
    os.environ["KIMERA_STAGE_CODEC"] = codec
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("KIMERA_STAGE_CODEC")
        else:
            os.environ["KIMERA_STAGE_CODEC"] = old


def landed(pipe) -> dict:
    """Super-batches per codec the decline chain landed on in a run."""
    return {t.split()[2]: pipe.stats.get(t).count for t in pipe.stats.tags()
            if t.startswith("stage codec ")}


def codec_cli_runs(dev, label: str, data: str, pfolder: str, gt, work: str) -> dict:
    """The CLI's --chunked mode on one EuRoC folder under each codec, raw
    first. Gates: check_cli_run's, and each codec's keyframe stamps equal
    to raw's, positions and quaternions bit for bit."""
    base = ["--params_folder", pfolder, "--dataset_path", data, "--max_features", "256",
            "--max_landmarks", "384", "--device", dev.type, "--chunked", "--chunk_size", str(CHUNK)]
    rows, raw = {}, None
    for codec in CODECS:
        out_dir = os.path.join(work, f"{label}_{codec}")
        with stage_codec(codec), recording_pipeline() as rec:
            reset_lk_counts()
            rc = cli_main(base + ["--log_output", "--output_path", out_dir])
            launches = lk_launches()
        row = check_cli_run(f"{label} {codec}", rec, rc, launches, gt, out_dir)
        run = rec["runs"][0]
        row["landed"] = landed(run["pipe"])
        out = run["out"]
        if raw is None:
            raw = out
        elif not (out.stamps_ns == raw.stamps_ns
                  and np.array_equal(np.stack(out.positions), np.stack(raw.positions))
                  and np.array_equal(np.stack(out.quats_wxyz), np.stack(raw.quats_wxyz))):
            raise AssertionError(f"{label} {codec}: the trajectory differs from raw staging's")
        rows[codec] = row
    return rows


def first_batch_decode(dev, data: str, pfolder: str, codec: str) -> dict:
    """The first super-batch of `data` staged in `codec` and in raw
    through the pipeline's own stager, decoded on the card: the frames
    must equal raw's byte for byte and the IMU rows bit for bit. Returns
    its wire MB, the stager's ms (decode, encode, pack), the copy's ms
    and the decode ms (CUDA events, mean of 5 after 2 warm-ups)."""
    params = VioParams.from_folder(pfolder)
    params.max_features, params.max_landmarks = 256, 384
    pipe = StereoImuPipeline(params, device=dev)
    prov = EurocDataProvider(data)
    rest = [p for p in list(prov.frames())[1:] if p.get("imu") is not None]
    img = prov.load_image(rest[0]["left_path"])
    F = stereo_pipeline.super_batch_frames(codec, CHUNK, SUPER_BATCH_BYTES, 2 * img.nbytes)
    batch = rest[:F]
    side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
    staged = {c: pipe._stage(prov, batch, side, c) for c in ("raw", codec)}
    if side is not None:
        side.synchronize()
    st = staged[codec]
    if st.codec != codec:
        raise AssertionError(f"{codec}: the first super-batch landed on {st.codec}")
    frames_raw, aux_raw = pipe._materialize(staged["raw"])
    decode_ms = time_ms(lambda: pipe._materialize(st), reps=5)
    frames, aux = pipe._materialize(st)
    torch.cuda.synchronize()
    if not (frames.dtype == torch.uint8 and torch.equal(frames, frames_raw)
            and torch.equal(aux.view(torch.int32), aux_raw.view(torch.int32))):
        raise AssertionError(f"{codec}: the decoded super-batch differs from the raw one")
    return {"codec": codec, "frames": len(batch), "wire_mb": st.host.numel() / 1e6,
            "raw_mb": staged["raw"].host.numel() / 1e6, "stage_ms": st.encode_ms,
            "h2d_ms": st.copy[0].elapsed_time(st.copy[1]) if st.copy else None,
            "decode_ms": decode_ms}


def codec_phase(dev, path: dict, work: str, n_frames: int = 80) -> dict:
    """Phase 10 (a): the codecs through the CLI's --chunked mode on phase
    3's folder (every codec declines) and on CODEC_VX's folder (every
    super-batch in the codec named), then each codec's first super-batch
    decoded on the card. One [codec] line per codec."""
    res = {"phase3": codec_cli_runs(dev, "phase3", path["euroc"], path["euroc_params"],
                                    path["gt"], work)}
    for codec, row in res["phase3"].items():
        if set(row["landed"]) != {"raw"}:
            raise AssertionError(f"phase3 {codec}: staged {row['landed']}, expected raw only")
    params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    params.pipeline.parallel_run = True
    provider = SyntheticStereoProvider(n_frames=n_frames, vx=CODEC_VX)
    data, pfolder, _ = write_folders(os.path.join(work, "codec_slow"), provider, params)
    res["slow"] = codec_cli_runs(dev, "slow", data, pfolder, provider.ground_truth, work)
    raw = res["slow"]["raw"]
    for codec in CODECS:
        row = res["slow"][codec]
        if set(row["landed"]) != {codec}:
            raise AssertionError(f"slow {codec}: staged {row['landed']}, expected {codec} only")
        first = first_batch_decode(dev, data, pfolder, codec) if codec != "raw" else {}
        line = {"codec": codec, "super_batches": row["super_batches"],
                "wire_mb_per_super_batch": row["stage wire [MB]"],
                "encode_ms_per_super_batch": row["stage encode [ms]"],
                "h2d_ms_per_super_batch": row["stage h2d [ms]"],
                "frames_per_s": row["frames_per_s"], "raw_frames_per_s": raw["frames_per_s"],
                "phase3_frames_per_s": res["phase3"][codec]["frames_per_s"],
                "phase3_landed": res["phase3"][codec]["landed"], "lk_launches": row["lk_launches"],
                "first_super_batch": first}
        res[codec] = line
        log(f"[codec] {json.dumps(line)}")
    return res


def wide_inputs(dev, win: int, size: str) -> tuple:
    """Phase 1's 752x480 pair or the 1241x376 pair, with the valid
    keypoints farther than win / 2 + 2 px from the border (the final
    in-image gate fails the others on both sides)."""
    prev_pyr, cur_pyr, uv, valid = (main_lk_inputs(dev) if size == "752x480"
                                    else kitti_lk_inputs(dev, margin=win / 2 + 2))
    H, W = prev_pyr[0].shape
    m = win / 2 + 2
    keep = valid & (uv[:, 0] >= m) & (uv[:, 0] < W - m) & (uv[:, 1] >= m) & (uv[:, 1] < H - m)
    pts = uv[keep].contiguous()
    return prev_pyr, cur_pyr, pts, torch.ones(pts.shape[0], dtype=torch.bool, device=dev)


def optin_bytes(dev) -> int:
    """The card's opt-in shared memory per block, as PyTorch reads it."""
    return int(torch.cuda.get_device_properties(dev).shared_memory_per_block_optin)


def check_wide_report(label: str, win: int, optin: int) -> dict:
    """The launches since the route counters were cleared: every one through
    the route of `lk.wide_plan(win, optin)`, a cluster of C >= 2 blocks,
    and the launcher's last report of it (route, C, threads, band rows,
    shared memory) equal to that plan. Returns the report."""
    plan = lk.wide_plan(win, optin)
    routes = dict(lk.lk_pyramid_cuda.routes)
    rep = lk.lk_pyramid_cuda.report.get(plan.route)
    if routes.keys() != {plan.route} or rep is None or rep.get("plan") != plan:
        raise AssertionError(f"{label}: launches by route {routes}, report {rep}; "
                             f"wide_plan({win}, {optin}) gives {plan}")
    if rep["optin"] != optin or plan.clusters < 2 or rep["active_clusters"] < 1:
        raise AssertionError(f"{label}: report {rep}: expected a cluster route on {optin} B")
    return rep


def wide_phase(dev, path: dict) -> dict:
    """Phase 10 (b): the kernel's wide path (`lk_wide`) against the plain
    version with the gather rule, each row's launches through the plan
    `wide_plan` gives; B = 4 streams at win 61 in one launch; a sequential
    run() at phase 2's configuration with klt_win_size 61 under the default
    tracker (`wide_run`; phase 12 runs it under "gather", lk_wide's run
    path)."""
    res = {}
    optin = optin_bytes(dev)
    for win, size in WIDE_WINS:
        label = f"{size} win {win} gather rule"
        lk.lk_pyramid_cuda.routes.clear()
        lk.lk_pyramid_cuda.report.clear()
        r = compare_lk(*wide_inputs(dev, win, size), label, win=win, search_rows=None)
        if any(lv["mode"] != "xla" for lv in r["levels"]):
            raise AssertionError(f"{label}: the gather rule tracks every level as an XLA level")
        # The plan the launcher took, as it reported it, against wide_plan.
        rep = check_wide_report(label, win, optin)
        plan = rep["plan"]
        r.update(launcher_route=plan.route, smem_bytes=plan.smem, clusters=plan.clusters,
                 threads=plan.threads, band_rows=plan.band_rows,
                 active_clusters=rep["active_clusters"], optin_bytes=optin,
                 launches_through_route=lk.lk_pyramid_cuda.routes[plan.route])
        res[label] = r
        log(f"[wide] {json.dumps({k: r[k] for k in WIDE_KEYS})}")
    routes = {r["launcher_route"] for r in res.values()}
    planned = {lk.wide_plan(win, optin).route for win, _ in WIDE_WINS}
    if routes != planned:
        raise AssertionError(f"phase 10 ran the routes {routes}; wide_plan gives {planned}")
    kw = {**LK_KW, "win": 61, "search_rows": None}
    res["fleet"] = compare_fleet_lk(fleet_lk_inputs(dev, 4), 4, "752x480 B=4 win 61", kw)
    log(f"[wide] {json.dumps(res['fleet'])}")
    res["run"] = wide_run(dev, path)
    return res


def wide_run(dev, path: dict, impl: str | None = None) -> dict:
    """A sequential run() at phase 2's configuration with klt_win_size 61:
    under the default tracker every launch through lk_cached_kernel's
    shared route; under "gather" every launch with the gather rule through
    `lk_wide_kernel` on the plan `wide_plan` gives. Gates LK launches =
    tracked frames and ATE < 0.05 m."""
    optin = optin_bytes(dev)
    p = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    p.frontend.klt_win_size = 61
    provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
    name = "klt_win_61" + (f" {impl}" if impl else "")
    with lk_impl(impl), timed_lk("lk_pyramid_cuda" if impl else "lk_cached_cuda") as rec:
        row, out, pipe = run_variant(name, lambda: StereoImuPipeline(
            p, parallel_run=False, device=dev), provider, provider.ground_truth,
            path["frames_per_s"], 0.05)
    n = row["lk_launches"]
    if impl:
        plan = lk.wide_plan(61, optin)
        if (dict(rec["rules"]) != {(61, None): n} or dict(rec["routes"]) != {plan.route: n}
                or rec["report"].get(plan.route, {}).get("plan") != plan or plan.clusters < 2):
            raise AssertionError(f"{name}: launches by (win, search_rows) {dict(rec['rules'])}, "
                                 f"by route {dict(rec['routes'])}, report {rec['report']}; "
                                 f"wide_plan(61, {optin}) gives {plan}")
        row["lk_plan"] = plan._asdict()
    else:
        route = lk.cached_route(61, optin)
        if dict(rec["rules"]) != {(61, "cached"): n} or dict(rec["routes"]) != {route: n}:
            raise AssertionError(f"{name}: launches by (win, rule) {dict(rec['rules'])}, "
                                 f"by route {dict(rec['routes'])}; expected {route}")
    if out.n_keyframes < 1:
        raise AssertionError(f"{name}: no keyframe")
    row["lk_launch_and_kernel_ms_per_frame"] = float(np.mean(rec["ms"]))
    row["lk_launches_by_route"] = dict(rec["routes"])
    log(f"[wide] {json.dumps(row)}")
    return row


def legacy_phase(dev, path: dict, kern: dict, work: str) -> dict:
    """Phase 12: the pyramid trackers kept on run paths. Phase 2's 80-frame
    run under KIMERA_LK_IMPL=pallas (B2 at every level of 752x480: every
    launch of `lk_pyramid_kernel<24, 56, 24>`), phase 8's KITTI run with
    ground truth under "pallas" (B1 at level 0) and phase 10's 61 px run
    under "gather" (`lk_wide_kernel`).
    Gates: LK launches = tracked frames, every launch through the expected
    kernel, ATE < 0.05 m."""
    res = {}
    provider = SyntheticStereoProvider(n_frames=80, vx=0.5)
    params = synthetic_params(nr_states=10, max_features=256, max_landmarks=384)
    with lk_impl("pallas"), timed_lk("lk_pyramid_cuda") as rec:
        row, out, pipe = run_variant("path pallas", lambda: StereoImuPipeline(
            params, parallel_run=False, device=dev), provider, provider.ground_truth,
            path["frames_per_s"], 0.05)
    n = row["lk_launches"]
    if dict(rec["routes"]) != {"<24, 56, 24>": n} or n != out.n_frames - 1:
        raise AssertionError(f"path pallas: {n} launches, routes {dict(rec['routes'])}")
    step = pipe.stats.get("vio_step [ms]")
    fr = pipe.stats.get("VioFrontend Frame Rate [ms]")
    row.update(lk_launches_by_route=dict(rec["routes"]), step_ms_mean=step.total / step.count,
               frame_ms_mean=fr.total / fr.count,
               lk_launch_and_kernel_ms_per_frame=float(np.mean(rec["ms"])))
    res["path"] = row
    log(f"[legacy] {json.dumps(row)}")
    res["kitti"] = kitti_phase(dev, path, kern["kitti"]["ms"], work, impl="pallas")
    res["wide"] = wide_run(dev, path, impl="gather")
    return res


# ---------------------------------------------------------------------------
# Phase 13: a distorted rig
# ---------------------------------------------------------------------------

# EuRoC MAV cam0 / cam1 (sensor.yaml): radial-tangential k1, k2, p1, p2.
EUROC_RADTAN = ((-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
                (-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05))
# Equidistant (Kannala-Brandt) k1..k4 of a fisheye calibration's magnitudes.
EQUIDISTANT = ((0.0034823894, 0.0007150348, -0.0020532361, 0.0002029367),
               (0.0034003171, 0.0017662782, -0.0026631257, 0.0003299517))
DISTORTED_FRAMES = 80
REMAP_REPS = 200


def distorted_params(model: str, **kw) -> VioParams:
    """Phase 2's synthetic rig with `model`'s distortion on both cameras;
    "omni": the 1280x960 pinhole rig the omni cameras replace."""
    if model == "omni":
        return synthetic_params(width=1280, height=960, fx=400.0, **kw)
    params = synthetic_params(**kw)
    name, coeffs = (("radial-tangential", EUROC_RADTAN) if model == "radtan"
                    else ("equidistant", EQUIDISTANT))
    for cam, c in ((params.left_cam, coeffs[0]), (params.right_cam, coeffs[1])):
        cam.distortion_model = name
        cam.distortion_coeffs = np.array(c)
    return params


def distorted_frontend(dev, model: str) -> StereoFrontend:
    """The port's StereoFrontend on `model`'s rig on `dev` (omni: phase 7's
    OCamCalib camera swapped in for both pinholes)."""
    from kimera_vio_tpu_torch.config.params import CameraParams
    from kimera_vio_tpu_torch.frontend import camera as cam_mod
    from kimera_vio_tpu_torch.frontend.imu_frontend import PimParams
    from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendConfig

    params = distorted_params(model, max_features=256)
    stereo = StereoCamera.from_params(params.left_cam, params.right_cam, device=dev)
    if model == "omni":
        cams = [cam_mod.PinholeCamera.from_params(CameraParams(T_BS=c.T_BS, **OMNI), device=dev)
                for c in (params.left_cam, params.right_cam)]
        stereo = dataclasses.replace(stereo, left=cams[0], right=cams[1])
    return StereoFrontend(FrontendConfig.from_params(params.frontend, max_features=256), stereo,
                          PimParams.from_params(params.imu, device=dev), dev)


def remap_card_vs_cpu(dev, model: str) -> dict:
    """(a) The card's rectified keyframe pair against the CPU port's on the
    same uint8 images. Radial-tangential and equidistant maps are built on
    the host, so the two frontends' separable remaps are the same function:
    within 1e-3 gray levels. An omni map is built on the camera's device
    (phase 7 holds it to the CPU's within 1e-3 px), so the card is held
    within 1e-3 to the CPU port's remap of the card's own map, and to the
    CPU frontend within the maps' gap times the image's largest step,
    doubled (tests/test_torch_rectification.py's rule)."""
    from kimera_vio_tpu_torch.frontend.camera import SeparableRemap

    cpu = torch.device("cpu")
    fe, fe_cpu = distorted_frontend(dev, model), distorted_frontend(cpu, model)
    if fe.identity_rect or fe_cpu.identity_rect:
        raise AssertionError(f"{model}: the distorted rig rectifies by identity")
    H, W = fe.left.height, fe.left.width
    prov = SyntheticStereoProvider(n_frames=2, width=W, height=H, fx=float(fe.stereo.fx))
    row = {"model": model, "size": f"{W}x{H}", "taps": fe.sep_remap_left.n_taps}
    for side in ("left", "right"):
        img = to_uint8(prov.load_image((side, 0)))
        card = getattr(fe, f"_remap_{side}")(torch.from_numpy(img).to(dev)).cpu().numpy()
        want = getattr(fe_cpu, f"_remap_{side}")(torch.from_numpy(img)).numpy()
        err = float(np.abs(card - want).max())
        row[f"{side}_max_abs_err"] = err
        if model != "omni":
            if not err <= 1e-3:
                raise AssertionError(f"{model} {side}: card vs CPU remap {err} gray levels")
            continue
        own = SeparableRemap(getattr(fe, f"map_{side}").cpu().numpy(), device=cpu)
        same_map = float(np.abs(card - own(torch.from_numpy(img)).numpy()).max())
        gap = float((getattr(fe, f"map_{side}").cpu() - getattr(fe_cpu, f"map_{side}")).abs().max())
        f = img.astype(np.float32)
        step = max(np.abs(np.diff(f, axis=0)).max(), np.abs(np.diff(f, axis=1)).max())
        tol = 2.0 * gap * float(step)
        row.update({f"{side}_same_map_max_abs_err": same_map, f"{side}_map_gap_px": gap,
                    f"{side}_tol": tol})
        if not (same_map <= 1e-3 and gap <= 1e-3 and err <= tol):
            raise AssertionError(f"omni {side}: same map {same_map}, map gap {gap} px, "
                                 f"card vs CPU {err} > {tol}")
    log(f"[distorted] {json.dumps(row)}")
    return row


def remap_times(dev) -> dict:
    """(c) One keyframe's two rectifications on the radial-tangential rig:
    the separable remap against the 4-tap gather on the same maps, each
    replayed from a CUDA graph (CUDA events, REMAP_REPS replays) and eager,
    in turns (separable, gather, separable, gather)."""
    fe = distorted_frontend(dev, "radtan")
    prov = SyntheticStereoProvider(n_frames=2, width=fe.left.width, height=fe.left.height,
                                   fx=float(fe.stereo.fx))
    left, right = (torch.from_numpy(prov.load_image((s, 0))).to(dev) for s in ("left", "right"))

    def separable():
        return fe._remap_left(left), fe._remap_right(right)

    def gather():
        return remap_bilinear(left, fe.map_left), remap_bilinear(right, fe.map_right)

    sep_max = max(float((a - b).abs().max()) for a, b in zip(separable(), gather()))
    times = {"separable": [], "gather": []}
    for _ in range(2):
        for name, fn in (("separable", separable), ("gather", gather)):
            times[name].append((graph_ms(fn, REMAP_REPS), time_ms(fn, REMAP_REPS)))
    row = {"rig": "752x480 radial-tangential (EuRoC cam0 / cam1)", "images": 2,
           "reps": REMAP_REPS, "separable_vs_gather_max_abs_diff": sep_max}
    for name, t in times.items():
        row[f"{name}_ms_per_keyframe"] = float(np.mean([g for g, _ in t]))
        row[f"{name}_ms_per_keyframe_turns"] = [g for g, _ in t]
        row[f"{name}_eager_ms_per_keyframe"] = float(np.mean([e for _, e in t]))
    log(f"[distorted] {json.dumps(row)}")
    return row


GUARD_MATCHES = 256


def guard_bearings(scale: float, seed: int, noise: float, outliers: int = 0):
    """(f_ref, f_cur, mask, R) of GUARD_MATCHES matches of points 4-12 m
    away, 10 `scale` m of translation (so |f_ref x R f_cur| lies around
    `scale`), f_cur perturbed by `noise` rad, the last `outliers` matches
    gross outliers and 10 % of the mask off where there are any."""
    rng = np.random.default_rng(seed)
    n = GUARD_MATCHES
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], -1)
    R = so3_exp(torch.tensor([0.02, -0.03, 0.01], dtype=torch.float64)).numpy()
    t = np.array([0.6, 0.2, -0.4])
    p_cur = (pts - t / np.linalg.norm(t) * 10 * scale) @ R
    f_ref = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    f_cur = p_cur / np.linalg.norm(p_cur, axis=-1, keepdims=True)
    f_cur = f_cur + rng.normal(0, noise, f_cur.shape)
    mask = np.ones(n, bool)
    if outliers:
        f_cur[n - outliers:] = rng.normal(size=(outliers, 3)) + [0, 0, 5]
        mask = rng.uniform(size=n) > 0.1
    f_cur /= np.linalg.norm(f_cur, axis=-1, keepdims=True)
    return f_ref.astype(np.float32), f_cur.astype(np.float32), mask, R.astype(np.float32)


def ransac_guard_gate(dev) -> dict:
    """(d) The guarded 2-pt mono RANSAC on CUDA tensors against the CPU
    port, each draw injected alone (`indices`) and as a batch."""
    from kimera_vio_tpu_torch.ops import ransac

    cpu = torch.device("cpu")

    def on(args, device):
        return [torch.from_numpy(a).to(device) for a in args]

    def per_draw(args, idx, device):
        targs, ti = on(args, device), torch.from_numpy(idx).to(device)
        return np.array([int(ransac.ransac_2pt_mono(*targs, indices=ti[h:h + 1])[2])
                         for h in range(len(idx))])

    n = GUARD_MATCHES
    rng = np.random.default_rng(21)
    # Low parallax, noisy: 240 matches and 16 of them again (parallel normals).
    low = guard_bearings(1e-3, 3, 1e-5)
    for a in low[:3]:
        a[n - 16:] = a[:16]
    degenerate = np.concatenate([np.stack([np.arange(n)] * 2, -1),
                                 np.stack([np.arange(16), np.arange(n - 16, n)], -1)])
    deg_scores = per_draw(low, degenerate, dev)
    # Well conditioned: exact inliers, 64 gross outliers, 10 % of the mask off.
    good = guard_bearings(0.039, 4, 0.0, outliers=64)
    valid = np.flatnonzero(good[2])
    proper = np.stack([rng.choice(valid, 2, replace=False) for _ in range(n)])
    card, host = per_draw(good, proper, dev), per_draw(good, proper, cpu)
    mixed = rng.permutation(np.concatenate([proper, np.stack([valid[:64]] * 2, -1)]))
    t_c, inl_c, n_c = ransac.ransac_2pt_mono(*on(good, dev), indices=torch.from_numpy(mixed).to(dev))
    t_h, inl_h, n_h = ransac.ransac_2pt_mono(*on(good, cpu), indices=torch.from_numpy(mixed))
    t_err = float((t_c.cpu() - t_h).abs().max())
    row = {"gate": "2-pt mono RANSAC guard", "matches": n, "degenerate_draws": len(degenerate),
           "degenerate_max_score": int(deg_scores.max()), "proper_draws": len(proper),
           "proper_equal_to_cpu": int((card == host).sum()), "proper_max_score": int(card.max()),
           "batch_n_inliers": int(n_c), "batch_n_inliers_cpu": int(n_h),
           "batch_t_max_abs_err": t_err, "parallel_eps": ransac.PARALLEL_EPS}
    log(f"[distorted] {json.dumps(row)}")
    if not (deg_scores == 0).all():
        raise AssertionError(f"ransac guard: degenerate draws scored {deg_scores.max()}")
    if not ((card == host).all() and int(n_c) == int(n_h)
            and torch.equal(inl_c.cpu(), inl_h) and t_err <= 1e-5):
        raise AssertionError(f"ransac guard: card vs CPU port: {row}")
    return row


def distorted_phase(dev, path: dict) -> dict:
    """Phase 13: a distorted rig. (a) `remap_card_vs_cpu` for the
    radial-tangential (EuRoC cam0 / cam1), equidistant and omni rigs; (b)
    phase 2's 80-frame sequential run() on the radial-tangential rig
    through the default tracker; (c) `remap_times`; (d)
    `ransac_guard_gate`.

    (b) has no ATE gate: the synthetic provider renders undistorted
    images, which a distorted camera model does not fit, so the poses
    drift. Its gates: LK launches = tracked frames (the cache builds = the
    caches the frontend built, `lk_launches`), finite poses, at least one
    keyframe, and each keyframe's pair through the separable remap: one
    left and one right rectification per cache the frontend built (the
    first frame and each keyframe)."""
    res = {"remap": {m: remap_card_vs_cpu(dev, m) for m in ("radtan", "equidistant", "omni")}}
    provider = SyntheticStereoProvider(n_frames=DISTORTED_FRAMES, vx=0.5)
    params = distorted_params("radtan", nr_states=10, max_features=256, max_landmarks=384)
    calls = {"left": 0, "right": 0}
    kf_inliers = []

    def make_pipe():
        pipe = StereoImuPipeline(params, parallel_run=False, device=dev)
        kf_inliers.append(record_keyframe_inliers(pipe))
        fe = pipe.frontend
        if fe.identity_rect:
            raise AssertionError("run radtan: the distorted rig rectifies by identity")
        for side in ("left", "right"):
            remap = getattr(fe, f"sep_remap_{side}")

            def counted(img, remap=remap, side=side):
                calls[side] += 1
                return remap(img)

            setattr(fe, f"sep_remap_{side}", counted)
        return pipe

    with lk_impl(None):
        row, out, pipe = run_variant("distorted radtan", make_pipe, provider,
                                     provider.ground_truth, path["frames_per_s"], None)
    builds = CACHE_BUILDS["frontend"]
    if not (out.n_keyframes >= 1 and calls["left"] == calls["right"] == builds >= 2):
        raise AssertionError(f"run radtan: {out.n_keyframes} keyframes, remaps {calls}, "
                             f"{builds} cache builds")
    step = pipe.stats.get("vio_step [ms]")
    row.update(cache_builds=builds, separable_remaps=calls, step_ms_mean=step.total / step.count,
               ate_note="no gate: undistorted images under a distorted model")
    log(f"[distorted] run radtan keyframe n_mono_inliers {json.dumps(kf_inliers[-1])}")
    log(f"[distorted] {json.dumps(row)}")
    res["run"] = row
    res["times"] = remap_times(dev)
    res["ransac_guard"] = ransac_guard_gate(dev)
    return res


def build_kernels() -> dict:
    """Build csrc/lk_kernel.cu and log each kernel's registers and spills
    (ptxas): {kernel: [ptxas lines]}."""
    t0 = time.perf_counter()
    so, ptxas = lk.build_kernel()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s")
    kernel, build = "?", {}
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '\S*?lk_pyramid_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                      line)
        c = re.search(r"Compiling entry function '\S*?lk_cached_kernelILi(\d)E", line)
        w = re.search(r"Compiling entry function '\S*?lk_cached_warp_kernel", line)
        bk = re.search(r"Compiling entry function '\S*?lk_cache_build_kernelILi(\d)ELi(\d+)ELb(\d)E",
                       line)
        if m:
            kernel = "lk_pyramid_kernel<win {}, search_rows {}, max_win {}>".format(*m.groups())
        elif c:
            kernel = f"lk_cached_kernel<{lk.CACHED_ROUTES[int(c.group(1))]}>"
        elif w:
            kernel = "lk_cached_warp_kernel"
        elif bk:
            kernel = "lk_cache_build_kernel<{}, win {}, staged {}>".format(
                lk.BUILD_ROUTES[int(bk.group(1))], bk.group(2), bool(int(bk.group(3))))
        elif re.search(r"Compiling entry function '\S*?lk_wide_kernel", line):
            kernel = "lk_wide_kernel"
        elif "registers" in line or "spill" in line:
            log(f"[build] {kernel}: {line.strip()}")
            build.setdefault(kernel, []).append(line.strip())
    return build


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # Phases 2-11 run the default tracker; phase 12 sets KIMERA_LK_IMPL itself.
    if os.environ.pop("KIMERA_LK_IMPL", None) is not None:
        log("KIMERA_LK_IMPL unset: phases 2-11 run the default tracker")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    log(cards[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    build = build_kernels()

    t = time.perf_counter()
    kern = kernel_phase(dev)
    kern["cached"] = cached_phase(dev)
    kern["cache_build"] = build_branch_phase(dev)
    log(f"[phase] kernel {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    path = path_phase(dev)
    log(f"[phase] path {time.perf_counter() - t:.1f} s")
    work = tempfile.mkdtemp(prefix="kimera_smoke_")
    try:
        return _phases(dev, kern, path, work, build, cards)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phases(dev, kern: dict, path: dict, work: str, build: dict, cards: list) -> int:
    """Phases 3-13, the kernel table and the result line."""
    t = time.perf_counter()
    cli_res = cli_phase(dev, path, work)
    log(f"[phase] cli {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    lcd_res = lcd_phase(dev, path)
    log(f"[phase] lcd {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    var_res = variants_phase(dev, path)
    log(f"[phase] variants {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    mesh_res = mesher_phase(dev, path)
    log(f"[phase] mesher {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    opt_res = options_phase(dev, path, kern)
    log(f"[phase] options {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    kitti_res = kitti_phase(dev, path, kern["cached"]["1241x376"]["ms"], work)
    live_res = live_phase(dev, path)
    aux_res = aux_phase(dev, path, work)
    log(f"[phase] host modules {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    fleet_res = fleet_phase(dev, path)
    log(f"[phase] fleet {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    codec_res = codec_phase(dev, path, work)
    wide_res = wide_phase(dev, path)
    log(f"[phase] codecs and wide windows {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    fleet_mesh_res = mesh_phase(dev, path, fleet_res, cards)
    log(f"[phase] mesh {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    legacy = legacy_phase(dev, path, kern, work)
    log(f"[phase] legacy trackers {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    distorted = distorted_phase(dev, path)
    log(f"[phase] distorted rig {time.perf_counter() - t:.1f} s")

    # lk_cached_kernel, the default tracker: every run of phases 2-11.
    cm = kern["cached"]["752x480"]
    # The build kernel against plain: every cached row's build, then the
    # builds of its other branches.
    build_rows = {**{label: r["build"] for label, r in kern["cached"].items()},
                  **kern["cache_build"]}
    kernels = [{
        "name": "lk_cached",
        "route": "cuda",
        "source": "kimera_vio_tpu_torch/csrc/lk_kernel.cu",
        "replaces": "kimera_vio_tpu/ops/optical_flow.py:461",
        "also_replaces": ["kimera_vio_tpu/ops/optical_flow.py:352"],
        "launches": path["lk_launches"],
        "launches_cli": {mode: r["lk_launches"] for mode, r in cli_res.items()},
        "launches_lcd": {mode: r["lk_launches"] for mode, r in lcd_res["runs"].items()},
        "launches_variants": {name: r["lk_launches"] for name, r in var_res.items()},
        "launches_mesher": {name: r["lk_launches"] for name, r in mesh_res.items()
                            if isinstance(r, dict) and "lk_launches" in r},
        "launches_options": {name: r["lk_launches"] for name, r in opt_res.items()
                             if isinstance(r, dict) and "lk_launches" in r},
        "launches_kitti": {name: r["lk_launches"] for name, r in kitti_res.items()},
        "kitti_kernel_ms_per_frame": kitti_res["profile"]["kernel_ms_per_frame"],
        "kitti_launch_and_kernel_ms_per_frame":
            kitti_res["gt"]["lk_launch_and_kernel_ms_per_frame"],
        "launches_live": live_res["lk_launches"],
        "launches_aux": {name: r["lk_launches"] for name, r in aux_res.items()
                         if "lk_launches" in r},
        "launches_fleet": {n: r["lk_launches"] for n, r in fleet_res["runs"].items()},
        "launches_mesh": {name: r["lk_launches"] for name, r in fleet_mesh_res.items()},
        "launches_mesh_by_device": {name: r["lk_launches_by_device"]
                                    for name, r in fleet_mesh_res.items()},
        "launches_wide_run": wide_res["run"]["lk_launches"],
        "launches_distorted": distorted["run"]["lk_launches"],
        "launches_codecs": {f"{seq} {codec}": r["lk_launches"]
                            for seq in ("phase3", "slow") for codec, r in codec_res[seq].items()},
        "max_abs_err": cm["max_abs_err"],
        "median_abs_err": cm["median_abs_err"],
        "ms": cm["ms"],
        "ms_no_steps": cm["ms_no_steps"],
        "us_per_step_on_longest_chain": cm["us_per_step_on_longest_chain"],
        "eager_ms": cm["eager_ms"],
        "plain_ms": cm["plain_ms"],
        "bound_ms": cm["bound_ms"],
        "bound_by": cm["bound_by"],
        "library_ms": None,  # no single PyTorch call computes pyramidal LK
        "rows": {label: {k: r.get(k) for k in ("win", "route", "smem_bytes",
                                                 "keypoints_a_block", "max_abs_err",
                                                 "median_abs_err", "ms", "ms_no_steps",
                                                 "us_per_step_on_longest_chain", "plain_ms",
                                                 "bound_ms", "bound_by", "ms_per_stream_frame")}
                 for label, r in kern["cached"].items()},
        "ptxas": {k: v for k, v in build.items() if k.startswith("lk_cached")},
    }, {
        # lk_cache_build_kernel, the default tracker's keyframe half: one
        # launch per cache the frontend builds in every run of phases 2-11.
        "name": "lk_cache_build",
        "route": "cuda",
        "source": "kimera_vio_tpu_torch/csrc/lk_kernel.cu",
        "replaces": "kimera_vio_tpu/ops/optical_flow.py:323",
        "also_replaces": ["kimera_vio_tpu/ops/optical_flow.py:235"],
        "launches": path["cache_builds"],
        "launches_distorted": distorted["run"]["cache_builds"],
        "in_run_ms_per_keyframe": path["cache_build_ms_per_keyframe"],
        "max_abs_err": max(r["max_abs_err"] for r in build_rows.values()),
        "inv_max_rel_err": max(r["inv_max_rel_err"] for r in build_rows.values()),
        "ms": cm["build"]["ms"],
        "eager_ms": cm["build"]["eager_ms"],
        "plain_ms": cm["build"]["plain_ms"],
        "bound_ms": cm["build"]["bound_ms"],
        "bound_by": cm["build"]["bound_by"],
        "library_ms": None,  # no single PyTorch call builds an LK template cache
        "rows": {label: {k: r.get(k) for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                "bound_by", "max_abs_err", "inv_max_rel_err",
                                                "route", "plan", "smem_bytes")}
                 for label, r in build_rows.items()},
        "ptxas": {k: v for k, v in build.items() if k.startswith("lk_cache_build")},
    }, {
        "name": "lk_pyramid",
        "route": "cuda",
        "source": "kimera_vio_tpu_torch/csrc/lk_kernel.cu",
        "replaces": "kimera_vio_tpu/ops/pallas/lk_kernel.py:332",
        "also_replaces": ["kimera_vio_tpu/ops/pallas/lk_kernel.py:68",
                          "kimera_vio_tpu/ops/optical_flow.py:92"],
        # Phase 12: B2 on every level of phase 2's run under "pallas", B1 at
        # level 0 of the KITTI runs under "pallas".
        "launches": legacy["path"]["lk_launches"],
        "launches_kitti": {name: r["lk_launches"] for name, r in legacy["kitti"].items()},
        "kitti_b1_kernel_ms_per_frame": legacy["kitti"]["profile"]["kernel_ms_per_frame"],
        "kitti_b1_launch_and_kernel_ms_per_frame":
            legacy["kitti"]["gt"]["lk_launch_and_kernel_ms_per_frame"],
        "kitti_b1_graph_ms": kern["kitti"]["ms"],
        "kitti_bound_ms": kern["kitti"]["bound_ms"],
        "kitti_plain_ms": kern["kitti"]["plain_ms"],
        # Phase 9: the stream axis, one launch for B streams; its
        # graph-replay ms per stream-frame and bound at B.
        "fleet_ms_per_stream_frame": {n: r["ms_per_stream_frame"]
                                      for n, r in fleet_res["rows"].items()},
        "fleet_ms": {n: r["ms"] for n, r in fleet_res["rows"].items()},
        "fleet_bound_ms": {n: r["bound_ms"] for n, r in fleet_res["rows"].items()},
        "fleet_plain_ms": {n: r["plain_ms"] for n, r in fleet_res["rows"].items()},
        "fleet_max_abs_err": {"752x480": fleet_res["kernel"]["max_abs_err"],
                              "752x480 B=8": fleet_res["kernel8"]["max_abs_err"],
                              "1241x376": fleet_res["kitti"]["max_abs_err"]},
        "max_abs_err": kern["max_abs_err"],
        "median_abs_err": kern["median_abs_err"],
        "ms": kern["ms"],
        "eager_ms": kern["eager_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,  # no single PyTorch call computes pyramidal LK
        # The generic instantiations at 33-54 px (phase 7), per shape.
        "wide": {label: {k: r[k] for k in ("win", "search_rows", "max_abs_err", "median_abs_err",
                                           "ms", "plain_ms", "bound_ms", "bound_by")}
                 for label, r in opt_res["wide"].items()},
        # Phase 10: the lk_wide mode (the gather rule over 54 px), per
        # shape and window.
        "wide_gather": {label: {**{k: r[k] for k in WIDE_KEYS if k != "label"},
                                "library_ms": None}
                        for label, r in wide_res.items() if label not in ("fleet", "run")},
        "wide_gather_ptxas": build.get("lk_wide_kernel"),
        "wide_gather_fleet_max_abs_err": wide_res["fleet"]["max_abs_err"],
    }]
    # lk_wide_kernel (the gather rule over 54 px, one thread-block cluster
    # per keypoint): its run path is phase 12's 61 px run under "gather";
    # its numbers are the 752x480 61 px row (the other rows are under
    # lk_pyramid's wide_gather).
    w61 = wide_res["752x480 win 61 gather rule"]
    kernels.append({
        "name": "lk_wide",
        "route": "cuda",
        "source": "kimera_vio_tpu_torch/csrc/lk_kernel.cu",
        "replaces": "kimera_vio_tpu/ops/optical_flow.py:92",
        "launches": legacy["wide"]["lk_launches"],
        "launches_by_route": legacy["wide"]["lk_launches_by_route"],
        "launch_route": {k: w61[k] for k in ("launcher_route", "clusters", "threads",
                                             "band_rows", "smem_bytes", "active_clusters")},
        "max_abs_err": w61["max_abs_err"],
        "ms": w61["ms"],
        "plain_ms": w61["plain_ms"],
        "bound_ms": w61["bound_ms"],
        "bound_by": w61["bound_by"],
        "library_ms": None,  # no single PyTorch call computes pyramidal LK
        "ptxas": build.get("lk_wide_kernel"),
    })
    # Every kernel launched on a run path of this call.
    for k in kernels:
        if not k["launches"] > 0:
            raise AssertionError(f"{k['name']}: no launch on its run path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
