#!/usr/bin/env python3
"""CPU rehearsal of fine IMU-camera time alignment on the 6-DoF orbit.

Runs `StereoImuPipeline.run()` of the JAX package (`--package jax`, with
its gather LK) or of the port (`--package torch`, on the CPU) with
`do_fine_imu_camera_temporal_sync` on chip_smoke.py's phase-4 orbit (one
4 s period on every axis, pixel and IMU noise, seed 3), cut to 320x240 so
that it runs on a CPU, and prints the time-shift estimate, the frames
published and the ATE. `--scaling` sets the aligner's variance-gate
scaling (the reference's default is 30); `--jax-draws` makes the port
draw the JAX package's RANSAC hypotheses and track with the gather
tracker's level plan.

    python scripts/rehearse_time_sync.py --package jax --frames 160 --scaling 1
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=["jax", "torch"], required=True)
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--scaling", type=float, default=None)
    ap.add_argument("--jax-draws", action="store_true")
    args = ap.parse_args()
    W, H, FX = 320, 240, 450.0 * 320 / 752
    kw = {}
    if args.package == "jax":
        os.environ["KIMERA_LK_IMPL"] = "gather"
        import jax

        jax.config.update("jax_platforms", "cpu")
        from kimera_vio_tpu.config import flags
        from kimera_vio_tpu.dataprovider import synthetic as mod
        from kimera_vio_tpu.pipeline.stereo_pipeline import StereoImuPipeline
        from kimera_vio_tpu.utils.logger import compute_ate
    else:
        from kimera_vio_tpu_torch.config import flags
        from kimera_vio_tpu_torch.dataprovider import synthetic as mod
        from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
        from kimera_vio_tpu_torch.utils.logger import compute_ate

        kw["device"] = "cpu"
        if args.jax_draws:
            import importlib.util

            from kimera_vio_tpu_torch.frontend import vision_frontend
            from kimera_vio_tpu_torch.ops import ransac
            from kimera_vio_tpu_torch.ops.lk_kernel import klt_track_lk

            spec = importlib.util.spec_from_file_location(
                "tv", os.path.join(REPO, "tests", "test_torch_variants.py"))
            tv = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(tv)
            vision_frontend.klt_track_lk = functools.partial(klt_track_lk, search_rows=None)
            ransac._sample_indices = tv._jax_draws
    w = 2 * np.pi / 4.0
    noise = mod._NoiseModel(imu_rate=200.0, pixel_noise_std=0.3, acc_noise_density=2.0e-3,
                            gyro_noise_density=1.6968e-4, seed=3)
    prov = mod.SyntheticPlanar6DofProvider(
        n_frames=args.frames, width=W, height=H, fx=FX, noise=noise, trans_amp=(0.8, 0.4, 0.2),
        rot_amp=(0.05, 0.06, 0.08), trans_freq=(w, w, w), rot_freq=(w, w, w))
    params = mod.synthetic_params(width=W, height=H, fx=FX, nr_states=10, max_features=128,
                                  max_landmarks=192)
    if args.scaling is not None:
        params.imu.time_alignment_variance_threshold_scaling = args.scaling
    flags.set_flag("do_fine_imu_camera_temporal_sync", True)
    # The variance gate's two sides at the last attempt: var(a) against
    # scaling * var(diff(a)) of the gyro signal a = |w| dt.
    gate = {}
    tmod = __import__(("kimera_vio_tpu" if args.package == "jax" else "kimera_vio_tpu_torch")
                      + ".initial.time_alignment", fromlist=["CrossCorrTimeAligner"])
    orig = tmod.CrossCorrTimeAligner.attempt_estimation

    def attempt(self):
        m = min(len(self.imu_signal), len(self.vis_signal))
        if m >= self.n // 2:
            a = np.asarray(self.imu_signal[-m:], np.float32)
            gate.update(var=float(np.var(a)),
                        scaled_var_diff=float(self.variance_threshold_scaling * np.var(np.diff(a))))
        return orig(self)

    tmod.CrossCorrTimeAligner.attempt_estimation = attempt
    t0 = time.time()
    pipe = StereoImuPipeline(params, parallel_run=False, **kw)
    out = pipe.run(prov)
    gt = prov.ground_truth
    ate = compute_ate(np.array(out.stamps_ns), np.stack(out.positions), gt.stamps_ns, gt.positions,
                      align=False)["rmse"]
    print(f"{args.package} frames_fed={args.frames} scaling={params.imu.time_alignment_variance_threshold_scaling}"
          f" estimate_s={pipe.time_shift_estimate_s} published={out.n_frames}"
          f" keyframes={out.n_keyframes} ate_m={ate:.6f} wall_s={time.time() - t0:.1f}"
          f" last_gate={gate}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
