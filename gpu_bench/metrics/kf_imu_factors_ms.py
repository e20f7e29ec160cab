"""kf_imu_factors_ms (host clock, program spans): median over the traced
span's keyframing stream-frames of the summed `backend.imu_factors` spans
(`_imu_factor_blocks`: the IMU and bias factors' Jacobians by `jacfwd`).
The sum holds every call in the stream-frame: one in each Gauss-Newton
iteration (`backend.gn_iter`) and one in the marginalization of the
oldest state (`backend.marginalize`), which builds the same factors for
the pair it drops."""

import program_trace


def read(run):
    return program_trace.per_keyframe(
        run, lambda f: program_trace.summed_ms(f, "backend.imu_factors"))
