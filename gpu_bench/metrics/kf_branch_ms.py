"""kf_branch_ms (host clock, program spans): median over the traced
span's keyframing stream-frames of the keyframe branch's time, the span
`frontend.keyframe_branch` in `StereoFrontend.finish` (rectification,
mono RANSAC, detection, stereo matching, stereo RANSAC, the LK cache
build)."""

import program_trace


def read(run):
    return program_trace.per_keyframe(
        run, lambda f: program_trace.summed_ms(f, "frontend.keyframe_branch"))
