"""kf_backend_ms (host clock, program spans): median over the traced
span's keyframing stream-frames of the backend's time, the span
`backend.step` around `backend_step` in `_keyframe_half`
(marginalization, landmarks, every Gauss-Newton iteration)."""

import program_trace


def read(run):
    return program_trace.per_keyframe(run, lambda f: program_trace.summed_ms(f, "backend.step"))
