"""kf_host_syncs (device trace, program spans): median over the traced
span's keyframing stream-frames of the host syncs (CUDA runtime calls
that wait on the card: synchronizes and blocking copies) whose innermost
open program span lies under the stream-frame's
`frontend.keyframe_branch` or `pipeline.keyframe_half`."""

import program_trace


def read(run):
    return program_trace.keyframe_syncs(run)
