"""fleet_keyframe_step_ms (host clock): median time of the window's
`FleetVio.step` calls in which the streams keyframe, outside the traced
span: the batched frame step plus every keyframing stream's keyframe
branch and `_keyframe_half` (pose guess, `backend_step`, bias feedback),
one stream after another."""

import numpy as np


def read(run):
    ms = [s.ms for s in run.steps if s.keyframe and not s.traced]
    return float(np.median(ms)) if ms else None
