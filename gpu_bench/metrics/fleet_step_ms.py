"""fleet_step_ms (host clock): median time of the window's `FleetVio.step`
calls outside the traced span, the card synchronised after each. Most
steps keyframe no stream, so this is the batched frame step: pyramids,
preintegration and one LK launch for every stream, and the policy."""

import numpy as np


def read(run):
    ms = [s.ms for s in run.steps if not s.traced]
    return float(np.median(ms)) if ms else None
