"""lk_cache_build_roofline_pct (device trace): the traced span's
`lk_cache_build_kernel` launches, their least time at the card's peaks
(roofline.cached_build_work of each launch's keyframe keypoints) over
their device time."""

import roofline_share


def read(run):
    return roofline_share.share(run, "lk_cache_build")
