"""lk_cached_roofline_pct (device trace): the traced span's
`lk_cached_kernel` launches (every route: kernel names with "lk_cached"),
their least time at the card's peaks (roofline.cached_work of each
launch's own keypoints, levels and steps) over their device time."""

import roofline_share


def read(run):
    return roofline_share.share(run, "lk_cached")
