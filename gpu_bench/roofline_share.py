"""A kernel's share of its roofline over a traced span: the least time of
its launches at the card's peaks over their device time."""

import roofline


def share(run, kernel: str):
    """Percent for the launches named `kernel` ("lk_cached",
    "lk_cache_build"); None where the span ran none, or where the trace
    and the recorded launches do not pair one to one."""
    if run.trace is None:
        return None
    names = {"lk_cached": lambda n: "lk_cached" in n,
             "lk_cache_build": lambda n: "lk_cache_build" in n}[kernel]
    times = [b - a for n, kind, a, b in run.trace.device if kind == "kernel" and names(n)]
    work = [(nb, fl) for k, nb, fl in run.trace.lk_work if k == kernel]
    if not times or len(times) != len(work):
        return None
    bound = sum(roofline.bound_s(nb, fl) for nb, fl in work)
    return 100.0 * bound / (sum(times) * 1e-9)
