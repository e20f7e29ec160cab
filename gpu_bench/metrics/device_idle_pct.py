"""device_idle_pct (device trace): 100 minus the share of the traced span
in which some device activity (kernel, copy, fill) ran, from the union of
their intervals (not their sum, which counts overlap twice)."""


def read(run):
    import harness

    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - harness.busy_s(run.trace) / run.trace.window_s)
