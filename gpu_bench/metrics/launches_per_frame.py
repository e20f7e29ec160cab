"""launches_per_frame (device trace): kernels the traced span ran, over
the stream-frames it held."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    n = sum(1 for _, kind, _, _ in run.trace.device if kind == "kernel")
    return n / run.trace.stream_frames
