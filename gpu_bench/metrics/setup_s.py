"""setup_s (host clock): process start to the window's first hand-off:
imports, loading (or, on a checkout's first run, building) the port's
CUDA library, rendering the period, building the pipeline and the warm-up
frames."""


def read(run):
    return run.setup_s
