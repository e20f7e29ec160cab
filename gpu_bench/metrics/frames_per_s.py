"""frames_per_s (host clock): stream-frames finished in the window, summed
over streams, over the window's seconds (from the request of its first
frame to the end of its last)."""


def read(run):
    return run.stream_frames / run.window_s
