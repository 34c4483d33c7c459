"""Share of the profiled wall time in which no device operation ran, in
percent (the union of the device spans; the profiler lengthens the host's
work, so this is an upper bound)."""

LAYER = "device: one H100"
UNIT = "%"
BETTER = "lower"
MOVES = "image_iters_per_s"


def read(trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s) if trace.window_s > 0 else None
