"""Device milliseconds a profiled iteration spends in group and layer norm
kernels."""

from portbench.trace import NORM

LAYER = "models: layers.py group and layer norm"
UNIT = "ms"
BETTER = "lower"
MOVES = "image_iters_per_s"


def read(trace):
    s = trace.group_s.get(NORM)
    return trace.per_step_ms(s) if s else None
