"""Device operations (kernels, copies, fills) per profiled iteration: what
the host has to issue for one iteration of the batch."""

LAYER = "host dispatch: attack/pgd.py run_pgd to eager torch"
UNIT = "launches"
BETTER = "lower"
MOVES = "image_iters_per_s"


def read(trace):
    return trace.device_ops / trace.steps if trace.device_ops else None
