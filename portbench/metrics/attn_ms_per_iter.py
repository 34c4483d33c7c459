"""Device milliseconds a profiled iteration spends in the flash-attention
kernels (names holding "flash_")."""

from portbench.trace import ATTENTION

LAYER = "attention kernels: ops/flash_attention.py, csrc/flash_attention.cu"
UNIT = "ms"
BETTER = "lower"
MOVES = "image_iters_per_s"


def read(trace):
    s = trace.group_s.get(ATTENTION)
    return trace.per_step_ms(s) if s else None
