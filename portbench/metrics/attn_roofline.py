"""The least device time of an iteration's long self-attentions, forward
and backward (portbench/counts.py, from the reference and the cell's
shapes), over the time the flash-attention kernels took, in percent."""

from portbench.trace import ATTENTION

LAYER = "attention kernels: ops/flash_attention.py, csrc/flash_attention.cu"
UNIT = "%"
BETTER = "higher"
MOVES = "image_iters_per_s"


def read(trace):
    s = trace.group_s.get(ATTENTION)
    bound = trace.work.get("attention_bound_s")
    if not s or not bound:
        return None
    return 100.0 * bound * trace.units / s
