"""Device milliseconds an iteration inside the program's attention spans
routed to the flash kernels, ``tid.attention`` and
``tid.attention.backward`` with route "flash" (the input copies included):
``attn_ms_per_iter`` read from the program's spans, not from kernel names."""

from portbench import spans

LAYER = "attention kernels: ops/flash_attention.py, csrc/flash_attention.cu"
UNIT = "ms"
BETTER = "lower"
MOVES = "image_iters_per_s"
NAMES = ("tid.attention", "tid.attention.backward")


def read(trace):
    return spans.device_ms_per_iter(trace, NAMES, lambda s: s.attrs.get("route") == "flash")
