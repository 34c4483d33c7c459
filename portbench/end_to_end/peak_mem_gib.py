"""The allocator's peak of bytes held by tensors on the card over set-up
and window, counted from after the weights were made (none on the CPU)."""

LAYER = "end to end"
UNIT = "GiB"
BETTER = "lower"


def read(run: dict):
    return run["peak_bytes"] / 2**30 if run["peak_bytes"] else None
