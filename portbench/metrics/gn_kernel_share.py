"""Share of the group norms run by the hand-written kernels: 100 times the
program's ``group_norm.kernel`` count over all its ``group_norm.<route>``
counts, summed over the spans of the traced iterations (a replayed chunk
counts what its capture counted).  None where the program keeps no
recording or counts no group norm."""

from portbench import spans

LAYER = "models: layers.py group and layer norm"
UNIT = "%"
BETTER = "higher"
MOVES = "image_iters_per_s"
PREFIX, KERNEL = "group_norm.", "group_norm.kernel"


def read(trace):
    rec = spans.recording(trace)
    if rec is None:
        return None
    kernel = total = 0
    for s in rec.spans:
        if s.iteration is None:
            continue
        for name, n in s.counts.items():
            if name.startswith(PREFIX):
                total += n
                kernel += n if name == KERNEL else 0
    return 100.0 * kernel / total if total else None
