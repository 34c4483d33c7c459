"""Host milliseconds to issue one iteration of the batch: the median host
time of the program's ``tid.pgd.iteration`` spans in the traced run, the
host's pace beside the device's busy time an iteration."""

from portbench import spans

LAYER = "host dispatch: attack/pgd.py run_pgd to eager torch"
UNIT = "ms"
BETTER = "lower"
MOVES = "image_iters_per_s"


def read(trace):
    rec = spans.recording(trace)
    if rec is None:
        return None
    return spans.median(s.host_ms for s in rec.spans if s.name == spans.ITERATION)
