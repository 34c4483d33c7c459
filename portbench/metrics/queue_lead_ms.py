"""How deep the stream's queue ran: the median, over every span of the
program's recording of the traced iterations, of the time from the host
enqueuing the span's end mark to the device reaching it (near 0 the device
had run dry and waited for the host)."""

from portbench import spans

LAYER = "device: one H100"
UNIT = "ms"
BETTER = "higher"
MOVES = "image_iters_per_s"


def read(trace):
    rec = spans.recording(trace)
    if rec is None:
        return None
    return spans.median(s.lead_ms for s in rec.spans if s.iteration is not None)
