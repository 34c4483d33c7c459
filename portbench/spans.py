"""The program's own recording of the traced iterations, for the readers of
``source: program_span`` metrics.

While ``torch.profiler`` runs, the program's ``run_pgd`` records its spans
(``tml_image_editing_defense_torch/utils/profiling.py``: a
``tid.pgd.iteration`` span an iteration, the EOT chunks, UNet, VAE and
attention calls under it, each with its host times and, on a card, its
extent on the stream).  The traced run's recording is the program's last
one.  A program without that recorder gives none, and the readers then
return None.
"""

from __future__ import annotations

import statistics
from typing import Callable, Iterable, Optional

ITERATION = "tid.pgd.iteration"


def recording(trace):
    """The program's last recording, or None where the program keeps none.
    Raises where its iterations are not the traced run's ``trace.steps``."""
    try:
        from tml_image_editing_defense_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_recording", None)
    rec = last() if last is not None else None
    if rec is None:
        return None
    n = sum(s.name == ITERATION for s in rec.spans)
    if n != trace.steps:
        raise ValueError(f"the program's recording holds {n} {ITERATION} spans, "
                         f"the traced run {trace.steps} iterations")
    return rec


def median(values: Iterable[Optional[float]]) -> Optional[float]:
    vals = [v for v in values if v is not None]
    return statistics.median(vals) if vals else None


def device_ms_per_iter(trace, names, keep: Callable = lambda s: True) -> Optional[float]:
    """Device milliseconds an iteration in the spans named in ``names`` that
    ``keep`` accepts, each counted once: a span inside another counted one
    (a forward recomputed in a backward) is left out."""
    rec = recording(trace)
    if rec is None:
        return None
    by_id = {s.id: s for s in rec.spans}

    def counted(s):
        return s.name in names and keep(s)

    total, found = 0.0, False
    for s in rec.spans:
        if not counted(s) or s.device_ms is None:
            continue
        p = by_id.get(s.parent)
        while p is not None and not counted(p):
            p = by_id.get(p.parent)
        if p is None:
            total += s.device_ms
            found = True
    return total / trace.steps if found else None
