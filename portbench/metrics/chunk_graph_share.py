"""Share of the EOT chunks served by replaying CUDA graphs: 100 times the
program's ``eot.chunks.graph`` count over that count plus
``eot.chunks.eager``, summed over the spans of the traced iterations.  None
where the program keeps no recording or counts neither."""

from portbench import spans

LAYER = "host dispatch: attack/pgd.py run_pgd to eager torch"
UNIT = "%"
BETTER = "higher"
MOVES = "image_iters_per_s"
GRAPH, EAGER = "eot.chunks.graph", "eot.chunks.eager"


def read(trace):
    rec = spans.recording(trace)
    if rec is None:
        return None
    graph = eager = 0
    for s in rec.spans:
        if s.iteration is not None:
            graph += s.counts.get(GRAPH, 0)
            eager += s.counts.get(EAGER, 0)
    return 100.0 * graph / (graph + eager) if graph + eager else None
