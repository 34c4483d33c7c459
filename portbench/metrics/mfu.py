"""Useful FLOPs of an image-iteration (counted on the reference, see
portbench/counts.py) times the run's untraced image-iterations a second,
over the card's data-sheet peak at the cell's dtype, in percent."""

LAYER = "the whole PGD iteration"
UNIT = "%"
BETTER = "higher"
MOVES = "image_iters_per_s"


def read(trace):
    peak = trace.work.get("peak")
    if not peak:
        return None
    return 100.0 * trace.work["flops"] * trace.run["image_iters_per_s"] / peak["flops"]
