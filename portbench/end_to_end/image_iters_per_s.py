"""PGD iterations completed in the window times the images each advanced,
over the time from the window's start to the wait after its last iteration."""

LAYER = "end to end"
UNIT = "image-iter/s"
BETTER = "higher"


def read(run: dict):
    return run["units"] / run["seconds"] if run["seconds"] > 0 else None
