"""Seconds from the process's start to the start of the window: imports,
weights made on the card, the attack's data, and the warm-up iteration."""

LAYER = "end to end"
UNIT = "s"
BETTER = "lower"


def read(run: dict):
    return run["setup_s"]
