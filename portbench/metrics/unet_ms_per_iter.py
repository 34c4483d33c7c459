"""Device milliseconds an iteration inside the program's UNet spans,
``tid.unet`` (forward) and ``tid.unet.backward``, attention included."""

from portbench import spans

LAYER = "models: unet.py UNet2DCondition, forward and backward"
UNIT = "ms"
BETTER = "lower"
MOVES = "image_iters_per_s"
NAMES = ("tid.unet", "tid.unet.backward")


def read(trace):
    return spans.device_ms_per_iter(trace, NAMES)
