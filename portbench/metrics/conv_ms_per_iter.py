"""Device milliseconds a profiled iteration spends in convolution kernels
(cuDNN, with the NCHW/NHWC copies it makes)."""

from portbench.trace import CONV

LAYER = "models: unet.py and vae.py convolutions"
UNIT = "ms"
BETTER = "lower"
MOVES = "image_iters_per_s"


def read(trace):
    s = trace.group_s.get(CONV)
    return trace.per_step_ms(s) if s else None
