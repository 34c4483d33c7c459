"""Device milliseconds an iteration inside the program's VAE spans: the
encode and the decodes, forward and backward."""

from portbench import spans

LAYER = "models: vae.py AutoencoderKL, forward and backward"
UNIT = "ms"
BETTER = "lower"
MOVES = "image_iters_per_s"
NAMES = ("tid.vae.encode", "tid.vae.decode", "tid.vae.encode.backward",
         "tid.vae.decode.backward")


def read(trace):
    return spans.device_ms_per_iter(trace, NAMES)
