"""PyTorch / CUDA port of ``tml_image_editing_defense_tpu`` for one NVIDIA H100.

PGD immunization of an image against Stable Diffusion img2img editing
(PhotoGuard-style): the attack differentiates through VAE encode, noise-add,
a K-step CFG UNet chain and VAE decode.  The JAX package beside this one is
the reference the port is held against; this package imports none of it.

The long self-attentions and the PGD updates run as hand-written CUDA
kernels (``csrc/``, built with nvcc for sm_90a at first use); everything else
is plain PyTorch.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from tml_image_editing_defense_torch.api import ImmunizeResult, evaluate, immunize
from tml_image_editing_defense_torch.configs import InferenceConfig, TrainConfig

__all__ = ["ImmunizeResult", "InferenceConfig", "TrainConfig", "evaluate", "immunize"]
