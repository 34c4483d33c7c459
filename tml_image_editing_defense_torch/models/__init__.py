"""The networks (UNet, VAE, CLIP text, the TAESD preview autoencoder) and
the model bundle."""

from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel, PromptBank, build_model
from tml_image_editing_defense_torch.models.tiny_vae import (
    AutoencoderTiny,
    TinyAutoencoder,
    build_tiny_autoencoder,
)

__all__ = ["AutoencoderTiny", "DiffusionModel", "PromptBank", "TinyAutoencoder", "build_model",
           "build_tiny_autoencoder"]
