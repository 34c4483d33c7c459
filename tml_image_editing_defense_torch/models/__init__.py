"""The networks (UNet, VAE, CLIP text, the TAESD preview autoencoder, the
ISNet segmenter) and the model bundle."""

from tml_image_editing_defense_torch.models.isnet import (
    ISNet,
    ISNetConfig,
    build_isnet,
    load_rmbg_checkpoint,
    salient_mask,
)
from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel, PromptBank, build_model
from tml_image_editing_defense_torch.models.tiny_vae import (
    AutoencoderTiny,
    TinyAutoencoder,
    build_tiny_autoencoder,
)

__all__ = ["AutoencoderTiny", "DiffusionModel", "ISNet", "ISNetConfig", "PromptBank",
           "TinyAutoencoder", "build_isnet", "build_model", "build_tiny_autoencoder",
           "load_rmbg_checkpoint", "salient_mask"]
