"""The SD-1.5 networks (UNet, VAE, CLIP text) and the model bundle."""

from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel, PromptBank, build_model

__all__ = ["DiffusionModel", "PromptBank", "build_model"]
