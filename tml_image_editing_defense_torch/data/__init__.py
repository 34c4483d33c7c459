"""The image/prompt dataset of the universal attack."""

from tml_image_editing_defense_torch.data.dataset import ImagePromptDataset

__all__ = ["ImagePromptDataset"]
