"""Editing pipelines: img2img (SDEdit) and txt2img."""

from tml_image_editing_defense_torch.pipelines.img2img import Img2ImgPipeline, Txt2ImgPipeline

__all__ = ["Img2ImgPipeline", "Txt2ImgPipeline"]
