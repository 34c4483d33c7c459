"""The auxiliary models of the attack: the salient-object mask
(:mod:`.segment`) and the BLIP-2 caption prefix (:mod:`.caption`)."""

from tml_image_editing_defense_torch.aux_models.caption import get_image_caption
from tml_image_editing_defense_torch.aux_models.segment import get_salient_mask

__all__ = ["get_image_caption", "get_salient_mask"]
