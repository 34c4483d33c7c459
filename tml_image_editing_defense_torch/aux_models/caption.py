"""Image captioning (reference C11: the BLIP-2 "what is shown in the image?"
prompt prefix, ``main.py:324-332``; port of ``aux_models/caption.py``).

:func:`torch_image_caption` runs a BLIP-2 checkpoint through
``transformers`` (imported when called; the reference's
``Salesforce/blip2-flan-t5-xl`` or any local BLIP-2 directory) on the
caller's device; :func:`get_image_caption` wraps it and degrades to an
empty caption, the reference's default behaviour
(``default_source_image_caption=""``, ``add_image_caption_to_prompts=False``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from PIL import Image

_DEFAULT_MODEL = "Salesforce/blip2-flan-t5-xl"
_QUESTION = "what is shown in the image?"


def torch_image_caption(
    image: Image.Image,
    model_path: Optional[str] = None,
    max_new_tokens: int = 20,
    device: Union[str, torch.device] = "cuda",
) -> str:
    """BLIP-2 caption of ``image`` (raises if the checkpoint is missing):
    processor(question) -> generate -> batch_decode, as the reference calls
    it (main.py:324-332).  The JAX package runs it on the CPU; here the
    model goes to ``device``."""
    from transformers import AutoProcessor, Blip2ForConditionalGeneration

    src = model_path or _DEFAULT_MODEL
    local = model_path is not None
    processor = AutoProcessor.from_pretrained(src, local_files_only=local)
    model = Blip2ForConditionalGeneration.from_pretrained(
        src, torch_dtype=torch.float32, local_files_only=local).to(device)
    inputs = processor(image, _QUESTION, return_tensors="pt").to(device)
    ids = model.generate(**inputs, max_new_tokens=max_new_tokens)
    return processor.batch_decode(ids, skip_special_tokens=True)[0].strip()


def get_image_caption(
    image: Image.Image,
    model_path: Optional[str] = None,
    max_new_tokens: int = 20,
    device: Union[str, torch.device] = "cuda",
) -> str:
    """The BLIP-2 caption used as a prompt prefix (main.py:324-332), or ""
    when no BLIP-2 can be loaded."""
    try:
        return torch_image_caption(image, model_path, max_new_tokens, device)
    except Exception as e:  # no weights / no network / no transformers: no prefix
        print(f"[aux.caption] BLIP-2 unavailable ({type(e).__name__}); using empty caption")
        return ""
