"""Salient-object segmentation (reference C12: the RMBG-1.4 mask that
restricts the perturbation to the foreground, ``main.py:311-322``, applied
on the L2 branch at ``main.py:260-261``; port of ``aux_models/segment.py``).

:func:`get_salient_mask` tries three routes in the JAX package's order:

1. **ISNet** (:func:`isnet_salient_mask`), when ``model_path`` is an
   RMBG-1.4 checkpoint directory (``*.safetensors``) or a model is passed:
   :mod:`~tml_image_editing_defense_torch.models.isnet` on the device, with
   the RMBG pipeline's pre- and post-processing;
2. the ``transformers`` ``image-segmentation`` pipeline
   (:func:`torch_salient_mask`), the reference's own stack, kept for other
   checkpoints;
3. a deterministic gradient-energy saliency heuristic, so that the masked
   attack runs with no checkpoint at all.  It is an approximation, on
   purpose the JAX package's: the same image gives the same mask in both.

:func:`salient_mask_and_route` is the same chain that also names the route
that gave the mask ("isnet", "pipeline" or "heuristic"), so that a caller
can see a checkpoint that fell through.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch
from PIL import Image

from tml_image_editing_defense_torch.core.image_ops import resize_crop_pil
from tml_image_editing_defense_torch.utils.device import resolve_device

_DEFAULT_MODEL = "briaai/RMBG-1.4"


def _heuristic_saliency(img: np.ndarray) -> np.ndarray:
    """Center-prior gradient-energy saliency, binarized at its mean.

    ``img``: HWC float [0,1].  Returns {0,1} float mask [H,W].
    """
    gray = img.mean(-1)
    gy, gx = np.gradient(gray)
    energy = np.hypot(gx, gy)
    # smooth with a cheap box blur (three passes ≈ gaussian)
    k = max(3, energy.shape[0] // 32) | 1
    for _ in range(3):
        # integral image with a zero top row/left column so the k×k box sum
        # keeps the full H×W extent
        c = np.cumsum(np.cumsum(np.pad(energy, k // 2, mode="edge"), 0), 1)
        c = np.pad(c, ((1, 0), (1, 0)))
        energy = (
            c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
        ) / (k * k)
    h, w = energy.shape
    yy, xx = np.mgrid[0:h, 0:w]
    center = np.exp(-(((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2))
    sal = energy * center
    return (sal > sal.mean()).astype(np.float32)


def _merge_pipeline_output(out, size: int) -> Image.Image:
    """The two ``transformers`` segmentation output contracts as one
    grayscale PIL mask.

    - RMBG-1.4's custom pipeline (``trust_remote_code``) returns a single
      PIL mask with ``return_mask=True`` (the reference call, main.py:317-320).
    - Standard ``image-segmentation`` pipelines return ``[{label, score,
      mask}, ...]``: the union of every non-background segment.
    """
    if isinstance(out, Image.Image):
        return out.convert("L")
    if isinstance(out, list) and out and isinstance(out[0], dict):
        fg = [d for d in out if str(d.get("label", "")).lower() != "background"]
        fg = fg or out
        acc = np.zeros((size, size), np.float32)
        for d in fg:
            m = np.asarray(resize_crop_pil(d["mask"].convert("L"), size), np.float32)
            acc = np.maximum(acc, m)
        return Image.fromarray(acc.astype(np.uint8), mode="L")
    raise TypeError(f"unrecognized segmentation pipeline output: {type(out)}")


def torch_salient_mask(
    image_path: Union[str, Path],
    size: int = 512,
    model_path: Optional[str] = None,
    threshold: float = 0.5,
) -> np.ndarray:
    """The ``transformers`` segmentation pipeline (raises if the checkpoint
    or the package is missing).

    ``model_path``: a local checkpoint directory; ``None`` resolves to the
    reference's ``briaai/RMBG-1.4`` (needs network or a warm HF cache)."""
    from transformers import pipeline as hf_pipeline

    src = model_path or _DEFAULT_MODEL
    pipe = hf_pipeline("image-segmentation", model=str(src), trust_remote_code=True,
                       local_files_only=model_path is not None)
    try:
        out = pipe(str(image_path), return_mask=True)   # RMBG custom pipeline
    except TypeError:
        out = pipe(str(image_path))                     # standard pipeline
    mask_img = _merge_pipeline_output(out, size)
    mask = np.asarray(resize_crop_pil(mask_img, size), np.float32) / 255.0
    return (mask > threshold).astype(np.float32)


def isnet_salient_mask(
    image_path: Union[str, Path],
    size: int = 512,
    model_path: Optional[str] = None,
    threshold: float = 0.5,
    isnet_bundle=None,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """ISNet inference (models/isnet.py) with the RMBG pipeline's pre- and
    post-processing: the counterpart of the JAX ``flax_salient_mask``
    (segment.py:104-131).  ``isnet_bundle`` is a built ISNet (it runs on its
    own device); otherwise ``model_path`` must be an RMBG-1.4 checkpoint
    directory, loaded on ``device`` and dropped on return."""
    from tml_image_editing_defense_torch.models.isnet import load_rmbg_checkpoint, salient_mask

    if isnet_bundle is None:
        if model_path is None:
            raise FileNotFoundError("no local RMBG checkpoint directory given")
        isnet_bundle = load_rmbg_checkpoint(model_path, device=device)
    # The training image's geometry (core/image_ops.load_image: resize the
    # shorter side, center crop) BEFORE inference, so that the mask lies on
    # the frame the attack perturbs for any non-square photo.
    img = resize_crop_pil(Image.open(image_path).convert("RGB"), size)
    arr = np.asarray(img, np.float32) / 255.0
    return salient_mask(isnet_bundle, arr, out_size=size, threshold=threshold)


def salient_mask_and_route(
    image_path: Union[str, Path],
    size: int = 512,
    model_path: Optional[str] = None,
    threshold: float = 0.5,
    isnet_bundle=None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, str]:
    """:func:`get_salient_mask`'s mask and the route that gave it:
    "isnet", "pipeline" or "heuristic"."""
    if isnet_bundle is None:
        device = resolve_device(device)
    try:
        return isnet_salient_mask(image_path, size, model_path, threshold,
                                  isnet_bundle=isnet_bundle, device=device), "isnet"
    except Exception as e:
        if isnet_bundle is not None or (
            model_path and any(Path(model_path).glob("*.safetensors"))
        ):
            # a checkpoint was offered to ISNet: say why it fell through
            print(f"[aux.segment] ISNet path failed ({type(e).__name__}: {e}); "
                  "trying the torch pipeline")
    try:
        return torch_salient_mask(image_path, size, model_path, threshold), "pipeline"
    except Exception as e:
        print(f"[aux.segment] RMBG unavailable ({type(e).__name__}); using heuristic saliency")
        pil = resize_crop_pil(Image.open(image_path).convert("RGB"), size)
        arr = np.asarray(pil, np.float32) / 255.0
        return _heuristic_saliency(arr), "heuristic"


def get_salient_mask(
    image_path: Union[str, Path],
    size: int = 512,
    model_path: Optional[str] = None,
    threshold: float = 0.5,
    isnet_bundle=None,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Foreground mask at ``[size, size]``, binarized at 0.5 like the
    reference (``main.py:320-321``).  Returns float32 {0,1} [H,W].

    ISNet first (see the module docstring); the ``transformers`` pipeline
    and the heuristic are the fallbacks, as in the JAX package.  Without a
    passed model, ``device`` is checked first: a missing card raises rather
    than sending the mask down a fallback."""
    return salient_mask_and_route(image_path, size, model_path, threshold, isnet_bundle,
                                  device)[0]
