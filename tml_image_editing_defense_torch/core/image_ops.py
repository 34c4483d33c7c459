"""Host image preprocessing (port of ``core/image_ops.py``, host path).

torchvision-on-PIL semantics: ``Resize(size, BILINEAR)`` on the shorter
side, ``CenterCrop(size)``, ``ToTensor``, ``Normalize([0.5], [0.5])``
(data/dataset.py:16-35): images live in [-1, 1], NCHW.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch
from PIL import Image


def resize_shorter_side(img: Image.Image, size: int) -> Image.Image:
    """Shorter side -> ``size``; long side ``int(size * long / short)``."""
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, int(size * h / w))
    else:
        new_w, new_h = max(1, int(size * w / h)), size
    return img.resize((new_w, new_h), Image.BILINEAR)


def center_crop_pil(img: Image.Image, size: int) -> Image.Image:
    """torchvision ``CenterCrop`` offsets: ``int(round((dim - size) / 2))``."""
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def resize_crop_pil(img: Image.Image, size: int = 512) -> Image.Image:
    """PIL in, PIL out: the reference's eval transform (main.py:447-450)."""
    return center_crop_pil(resize_shorter_side(img, size), size)


def preprocess_pil(img: Image.Image, size: int = 512, normalize: bool = True) -> np.ndarray:
    arr = np.asarray(resize_crop_pil(img, size), np.float32) / 255.0     # HWC, [0,1]
    arr = np.ascontiguousarray(arr.transpose(2, 0, 1)[None])             # NCHW
    if normalize:
        arr = arr * 2.0 - 1.0
    return arr


def load_image(path: Union[str, Path], size: int = 512, normalize: bool = True) -> np.ndarray:
    """Load -> resize/crop -> float32 NCHW numpy, in [-1,1] (normalize) or [0,1]."""
    img = Image.open(path).convert("RGB")
    return preprocess_pil(img, size=size, normalize=normalize)


def to_pil(x: Union[np.ndarray, torch.Tensor], denormalize: bool = True) -> Image.Image:
    """NCHW/CHW float -> PIL, as ``T.ToPILImage()((x/2+0.5).clamp(0,1))``
    (main.py:118-126, 139-140): the uint8 round-trip of the artifact."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    x = np.asarray(x)
    if x.ndim == 4:
        x = x[0]
    if denormalize:
        x = x / 2.0 + 0.5
    x = np.clip(x, 0.0, 1.0)
    arr = (x * 255.0 + 0.5).astype(np.uint8).transpose(1, 2, 0)
    return Image.fromarray(arr)
