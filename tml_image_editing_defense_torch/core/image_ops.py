"""Image preprocessing (port of ``core/image_ops.py``).

Host path: torchvision-on-PIL semantics, ``Resize(size, BILINEAR)`` on the
shorter side, ``CenterCrop(size)``, ``ToTensor``, ``Normalize([0.5], [0.5])``
(data/dataset.py:16-35): images live in [-1, 1], NCHW.  Device path: the
same steps on NCHW tensors (JAX ``core/image_ops.py:89-119``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F
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


# ---------------------------------------------------------------------------
# Device path (NCHW tensors)
# ---------------------------------------------------------------------------


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1] (torchvision ``Normalize([0.5], [0.5])``)."""
    return x * 2.0 - 1.0


def denormalize(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], clamped (reference main.py:139)."""
    return torch.clamp(x / 2.0 + 0.5, 0.0, 1.0)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """Antialiased bilinear resize of an NCHW batch, the shorter side to
    ``size`` (``jax.image.resize(..., "bilinear", antialias=True)``)."""
    h, w = x.shape[-2:]
    if h <= w:
        new_h, new_w = size, max(1, int(size * w / h))
    else:
        new_h, new_w = max(1, int(size * h / w)), size
    return F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False,
                         antialias=True)


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """The central ``size`` x ``size`` window (offsets rounded down)."""
    h, w = x.shape[-2:]
    top, left = (h - size) // 2, (w - size) // 2
    return x[..., top:top + size, left:left + size]


def quantize_uint8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """uint8 quantize / dequantize of a [-1, 1] image, the PNG round trip
    that is part of the reference's measured defense (main.py:618-621):
    round half to even, clamp, uint8, back to ``x``'s dtype."""
    u8 = torch.clamp(torch.round(denormalize(x) * 255.0), 0, 255).to(torch.uint8)
    return normalize(u8.to(x.dtype) / 255.0)
