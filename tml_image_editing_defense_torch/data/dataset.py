"""Image/prompt dataset (port of ``data/dataset.py``; reference
data/dataset.py:7-43).

A folder of images with the canonical resize (shorter side) -> center crop
-> normalize to [-1, 1] transform of ``core/image_ops.load_image``.  It
yields numpy CHW float32 arrays and the default prompt; the caller moves
them to the device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from tml_image_editing_defense_torch.core.image_ops import load_image

_EXTS = (".jpg", ".jpeg", ".png")


class ImagePromptDataset:
    def __init__(self, image_dir: str, default_prompt: str = "", size: int = 512,
                 normalize: bool = True, recursive: bool = True):
        self.default_prompt = default_prompt
        self.size = size
        self.normalize = normalize
        root = Path(image_dir)
        glob = root.rglob if recursive else root.glob
        self.paths: List[Path] = sorted(p for p in glob("*") if p.suffix.lower() in _EXTS)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        arr = load_image(self.paths[idx], self.size, normalize=self.normalize)
        return arr[0], self.default_prompt      # CHW, prompt

    def batches(self, batch_size: int,
                drop_remainder: bool = False) -> Iterator[Tuple[np.ndarray, List[str]]]:
        """Yield (images [B, C, H, W], prompts) batches in order."""
        n = len(self)
        end = n - n % batch_size if drop_remainder else n
        for start in range(0, end, batch_size):
            imgs = np.stack([self[i][0] for i in range(start, min(start + batch_size, n))])
            yield imgs, [self.default_prompt] * len(imgs)
