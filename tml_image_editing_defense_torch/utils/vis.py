"""Visualization: captioned side-by-side comparison grids (port of
``utils/vis.py``).

Same output contract as reference ``utils/vis_utils.py:10-60`` (caption strip
height = 12% of image height per wrapped line, white background, centered
text, images concatenated horizontally) with a system-font fallback instead
of a bundled ttf.
"""

from __future__ import annotations

import textwrap
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

LINE_WIDTH = 20

_FONT_CANDIDATES = [
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/liberation/LiberationSans-Regular.ttf",
    "/usr/share/fonts/TTF/DejaVuSans.ttf",
]


def _load_font(size: int):
    for p in _FONT_CANDIDATES:
        if Path(p).exists():
            try:
                return ImageFont.truetype(p, size)
            except OSError:
                continue
    return ImageFont.load_default()


def add_text_to_image(
    image: np.ndarray,
    text: str,
    text_color: Tuple[int, int, int] = (0, 0, 0),
    min_lines: Optional[int] = None,
    add_below: bool = True,
) -> np.ndarray:
    """Attach a wrapped caption strip above/below an HWC uint8 image."""
    lines = textwrap.wrap(text, width=LINE_WIDTH) or [""]
    if min_lines is not None and len(lines) < min_lines:
        pad = [""] * (min_lines - len(lines))
        lines = lines + pad if add_below else pad + lines
    h, w, c = image.shape
    offset = int(h * 0.12)
    canvas = np.full((h + offset * len(lines), w, c), 255, np.uint8)
    font = _load_font(int(offset * 0.8))
    try:
        bbox = font.getbbox(text or "x")
        y_offset = (offset - bbox[3]) // 2
    except Exception:
        y_offset = offset // 2
    if add_below:
        canvas[:h] = image
    else:
        canvas[-h:] = image
    img = Image.fromarray(canvas)
    draw = ImageDraw.Draw(img)
    for i, line in enumerate(lines):
        bbox = font.getbbox(line or " ")
        x = (w - bbox[2]) // 2
        y = (h if add_below else 0) + y_offset + offset * i
        draw.text((x, y), line, font=font, fill=text_color)
    return np.asarray(img)


def create_table_plot(
    images: List[Image.Image],
    titles: Optional[List[str]] = None,
    captions: Optional[List[str]] = None,
) -> Image.Image:
    """Horizontal table of images with optional titles (above) and captions
    (below) — the reference's eval/vis grid (main.py:127-129, 502-521)."""
    t_lines = (
        max(len(textwrap.wrap(t, LINE_WIDTH) or [""]) for t in titles) if titles else 0
    )
    c_lines = (
        max(len(textwrap.wrap(t, LINE_WIDTH) or [""]) for t in captions) if captions else 0
    )
    cols = []
    for i, im in enumerate(images):
        arr = np.asarray(im.convert("RGB") if isinstance(im, Image.Image) else im)
        if titles is not None:
            arr = add_text_to_image(arr, titles[i], add_below=False, min_lines=t_lines)
        if captions is not None:
            arr = add_text_to_image(arr, captions[i], add_below=True, min_lines=c_lines)
        cols.append(arr)
    return Image.fromarray(np.concatenate(cols, axis=1))
