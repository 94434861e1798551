"""Debug visualization (PIL-based, replaces the reference's cv2 drawing).

Covers utils.put_text_box (track_generation/utils.py:95-128) for annotating
prompt/track debug renders, plus mask overlay helpers. Host-only, not on any
compute path.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def put_text_box(img: np.ndarray, text: str, top_left: tuple,
                 bottom_right: tuple, color: tuple) -> np.ndarray:
    """Draw a filled label box with text near a bounding box.

    Placement mirrors the reference: above the box when it fits, else below,
    else inside the top edge (utils.py:108-125). Empty text renders as
    "[NONE]".
    """
    from PIL import Image, ImageDraw
    if text.strip() == "":
        text = "[NONE]"
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    bbox = draw.textbbox((0, 0), text)
    text_w, text_h = bbox[2] - bbox[0], bbox[3] - bbox[1] + 4
    x0, y0 = int(top_left[0]), int(top_left[1])
    x1, y1 = int(bottom_right[0]), int(bottom_right[1])
    if y0 - text_h < 0:
        if y1 + text_h > img.shape[0]:
            org = (x0, y0)
        else:
            org = (x0, y1)
    else:
        org = (x0, y0 - text_h)
    draw.rectangle([org, (org[0] + text_w, org[1] + text_h)],
                   fill=tuple(int(c) for c in color))
    draw.text((org[0], org[1]), text, fill=(0, 0, 0))
    return np.asarray(pil)


def overlay_mask(img: np.ndarray, mask: np.ndarray,
                 color: tuple = (255, 64, 64),
                 alpha: float = 0.5) -> np.ndarray:
    """Alpha-blend a binary mask onto an RGB image."""
    out = img.astype(np.float32).copy()
    m = np.asarray(mask) > 0
    out[m] = (1 - alpha) * out[m] + alpha * np.asarray(color, np.float32)
    return out.astype(np.uint8)


def draw_box(img: np.ndarray, box: Sequence[float],
             color: tuple = (64, 255, 64), width: int = 2) -> np.ndarray:
    """Draw an xyxy box outline."""
    from PIL import Image, ImageDraw
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    draw.rectangle([int(box[0]), int(box[1]), int(box[2]), int(box[3])],
                   outline=tuple(int(c) for c in color), width=width)
    return np.asarray(pil)
