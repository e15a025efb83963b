"""Host-side image decode / resize / crop (PIL, BICUBIC).

A copy of ``intro_tc_vae_tpu/data/image.py`` (reference dataset.py:291-336,
load_image): RGB/L convert, optional mirror, BICUBIC resize to the input
size, optional random/center crop, BICUBIC resize to the output size.
Returns float32 HWC in [0, 1], the same bytes as the JAX package's.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageOps


def load_image(
    file_path: str,
    input_height: int | None = 128,
    input_width: int | None = None,
    output_height: int = 128,
    output_width: int | None = None,
    crop_height: int | None = None,
    crop_width: int | None = None,
    is_random_crop: bool = True,
    is_mirror: bool = True,
    is_gray: bool = False,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Decode + resize one image file to float32 HWC in [0, 1]."""
    if input_width is None:
        input_width = input_height
    if output_width is None:
        output_width = output_height
    if crop_width is None:
        crop_width = crop_height
    rng = rng or np.random

    img = Image.open(file_path)
    if not is_gray and img.mode != "RGB":
        img = img.convert("RGB")
    if is_gray and img.mode != "L":
        img = img.convert("L")

    if is_mirror and rng.randint(0, 2) == 0:
        img = ImageOps.mirror(img)

    if input_height is not None:
        img = img.resize((input_width, input_height), Image.BICUBIC)

    if crop_height is not None:
        w, h = img.size
        if is_random_crop:
            cx1 = rng.randint(0, w - crop_width + 1)
            cx2 = w - crop_width - cx1
            cy1 = rng.randint(0, h - crop_height + 1)
            cy2 = h - crop_height - cy1
        else:
            cx2 = cx1 = int(round((w - crop_width) / 2.0))
            cy2 = cy1 = int(round((h - crop_height) / 2.0))
        img = ImageOps.crop(img, (cx1, cy1, cx2, cy2))

    img = img.resize((output_width, output_height), Image.BICUBIC)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr
