"""ADM-style crops (ref dataset/augmentation.py:8-50, itself from
openai/guided-diffusion): the port's copy of the JAX package's
`data/augmentation.py`. Host-side numpy/PIL; used by offline extraction."""
from __future__ import annotations

import math
import random

import numpy as np
from PIL import Image


def center_crop_arr(pil_image: Image.Image, image_size: int) -> Image.Image:
    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX
        )
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC
    )
    arr = np.array(pil_image)
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    return Image.fromarray(arr[crop_y: crop_y + image_size, crop_x: crop_x + image_size])


def random_crop_arr(
    pil_image: Image.Image, image_size: int,
    min_crop_frac: float = 0.8, max_crop_frac: float = 1.0,
    rng: random.Random | None = None,
) -> Image.Image:
    rng = rng or random
    min_smaller = math.ceil(image_size / max_crop_frac)
    max_smaller = math.ceil(image_size / min_crop_frac)
    smaller = rng.randrange(min_smaller, max_smaller + 1)
    while min(*pil_image.size) >= 2 * smaller:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX
        )
    scale = smaller / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC
    )
    arr = np.array(pil_image)
    crop_y = rng.randrange(arr.shape[0] - image_size + 1)
    crop_x = rng.randrange(arr.shape[1] - image_size + 1)
    return Image.fromarray(arr[crop_y: crop_y + image_size, crop_x: crop_x + image_size])
