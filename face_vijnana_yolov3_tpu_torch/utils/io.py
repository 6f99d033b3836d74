"""Image IO (PIL-backed; the environment has no skimage).

A copy of face_vijnana_yolov3_tpu/utils/io.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def imread(path: str) -> np.ndarray:
    """RGB uint8 array, like the reference's skimage.io.imread on JPEGs."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def imsave(path: str, image: np.ndarray) -> None:
    Image.fromarray(np.asarray(image, dtype=np.uint8)).save(path)
