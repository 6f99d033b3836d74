"""A seeded synthetic face-detection set (no download): bright disks on
textured noise, written as JPEGs with `training.csv` / `validation.csv` in
the UCCS column layout.

A copy of `make_dataset` from scripts/synthetic_e2e.py:24-60, which belongs
to the JAX package's tooling (the port imports nothing of it);
tests/test_torch_train.py holds the two to the same files, pixel for pixel.
"""

from __future__ import annotations

import os

import numpy as np


def make_dataset(root: str, n_train: int = 160, n_val: int = 40,
                 image_size: int = 416, seed: int = 0) -> str:
    """Write n_train + n_val square images of `image_size` under `root`,
    1-3 disks of radius 24-55 each, every disk a face row; returns root."""
    import pandas as pd

    from face_vijnana_yolov3_tpu_torch.utils.io import imsave

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)

    def gen_split(prefix, n):
        rows = []
        fid = 0
        for i in range(n):
            # Textured background.
            img = rng.uniform(40, 90, (image_size, image_size, 3))
            img += rng.normal(0, 12, (image_size, image_size, 3))
            name = f"{prefix}_{i}.jpg"
            for _ in range(int(rng.integers(1, 4))):
                r = int(rng.integers(24, 56))
                cx = int(rng.integers(r + 2, image_size - r - 2))
                cy = int(rng.integers(r + 2, image_size - r - 2))
                yy, xx = np.mgrid[0:image_size, 0:image_size]
                mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
                img[mask] = [220, 190, 160]  # skin-ish bright disk
                rows.append({
                    "FACE_ID": fid, "FILE": name, "SUBJECT_ID": 1,
                    "FACE_X": cx - r, "FACE_Y": cy - r,
                    "FACE_WIDTH": 2 * r, "FACE_HEIGHT": 2 * r,
                })
                fid += 1
            imsave(os.path.join(root, name),
                   np.clip(img, 0, 255).astype(np.uint8))
        return pd.DataFrame(rows)

    gen_split("tr", n_train).to_csv(os.path.join(root, "training.csv"),
                                    index=False)
    val = gen_split("val", n_val)
    val.to_csv(os.path.join(root, "validation.csv"), index=False)
    return root
