"""Seeded synthetic sets (no download), in the UCCS column layout.

`make_dataset`, a face-detection set (bright disks on textured noise, JPEGs
with `training.csv` / `validation.csv`), is a copy of scripts/synthetic_e2e.
py:24-60; `make_fi_tree`, a tree of synthetic identities for face
identification (a per-subject ring pattern under per-instance noise,
lighting and an occlusion bar, pasted on noise), with `subject_face` and
`holdout_crops`, is a copy of scripts/synthetic_fi_e2e.py:27-105. Both
scripts belong to the JAX package's tooling (the port imports nothing of
it); tests/test_torch_train.py and tests/test_torch_facedb.py hold the
copies to them, pixel for pixel, at their defaults. `make_fi_tree` also
takes the image side and the face-size range, so the tests can run at 64².
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


# ------------------------------------------------------------------ identities

FI_TRAIN_PER_SUBJ = 6
FI_HOLD_PER_SUBJ = 3


def subject_face(sid: int, size: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic per-subject pattern (the identity) + per-instance
    noise, lighting and occlusion: ((size, size, 3) f64 pixels, disk mask)."""
    srng = np.random.default_rng(1000 + sid)
    base = srng.uniform(80, 200, 3)
    freq = srng.uniform(0.15, 0.45)
    phase = srng.uniform(0, np.pi)
    stripe_c = srng.uniform(40, 255, 3)
    yy, xx = np.mgrid[0:size, 0:size]
    r = np.sqrt((yy - size / 2) ** 2 + (xx - size / 2) ** 2)
    disk = r <= size / 2
    rings = 0.5 * (1 + np.sin(freq * r + phase))
    face = np.zeros((size, size, 3))
    face += base
    face += rings[..., None] * (stripe_c - base)
    face[~disk] = 0
    face += rng.normal(0, 25, face.shape)  # per-instance augmentation
    face *= rng.uniform(0.6, 1.4)  # strong lighting variation
    # An occlusion bar, so the margin does not saturate at once.
    if rng.uniform() < 0.7:
        t0 = int(rng.integers(0, size - size // 5))
        if rng.uniform() < 0.5:
            face[t0:t0 + size // 5, :] *= rng.uniform(0.0, 0.4)
        else:
            face[:, t0:t0 + size // 5] *= rng.uniform(0.0, 0.4)
    return np.clip(face, 0, 255), disk


def make_fi_tree(root: str, n_subjects: int, seed: int = 0,
                 hold_per_subj: int = FI_HOLD_PER_SUBJ, *,
                 train_per_subj: int = FI_TRAIN_PER_SUBJ, image_size: int = 416,
                 face_sizes: tuple[int, int] = (90, 200)) -> list:
    """Write `root`/training/{training.csv, s<sid>_<j>.jpg}: subjects 1..n,
    `train_per_subj` images each with one face of side in `face_sizes`
    (upper bound exclusive) pasted at a random place; returns the held-out
    faces [(sid, image, (x0, y0, side))]."""
    import pandas as pd

    from face_vijnana_yolov3_tpu_torch.utils.io import imsave

    rng = np.random.default_rng(seed)
    tdir = os.path.join(root, "training")
    os.makedirs(tdir, exist_ok=True)
    rows, holdout = [], []
    fid = 0
    for sid in range(1, n_subjects + 1):
        for j in range(train_per_subj + hold_per_subj):
            fsize = int(rng.integers(*face_sizes))
            face, disk = subject_face(sid, fsize, rng)
            img = rng.uniform(30, 90, (image_size, image_size, 3))
            x0 = int(rng.integers(2, image_size - fsize - 2))
            y0 = int(rng.integers(2, image_size - fsize - 2))
            patch = img[y0:y0 + fsize, x0:x0 + fsize]
            img[y0:y0 + fsize, x0:x0 + fsize] = np.where(disk[..., None], face, patch)
            img = np.clip(img, 0, 255).astype(np.uint8)
            if j < train_per_subj:
                name = f"s{sid}_{j}.jpg"
                imsave(os.path.join(tdir, name), img)
                rows.append({
                    "FACE_ID": fid, "FILE": name, "SUBJECT_ID": sid,
                    "FACE_X": x0, "FACE_Y": y0,
                    "FACE_WIDTH": fsize, "FACE_HEIGHT": fsize,
                })
                fid += 1
            else:
                holdout.append((sid, img, (x0, y0, fsize)))
    pd.DataFrame(rows).to_csv(os.path.join(tdir, "training.csv"), index=False)
    return holdout


def holdout_crops(holdout, image_size: int = 416):
    """Held-out faces cropped and letterboxed as the subject DB builds its
    crops (the reference's off-by-one, INTER_NEAREST uint8 letterbox, /255):
    ((N, S, S, 3) f32, (N,) subject ids)."""
    from face_vijnana_yolov3_tpu_torch.data.facedb import _letterbox_uint8

    crops, sids = [], []
    for sid, img, (x0, y0, fs) in holdout:
        l, t = x0, y0
        r, b = x0 + fs - 1, y0 + fs - 1
        crop = img[(t - 1):(b - 1), (l - 1):(r - 1), :]
        crops.append(_letterbox_uint8(crop, image_size, "nearest") / 255.0)
        sids.append(sid)
    return np.asarray(crops, np.float32), np.asarray(sids)
