"""Subject-face database: crop extraction, triplet sampling, embedding registry.

A copy of face_vijnana_yolov3_tpu/data/facedb.py:35-309 (numpy, pandas
and h5py only; tests/test_torch_facedb.py holds it to the original). The
files it reads and writes are the reference's, and interchangeable with
the JAX package's:

* `subject_faces/` + `subject_image_db.csv`: GT face crops per subject,
  with the reference's `(t-1):(b-1), (l-1):(r-1)` off-by-one crop and an
  INTER_NEAREST letterbox of the raw uint8 crop;
* `subject_faces_vggface2/` + `subject_image_vggface2_db.csv`: the
  VGGFace2 arm (a thread pool fans the crops out);
* `img_triplet_pairs.pickle`: all same-subject (anchor, positive) pairs,
  each with one random negative, shuffled;
* `subject_facial_ids.h5`: per-crop embeddings with subject_id attrs;
* `ref_facial_id_db.pickle`: {subject_id: (D,) mean embedding}.

The h5 and the pickles hold numpy arrays, never tensors, so either package
reads what the other wrote. One difference: `TripletDataset` takes its
random generators explicitly (a numpy Generator for the negatives, a
`random.Random` for the shuffle); the JAX class draws from an unseeded
default_rng and Python's global `random.shuffle`. Seeded alike (the
global `random.seed(s)` there, `random.Random(s)` here), the two give the
same pairs.
"""

from __future__ import annotations

import os
import pickle
import random
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd

from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host
from face_vijnana_yolov3_tpu_torch.utils.io import imread, imsave


def _letterbox_uint8(image: np.ndarray, image_size: int, interpolation: str):
    """Letterbox a raw uint8 crop (the reference keeps crops uint8 end to end)."""
    out, _ = letterbox_host(image, image_size, interpolation)
    return out.astype(np.uint8)


def create_subject_db_uccs(raw_data_path: str, image_size: int = 416) -> pd.DataFrame:
    """UCCS arm of create_db_fi: crop GT faces per subject into
    subject_faces/; writes `subject_image_db.csv` (in the working
    directory, as the reference) with columns subject_id / face_file / w / h
    and returns the frame."""
    faces_dir = os.path.join(raw_data_path, "subject_faces")
    if os.path.isdir(faces_dir):
        shutil.rmtree(faces_dir)
    os.mkdir(faces_dir)

    gt_df = pd.read_csv(os.path.join(raw_data_path, "training", "training.csv"))
    groups = gt_df.groupby("SUBJECT_ID")
    records = []
    for subject_id in groups.groups.keys():
        if subject_id == -1:
            continue
        df = groups.get_group(subject_id)
        for i in range(df.shape[0]):
            file_name = df.iloc[i, 1]
            if not bool((df.iloc[i, 3:] > 0).all()):
                continue
            image = imread(os.path.join(raw_data_path, "training", file_name))
            l = int(df.iloc[i, 3])
            t = int(df.iloc[i, 4])
            r = int(df.iloc[i, 3] + df.iloc[i, 5] - 1)
            b = int(df.iloc[i, 4] + df.iloc[i, 6] - 1)
            # The reference's off-by-one crop (face_identification.py:120).
            crop = image[(t - 1):(b - 1), (l - 1):(r - 1), :]
            if crop.shape[0] == 0 or crop.shape[1] == 0:
                continue
            w, h = crop.shape[1], crop.shape[0]
            out = _letterbox_uint8(crop, image_size, "nearest")
            face_file = (
                f"{file_name[:-4]}_{subject_id}_{int(df.iloc[i, 3])}_"
                f"{int(df.iloc[i, 4])}{file_name[-4:]}"
            )
            imsave(os.path.join(faces_dir, face_file), out)
            records.append(
                {"subject_id": subject_id, "face_file": face_file, "w": w, "h": h}
            )
    db = pd.DataFrame(records, columns=["subject_id", "face_file", "w", "h"])
    db.to_csv("subject_image_db.csv")
    return db


def create_subject_db_vggface2(
    raw_data_path: str, image_size: int = 416, workers: int = 8
) -> pd.DataFrame:
    """VGGFace2 arm: loose_bb_train.csv rows → subject_faces_vggface2/ crops
    (a thread pool in place of the reference's ipyparallel cluster)."""
    faces_dir = os.path.join(raw_data_path, "subject_faces_vggface2")
    if os.path.isdir(faces_dir):
        shutil.rmtree(faces_dir)
    os.mkdir(faces_dir)

    df = pd.read_csv(os.path.join(raw_data_path, "loose_bb_train.csv"))

    def one(i):
        row = df.iloc[i]
        identity, fname = row.iloc[0].split("/")
        file_name = fname + ".jpg"
        x, y, w, h = (int(row.iloc[j]) for j in range(1, 5))
        if x < 0 or y < 0 or w <= 0 or h <= 0:
            return None
        image = imread(os.path.join(raw_data_path, "train", identity, file_name))
        crop = image[y : y + h, x : x + w, :]
        if crop.shape[0] == 0 or crop.shape[1] == 0:
            return None
        cw, ch = crop.shape[1], crop.shape[0]
        out = _letterbox_uint8(crop, image_size, "nearest")
        face_file = f"{identity}_{file_name}"
        imsave(os.path.join(faces_dir, face_file), out)
        return {"subject_id": identity, "face_file": face_file, "w": cw, "h": ch}

    with ThreadPoolExecutor(max_workers=workers) as ex:
        results = list(ex.map(one, range(df.shape[0])))
    records = [r for r in results if r is not None]
    db = pd.DataFrame(records, columns=["subject_id", "face_file", "w", "h"])
    db.to_csv("subject_image_vggface2_db.csv")
    return db


# ------------------------------------------------------------------ triplets

class TripletDataset:
    """All same-subject (a, p) pairs x 1 random negative, shuffled + pickled.

    The reference's O(Σ n_s²) pair sweep (face_identification.py:1520-1553);
    `load_flag` reuses the pickle. rng draws the negatives (an unseeded
    default_rng when None), shuffle_rng shuffles the pairs (a fresh
    `random.Random()` when None).
    """

    def __init__(
        self,
        raw_data_path: str,
        db_csv: str = "subject_image_db.csv",
        faces_subdir: str = "subject_faces",
        pairs_pickle: str = "img_triplet_pairs.pickle",
        load_flag: bool = False,
        rng: np.random.Generator | None = None,
        shuffle_rng: random.Random | None = None,
    ):
        self.raw_data_path = raw_data_path
        self.faces_subdir = faces_subdir
        self.db = pd.read_csv(db_csv)
        self.db = self.db.iloc[:, 1:]
        rng = rng or np.random.default_rng()
        shuffle_rng = shuffle_rng or random.Random()

        if load_flag and os.path.exists(pairs_pickle):
            with open(pairs_pickle, "rb") as f:
                self.img_triplet_pairs = pickle.load(f)
        else:
            t_indexes = np.asarray(self.db.index)
            groups = self.db.groupby("subject_id")
            pairs = []
            for sid in groups.groups.keys():
                ex2 = np.asarray(groups.get_group(sid).index)
                others = t_indexes[~np.isin(t_indexes, ex2)]
                if others.size == 0:
                    continue
                for k in range(ex2.shape[0] - 1):
                    for l in range(k + 1, ex2.shape[0]):
                        pairs.append(
                            (int(ex2[k]), int(ex2[l]), int(rng.choice(others)))
                        )
            shuffle_rng.shuffle(pairs)
            self.img_triplet_pairs = pairs
            with open(pairs_pickle, "wb") as f:
                pickle.dump(pairs, f)

    def __len__(self):
        return len(self.img_triplet_pairs)

    def steps(self, batch_size: int) -> int:
        n = len(self.img_triplet_pairs)
        return n // batch_size + (1 if n % batch_size else 0)

    def _load(self, idx: int) -> np.ndarray:
        face_file = self.db.loc[idx, "face_file"]
        return (
            imread(os.path.join(self.raw_data_path, self.faces_subdir, face_file))
            / 255
        )

    def batch(self, index: int, batch_size: int):
        """(anchors, positives, negatives) float32 (n, S, S, 3) in [0, 1]."""
        n = len(self.img_triplet_pairs)
        start = index * batch_size
        stop = min(start + batch_size, n)
        a, p, ng = [], [], []
        for bi in range(start, stop):
            ia, ip, in_ = self.img_triplet_pairs[bi]
            a.append(self._load(ia))
            p.append(self._load(ip))
            ng.append(self._load(in_))
        return (
            np.asarray(a, np.float32),
            np.asarray(p, np.float32),
            np.asarray(ng, np.float32),
        )

    def batch_subject_codes(self, index: int, batch_size: int):
        """(anchor_codes, negative_codes) int32 for one batch: integer codes
        of subject_id (strings for VGGFace2), for in-batch semi-hard mining."""
        if not hasattr(self, "_subject_codes"):
            self._subject_codes = pd.factorize(self.db["subject_id"])[0]
            self._index_pos = {idx: k for k, idx in enumerate(self.db.index)}
        n = len(self.img_triplet_pairs)
        start = index * batch_size
        stop = min(start + batch_size, n)
        rows = self.img_triplet_pairs[start:stop]
        pos = self._index_pos
        a = np.asarray([self._subject_codes[pos[r[0]]] for r in rows], np.int32)
        ng = np.asarray([self._subject_codes[pos[r[2]]] for r in rows], np.int32)
        return a, ng


# ------------------------------------------------------------------ embedding DB

def _subject_embeddings(embed_fn, raw_data_path, faces_subdir, files, batch_size):
    embs = []
    for s in range(0, len(files), batch_size):
        chunk = files[s : s + batch_size]
        images = np.asarray(
            [imread(os.path.join(raw_data_path, faces_subdir, ff)) / 255 for ff in chunk],
            np.float32,
        )
        embs.append(np.asarray(embed_fn(images)))
    return np.concatenate(embs)


def make_facial_ids_db(
    embed_fn,
    raw_data_path: str,
    db_csv: str = "subject_image_db.csv",
    faces_subdir: str = "subject_faces",
    out_h5: str = "subject_facial_ids.h5",
    batch_size: int = 32,
):
    """Per-crop embeddings → an h5 keyed by face_file with subject_id attrs
    (face_identification.py:645-700). embed_fn: (B, S, S, 3) float32 →
    (B, D) numpy."""
    import h5py

    with h5py.File(out_h5, "w") as f:
        for subject_id, ff, emb in facial_ids(embed_fn, raw_data_path, db_csv,
                                              faces_subdir, batch_size):
            f[ff] = emb
            f[ff].attrs["subject_id"] = subject_id


def facial_ids(embed_fn, raw_data_path: str, db_csv: str = "subject_image_db.csv",
               faces_subdir: str = "subject_faces", batch_size: int = 32):
    """What `make_facial_ids_db` writes, in memory: (subject_id, face_file,
    embedding) for every known subject's crop, in the db's order."""
    db = pd.read_csv(db_csv)
    db = db.iloc[:, 1:]
    groups = db.groupby("subject_id")
    out = []
    for subject_id in groups.groups.keys():
        if subject_id == -1:
            continue
        files = list(groups.get_group(subject_id).iloc[:, 1])
        embs = _subject_embeddings(embed_fn, raw_data_path, faces_subdir, files,
                                   batch_size)
        out.extend((subject_id, ff, embs[k]) for k, ff in enumerate(files))
    return out


def register_facial_ids(
    embed_fn,
    raw_data_path: str,
    db_csv: str = "subject_image_db.csv",
    faces_subdir: str = "subject_faces",
    out_pickle: str = "ref_facial_id_db.pickle",
    batch_size: int = 32,
) -> dict:
    """Mean embedding per subject → a {subject_id: (D,) numpy array} pickle
    (face_identification.py:702-770)."""
    db = pd.read_csv(db_csv)
    db = db.iloc[:, 1:]
    groups = db.groupby("subject_id")
    registry: dict = {}
    for subject_id in groups.groups.keys():
        if subject_id == -1:
            continue
        files = list(groups.get_group(subject_id).iloc[:, 1])
        registry[subject_id] = _subject_embeddings(
            embed_fn, raw_data_path, faces_subdir, files, batch_size).mean(axis=0)
    with open(out_pickle, "wb") as f:
        pickle.dump(registry, f)
    return registry
