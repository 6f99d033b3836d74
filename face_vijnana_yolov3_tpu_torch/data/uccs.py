"""UCCS detection dataset: training.csv parsing + 13x13x6 GT tensor assembly.

A copy of face_vijnana_yolov3_tpu/data/uccs.py:1-199 (the port imports
nothing of the JAX package; tests/test_torch_train.py holds the GT tensors
and batches bit-equal to the original's), reading through the port's
ops/letterbox and utils/io.

CSV contract (reference src/space/face_detection.py:83-84, :152-164 and
face_identification.py:102-117): columns by position are
[0]=row id, [1]=FILE, [2]=SUBJECT_ID, [3]=FACE_X, [4]=FACE_Y, [5]=FACE_WIDTH,
[6]=FACE_HEIGHT; rows group by FILE; a row is valid iff every column from
position 3 on is > 0 (the reference's `df.iloc[i, 3:] > 0 ... all()`).

The GT tensor math below is the reference's exactly (face_detection.py:149-202):
integer-truncating coordinate scaling into the letterbox frame, center-cell
assignment by integer division, cell-relative centers, and width/height
normalized by the image's LONG side.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

from face_vijnana_yolov3_tpu_torch.ops.letterbox import LetterboxGeometry


def load_gt_frame(csv_path: str) -> pd.DataFrame:
    return pd.read_csv(csv_path)


def group_by_file(df: pd.DataFrame):
    """Groupby FILE preserving the reference's iteration order (group keys)."""
    return df.groupby("FILE")


def valid_row_mask(df: pd.DataFrame) -> np.ndarray:
    """Reference validity predicate: all positional columns [3:] strictly > 0."""
    return np.asarray((df.iloc[:, 3:] > 0).all(axis=1))


def build_gt_tensor(
    df: pd.DataFrame,
    geom: LetterboxGeometry,
    grid: int = 13,
    channels: int = 6,
) -> np.ndarray:
    """Assemble one image's (grid, grid, channels) GT tensor.

    `df` holds that image's rows (already grouped); `geom` is the image's
    letterbox geometry. Exact reference math, face_detection.py:149-202.
    """
    image_size = geom.image_size
    cell_size = image_size // grid
    gt = np.zeros((grid, grid, channels), dtype=np.float64)
    w, h = geom.src_w, geom.src_h
    valid = valid_row_mask(df)
    for i in range(df.shape[0]):
        if not valid[i]:
            continue
        x1 = int(df.iloc[i]["FACE_X"])
        y1 = int(df.iloc[i]["FACE_Y"])
        x2 = x1 + int(df.iloc[i]["FACE_WIDTH"]) - 1
        y2 = y1 + int(df.iloc[i]["FACE_HEIGHT"]) - 1
        wb = x2 - x1 + 1
        hb = y2 - y1 + 1

        if w >= h:
            x1_p = int(x1 / w * image_size)
            y1_p = int(y1 / w * image_size) + geom.pad_t
            x2_p = int(x2 / w * image_size)
            y2_p = int(y2 / w * image_size) + geom.pad_t
        else:
            x1_p = int(x1 / h * image_size) + geom.pad_l
            y1_p = int(y1 / h * image_size)
            x2_p = int(x2 / h * image_size) + geom.pad_l
            y2_p = int(y2 / h * image_size)

        xc_p = (x1_p + x2_p) // 2
        yc_p = (y1_p + y2_p) // 2
        cx = xc_p // cell_size
        cy = yc_p // cell_size

        bx_p = (xc_p - cx * cell_size) / cell_size
        by_p = (yc_p - cy * cell_size) / cell_size
        long_side = w if w >= h else h
        bw_p = wb / long_side
        bh_p = hb / long_side

        gt[cy, cx, 0] = 1.0
        gt[cy, cx, 1] = bx_p
        gt[cy, cx, 2] = by_p
        gt[cy, cx, 3] = bw_p
        gt[cy, cx, 4] = bh_p
        gt[cy, cx, 5] = 1.0
    return gt


class DetectionDataset:
    """UCCS training set: file list + per-sample (image, gt_tensor) assembly.

    Replaces the reference's keras Sequence (C10): same ceil(N/batch) step count
    (written back into hps['step'] by the caller, mirroring the reference's
    runtime overwrite at face_detection.py:87-90), same per-image preprocessing
    (imread → /255 → INTER_CUBIC letterbox) and GT math.
    """

    def __init__(self, raw_data_path: str, image_size: int = 416, grid: int = 13,
                 channels: int = 6, csv_name: str = "training.csv",
                 cache: str = "none"):
        """cache: "none" re-decodes every epoch (reference Sequence behavior);
        "samples" keeps each letterboxed image + GT tensor in host RAM after
        first assembly (bit-exact reuse — multi-epoch training on a 1-core
        host is otherwise JPEG-decode bound; ~2 MB/image at 416²);
        "disk" additionally persists the assembled f32 stack as an .npz next
        to the CSV, so REPEAT RUNS skip the decode entirely (bit-exact:
        stored at full f32)."""
        self.raw_data_path = raw_data_path
        self.image_size = image_size
        self.grid = grid
        self.channels = channels
        self.gt_df = load_gt_frame(os.path.join(raw_data_path, csv_name))
        self.groups = group_by_file(self.gt_df)
        self.file_names = list(self.groups.groups.keys())
        if cache not in ("none", "samples", "disk"):
            raise ValueError(f"unknown cache mode {cache!r}")
        self._sample_cache: dict[int, tuple] | None = (
            {} if cache in ("samples", "disk") else None
        )
        self._stack = None
        if cache == "disk":
            path = os.path.join(
                raw_data_path, f"{csv_name}.samples_{image_size}.npz"
            )
            # Cache validity = CSV content fingerprint, not just row count: a
            # regenerated dataset with the same N (new seed, corrected boxes)
            # must invalidate the cached pixels/GT tensors.
            csv_path = os.path.join(raw_data_path, csv_name)
            st = os.stat(csv_path)
            fprint = np.array([st.st_size, int(st.st_mtime_ns)], np.int64)
            if os.path.exists(path):
                data = np.load(path, mmap_mode=None)
                imgs = data["images"]  # bind once: each subscript of an
                gts = data["gts"]      # NpzFile re-deserializes the array
                stale = ("csv_fprint" not in data.files
                         or not np.array_equal(data["csv_fprint"], fprint))
                if imgs.shape[0] == len(self.file_names) and not stale:
                    self._stack = (imgs, gts)
                    self._sample_cache = None
            if self._stack is None:
                self._sample_cache = None  # the stack supersedes it
                images = []
                gts = []
                for i in range(len(self.file_names)):
                    img, gt = self.sample(i)
                    images.append(np.asarray(img, np.float32))
                    gts.append(np.asarray(gt, np.float32))
                images = np.stack(images)
                gts = np.stack(gts)
                tmp = path + ".tmp.npz"
                np.savez(tmp, images=images, gts=gts, csv_fprint=fprint)
                os.replace(tmp, path)
                self._stack = (images, gts)
                self._sample_cache = None

    def __len__(self) -> int:
        return len(self.file_names)

    def steps(self, batch_size: int) -> int:
        n = len(self.file_names)
        return n // batch_size + (1 if n % batch_size else 0)

    def sample(self, index: int):
        """(letterboxed float image (S,S,3), gt tensor (G,G,C)) for one file."""
        from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host
        from face_vijnana_yolov3_tpu_torch.utils.io import imread

        if self._stack is not None:
            return self._stack[0][index], self._stack[1][index]
        if self._sample_cache is not None and index in self._sample_cache:
            return self._sample_cache[index]
        file_name = self.file_names[index]
        df = self.groups.get_group(file_name)
        df = df.reset_index(drop=True)
        image = imread(os.path.join(self.raw_data_path, file_name)) / 255
        lb, geom = letterbox_host(image, self.image_size, "cubic")
        gt = build_gt_tensor(df, geom, self.grid, self.channels)
        if self._sample_cache is not None:
            self._sample_cache[index] = (lb, gt)
        return lb, gt

    def batch(self, index: int, batch_size: int):
        """One batch in reference order; the final batch carries the remainder."""
        n = len(self.file_names)
        start = index * batch_size
        stop = min(start + batch_size, n)
        images, gts = [], []
        for bi in range(start, stop):
            img, gt = self.sample(bi)
            images.append(img)
            gts.append(gt)
        return np.asarray(images, np.float32), np.asarray(gts, np.float32)
