"""Device ROI crops: face crop + cv2-exact cubic letterbox as matmuls.

Port of face_vijnana_yolov3_tpu/ops/roi.py. The host half (crop windows
with the reference's `(t-1):(b-1)` off-by-one slice, per-ROI cubic tap
tables, window buckets, operand packing; roi.py:38-116, :166-249) is a
copy in numpy; tests/test_torch_roi.py holds it to the original. The
device half expands each ROI's tap tables into dense resize matrices and
applies them to the staged original image as two f32 matmuls (TF32 off):
crop, replicate-border cubic resize, the black pad band and the uint8 /255
all come out of the same pair of products, and the crop is never
materialised.

The windowed form gathers each ROI's (window_h, window_w) window from the
staged batch at a host-clamped origin, so the matmuls contract over about
the crop's extent instead of the whole staged axes (the skipped columns are
exact zeros; only the f32 summation order differs). The JAX function
`lax.map`s padded sub-batches to bound its compile count; the caller
(api/face_identification.py) runs a chunk's ROIs in pieces of those
bucket sizes, unpadded, each through a captured program.

Numerics: the host reference path computes in float64 (uint8/255 → cv2
f64 cubic); this path is f32, so parity is float-rounding-level.
"""

from __future__ import annotations

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.models.darknet import exact_f32
from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry
from face_vijnana_yolov3_tpu_torch.ops.resize import (
    cols_pass,
    cubic_taps,
    letterbox_device_matmul,
    to_unit_f32,
)


def roi_window(l: int, t: int, r: int, b: int, src_h: int, src_w: int):
    """The reference crop window `image[(t-1):(b-1), (l-1):(r-1)]` with
    python slice rules (roi.py:38-62): t == 0 or l == 0 wraps to a start of
    src - 1, as the slice does. Returns (y0, x0, crop_h, crop_w); crop_h <= 0
    or crop_w <= 0 is an empty crop the caller skips."""

    def axis(start: int, stop: int, n: int):
        s = start if start >= 0 else start + n
        s = min(max(s, 0), n)
        e = stop if stop >= 0 else stop + n
        e = min(max(e, 0), n)
        return s, e - s

    y0, crop_h = axis(t - 1, b - 1, src_h)
    x0, crop_w = axis(l - 1, r - 1, src_w)
    return y0, x0, crop_h, crop_w


def roi_letterbox_taps(y0: int, x0: int, crop_h: int, crop_w: int, image_size: int):
    """Cubic letterbox tap tables for one crop window, addressing the whole
    staged image (rows offset by y0, cols by x0) (roi.py:65-100): (row_idx
    (S, 4) int32, row_w (S, 4) f32, col_idx, col_w), zero weights in the pad
    band. A crop thinner than image_size:1 (a zero-size resize target)
    raises, as cv2.resize does on the host path."""
    geom = letterbox_geometry(crop_h, crop_w, image_size)
    if geom.new_h <= 0 or geom.new_w <= 0:
        raise ValueError(
            f"degenerate crop aspect {crop_h}x{crop_w}: letterbox target "
            f"{geom.new_h}x{geom.new_w} has a zero dimension (cv2.resize in "
            "the host/reference path rejects this)"
        )

    def one(origin: int, src: int, new: int, pad: int):
        idx = np.zeros((image_size, 4), np.int32)
        w = np.zeros((image_size, 4), np.float32)
        ti, tw = cubic_taps(src, new)  # replicate-clamped to the CROP edges
        idx[pad : pad + new] = ti + origin
        w[pad : pad + new] = tw
        return idx, w

    ri, rw = one(y0, crop_h, geom.new_h, geom.pad_t)
    ci, cw = one(x0, crop_w, geom.new_w, geom.pad_l)
    return ri, rw, ci, cw


_WINDOW_BUCKETS = (128, 256, 512, 1024, 2048)


def window_bucket(need: int, limit: int) -> int:
    """Smallest window bucket covering `need` source rows/cols, capped at the
    staged dimension (roi.py:106-116)."""
    for b in _WINDOW_BUCKETS:
        if b >= need:
            return min(b, limit)
    return limit


def zero_taps(image_size: int):
    """All-zero tap tables (a black crop)."""
    z_i = np.zeros((image_size, 4), np.int32)
    z_w = np.zeros((image_size, 4), np.float32)
    return z_i, z_w, z_i.copy(), z_w.copy()


def pack_roi_operands(origins: np.ndarray, row_idx: np.ndarray, row_w: np.ndarray,
                      col_idx: np.ndarray, col_w: np.ndarray) -> np.ndarray:
    """Pack per-ROI operands into one (R, 3 + 4·S·4) float32 array, one
    upload instead of five (roi.py:166-181); the integer fields (all
    < 2^24) round-trip exactly through f32."""
    r, s, t = row_idx.shape
    flat = lambda a: a.reshape(r, s * t).astype(np.float32)  # noqa: E731
    return np.concatenate(
        [origins.astype(np.float32), flat(row_idx), flat(row_w),
         flat(col_idx), flat(col_w)], axis=1,
    )


def unpack_roi_operands(packed: torch.Tensor, image_size: int, taps: int = 4):
    """Device-side inverse of `pack_roi_operands`: (R, F) → (origins (R, 3)
    int32, row_idx, row_w, col_idx, col_w)."""
    r = packed.shape[0]
    st = image_size * taps

    def cut(j):
        return packed[:, 3 + j * st : 3 + (j + 1) * st].reshape(r, image_size, taps)

    return (packed[:, :3].to(torch.int32), cut(0).to(torch.int32), cut(1),
            cut(2).to(torch.int32), cut(3))


def build_roi_windows(boxes: np.ndarray, src_h: int, src_w: int):
    """Crop windows for a batch of detect boxes ((N, >= 4) rows [xmin,
    ymin, xmax, ymax, ...] in original image coordinates): (keep, wins),
    the indices of the boxes whose crop is non-empty, in order, and their
    (y0, x0, crop_h, crop_w) (roi.py:199-221)."""
    keep: list[int] = []
    wins: list[tuple[int, int, int, int]] = []
    for k in range(boxes.shape[0]):
        l, t, r, b = (int(boxes[k, 0]), int(boxes[k, 1]),
                      int(boxes[k, 2]), int(boxes[k, 3]))
        y0, x0, ch, cw = roi_window(l, t, r, b, src_h, src_w)
        if ch <= 0 or cw <= 0:
            continue
        keep.append(k)
        wins.append((y0, x0, ch, cw))
    return keep, wins


def stack_roi_taps(wins, image_size: int, origins: np.ndarray | None = None):
    """Stacked (K, S, 4) tap tables for a list of crop windows; with
    `origins` ((K, 2) per-ROI (oy, ox)), indices are relative to each
    window's origin (for `roi_letterbox_device_windowed`), else absolute
    (roi.py:224-242)."""
    if not wins:
        z = np.zeros((0, image_size, 4), np.int32)
        zw = np.zeros((0, image_size, 4), np.float32)
        return z, zw, z.copy(), zw.copy()
    tabs = []
    for j, (y0, x0, ch, cw) in enumerate(wins):
        oy, ox = (int(origins[j, 0]), int(origins[j, 1])) if origins is not None else (0, 0)
        tabs.append(roi_letterbox_taps(y0 - oy, x0 - ox, ch, cw, image_size))
    return (np.stack([t[0] for t in tabs]), np.stack([t[1] for t in tabs]),
            np.stack([t[2] for t in tabs]), np.stack([t[3] for t in tabs]))


def build_roi_taps(boxes: np.ndarray, src_h: int, src_w: int, image_size: int):
    """Windows → stacked absolute tap tables: (keep, row_idx (K, S, 4),
    row_w, col_idx, col_w) (roi.py:245-249)."""
    keep, wins = build_roi_windows(boxes, src_h, src_w)
    return (keep,) + stack_roi_taps(wins, image_size)


# ------------------------------------------------------------------ device half

def _mat_from_taps(idx: torch.Tensor, w: torch.Tensor, in_size: int) -> torch.Tensor:
    """(..., S, T) tap tables → dense (..., S, in_size) resize matrices
    (roi.py:119-128). Taps are added in order 0..T-1, each a scatter with
    one index per row, so duplicate (edge-replicated) indices sum their
    weights as `resize.taps_to_matrix` does, deterministically."""
    m = torch.zeros(*idx.shape[:-1], in_size, dtype=w.dtype, device=w.device)
    for t in range(idx.shape[-1]):
        m.scatter_add_(-1, idx[..., t:t + 1].long(), w[..., t:t + 1])
    return m


def roi_letterbox_device(image: torch.Tensor, row_idx: torch.Tensor, row_w: torch.Tensor,
                         col_idx: torch.Tensor, col_w: torch.Tensor) -> torch.Tensor:
    """All ROIs of one staged image → (R, S, S, C) f32 letterboxed crops
    (roi.py:131-164). image: (maxH, maxW, C) uint8 raw pixels (the /255
    fuses in) or f32 already in [0, 1]; the tap tables (R, S, 4) absolute,
    from `roi_letterbox_taps`."""
    img = to_unit_f32(image)
    max_h, max_w = image.shape[0], image.shape[1]
    rm = _mat_from_taps(row_idx, row_w, max_h)
    cm = _mat_from_taps(col_idx, col_w, max_w)
    r, s = row_idx.shape[0], row_idx.shape[1]
    with exact_f32():
        # The rows pass of every ROI as one (R·S, H) @ (H, W·C) product: the
        # image is read once, not expanded to R copies.
        tmp = torch.matmul(rm.reshape(r * s, max_h), img.reshape(max_h, -1))
        return cols_pass(tmp.reshape(r, s, max_w, img.shape[2]), cm)


def roi_letterbox_device_windowed(staged: torch.Tensor, origins: torch.Tensor,
                                  row_idx: torch.Tensor, row_w: torch.Tensor,
                                  col_idx: torch.Tensor, col_w: torch.Tensor, *,
                                  window_h: int, window_w: int) -> torch.Tensor:
    """Windowed `roi_letterbox_device` across the images of a staged batch
    (roi.py:251-297): each ROI takes the (window_h, window_w) window of
    its image at its origin, then the two resize matmuls over the window.

    staged: (B, maxH, maxW, C) uint8 (the /255 fuses into the window's
    convert) or f32 in [0, 1]. origins: (R, 3) int (img_idx, oy, ox),
    clamped by the caller so the window fits. Tap tables (R, S, 4) relative
    to the window origin (`stack_roi_taps(..., origins=...)`). Returns
    (R, S, S, C) f32 crops in [0, 1].
    """
    org = origins.to(device=staged.device, dtype=torch.long)
    rows = org[:, 1:2] + torch.arange(window_h, device=staged.device)   # (R, wh)
    cols = org[:, 2:3] + torch.arange(window_w, device=staged.device)   # (R, ww)
    win = staged[org[:, 0, None, None], rows[:, :, None], cols[:, None, :]]
    win = to_unit_f32(win)                                             # (R, wh, ww, C)
    rm = _mat_from_taps(row_idx, row_w, window_h)
    cm = _mat_from_taps(col_idx, col_w, window_w)
    with exact_f32():
        return letterbox_device_matmul(win, rm, cm)
