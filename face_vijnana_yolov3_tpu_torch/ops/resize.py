"""OpenCV-faithful strict letterbox as two f32 matmuls on the device.

Port of face_vijnana_yolov3_tpu/ops/resize.py:25-72 and :111-180 for the
detector's cubic letterbox (the nearest taps of the face-crop path, the
gather-form passes and the scaled-decode options are not carried). The tap
tables stay host numpy, copied: cv2's cubic kernel with a = -0.75, source
coordinate (x_dst + 0.5) * scale - 0.5, 4 taps with edge replication. The
device side is two batched matmuls, `torch.matmul` in f32: with TF32 off
(FaceDetectorPipeline sets it) that is the counterpart of the JAX
`precision="highest"` (api/face_detection.py:672-677).
"""

from __future__ import annotations

import numpy as np
import torch


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """OpenCV interpolateCubic: weights for taps at offsets -1..2 given the
    fractional coordinate t in [0,1). Returns (..., 4)."""
    d = np.stack([1.0 + t, t, 1.0 - t, 2.0 - t], axis=-1)
    ad = np.abs(d)
    w_near = ((a + 2.0) * ad - (a + 3.0)) * ad * ad + 1.0          # |d| <= 1
    w_far = a * (((ad - 5.0) * ad + 8.0) * ad - 4.0)               # 1 < |d| < 2
    return np.where(ad <= 1.0, w_near, np.where(ad < 2.0, w_far, 0.0))


def cubic_taps(in_size: int, out_size: int):
    """(indices (out,4) int32, weights (out,4) f32) for one axis, cv2 semantics."""
    scale = in_size / out_size
    x = (np.arange(out_size) + 0.5) * scale - 0.5
    x0 = np.floor(x)
    t = x - x0
    idx = x0[:, None].astype(np.int64) + np.arange(-1, 3)[None, :]
    idx = np.clip(idx, 0, in_size - 1)  # BORDER_REPLICATE
    w = _cubic_weights(t)
    return idx.astype(np.int32), w.astype(np.float32)


def taps_to_matrix(idx: np.ndarray, w: np.ndarray, in_size: int) -> np.ndarray:
    """(out, taps) tap tables → dense (out, in) resize matrix; the clamped
    taps scatter-add into the edge column, which is BORDER_REPLICATE."""
    m = np.zeros((idx.shape[0], in_size), np.float32)
    np.add.at(m, (np.arange(idx.shape[0])[:, None], idx), w)
    return m


def letterbox_taps(geom, image_size: int, dec_h: int | None = None,
                   dec_w: int | None = None):
    """Fixed-shape cubic tap tables for one image's strict letterbox:
    rows/cols in the pad band keep weight 0 (the black border); rows/cols
    inside [pad, pad+new) carry the (src → new) resize taps. dec_h/dec_w:
    the staged pixels' dims when the JPEG was decoded at a reduced DCT
    scale; the geometry stays the original dims' (resize.py:108-140)."""

    def one_axis(src, new, pad):
        idx = np.zeros((image_size, 4), np.int32)
        w = np.zeros((image_size, 4), np.float32)
        ti, tw = cubic_taps(src, new)
        idx[pad : pad + new] = ti
        w[pad : pad + new] = tw
        return idx, w

    ri, rw = one_axis(dec_h or geom.src_h, geom.new_h, geom.pad_t)
    ci, cw = one_axis(dec_w or geom.src_w, geom.new_w, geom.pad_l)
    return ri, rw, ci, cw


def letterbox_matrices(geom, max_h: int, max_w: int, image_size: int,
                       dec_h: int | None = None, dec_w: int | None = None):
    """(row (S, max_h), col (S, max_w)) dense f32 cubic letterbox matrices for
    one image staged top-left in a (max_h, max_w) buffer (dec_h/dec_w: see
    letterbox_taps)."""
    ri, rw, ci, cw = letterbox_taps(geom, image_size, dec_h, dec_w)
    return taps_to_matrix(ri, rw, max_h), taps_to_matrix(ci, cw, max_w)


def to_unit_f32(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels → f32 * (1/255) (the JAX fused path's order); float
    pixels are taken as already in [0, 1]."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * (1.0 / 255.0)
    return x.to(torch.float32)


def letterbox_device_matmul(staged: torch.Tensor, row_ms: torch.Tensor,
                            col_ms: torch.Tensor) -> torch.Tensor:
    """Batched strict letterbox: staged (B, H, W, C) f32 + per-image matrices
    row_ms (B or 1, S, H) / col_ms (B or 1, S, W) → (B, S, S, C) f32.

    Rows pass then cols pass, as the JAX einsums "oh,hwc->owc" and
    "pw,owc->opc"; a leading 1 broadcasts one matrix pair over the batch.
    """
    b, h, w, c = staged.shape
    tmp = torch.matmul(row_ms, staged.reshape(b, h, w * c))      # (B, S, W*C)
    tmp = tmp.reshape(b, -1, w, c)                               # (B, S, W, C)
    return torch.matmul(col_ms[:, None], tmp)                    # (B, S, S, C)
