"""Letterbox geometry, the host cv2 letterbox and the box un-mapping (numpy).

A copy of the numpy parts of face_vijnana_yolov3_tpu/ops/letterbox.py:31-113
and :189-257 (that module imports jax, so it cannot be imported here). The
integer geometry — truncating scaled size, odd-pad split with the extra
pixel on bottom/right — is part of the numeric contract, and the un-mapping
stays f64 so the CSV text matches the JAX package's byte for byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from face_vijnana_yolov3_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class LetterboxGeometry:
    """Integer letterbox geometry for one image (exact reference math)."""

    src_h: int
    src_w: int
    image_size: int
    new_h: int  # resized height before padding (h_p)
    new_w: int  # resized width before padding (w_p)
    pad_t: int
    pad_b: int
    pad_l: int
    pad_r: int


def letterbox_geometry(src_h: int, src_w: int, image_size: int) -> LetterboxGeometry:
    """The long side maps to `image_size`; the short side scales by int()
    truncation; an odd pad puts the extra pixel on the bottom (landscape) or
    right (portrait). `w >= h` selects the landscape branch."""
    pad_t = pad_b = pad_l = pad_r = 0
    if src_w >= src_h:
        new_w = image_size
        new_h = int(src_h / src_w * image_size)
        pad = image_size - new_h
        pad_t = pad // 2
        pad_b = pad // 2 if pad % 2 == 0 else pad // 2 + 1
    else:
        new_h = image_size
        new_w = int(src_w / src_h * image_size)
        pad = image_size - new_w
        pad_l = pad // 2
        pad_r = pad // 2 if pad % 2 == 0 else pad // 2 + 1
    return LetterboxGeometry(
        src_h=src_h,
        src_w=src_w,
        image_size=image_size,
        new_h=new_h,
        new_w=new_w,
        pad_t=pad_t,
        pad_b=pad_b,
        pad_l=pad_l,
        pad_r=pad_r,
    )


def letterbox_host(
    image: np.ndarray, image_size: int, interpolation: str = "cubic"
) -> tuple[np.ndarray, LetterboxGeometry]:
    """Bit-faithful host letterbox: cv2 resize + zero border.

    `image` is (H, W, 3), already normalized the way the caller wants (the
    reference divides by 255 before resizing); interpolation 'cubic'
    (detector) or 'nearest' (face crops).
    """
    import cv2 as cv

    geom = letterbox_geometry(image.shape[0], image.shape[1], image_size)
    interp = cv.INTER_CUBIC if interpolation == "cubic" else cv.INTER_NEAREST
    resized = cv.resize(image, (geom.new_w, geom.new_h), interpolation=interp)
    out = cv.copyMakeBorder(
        resized,
        geom.pad_t,
        geom.pad_b,
        geom.pad_l,
        geom.pad_r,
        cv.BORDER_CONSTANT,
        value=[0, 0, 0],
    )
    return out, geom


@profiling.spanned("fvy.unletterbox")
def unletterbox_boxes_chunk(cands: np.ndarray, geoms: list) -> np.ndarray:
    """Map a chunk's (B, N, >=4) candidate rows back to original coords in
    one set of f64 numpy passes; bitwise-identical to per-image
    `unletterbox_boxes` calls. Rows beyond each image's count come back
    transformed like any others — the caller slices them away."""
    b = np.asarray(cands[..., :4], np.float64)  # (B, N, 4)
    if b.shape[0] == 0:
        return b
    s = float(geoms[0].image_size)
    w = np.asarray([g.src_w for g in geoms], np.float64)[:, None, None]
    h = np.asarray([g.src_h for g in geoms], np.float64)[:, None, None]
    pad_t = np.asarray([g.pad_t for g in geoms], np.float64)[:, None, None]
    pad_l = np.asarray([g.pad_l for g in geoms], np.float64)[:, None, None]
    wide = w >= h  # (B,1,1): landscape pads rows (pad_t), portrait pads cols
    out = np.empty_like(b)
    for x0, x1 in ((0, 2), (1, 3)):  # (xmin,xmax) then (ymin,ymax)
        x = b[..., (x0, x1)]  # (B, N, 2)
        land = (np.minimum(x * w / s, w) if x0 == 0 else
                np.minimum(np.maximum(x - pad_t, 0) * w / s, h))
        port = (np.minimum(np.maximum(x - pad_l, 0) * h / s, w) if x0 == 0
                else np.minimum(x * h / s, h))
        out[..., (x0, x1)] = np.where(wide, land, port)
    return out


def unletterbox_boxes(boxes: np.ndarray, geom: LetterboxGeometry) -> np.ndarray:
    """Map [xmin,ymin,xmax,ymax] boxes from net coords back to original image
    coords: subtract the pad on the short axis (clamped at 0), scale by
    long_side/image_size, clamp x at src_w and y at src_h."""
    boxes = np.asarray(boxes, dtype=np.float64)
    out = boxes.copy()
    s = geom.image_size
    w, h = geom.src_w, geom.src_h
    if w >= h:
        out[:, 0] = np.minimum(boxes[:, 0] * w / s, w)
        out[:, 2] = np.minimum(boxes[:, 2] * w / s, w)
        out[:, 1] = np.minimum(np.maximum(boxes[:, 1] - geom.pad_t, 0) * w / s, h)
        out[:, 3] = np.minimum(np.maximum(boxes[:, 3] - geom.pad_t, 0) * w / s, h)
    else:
        out[:, 0] = np.minimum(np.maximum(boxes[:, 0] - geom.pad_l, 0) * h / s, w)
        out[:, 2] = np.minimum(np.maximum(boxes[:, 2] - geom.pad_l, 0) * h / s, w)
        out[:, 1] = np.minimum(boxes[:, 1] * h / s, h)
        out[:, 3] = np.minimum(boxes[:, 3] * h / s, h)
    return out
