"""Box/annotation drawing (reference draw_boxes_v3 equivalent).

The reference draws GT boxes red and predictions green with
score/classes/subject_id text (reference src/space/yolov3_detect.py:515-530,
PIL rectangle width 3, arial 25). Font falls back to PIL's default when arial
isn't installed.

A copy of face_vijnana_yolov3_tpu/utils/drawing.py: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw, ImageFont


def _font():
    try:
        return ImageFont.truetype("arial.ttf", 25)
    except OSError:
        return ImageFont.load_default()


def draw_boxes(
    image: np.ndarray,
    boxes: list[dict],
    color=(0, 255, 0),
) -> np.ndarray:
    """Draw boxes onto an RGB uint8 image.

    Each box dict: {xmin, ymin, xmax, ymax, score (optional), subject_id (optional)}.
    Returns a new array (input untouched).
    """
    im = Image.fromarray(np.asarray(image, dtype=np.uint8), mode="RGB")
    draw = ImageDraw.Draw(im)
    font = _font()
    for box in boxes:
        draw.rectangle(
            [box["xmin"], box["ymin"], box["xmax"], box["ymax"]],
            outline=color,
            width=3,
        )
        label = f"{box.get('score', 1.0)}, {box.get('score', 1.0)}, {box.get('subject_id', -1)}"
        draw.text((box["xmin"], box["ymin"] - 20), label, fill=color, font=font)
    return np.asarray(im)


# ----------------------------------------------------------- v1/v2 generations

def _rect_perimeter(ymin, ymax, xmin, xmax, shape):
    """(rr, cc) pixel indices of an axis-aligned rectangle outline, clipped to
    `shape` — the pixels skimage's polygon_perimeter sets for the reference's
    rectangle call (yolov3_detect.py:483-485; skimage isn't in this image, so
    the rasterization is inlined)."""
    ymin, ymax = int(round(ymin)), int(round(ymax))
    xmin, xmax = int(round(xmin)), int(round(xmax))
    ys = np.arange(min(ymin, ymax), max(ymin, ymax) + 1)
    xs = np.arange(min(xmin, xmax), max(xmin, xmax) + 1)
    rr = np.concatenate([
        np.full(xs.shape, ymin), np.full(xs.shape, ymax), ys, ys,
    ])
    cc = np.concatenate([
        xs, xs, np.full(ys.shape, xmin), np.full(ys.shape, xmax),
    ])
    keep = (rr >= 0) & (rr < shape[0]) & (cc >= 0) & (cc < shape[1])
    return rr[keep], cc[keep]


def draw_boxes_v1(image: np.ndarray, boxes, labels, cls_thresh) -> np.ndarray:
    """First-generation COCO drawing (reference draw_boxes,
    yolov3_detect.py:460-495): for each box whose any class score > 0.1 (the
    hardcoded 0.1, NOT cls_thresh — reference quirk at :468), draw a
    1px green perimeter and a blue text line
    'labels score objness (anchor_w,anchor_h) entropy', printing per-class
    percentages and the summary line to stdout as the reference does.

    `boxes` are BoundBox-like (ops/boxes.BoundBox): .classes, .objness,
    .anchor, .get_score().
    """
    from scipy.stats import entropy

    image = np.array(image, dtype=np.uint8, copy=True)
    for box in boxes:
        label_str = ""
        label = -1
        for i in range(len(labels)):
            if box.classes[i] > 0.1:  # reference hardcodes 0.1, ignores cls_thresh
                label_str += labels[i]
                label = i
                print(labels[i] + ": " + str(box.classes[i] * 100) + "%")
        anchor = box.anchor if box.anchor is not None else (-1, -1)
        print(
            label_str + " " + str(box.get_score()) + " " + str(box.objness)
            + " (" + str(anchor[0]) + "," + str(anchor[1]) + ") "
            + str(entropy(box.classes)) + "\n"
        )
        if label >= 0:
            rr, cc = _rect_perimeter(box.ymin, box.ymax, box.xmin, box.xmax,
                                     image.shape)
            image[rr, cc] = (0, 255, 0)
            im = Image.fromarray(image, mode="RGB")
            draw = ImageDraw.Draw(im)
            draw.text(
                (box.xmin, box.ymin - 13),
                label_str + " " + str(box.get_score()) + " "
                + str(box.objness) + " (" + str(anchor[0]) + ","
                + str(anchor[1]) + ") " + str(entropy(box.classes)),
                (0, 0, 255),
            )
            image = np.asarray(im).copy()
    return image


def draw_boxes_v2(image: np.ndarray, boxes, cls_thresh=None) -> np.ndarray:
    """Second-generation drawing (reference draw_boxes_v2,
    yolov3_detect.py:497-513): width-1 green rectangle + 'score, classes[0]'
    text per box (score printed twice when classes[0] == get_score()),
    printing each line to stdout. cls_thresh is accepted and ignored, as in
    the reference."""
    image = np.array(image, dtype=np.uint8, copy=True)
    font = _font()
    for box in boxes:
        print(str(box.get_score()) + ", " + str(box.classes[0]) + "\n")
        im = Image.fromarray(image, mode="RGB")
        draw = ImageDraw.Draw(im)
        draw.rectangle([box.xmin, box.ymin, box.xmax, box.ymax],
                       outline=(0, 255, 0), width=1)
        draw.text((box.xmin, box.ymin - 20),
                  str(box.get_score()) + ", " + str(box.classes[0]),
                  fill=(0, 255, 0), font=font)
        image = np.asarray(im).copy()
    return image
