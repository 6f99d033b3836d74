"""Entropy-filtered person/bottle box selector (reference get_person_boxes,
src/space/yolov3_detect.py:532-549 — unused by the face path but part of the
public utility surface).

A copy of face_vijnana_yolov3_tpu/utils/box_select.py: the port imports
nothing of the JAX package (tests/test_torch_coco.py holds the copy to the
original).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import entropy


def get_person_boxes(boxes, labels, cls_thresh, human_entropy_thresh,
                     bottle_entropy_thresh):
    """Filter boxes whose argmax class is person/bottle above cls_thresh and
    whose class-distribution entropy is below the per-class threshold.

    `boxes` are BoundBox-like objects with a `.classes` array.
    """
    person_boxes = []
    person_index = labels.index("person")
    bottle_index = labels.index("bottle")
    for box in boxes:
        max_index = int(np.argmax(box.classes))
        if (max_index in (person_index, bottle_index)) and (
            box.classes[person_index] > cls_thresh
            or box.classes[bottle_index] > cls_thresh
        ):
            th = (
                human_entropy_thresh
                if max_index == person_index
                else bottle_entropy_thresh
            )
            if entropy(box.classes) < th:
                person_boxes.append(box)
    return person_boxes
