"""Self-contained COCO YOLOv3 demo CLI (reference yolov3_detect.py parity).

Port of face_vijnana_yolov3_tpu/api/yolov3_detect.py:

    python -m face_vijnana_yolov3_tpu_torch.api.yolov3_detect \
        -w yolov3.weights -i img.jpg [--precision float32|bfloat16|int8]

detects the 80 COCO classes in one image with the full published YOLOv3-416
(75 convs, three 255-channel heads) and writes `<img>_detected.<ext>`
(reference src/space/yolov3_detect.py:551-614: thresholds 0.5/0.5/0.45,
letterbox with gray 0.5 padding, per-scale anchor subsets, per-class NMS,
boxes drawn for classes scoring > 0.1). Everything runs on the CUDA card
unless the caller passes `device="cpu"`.

Precisions (the programs of the JAX package, with two of its kernels
where the JAX demo uses XLA):
- float32: the eval-mode `Darknet` module (cuDNN convs, TF32 off);
- bfloat16: `darknet.apply_graph_folded` in bf16, with no f32 front guard
  (the JAX demo passes none), so the stock front runs;
- int8: `quant.quantize_folded` calibrated on the image itself, no bf16 tail
  (the routed graph has none), served by `quant.apply_graph_quant`: kernel
  A0 (csrc/conv_int8.cu) on every conv outside the residual blocks, the
  three linear 255-channel heads included, and the fused residual blocks
  on, kernel A (csrc/block_int8.cu) on the 20 blocks of stages 3-5. The
  JAX demo leaves its fused blocks off (XLA convs there); the int8 heads
  are bit-identical either way.
The postprocess (ops/postprocess.coco_postprocess) runs its 80-class NMS as
one launch of kernel B (csrc/nms_sweep.cu) over a (80, 256) batch, where
the JAX demo runs the same sweep as an XLA loop.

Programs: the JAX demo jits its forward and postprocess as one program.
Here `YOLOV3`, where images recur, keeps a `core/programs.ProgramCache`
and replays the f32 or bf16 forward with `coco_postprocess` as one CUDA
graph per (image shape, thresholds) (`detect_coco(..., forward=,
programs=)`). The `-w` CLI detects one image and runs eagerly, as does
int8, which calibrates on each image.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from face_vijnana_yolov3_tpu_torch.api.face_detection import resolve_device
from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache
from face_vijnana_yolov3_tpu_torch.models import darknet, quant
from face_vijnana_yolov3_tpu_torch.ops.postprocess import coco_postprocess

COCO_LABELS = [
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "sofa", "pottedplant",
    "bed", "diningtable", "toilet", "tvmonitor", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]
YOLO_OUTPUTS = ("yolo_82", "yolo_94", "yolo_106")
PRECISIONS = ("float32", "bfloat16", "int8")


def preprocess_coco(image: np.ndarray, net_h: int = 416, net_w: int = 416):
    """The COCO demo's letterbox (yolov3_detect.py:313-333): float resize of the
    BGR-flipped /255 image into a 0.5-gray canvas.

    Note this differs from the face pipeline's letterbox: float (not int)
    geometry with ceil, gray (not black) padding, and a channel flip quirk
    (`image[:,:,::-1]` — the reference feeds BGR to a network trained on RGB;
    preserved for output parity).
    """
    import cv2 as cv

    new_h, new_w, _ = image.shape
    if (float(net_w) / new_w) < (float(net_h) / new_h):
        new_h = (new_h * net_w) / new_w
        new_w = net_w
    else:
        new_w = (new_w * net_h) / new_h
        new_h = net_h
    rh, rw = int(np.ceil(new_h)), int(np.ceil(new_w))
    resized = cv.resize(
        (image[:, :, ::-1] / 255.0).astype(np.float64), (rw, rh),
        interpolation=cv.INTER_LINEAR,
    )
    canvas = np.ones((net_h, net_w, 3)) * 0.5
    y0 = int((net_h - new_h) / 2)
    x0 = int((net_w - new_w) / 2)
    canvas[y0 : y0 + rh, x0 : x0 + rw, :] = resized
    return canvas[None].astype(np.float32)


def load_yolov3_params(path: str) -> dict[str, torch.Tensor]:
    """The full 3-head graph's state dict (OIHW f32, CPU) from either weight
    format: a darknet binary (`yolov3.weights`) or a Keras-layout h5
    (`yolov3_model.h5` — the demo CLI's save/load fast path, reference
    yolov3_detect.py:572-585)."""
    if path.endswith((".h5", ".hd5")):
        from face_vijnana_yolov3_tpu_torch.core.keras_import import yolov3_from_keras_h5

        return yolov3_from_keras_h5(path)
    from face_vijnana_yolov3_tpu_torch.core.weights import load_darknet_weights

    return {k: torch.from_numpy(v)
            for k, v in load_darknet_weights(path, darknet.yolov3_graph()).items()}


def coco_forward(state_dict: dict, precision: str, device, x_calib=None):
    """The forward of one precision as a function of a (B, S, S, 3) f32
    NHWC batch on `device` → the three heads (B, G, G, 255) f32, largest
    stride first. int8 calibrates on `x_calib` (the image, in the CLI)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: expected one of {PRECISIONS}")
    ops = darknet.yolov3_graph()
    sd = {k: torch.as_tensor(v).to(device) for k, v in state_dict.items()}
    if precision == "float32":
        model = darknet.Darknet(ops, device=device)
        model.load_state_dict(sd)

        def run(x):
            with darknet.exact_f32():
                return model(x)
    elif precision == "bfloat16":
        folded = darknet.fold_graph_params(sd, ops)

        def run(x):
            return darknet.apply_graph_folded(folded, x, ops,
                                              compute_dtype=torch.bfloat16)
    else:
        folded = darknet.fold_graph_params(sd, ops)
        with torch.inference_mode():
            qparams = quant.to_device(quant.quantize_folded(folded, x_calib, ops),
                                      device)

        def run(x):
            return quant.apply_graph_quant(qparams, x, ops, fused_blocks=True)

    def heads(x: torch.Tensor):
        with torch.inference_mode():
            outs = run(x)
        return tuple(outs[k] for k in YOLO_OUTPUTS)

    return heads


def detect_coco(
    weights_path: str,
    image: np.ndarray,
    obj_thresh: float = 0.5,
    nms_thresh: float = 0.45,
    precision: str = "float32",
    net_size: int = 416,
    params_state: dict | None = None,
    device: torch.device | str | None = None,
    *,
    forward=None,
    programs: ProgramCache | None = None,
):
    """Full-image COCO detection on `device` (the card when None); returns
    numpy (boxes, objness, classes, valid). `params_state` is a state dict
    from `load_yolov3_params` (then `weights_path` is not read).

    forward: a `coco_forward` of this precision built by the caller once
    (weights moved and folded once); None builds one for the call (int8
    calibrates it on the image). programs: a cache of the caller's, where
    images recur: the f32 and bf16 forward and `coco_postprocess` replay
    as one captured program (the JAX demo's jitted `run`), key ("coco",
    precision, net size, image_h, image_w, obj_thresh, nms_thresh). It
    needs `forward`, whose weights the program reads, and takes no int8:
    the int8 forward is calibrated on each image, so its program would run
    once."""
    dev = resolve_device(device)
    image_h, image_w = image.shape[:2]
    x = torch.from_numpy(preprocess_coco(image, net_size, net_size)).to(dev)
    if programs is not None and (forward is None or precision == "int8"):
        raise ValueError("detect_coco: a program cache takes a prebuilt f32 or bf16 "
                         "forward")
    if forward is None:
        sd = params_state if params_state is not None else load_yolov3_params(weights_path)
        forward = coco_forward(sd, precision, dev, x_calib=x)

    def run(t):
        return coco_postprocess(tuple(h[0] for h in forward(t)), image_h, image_w,
                                obj_thresh, nms_thresh, net_h=net_size, net_w=net_size)

    if programs is None:
        with torch.inference_mode():
            out = run(x)
    else:
        key = ("coco", precision, net_size, image_h, image_w, float(obj_thresh),
               float(nms_thresh))
        out = programs.run(key, run, x)
    return tuple(t.cpu().numpy() for t in out)


def draw_coco(image: np.ndarray, boxes, objness, classes, valid,
              draw_thresh: float = 0.1) -> np.ndarray:
    """Draw per-class detections (draw_boxes semantics: any class > 0.1)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(image.astype(np.uint8), mode="RGB")
    draw = ImageDraw.Draw(im)
    h, w = image.shape[:2]
    for k in range(boxes.shape[0]):
        if not valid[k]:
            continue
        labels = [
            (COCO_LABELS[c], float(classes[k, c]))
            for c in range(classes.shape[1])
            if classes[k, c] > draw_thresh
        ]
        if not labels:
            continue
        if not np.all(np.isfinite(boxes[k])):
            continue
        x0 = float(np.clip(boxes[k, 0], 0, w - 1))
        y0 = float(np.clip(boxes[k, 1], 0, h - 1))
        x1 = float(np.clip(boxes[k, 2], 0, w - 1))
        y1 = float(np.clip(boxes[k, 3], 0, h - 1))
        if x1 <= x0 or y1 <= y0:
            continue
        draw.rectangle([x0, y0, x1, y1], outline=(0, 255, 0), width=2)
        text = " ".join(f"{n} {s:.2f}" for n, s in labels)
        draw.text((x0, max(y0 - 13, 0)), text, fill=(0, 0, 255))
    return np.asarray(im)


class YOLOV3:
    """Convenience detector mirroring the docker variant's `YOLOV3` class
    (reference docker/code/yolov3_detect.py:623-683): constructed from the
    saved model file, `detect_object` runs detect → person/bottle entropy
    filter → draw → `*_detected*` save and returns (image, boxes).

    `model_path` accepts the legacy `yolov3_model.hd5`/`.h5` (Keras-layout
    weights h5) or a darknet `yolov3.weights`. The weights move to `device`
    (the card when None) once; at f32 and bf16 the forward is built once
    (bf16 folds once) and every image replays one program of `programs`
    per (image shape, thresholds) (`detect_coco`). int8 calibrates on each
    image and runs eagerly.
    """

    def __init__(self, model_path: str = "yolov3_model.h5",
                 precision: str = "float32", net_size: int = 416,
                 device: torch.device | str | None = None):
        # 416 like the reference; the 256/128 variants it keeps commented
        # out (docker/code/yolov3_detect.py:630-632) are the net_size knob
        self.net_h = self.net_w = net_size
        self.labels = COCO_LABELS
        self.precision = precision
        self.device = resolve_device(device)
        self.params_state = {k: v.to(self.device)
                             for k, v in load_yolov3_params(model_path).items()}
        self._forward = self.programs = None
        if precision != "int8":
            self._forward = coco_forward(self.params_state, precision, self.device)
            self.programs = ProgramCache(self.device)

    def _detect_boxes(self, image: np.ndarray, obj_thresh, nms_thresh):
        """BoundBox list in original-image coords (reference box API)."""
        from face_vijnana_yolov3_tpu_torch.ops.boxes import BoundBox

        boxes, obj, classes, valid = detect_coco(
            "", image, obj_thresh, nms_thresh, self.precision,
            net_size=self.net_h, params_state=self.params_state, device=self.device,
            forward=self._forward, programs=self.programs,
        )
        out = []
        for k in range(boxes.shape[0]):
            if not valid[k] or not np.all(np.isfinite(boxes[k])):
                continue
            out.append(BoundBox(
                float(boxes[k, 0]), float(boxes[k, 1]),
                float(boxes[k, 2]), float(boxes[k, 3]),
                objness=float(obj[k]), classes=np.asarray(classes[k]),
            ))
        return out

    def detect_object(self, image_path, obj_thresh, cls_thresh, nms_thresh,
                      human_entropy_thresh, bottle_entropy_thresh):
        """docker/code/yolov3_detect.py:640-668 semantics, incl. the
        `image_path[:-5] + '_detected' + image_path[-5:]` output-name
        arithmetic (written for 5-char '.jpeg' suffixes; a '.jpg' input loses
        a stem character exactly as the reference would)."""
        from face_vijnana_yolov3_tpu_torch.utils.box_select import get_person_boxes
        from face_vijnana_yolov3_tpu_torch.utils.drawing import draw_boxes_v1
        from face_vijnana_yolov3_tpu_torch.utils.io import imread, imsave

        image = imread(image_path)
        boxes = self._detect_boxes(image, obj_thresh, nms_thresh)
        boxes = get_person_boxes(boxes, self.labels, cls_thresh,
                                 human_entropy_thresh, bottle_entropy_thresh)
        image = draw_boxes_v1(image, boxes, self.labels, cls_thresh)
        imsave(image_path[:-5] + "_detected" + image_path[-5:],
               image.astype("uint8"))
        return image, boxes

    def detect_person(self, image, obj_thresh, cls_thresh, nms_thresh,
                      human_entropy_thresh, bottle_entropy_thresh):
        """In-memory variant (docker/code/yolov3_detect.py:670-683): detect on
        an array and return the entropy-filtered person boxes, no drawing."""
        from face_vijnana_yolov3_tpu_torch.utils.box_select import get_person_boxes

        boxes = self._detect_boxes(np.asarray(image), obj_thresh, nms_thresh)
        return get_person_boxes(boxes, self.labels, cls_thresh,
                                human_entropy_thresh, bottle_entropy_thresh)


def main(argv: list[str] | None = None, *,
         device: torch.device | str | None = None) -> str:
    """The demo CLI on `device` (the card when None); returns the path of
    the image it wrote."""
    from face_vijnana_yolov3_tpu_torch.utils.io import imread, imsave

    parser = argparse.ArgumentParser(
        description="test yolov3 network with coco weights"
    )
    parser.add_argument("-w", "--weights", default="yolov3.weights")
    parser.add_argument("-i", "--image", required=True)
    parser.add_argument("-l", "--load", default=0, type=int,
                        help="1: load yolov3_model.h5 instead of -w "
                             "(reference yolov3_detect.py:572-580)")
    parser.add_argument("-s", "--save", default=0, type=int,
                        help="1: save yolov3_model.h5 after loading "
                             "(reference yolov3_detect.py:584-585)")
    parser.add_argument("--obj-thresh", type=float, default=0.5)
    parser.add_argument("--nms-thresh", type=float, default=0.45)
    parser.add_argument("--precision", default="float32", choices=list(PRECISIONS))
    ns = parser.parse_args(argv)

    if ns.load:
        params_state = load_yolov3_params("yolov3_model.h5")
    else:
        params_state = load_yolov3_params(ns.weights)
    if ns.save:
        from face_vijnana_yolov3_tpu_torch.core.keras_import import save_yolov3_keras_h5

        save_yolov3_keras_h5(params_state, "yolov3_model.h5")
    image = imread(ns.image)
    boxes, obj, classes, valid = detect_coco(
        "", image, ns.obj_thresh, ns.nms_thresh, ns.precision,
        params_state=params_state, device=device,
    )
    out = draw_coco(image, boxes, obj, classes, valid)
    root, ext = os.path.splitext(ns.image)
    out_path = f"{root}_detected{ext}"
    imsave(out_path, out)
    n = int(
        ((classes > 0.1).any(axis=1) & valid).sum()
    )
    print(f"{n} detections → {out_path}")
    return out_path


if __name__ == "__main__":
    main()
