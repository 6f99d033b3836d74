"""Decode, NMS and postprocess of the PyTorch port vs the JAX package.

Seeded (B, 13, 13, 6) heads go through both packages as the same numpy
arrays; the port runs on the CPU (its NMS wrapper then takes the plain sweep).
Tolerances: boxes, mask, counts and the kept set bit-exact (integer-valued
floats and comparisons). The objness column within 2 ULP and the score column
within 4 ULP: torch's and XLA's CPU `exp` are different implementations that
differ by at most 1 ULP (measured on 1e5 normal draws), objness is one
sigmoid of it and score the product of two (measured maxima on these cases:
2 and 3 ULP).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from face_vijnana_yolov3_tpu.ops.boxes import BoundBox as JaxBoundBox
from face_vijnana_yolov3_tpu.ops.decode import decode_face_head as jax_decode
from face_vijnana_yolov3_tpu.ops.nms import nms_single_class as jax_nms
from face_vijnana_yolov3_tpu.ops.postprocess import (
    FacePostprocessConfig as JaxCfg,
    face_postprocess_batch as jax_postprocess_batch,
)
from face_vijnana_yolov3_tpu_torch.ops.boxes import BoundBox, iou_single, pairwise_iou
from face_vijnana_yolov3_tpu_torch.ops.decode import decode_face_head
from face_vijnana_yolov3_tpu_torch.ops.nms import nms_single_class
from face_vijnana_yolov3_tpu_torch.ops.postprocess import (
    FacePostprocessConfig,
    face_postprocess_batch,
)

from oracles import oracle_face_detect, oracle_iou, oracle_nms_single
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)

OBJ_ULP, SCORE_ULP = 2, 4  # see the module docstring


def ulp_distance(got, want) -> np.ndarray:
    """|got - want| in f32 units in the last place; 0 where both are NaN."""
    a = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    # map the sign-magnitude bit patterns onto one monotone integer line
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    both_nan = np.isnan(got) & np.isnan(want)
    return np.where(both_nan, 0, np.abs(a - b))


def _assert_ulp(got, want, ulps):
    assert np.shape(got) == np.shape(want)
    d = ulp_distance(got, want)
    assert d.max(initial=0) <= ulps, f"{d.max()} ULP apart"


def _heads(kind: str, b: int = 4, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    head = rng.normal(size=(b, 13, 13, 6)).astype(np.float32)
    if kind == "peaky":  # a handful of confident cells per image
        for k in range(b):
            for _ in range(8):
                i, j = rng.integers(0, 13, size=2)
                head[k, i, j, 0] = rng.uniform(2.0, 5.0)
                head[k, i, j, 5] = rng.uniform(2.0, 5.0)
                head[k, i, j, 1:5] = rng.uniform(0.0, 1.0, size=4)
    elif kind == "wide":  # big logits: exp saturation, clamps at 0 and S
        head *= 8.0
    elif kind == "ties":  # equal scores across many cells: stable order matters
        head[..., 0] = 3.0
        head[..., 5] = 3.0
    elif kind == "absent":  # nothing passes the gate
        head[...] = -10.0
    elif kind == "nan":  # NaN cells never gate in and never suppress
        head[:, ::3, ::2, :] = np.nan
    return head


HEAD_KINDS = ["peaky", "wide", "ties", "absent", "nan"]


@pytest.mark.parametrize("kind", HEAD_KINDS)
def test_decode_matches_jax(kind):
    head = _heads(kind)
    got = [t.numpy() for t in decode_face_head(torch.from_numpy(head), 416, 13, 0.3)]
    for k in range(head.shape[0]):
        want = [np.asarray(a) for a in jax_decode(jnp.asarray(head[k]), 416, 13, 0.3)]
        np.testing.assert_array_equal(got[0][k], want[0])  # boxes
        _assert_ulp(got[1][k], want[1], SCORE_ULP)         # scores
        _assert_ulp(got[2][k], want[2], OBJ_ULP)           # objness
        np.testing.assert_array_equal(got[3][k], want[3])  # mask


def _nms_inputs(seed, n=169, b=3, ties=False, integer=False):
    rng = np.random.default_rng(seed)
    mins = rng.uniform(0, 300, (b, n, 2))
    sizes = rng.uniform(10, 120, (b, n, 2))
    if integer:
        mins, sizes = np.floor(mins), np.floor(sizes)
    boxes = np.concatenate([mins, mins + sizes], -1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (b, n)).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4  # few distinct values, many ties
    scores[:, rng.integers(0, n, 20)] = 0.0
    return boxes, scores


@pytest.mark.parametrize("ties,integer", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("th", [0.45, 0.5])
def test_nms_single_class_matches_jax(ties, integer, th):
    boxes, scores = _nms_inputs(1, ties=ties, integer=integer)
    got = nms_single_class(torch.from_numpy(boxes), torch.from_numpy(scores), th)
    for k in range(boxes.shape[0]):
        want = np.asarray(jax_nms(jnp.asarray(boxes[k]), jnp.asarray(scores[k]), th))
        np.testing.assert_array_equal(got[k].numpy(), want)


def test_nms_single_class_matches_oracle():
    boxes, scores = _nms_inputs(2, n=30, b=2)
    got = nms_single_class(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45)
    for k in range(2):
        want = oracle_nms_single(boxes[k], scores[k], 0.45)
        np.testing.assert_allclose(got[k].numpy(), want, atol=1e-6)


def test_nms_degenerate_boxes_never_suppress():
    """The tests/test_pallas_nms.py degenerate case: all-zero boxes, NaN IoU."""
    boxes = torch.zeros((1, 4, 4))
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.6]])
    got = nms_single_class(boxes, scores, 0.3)
    np.testing.assert_array_equal(got.numpy(), scores.numpy())


def test_pairwise_iou_matches_oracle():
    boxes, _ = _nms_inputs(3, n=25, b=1)
    got = pairwise_iou(torch.from_numpy(boxes[0]), torch.from_numpy(boxes[0])).numpy()
    for i in range(25):
        for j in range(25):
            assert got[i, j] == pytest.approx(oracle_iou(boxes[0, i], boxes[0, j]),
                                              abs=1e-5)
            assert iou_single(boxes[0, i], boxes[0, j]) == pytest.approx(
                oracle_iou(boxes[0, i], boxes[0, j]))


@pytest.mark.parametrize("kind", HEAD_KINDS)
@pytest.mark.parametrize("conf_th,num_cands", [(0.5, 60), (0.05, 60), (0.05, 7)])
def test_face_postprocess_batch_matches_jax(kind, conf_th, num_cands):
    head = _heads(kind, seed=5)
    cfg = FacePostprocessConfig(conf_th=conf_th, num_cands=num_cands)
    jcfg = JaxCfg(conf_th=conf_th, num_cands=num_cands)
    cands, counts = face_postprocess_batch(torch.from_numpy(head), cfg)
    want_c, want_n = map(np.asarray, jax_postprocess_batch(jnp.asarray(head), jcfg))
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), want_n)
    np.testing.assert_array_equal(cands[..., :4].numpy(), want_c[..., :4])
    _assert_ulp(cands[..., 4].numpy(), want_c[..., 4], OBJ_ULP)
    _assert_ulp(cands[..., 5].numpy(), want_c[..., 5], SCORE_ULP)
    for k in range(head.shape[0]):
        assert not cands[k, int(counts[k]):].any()  # rows past count are zero


def test_face_postprocess_matches_full_oracle():
    head = _heads("peaky", seed=6)
    cands, counts = face_postprocess_batch(torch.from_numpy(head),
                                           FacePostprocessConfig())
    for k in range(head.shape[0]):
        want = oracle_face_detect(head[k])
        assert int(counts[k]) == len(want)
        for r, (box, score) in enumerate(want):
            np.testing.assert_array_equal(cands[k, r, :4].numpy(),
                                          np.array(box, np.float32))
            assert float(cands[k, r, 5]) == pytest.approx(score, rel=1e-5)


def test_bound_box_matches_jax():
    for classes in ([0.2, 0.7, 0.1], [1.5, 0.3]):
        got = BoundBox(10, 20, 110, 70, objness=0.9, classes=classes)
        want = JaxBoundBox(10, 20, 110, 70, objness=0.9, classes=classes)
        assert got.get_label() == want.get_label()
        assert got.get_score() == want.get_score()  # clamped at 1.0
        assert got.get_relative_bb(640, 480) == want.get_relative_bb(640, 480)
