"""The port's ROI crops (ops/roi.py) vs the JAX package's.

The host half (crop windows, tap tables, window buckets, operand packing)
is a copy: equal outputs, exactly. The device half (tap tables → resize
matrices → two f32 matmuls over the staged image or a window of it) is
held to the JAX functions and to the host crop + cv2 letterbox with the
f32 rule of tests/test_roi.py: 1e-6 abs against the JAX device functions
(the same weights, f32 sums in another order) [measured 2.4e-7], 3e-6
against the host crop's f64 cv2 letterbox [2.0e-6].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.ops import roi as jax_roi
from face_vijnana_yolov3_tpu_torch.ops import roi
from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host

torch.set_num_threads(2)

DEVICE_TOL = 1e-6
HOST_TOL = 3e-6
H, W, S = 150, 200, 64
BOXES = np.array([
    [40, 30, 110, 90, 0.9],
    [1, 1, 50, 40, 0.8],
    [150, 100, 200, 150, 0.7],
    [10, 90, 180, 100, 0.6],    # wide and thin: the portrait letterbox branch
    [199, 149, 200, 150, 0.5],  # 1x1 crop
    [0, 30, 110, 90, 0.4],      # l == 0: the off-by-one slice wraps, empty crop
    [40.7, 30.2, 110.9, 90.5, 0.3],  # int() truncation of the corners
], np.float64)


@pytest.mark.parametrize("l,t,r,b", [
    (40, 30, 110, 90), (1, 1, 50, 40), (0, 30, 110, 90), (40, 0, 110, 90),
    (150, 100, 200, 150), (40, 30, 40, 90), (40, 30, 110, 30), (0, 0, 0, 0),
    (199, 149, 200, 150), (0, 0, 200, 150),
])
def test_roi_window_matches_jax_and_the_slice(l, t, r, b):
    img = np.arange(H * W).reshape(H, W)
    want = img[(t - 1):(b - 1), (l - 1):(r - 1)]
    got = roi.roi_window(l, t, r, b, H, W)
    assert got == jax_roi.roi_window(l, t, r, b, H, W)
    y0, x0, ch, cw = got
    assert (max(ch, 0), max(cw, 0)) == want.shape
    if ch > 0 and cw > 0:
        np.testing.assert_array_equal(img[y0:y0 + ch, x0:x0 + cw], want)


def test_host_tables_equal_jax():
    keep, *taps = roi.build_roi_taps(BOXES, H, W, S)
    jkeep, *jtaps = jax_roi.build_roi_taps(BOXES, H, W, S)
    assert keep == jkeep == [0, 1, 2, 3, 4, 6]
    for g, w in zip(taps, jtaps):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    keep, wins = roi.build_roi_windows(BOXES, H, W)
    assert (keep, wins) == jax_roi.build_roi_windows(BOXES, H, W)
    origins = np.array([[min(y0, 20), min(x0, 30)] for y0, x0, _, _ in wins])
    for g, w in zip(roi.stack_roi_taps(wins, S, origins),
                    jax_roi.stack_roi_taps(wins, S, origins)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(roi.stack_roi_taps([], S), jax_roi.stack_roi_taps([], S)):
        assert g.shape == w.shape == (0, S, 4)
    for g, w in zip(roi.zero_taps(S), jax_roi.zero_taps(S)):
        np.testing.assert_array_equal(g, w)
    for need, limit in ((1, 150), (129, 1000), (600, 700), (5000, 4000), (90, 64)):
        assert roi.window_bucket(need, limit) == jax_roi.window_bucket(need, limit)
    with pytest.raises(ValueError, match="degenerate crop aspect"):
        roi.roi_letterbox_taps(0, 0, 1, 200, S)
    with pytest.raises(ValueError, match="degenerate crop aspect"):
        jax_roi.roi_letterbox_taps(0, 0, 1, 200, S)


def test_pack_and_unpack_match_jax():
    keep, wins = roi.build_roi_windows(BOXES, H, W)
    origins = np.array([[j % 2, y0, x0] for j, (y0, x0, _, _) in enumerate(wins)], np.int32)
    taps = roi.stack_roi_taps(wins, S, origins[:, 1:])
    packed = roi.pack_roi_operands(origins, *taps)
    np.testing.assert_array_equal(packed, jax_roi.pack_roi_operands(origins, *taps))
    got = roi.unpack_roi_operands(torch.from_numpy(packed), S)
    want = jax_roi.unpack_roi_operands(jnp.asarray(packed), S)
    for g, w, orig in zip(got, want, (origins, *taps)):
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), orig)


def _image(seed=7, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3)).astype(np.uint8)


def test_mat_from_taps_equals_the_host_matrix():
    from face_vijnana_yolov3_tpu_torch.ops.resize import taps_to_matrix

    _, ri, rw, ci, cw = roi.build_roi_taps(BOXES, H, W, S)
    got = roi._mat_from_taps(torch.from_numpy(ri), torch.from_numpy(rw), H)
    for k in range(ri.shape[0]):
        np.testing.assert_array_equal(got[k].numpy(), taps_to_matrix(ri[k], rw[k], H))


def test_roi_letterbox_device_matches_jax_and_host():
    img = _image()
    keep, ri, rw, ci, cw = roi.build_roi_taps(BOXES, H, W, S)
    got = roi.roi_letterbox_device(*(torch.from_numpy(a) for a in (img, ri, rw, ci, cw)))
    want = np.asarray(jax.jit(jax_roi.roi_letterbox_device)(
        *(jnp.asarray(a) for a in (img, ri, rw, ci, cw))))
    assert got.shape == (len(keep), S, S, 3) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= DEVICE_TOL
    for j, k in enumerate(keep):
        l, t, r, b = (int(v) for v in BOXES[k, :4])
        host, _ = letterbox_host(img[(t - 1):(b - 1), (l - 1):(r - 1), :] / 255, S, "cubic")
        assert float(np.abs(got[j].numpy() - host).max()) <= HOST_TOL


@pytest.mark.parametrize("staged_dtype", ["uint8", "float32"])
def test_roi_letterbox_windowed_matches_jax_and_absolute(staged_dtype):
    """Two staged images in one padded batch, windows clamped at the staged
    edges: the windowed crops equal the JAX windowed function's and the
    absolute path's of each image within the f32 rule; float staging is
    taken as already in [0, 1] in both packages."""
    imgs = [_image(13, 300, 400), _image(14, 250, 380)]
    bh, bw = 384, 512
    staged = np.zeros((2, bh, bw, 3), np.uint8)
    for j, im in enumerate(imgs):
        staged[j, : im.shape[0], : im.shape[1]] = im
    if staged_dtype == "float32":
        staged = staged.astype(np.float32) / 255.0
    owners, wins = [], []
    for j, im in enumerate(imgs):
        boxes = BOXES.copy()
        boxes[:, :4] *= (1.5 + 0.3 * j)
        boxes = np.concatenate([boxes, [[300, 200, 380, 250, 0.1]]])
        keep, w = roi.build_roi_windows(boxes, im.shape[0], im.shape[1])
        owners += [(j, k) for k in keep]
        wins += w
    wh = roi.window_bucket(max(w[2] for w in wins), bh)
    ww = roi.window_bucket(max(w[3] for w in wins), bw)
    origins = np.array([(j, min(y0, bh - wh), min(x0, bw - ww))
                        for (j, _), (y0, x0, _, _) in zip(owners, wins)], np.int32)
    taps = roi.stack_roi_taps(wins, S, origins[:, 1:])
    got = roi.roi_letterbox_device_windowed(
        torch.from_numpy(staged), torch.from_numpy(origins),
        *(torch.from_numpy(a) for a in taps), window_h=wh, window_w=ww)
    want = np.asarray(jax.jit(lambda *a: jax_roi.roi_letterbox_device_windowed(
        *a, window_h=wh, window_w=ww))(jnp.asarray(staged), jnp.asarray(origins),
                                       *(jnp.asarray(a) for a in taps)))
    assert float(np.abs(got.numpy() - want).max()) <= DEVICE_TOL
    absolute = roi.stack_roi_taps(wins, S)
    for r, (j, _k) in enumerate(owners):
        one = roi.roi_letterbox_device(torch.from_numpy(staged[j]),
                                       *(torch.from_numpy(a[r:r + 1]) for a in absolute))
        assert float(np.abs(got[r].numpy() - one[0].numpy()).max()) <= DEVICE_TOL
