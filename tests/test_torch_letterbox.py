"""Letterbox geometry, box un-mapping and the device letterbox: port vs JAX.

Geometry, tap matrices and the f64 un-mapping are numpy in both packages and
must be exact. The two-matmul device letterbox is held against the JAX
`letterbox_device_matmul(precision="highest")` within atol 1e-5: both are f32
matmuls, summed in a different order (pixels in [0, 1], cubic weights
summing to 1).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from face_vijnana_yolov3_tpu.ops import letterbox as jlb
from face_vijnana_yolov3_tpu.ops import resize as jrs
from face_vijnana_yolov3_tpu_torch.ops import letterbox as lb
from face_vijnana_yolov3_tpu_torch.ops import resize as rs
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)

SHAPES = [(240, 320), (320, 240), (64, 64), (57, 203), (203, 57), (5, 99)]


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("size", [64, 416])
def test_geometry_equals_jax(h, w, size):
    got = lb.letterbox_geometry(h, w, size)
    want = jlb.letterbox_geometry(h, w, size)
    assert vars(got) == vars(want)


def test_unletterbox_chunk_equals_jax():
    rng = np.random.default_rng(3)
    geoms = [(300, 500), (640, 360), (416, 416), (57, 1203)]
    cands = rng.uniform(-10, 430, (4, 60, 6))
    got = lb.unletterbox_boxes_chunk(cands, [lb.letterbox_geometry(h, w, 416)
                                             for h, w in geoms])
    want = jlb.unletterbox_boxes_chunk(cands, [jlb.letterbox_geometry(h, w, 416)
                                               for h, w in geoms])
    np.testing.assert_array_equal(got, want)
    for k, (h, w) in enumerate(geoms):
        np.testing.assert_array_equal(
            lb.unletterbox_boxes(cands[k, :, :4], lb.letterbox_geometry(h, w, 416)),
            got[k])


@pytest.mark.parametrize("h,w", SHAPES[:2])
def test_letterbox_host_equals_jax(h, w):
    img = np.random.default_rng(0).integers(0, 256, (h, w, 3)).astype(np.uint8)
    got, _ = lb.letterbox_host(img / 255, 64, "cubic")
    want, _ = jlb.letterbox_host(img / 255, 64, "cubic")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [64, 416])
@pytest.mark.parametrize("h,w", SHAPES)
def test_letterbox_matrices_equal_jax(size, h, w):
    g = lb.letterbox_geometry(h, w, size)
    got = rs.letterbox_matrices(g, h + 5, w + 7, size)
    want = jrs.letterbox_matrices(jlb.letterbox_geometry(h, w, size), h + 5,
                                  w + 7, size, "cubic")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("uniform", [True, False])
def test_device_letterbox_matches_jax(uniform):
    """Landscape and portrait images staged top-left in one buffer."""
    rng = np.random.default_rng(1)
    dims = [(240, 320), (240, 320)] if uniform else [(240, 320), (320, 240)]
    max_h, max_w = max(d[0] for d in dims), max(d[1] for d in dims)
    staged = np.zeros((len(dims), max_h, max_w, 3), np.float32)
    for k, (h, w) in enumerate(dims):
        staged[k, :h, :w] = rng.uniform(size=(h, w, 3))
    mats = [rs.letterbox_matrices(lb.letterbox_geometry(h, w, 64), max_h, max_w, 64)
            for h, w in dims]
    row = np.stack([m[0] for m in mats])
    col = np.stack([m[1] for m in mats])
    if uniform:
        row, col = row[:1], col[:1]
    got = rs.letterbox_device_matmul(torch.from_numpy(staged),
                                     torch.from_numpy(row), torch.from_numpy(col))
    want = jrs.letterbox_device_matmul(
        jnp.asarray(staged), jnp.broadcast_to(row, (len(dims),) + row.shape[1:]),
        jnp.broadcast_to(col, (len(dims),) + col.shape[1:]), precision="highest")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # The border band is exactly zero, as in the host cv2 path.
    for k, (h, w) in enumerate(dims):
        g = lb.letterbox_geometry(h, w, 64)
        assert not got[k, : g.pad_t].any() and not got[k, 64 - g.pad_b:].any()
        assert not got[k, :, : g.pad_l].any() and not got[k, :, 64 - g.pad_r:].any()


def test_cols_pass_allocates_no_broadcast():
    """The cols pass contracts the transposed row result: no allocation
    reaches one (B, S, S, W) f32 tensor, the broadcast of the column
    matrices that `torch.matmul(col_ms[:, None], tmp)` made (21 GB at 60
    ROIs of W = 512 on the card), divided by 8."""
    b, s, h, w = 4, 64, 384, 512
    rng = np.random.default_rng(3)
    staged = torch.from_numpy(rng.uniform(size=(b, h, w, 3)).astype(np.float32))
    row = torch.from_numpy(rng.uniform(size=(b, s, h)).astype(np.float32))
    col = torch.from_numpy(rng.uniform(size=(b, s, w)).astype(np.float32))
    want = torch.einsum("bpw,bowc->bopc", col,
                        torch.einsum("boh,bhwc->bowc", row, staged))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        got = rs.letterbox_device_matmul(staged, row, col)
    largest = max(e.cpu_memory_usage for e in prof.events())
    broadcast = b * s * s * w * 4
    assert largest < broadcast / 8, (largest, broadcast)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-3)
