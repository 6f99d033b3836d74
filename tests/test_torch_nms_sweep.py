"""NMS sweep of the PyTorch port vs the JAX package's Pallas sweep.

The plain PyTorch sweep (`nms_sweep_reference`, what the wrapper runs for CPU
tensors) is held against `nms_sweep_pallas(..., interpret=True)` on the same
numpy inputs. Tolerance: bit-exact — every output is a copy of an input score
or 0. The CUDA kernel (csrc/nms_sweep.cu) is held against the plain version
in `test_cuda_*`, which needs a card and skips without one. The kernel's
bitmask build and word-by-word scan are walked in numpy here
(`_emulate_bitmask_sweep`) and held bit-exact against both.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from face_vijnana_yolov3_tpu.ops.pallas_nms import nms_sweep_pallas
from face_vijnana_yolov3_tpu_torch.ops.boxes import pairwise_iou
from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import (
    SMEM_MAX_N,
    WORKSPACE_BYTES,
    mask_words,
    nms_sweep,
    nms_sweep_reference,
    workspace_chunk,
)
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)


def _sorted_case(kind: str, b: int = 3, n: int = 169, seed: int = 0):
    """(boxes (B,N,4), scores (B,N)) f32, scores descending with 20 absent
    rows; "nonfinite": NaN and infinite coordinates on a few boxes;
    "absent": every score 0; "ties": scores on a 0.1 grid, so equal
    scores sit in adjacent rows."""
    rng = np.random.default_rng(seed)
    if kind == "degenerate":
        boxes = np.zeros((b, n, 4), np.float32)  # 0/0 IoU everywhere
    else:
        mins = rng.uniform(0, 300, (b, n, 2))
        sizes = rng.uniform(10, 120, (b, n, 2))
        if kind == "integer":  # what the decode produces on the main path
            mins, sizes = np.floor(mins), np.floor(sizes)
        boxes = np.concatenate([mins, mins + sizes], -1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (b, n)).astype(np.float32)
    for k in range(b):
        scores[k, rng.integers(0, n, 20)] = 0.0
    if kind == "nonfinite":  # NaN and infinite coordinates on a few boxes
        flat = boxes.reshape(-1)
        pick = rng.choice(flat.size, max(1, flat.size // 25), replace=False)
        flat[pick] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), pick.size)
    if kind == "absent":
        scores[:] = 0.0
    if kind == "ties":
        scores = np.round(scores, 1).astype(np.float32)
    scores = -np.sort(-scores, axis=-1)
    return boxes, scores


def _emulate_bitmask_sweep(boxes, scores, th):
    """csrc/nms_sweep.cu in numpy: the mask words (row i with score > 0,
    words w >= i // 32, bit j set iff j > i and IoU(i, j) >= th with box i
    as operand a), then one scan word by word: the removed words (lane v's
    register for N <= 1024; for N > 1024 `nms_sweep_global_kernel`'s shared
    array, ceil(N/32) words, with the mask in a workspace whose unwritten
    words hold garbage), the word's rows resolved in order, the alive rows'
    mask words ORed into the words >= w; out = removed ? 0 : s."""
    th = np.float32(th)
    iou = pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    b, n = scores.shape
    words = (n + 31) // 32
    out = np.empty_like(scores)
    for k in range(b):
        s = scores[k]
        mask = np.full((n, words), 0xDEADBEEF, np.uint32)  # unwritten words
        for i in range(n):
            if not s[i] > 0:
                continue
            w0 = i // 32
            j = np.arange(32 * w0, 32 * words)
            ok = (j > i) & (j < n)
            hit = np.zeros(j.size, bool)
            with np.errstate(invalid="ignore"):
                hit[ok] = iou[k, i, j[ok]] >= th
            mask[i, w0:] = np.packbits(hit, bitorder="little").view("<u4")
        removed = [0] * words
        for w in range(words):
            positive = sum(1 << l for l in range(32) if 32 * w + l < n and s[32 * w + l] > 0)
            cand, alive = positive & ~removed[w], 0
            while cand:
                bit = (cand & -cand).bit_length() - 1
                alive |= 1 << bit
                cand &= ~(1 << bit)
                cand &= ~int(mask[32 * w + bit, w])
            rows = [32 * w + bit for bit in range(32) if (alive >> bit) & 1]
            if rows:
                folded = np.bitwise_or.reduce(mask[rows, w:], axis=0)
                for v in range(w, words):
                    removed[v] |= int(folded[v - w])
        for j in range(n):
            out[k, j] = 0.0 if (removed[j // 32] >> (j % 32)) & 1 else s[j]
    return out


def _pallas(boxes, scores, th):
    return np.asarray(nms_sweep_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), th, interpret=True))


@pytest.mark.parametrize("kind", ["float", "integer", "degenerate"])
@pytest.mark.parametrize("th", [0.45, 0.5])
def test_reference_matches_pallas_interpret(kind, th):
    boxes, scores = _sorted_case(kind)
    want = _pallas(boxes, scores, th)
    got = nms_sweep_reference(torch.from_numpy(boxes), torch.from_numpy(scores), th)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "degenerate":
        np.testing.assert_array_equal(want, scores)  # NaN IoU never suppresses


EMULATED = [("float", 1), ("float", 31), ("float", 32), ("integer", 33),
            ("integer", 169), ("degenerate", 169), ("nonfinite", 169), ("absent", 169),
            ("ties", 169),
            ("float", 1024), ("float", 1025), ("integer", 1089), ("nonfinite", 1089),
            ("float", 4096)]


@pytest.mark.parametrize("kind,n", EMULATED)
def test_bitmask_walk_matches_plain_and_pallas(kind, n):
    """The kernel's index math (mask words, the diagonal, N not a multiple of
    32, the word-by-word scan) must reproduce the sweep bit for bit."""
    boxes, scores = _sorted_case(kind, b=1 if n >= 1024 else 2, n=n, seed=n)
    if kind == "float" and n >= 1024:
        boxes[..., 2:] = boxes[..., :2] + (boxes[..., 2:] - boxes[..., :2]) / 4
    got = _emulate_bitmask_sweep(boxes, scores, 0.45)
    want = nms_sweep_reference(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45)
    np.testing.assert_array_equal(got, want.numpy())
    if kind != "nonfinite" and n <= 1089:  # the Pallas path maps an infinite IoU to -1
        np.testing.assert_array_equal(got, _pallas(boxes, scores, 0.45))
    if kind in ("degenerate", "absent"):
        np.testing.assert_array_equal(got, scores)


@pytest.mark.parametrize("b,n", [(128, 169), (1, 1024), (32, 1025), (32, 1600),
                                 (300, 4096), (3, 65536)])
def test_workspace_chunks_cover_the_batch(b, n):
    """N <= 1024 launches once with no workspace; above, each launch's mask
    workspace (images x N x ceil(N/32) words) stays within WORKSPACE_BYTES,
    or is one image, and the launches cover every image once."""
    chunk = workspace_chunk(b, n)
    if n <= SMEM_MAX_N:
        assert chunk == b
        return
    assert 1 <= chunk <= b
    assert chunk == 1 or 4 * chunk * mask_words(n) <= WORKSPACE_BYTES
    starts = list(range(0, b, chunk))
    sizes = [min(chunk, b - i) for i in starts]
    assert sum(sizes) == b and all(s > 0 for s in sizes)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    boxes, scores = _sorted_case("float", seed=1)
    before = nms_sweep.launches
    got = nms_sweep(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45)
    np.testing.assert_array_equal(got.numpy(), _pallas(boxes, scores, 0.45))
    assert nms_sweep.launches == before  # only a kernel launch counts


def test_wrapper_refuses_other_devices():
    boxes = torch.zeros((1, 4, 4), device="meta")
    scores = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        nms_sweep(boxes, scores, 0.5)


def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cases = [(kind, b, n) for kind in ("float", "integer", "degenerate")
             for b in (1, 32, 128) for n in (1, 31, 32, 33, 169, 1024)]
    cases += [(kind, b, 169) for kind in ("nonfinite", "absent", "ties")
              for b in (1, 32, 128)]
    # N > 1024: the mask in a device-memory workspace (image_size >= 1,056)
    cases += [(kind, b, n) for kind in ("float", "integer", "degenerate", "nonfinite",
                                        "absent", "ties")
              for b in (1, 32) for n in (1025, 1089, 1600, 4096)]
    for kind, b, n in cases:
        boxes, scores = _sorted_case(kind, b=b, n=n, seed=2)
        cb, cs = torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda()
        for th in (0.45, 0.5):
            want = nms_sweep_reference(cb, cs, th)
            before = nms_sweep.launches
            got = nms_sweep(cb, cs, th)
            torch.cuda.synchronize()
            assert nms_sweep.launches == before + 1
            assert torch.equal(got, want), (kind, b, n, th)
