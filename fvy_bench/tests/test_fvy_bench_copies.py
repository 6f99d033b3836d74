"""The benchmark's copies held to their originals, and its plain reference
held to the program, on the CPU at small sizes.

Originals: chip_smoke.py (`conv_cost`, `block_cost`, `bound`),
face_vijnana_yolov3_tpu_torch/profile_detect.py (`category`), bench.py
(`detector_flops_per_image`), data/synthetic.make_dataset (the scene draw)
and data/uccs.build_gt_tensor (the training target); the reference's
letterbox, fold, int8 walk, postprocess and un-letterbox against the
port's own functions.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from fvy_bench.harness import costs, traffic
from fvy_bench.reference import detector as ref

ROOT = Path(__file__).resolve().parents[2]
ARCH = json.loads((ROOT / "fvy_bench" / "configs" / "face_detector_416.json").read_text())


def _module(name):
    spec = importlib.util.spec_from_file_location(f"orig_{name}", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chip_smoke():
    return _module("chip_smoke")


@pytest.mark.parametrize("shape", [(40, 416, 416, 3, 32, 3, 1, False),
                                   (40, 208, 208, 32, 64, 3, 2, False),
                                   (8, 52, 52, 128, 256, 1, 1, True),
                                   (1, 13, 13, 1024, 512, 3, 1, True)])
def test_conv_cost_and_bound(chip_smoke, shape):
    assert costs.conv_cost(*shape) == chip_smoke.conv_cost(*shape)
    nb, ops = costs.conv_cost(*shape)
    for peak in (costs.PEAK_INT8, costs.PEAK_BF16, costs.PEAK_F32):
        assert costs.bound(nb, ops, peak) == chip_smoke.bound(nb, ops, peak)
    assert (costs.PEAK_INT8, costs.PEAK_BF16, costs.PEAK_F32, costs.HBM) == (
        chip_smoke.PEAK_INT8, chip_smoke.PEAK_BF16, chip_smoke.PEAK_F32, chip_smoke.HBM)


@pytest.mark.parametrize("shape", [(40, 52, 52, 256, 128), (40, 13, 13, 1024, 512)])
def test_block_cost(chip_smoke, shape):
    assert costs.block_cost(*shape) == chip_smoke.block_cost(*shape)


def test_category():
    from face_vijnana_yolov3_tpu_torch.profile_detect import category

    names = ["block_int8_kernel<128>", "conv_tma_kernel", "conv_gather_kernel",
             "nms_sweep_kernel", "front_fused", "Memcpy HtoD (Pinned -> Device)",
             "Memset (Device)", "sm90_xmma_fprop_implicit_gemm", "ampere_sgemm_128x64_nn",
             "void at::native::vectorized_elementwise_kernel<4>", "winograd",
             "void at::native::reduce_kernel<512, 1>"]
    assert [costs.category(n) for n in names] == [category(n) for n in names]


def test_flops_and_trunk():
    from face_vijnana_yolov3_tpu_torch.models.darknet import conv_layout, trunk_graph

    bench = _module("bench")
    assert costs.detector_flops_per_image(ARCH) == bench.detector_flops_per_image(416)
    port = [(i, ci, co, k, s) for i, ci, co, k, s, _bn in conv_layout(trunk_graph())]
    mine = [(c["idx"], c["cin"], c["cout"], c["k"], c["stride"])
            for c in costs.trunk_convs(ARCH)]
    assert mine == port
    assert ref.trunk_ops(ARCH) == [op for op in trunk_graph() if op[0] != "mark"]


def test_scene_draw_follows_make_dataset(tmp_path):
    """The same rules as make_dataset: 1-3 disks a scene, radius in
    [24, 56), centre r + 2 from the edges, every disk pixel the face
    colour, the background's mean and spread those of its draw."""
    from face_vijnana_yolov3_tpu_torch.data.synthetic import make_dataset
    from face_vijnana_yolov3_tpu_torch.utils.io import imread

    params = dict(height=128, width=128, faces_per_frame=[1, 3], face_radius=[24, 56],
                  background_uniform=[40, 90], background_std=12,
                  face_rgb=[220, 190, 160], chunk=4, ring_chunks=2)
    frames, faces = traffic.make_scenes(params, 11, "cpu")
    assert frames.shape == (8, 128, 128, 3) and frames.dtype == torch.uint8
    yy, xx = np.mgrid[0:128, 0:128]
    covered = np.zeros((8, 128, 128), bool)
    for k, rows in enumerate(faces):
        assert 1 <= len(rows) <= 3
        for cx, cy, r in rows:
            assert 24 <= r < 56 and r + 2 <= cx < 128 - r - 2 and r + 2 <= cy < 128 - r - 2
            mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            assert (frames[k].numpy()[mask] == [220, 190, 160]).all()
            covered[k] |= mask
    ours = frames.numpy()[~covered].astype(np.float64)
    root = make_dataset(str(tmp_path / "ds"), n_train=8, n_val=0, image_size=128, seed=3)
    rows = pd.read_csv(os.path.join(root, "training.csv"))
    theirs = []
    for i in range(8):
        img = imread(os.path.join(root, f"tr_{i}.jpg")).astype(np.float64)
        m = np.ones((128, 128), bool)
        for _, f in rows[rows.FILE == f"tr_{i}.jpg"].iterrows():
            r = f.FACE_WIDTH // 2
            m &= (xx - (f.FACE_X + r)) ** 2 + (yy - (f.FACE_Y + r)) ** 2 > (r + 3) ** 2
        theirs.append(img[m])
    theirs = np.concatenate(theirs)
    # make_dataset's pixels went through JPEG, which smooths the noise: its
    # mean, and the spread of its draw, uniform(40, 90) + normal(0, 12).
    assert abs(ours.mean() - theirs.mean()) < 1.0
    assert abs(ours.std() - np.sqrt(50 ** 2 / 12 + 12 ** 2)) < 0.3
    assert rows.FACE_WIDTH.between(48, 110).all() and (rows.FACE_WIDTH % 2 == 0).all()


def test_gt_tensor_is_build_gt_tensor():
    from face_vijnana_yolov3_tpu_torch.data.uccs import build_gt_tensor
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry

    rng = np.random.default_rng(5)
    for faces in traffic.face_rows(dict(height=416, width=416, faces_per_frame=[1, 3],
                                        face_radius=[24, 56]), 20, rng):
        df = pd.DataFrame([{"FACE_ID": i, "FILE": "a.jpg", "SUBJECT_ID": 1,
                            "FACE_X": cx - r, "FACE_Y": cy - r,
                            "FACE_WIDTH": 2 * r, "FACE_HEIGHT": 2 * r}
                           for i, (cx, cy, r) in enumerate(faces.tolist())])
        want = build_gt_tensor(df, letterbox_geometry(416, 416, 416), 13, 6)
        np.testing.assert_array_equal(traffic.gt_tensor(faces, 416, 13, 6), want)


@pytest.mark.parametrize("hw", [(72, 128), (128, 72), (720, 1280)])
def test_letterbox_geometry_and_unletterbox(hw):
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import (
        letterbox_geometry,
        unletterbox_boxes_chunk,
    )
    from face_vijnana_yolov3_tpu_torch.ops.resize import letterbox_matrices

    h, w = hw
    g, pg = ref.geometry(h, w, 416), letterbox_geometry(h, w, 416)
    assert (g.new_h, g.new_w, g.pad_t, g.pad_l) == (pg.new_h, pg.new_w, pg.pad_t, pg.pad_l)
    row, col = letterbox_matrices(pg, h, w, 416)
    np.testing.assert_array_equal(ref.resize_matrix(h, g.new_h, g.pad_t, 416), row)
    np.testing.assert_array_equal(ref.resize_matrix(w, g.new_w, g.pad_l, 416), col)
    cands = np.random.default_rng(1).integers(0, 416, (3, 7, 6)).astype(np.float32)
    np.testing.assert_array_equal(ref.unletterbox(cands, g, 416),
                                  unletterbox_boxes_chunk(cands, [pg] * 3))


@pytest.fixture(scope="module")
def small():
    """A 64² detector of the configuration's trunk with the benchmark's
    weights, the port's pipeline of it, and 4 staged frames."""
    from fvy_bench.harness.weights import detector_state_dict

    arch = dict(ARCH, image_size=64)
    sd = detector_state_dict(arch, 123, "cpu")
    frames, _ = traffic.make_scenes(dict(height=48, width=80, faces_per_frame=[1, 2],
                                         face_radius=[4, 8], background_uniform=[40, 90],
                                         background_std=12, face_rgb=[220, 190, 160],
                                         chunk=4, ring_chunks=1), 7, "cpu")
    return arch, sd, frames


def _pipeline(arch, sd, precision):
    from face_vijnana_yolov3_tpu_torch.api.config import FdConf
    from face_vijnana_yolov3_tpu_torch.api.face_detection import FaceDetectorPipeline

    conf = FdConf(weights_path="does_not_exist.weights")
    conf.nn_arch.image_size = arch["image_size"]
    conf.int8_pallas_blocks = True
    fd = FaceDetectorPipeline(conf, precision=precision, device="cpu")
    fd.model.load_state_dict(sd)
    return fd


@pytest.mark.parametrize("precision", ["int8", "bfloat16", "float32"])
def test_reference_rows_are_the_programs(small, precision):
    """The reference's rows equal the program's on the same frames and
    weights (int8: its own calibration on the same first frames)."""
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import (
        letterbox_geometry,
        unletterbox_boxes_chunk,
    )

    arch, sd, frames = small
    fd = _pipeline(arch, sd, precision)
    geoms = [letterbox_geometry(48, 80, 64)] * 4
    cands, counts = fd.detect_batch_fused(frames, geoms, pad_batch_to=4)
    ub = unletterbox_boxes_chunk(cands, geoms)
    rows = [np.concatenate([ub[k, :n], cands[k, :n, 5:6].astype(np.float64)], 1)
            for k, n in enumerate(counts)]
    det = ref.Detector(arch, sd, precision)
    if precision == "int8":
        det.calibrate(frames)
        assert det.tail == fd.int8_tail_chosen
    want = det.rows(frames)
    assert sum(map(len, want)) > 0
    for a, b in zip(rows, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_reference_fold_is_the_programs(small):
    arch, sd, _ = small
    fd = _pipeline(arch, sd, "float32")
    mine, theirs = ref.fold(sd, ref.trunk_ops(arch)), fd.model.fold()
    for k, v in theirs.items():
        for kk in v:
            assert torch.equal(mine[k][kk], v[kk]), (k, kk)
