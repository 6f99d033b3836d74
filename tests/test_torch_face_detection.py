"""The whole f32 serving slice: the port's FaceDetectorPipeline vs the JAX one.

The JAX pipeline takes its random-init weights (weights file absent); the
port loads the same weights from a `.pt` checkpoint written through
`params_from_jax`. Both run test() and evaluate() on the synthetic set of
tests/test_pipeline.py (3 JPEGs, 240x320) at image_size 64 with the full
trunk, face_conf_th 0.05, batch 2, and `solution_fd.csv` must agree: the
same files and row counts, and boxes exact. Heads: rtol/atol 1e-4 (conv
summation order). Scores: |diff| <= 5e-5, the head tolerance carried through
score = sigmoid(h0) * sigmoid(h5), whose slope in each logit is at most 1/4.
They cannot be held to a few ULP as in tests/test_torch_postprocess.py,
where both packages decode the same head: here the heads themselves differ
by the conv summation order (measured: ~1e-6, 6 ULP on a score).
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

from face_vijnana_yolov3_tpu.api.config import FdConf
from face_vijnana_yolov3_tpu.api.face_detection import (
    FaceDetectorPipeline as JaxPipeline,
)
from face_vijnana_yolov3_tpu.ops.letterbox import letterbox_geometry as jax_geometry
from face_vijnana_yolov3_tpu.utils.io import imread, imsave
from face_vijnana_yolov3_tpu_torch.api import face_detection as port_fd
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
from face_vijnana_yolov3_tpu_torch.core.checkpoints import (
    load_checkpoint,
    load_train_meta,
    save_checkpoint,
    update_train_meta,
)
from face_vijnana_yolov3_tpu_torch.data.pipeline import prefetch_batches
from face_vijnana_yolov3_tpu_torch.ops.letterbox import (
    letterbox_geometry,
    letterbox_host,
)
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)

HEAD_TOL = 1e-4  # conv summation order differs between the frameworks
SCORE_ATOL = HEAD_TOL / 2  # two sigmoids of slope <= 1/4, see the docstring


def _make_synthetic_testdir(path, n_images=3):
    """The tests/test_pipeline.py synthetic set: 240x320 noise JPEGs + GT."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_images):
        img = rng.uniform(0, 255, size=(240, 320, 3)).astype(np.uint8)
        name = f"img_{i}.jpg"
        imsave(str(path / name), img)
        rows.append({"FACE_ID": i, "FILE": name, "SUBJECT_ID": i, "FACE_X": 50,
                     "FACE_Y": 60, "FACE_WIDTH": 40, "FACE_HEIGHT": 40})
    pd.DataFrame(rows).to_csv(path / "validation.csv", index=False)
    return path


def _conf(testdir, out, **kw):
    conf = FdConf(mode="test", test_path=str(testdir), output_file_path=str(out),
                  weights_path="does_not_exist.weights", **kw)
    conf.nn_arch.image_size = 64
    conf.hps.face_conf_th = 0.05  # random trunk scores hover near 0.25
    conf.hps.batch_size = 2
    return conf


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    testdir = _make_synthetic_testdir(tmp_path_factory.mktemp("set"))
    cwd = os.getcwd()
    os.chdir(tmp)  # evaluate() writes ratios.csv to the working directory
    try:
        out = {}
        jfd = JaxPipeline(_conf(testdir, tmp / "jax_eval.csv"))
        jfd.evaluate()
        jfd.conf.output_file_path = str(tmp / "jax_test.csv")
        jfd.test()
        out["jax_results"] = sorted(os.listdir(testdir / "results"))

        ckpt = str(tmp / "fd.pt")
        save_checkpoint(ckpt, params_from_jax(jfd.params, jfd.state),
                        meta={"qat": False})
        pconf = _conf(testdir, tmp / "port_eval.csv", model_loading=True,
                      model_path=ckpt)
        pfd = port_fd.FaceDetectorPipeline(pconf, device="cpu")
        pfd.evaluate()
        pfd.conf.output_file_path = str(tmp / "port_test.csv")
        pfd.test()
        out["port_results"] = sorted(os.listdir(testdir / "results"))

        # The CLI surface: --conf JSON + dotted overrides, test mode.
        with open(tmp / "conf.json", "w") as f:
            json.dump({"fd_conf": {
                "mode": "test", "test_path": str(testdir),
                "model_loading": True, "model_path": ckpt,
                "hps": {"face_conf_th": 0.05, "batch_size": 2},
                "nn_arch": {"image_size": 64},
            }}, f)
        cli = port_fd.main([f"--conf={tmp / 'conf.json'}", "--set",
                            f"fd_conf.output_file_path={tmp / 'port_cli.csv'}"],
                           device="cpu")
        assert cli.device == torch.device("cpu")
    finally:
        os.chdir(cwd)
    return dict(out, tmp=tmp, testdir=testdir, jfd=jfd, pfd=pfd, ckpt=ckpt)


def _read_csv(path):
    rows = [line.split(",") for line in open(path).read().splitlines()]
    return [(r[0], [float(v) for v in r[1:5]], np.float32(float(r[5]))) for r in rows]


@pytest.mark.parametrize("jax_csv,port_csv", [
    ("jax_test.csv", "port_test.csv"),
    ("jax_eval.csv", "port_eval.csv"),
    ("jax_test.csv", "port_cli.csv"),
])
def test_solution_csv_matches_jax(slice_run, jax_csv, port_csv):
    want = _read_csv(slice_run["tmp"] / jax_csv)
    got = _read_csv(slice_run["tmp"] / port_csv)
    assert want, "the synthetic set must produce detections at face_conf_th 0.05"
    assert [r[0] for r in got] == [r[0] for r in want]  # files, order, row counts
    for (_, gb, gs), (_, wb, ws) in zip(got, want):
        assert gb == wb
        assert abs(float(gs) - float(ws)) <= SCORE_ATOL


def test_evaluate_writes_the_same_overlays(slice_run):
    assert slice_run["port_results"] == slice_run["jax_results"]
    assert os.path.exists(slice_run["tmp"] / "ratios.csv")


def _letterboxed(testdir):
    files = sorted(str(p) for p in testdir.glob("*.jpg"))
    return np.asarray([letterbox_host(imread(f) / 255, 64, "cubic")[0]
                       for f in files], np.float32)


def test_head_matches_jax(slice_run):
    jfd, pfd = slice_run["jfd"], slice_run["pfd"]
    x = _letterboxed(slice_run["testdir"])
    want, _ = jax.jit(lambda p, s, x: jfd.model.apply(p, s, x))(
        jfd.params, jfd.state, jnp.asarray(x))
    got = pfd.model(torch.from_numpy(x))
    assert got.shape == (3, 2, 2, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=HEAD_TOL, atol=HEAD_TOL)


def test_detect_batch_fused_matches_jax_and_host(slice_run):
    jfd, pfd = slice_run["jfd"], slice_run["pfd"]
    files = sorted(str(p) for p in slice_run["testdir"].glob("*.jpg"))
    ims = [imread(f) for f in files]
    staged = np.stack(ims)  # one geometry: the broadcast branch
    geoms = [letterbox_geometry(*im.shape[:2], 64) for im in ims]
    got_c, got_n = pfd.detect_batch_fused(staged, geoms)
    want_c, want_n = jfd.detect_batch_fused(
        staged, [jax_geometry(*im.shape[:2], 64) for im in ims])
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(got_c[..., :4], want_c[..., :4])
    np.testing.assert_allclose(got_c[..., 5], want_c[..., 5], rtol=0, atol=SCORE_ATOL)
    # The host cv2 letterbox differs from the matmul form only by rounding
    # (the JAX package's own test, tests/test_resize.py, holds it so too).
    host_c, host_n = pfd.detect_batch(_letterboxed(slice_run["testdir"]))
    np.testing.assert_array_equal(host_n, got_n)
    np.testing.assert_allclose(host_c, got_c, atol=1e-3)
    # Mixed geometries take the stacked-matrix branch.
    mixed = staged.copy()
    mixed[1, 200:] = 0
    mix_geoms = [geoms[0], letterbox_geometry(200, 320, 64), geoms[2]]
    mix_c, mix_n = pfd.detect_batch_fused(mixed, mix_geoms)
    jmix_c, jmix_n = jfd.detect_batch_fused(
        mixed, [jax_geometry(g.src_h, g.src_w, 64) for g in mix_geoms])
    np.testing.assert_array_equal(mix_n, jmix_n)
    np.testing.assert_array_equal(mix_c[..., :4], jmix_c[..., :4])
    # An empty chunk returns empty results, as in the JAX package.
    empty_c, empty_n = pfd.detect_batch_fused(np.zeros((0, 8, 8, 3), np.uint8), [])
    assert empty_c.shape == (0, 60, 6) and empty_n.shape == (0,)


def test_device_letterbox_stream_matches_host_stream(slice_run):
    """The FVY_DEVICE_LETTERBOX=1 path of the CLI loop (staged uint8 chunks
    through detect_batch_fused) against the host cv2 path, as the JAX
    package's tests/test_resize.py holds its own two paths."""
    pfd = slice_run["pfd"]
    files = sorted(str(p) for p in slice_run["testdir"].glob("*.jpg"))
    host = list(pfd._iter_detections(files, 2, device_letterbox=False))
    dev = list(pfd._iter_detections(files, 2, device_letterbox=True))
    assert [r[0] for r in host] == [r[0] for r in dev] == files
    for (_, _, _, boxes_a), (_, _, _, boxes_b) in zip(host, dev):
        np.testing.assert_allclose(boxes_a, boxes_b, atol=1e-3)


def test_detect_returns_reference_rows(slice_run):
    pfd = slice_run["pfd"]
    x = _letterboxed(slice_run["testdir"])
    cands, counts = pfd.detect_batch(x[:1])
    rows = pfd.detect(x[0])
    assert len(rows) == int(counts[0])
    for r, c in zip(rows, cands[0]):
        assert (r["xmin"], r["ymax"], r["score"]) == (c[0], c[3], c[5])


def test_correct_aspect_ratio_matches_jax(slice_run):
    """The docker variant's aspect correction (apply_face_region_ratio)."""
    rng = np.random.default_rng(8)
    mins = rng.uniform(0, 200, (40, 2))
    boxes = np.concatenate([mins, mins + rng.uniform(-5, 120, (40, 2)),
                            rng.uniform(size=(40, 1))], 1)
    np.testing.assert_array_equal(
        slice_run["pfd"]._correct_aspect_ratio(boxes[:, :4]),
        slice_run["jfd"]._correct_aspect_ratio(boxes[:, :4]))


def test_checkpoint_sidecar_and_refusals(slice_run, tmp_path):
    ckpt = slice_run["ckpt"]
    assert load_train_meta(ckpt) == {"qat": False}
    assert update_train_meta(ckpt, int8_tail=3) == {"qat": False, "int8_tail": 3}
    assert load_train_meta(ckpt)["int8_tail"] == 3
    assert load_train_meta(str(tmp_path / "none.pt")) == {}
    sd = load_checkpoint(ckpt)
    assert sd["conv_0.weight"].shape == (32, 3, 3, 3)
    # Orbax directories (and any other non-.pt, non-h5 path) are refused,
    # naming the converter; Keras h5 loads (tests/test_torch_keras_h5.py).
    for bad in (str(tmp_path / "orbax_dir"), "weights.npz"):
        with pytest.raises(ValueError, match="orbax_to_pt"):
            load_checkpoint(bad)


def test_unported_precisions_and_modes_raise(tmp_path):
    """An unknown precision raises naming ROADMAP; `--mode` now reaches the
    legacy CLI (tests/test_torch_legacy_cli.py), which, like the JAX
    package's, refuses a flag set without the numeric flags."""
    conf = _conf(tmp_path, tmp_path / "x.csv")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_fd.FaceDetectorPipeline(conf, precision="float16", device="cpu")
    with pytest.raises(TypeError):
        port_fd.main(["--mode=test"], device="cpu")


def test_prefetch_keeps_order_and_moves_tensors():
    batches = list(prefetch_batches(
        lambda i: ("b", torch.full((2,), float(i)), [i]), 5, device="cpu"))
    assert [b[2] for b in batches] == [[i] for i in range(5)]
    assert all(b[1].device.type == "cpu" and b[1][0] == i
               for i, b in enumerate(batches))


def test_prefetch_reraises_worker_errors():
    def make(i):
        if i == 2:
            raise OSError("corrupt image")
        return (i,)

    seen = []
    with pytest.raises(OSError, match="corrupt"):
        for b in prefetch_batches(make, 5):
            seen.append(b)
    assert seen == [(0,), (1,)]
