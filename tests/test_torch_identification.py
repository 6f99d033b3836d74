"""The port's face identification (api/face_identification.py, the FI modes of
api/evaluate.py, evals/identification.py) vs the JAX package's, on the CPU.

A synthetic identity tree (96² images, 3 subjects x 3 faces, the subject
DB at 64²) feeds a JAX FaceIdentifierPipeline (random weights, dense1_dim
8) and the port's with the same numpy weights in the identifier and the
nested detector. Rules, each measured here (in brackets):
- `solution_fi.csv`: the same files, rows, subject ids and boxes; scores
  within the detector's rule of tests/test_torch_face_detection.py (5e-5
  abs: two sigmoids of the head, whose convs sum in another order)
  [8.9e-8]; on the host-crop path and the device_roi path, on handcrafted
  boxes (with degenerate, wrapped and more than 60 boxes) and end to end;
- row choices sit far from the sim_th gate: the embeddings agree to 1e-5
  (tests/test_torch_identifier.py), the gates below are set between
  distances at least 1e-3 apart;
- bf16 and int8 pipeline embeds against the JAX pipeline's: 3e-2 abs on
  unit vectors [bf16 4.2e-3; int8 6.1e-3 with each package calibrating
  itself on the same 16 images];
- the FI metrics: equal (host numpy on the same files).
"""

import json
import os

import h5py
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from face_vijnana_yolov3_tpu.api import evaluate as jax_evaluate
from face_vijnana_yolov3_tpu.api.config import Conf as JaxConf
from face_vijnana_yolov3_tpu.api.face_identification import (
    FaceIdentifierPipeline as JaxPipeline,
)
from face_vijnana_yolov3_tpu.data import facedb as jax_facedb
from face_vijnana_yolov3_tpu.evals import identification as jax_ident
from face_vijnana_yolov3_tpu_torch.api import evaluate
from face_vijnana_yolov3_tpu_torch.api import face_identification as port_fi
from face_vijnana_yolov3_tpu_torch.api.config import Conf
from face_vijnana_yolov3_tpu_torch.convert import identifier_params_from_jax, params_from_jax
from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
from face_vijnana_yolov3_tpu_torch.data import synthetic
from face_vijnana_yolov3_tpu_torch.evals import identification
from face_vijnana_yolov3_tpu_torch.utils.io import imread
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)
port_fi.DEBUG = False

S, D = 64, 8
SCORE_ATOL = 5e-5
EMBED_TOL = 3e-2


def _conf(cls, root, out, **fi):
    conf = cls()
    c = conf.fi_conf
    c.raw_data_path = str(root)
    c.test_path = str(root / "training")
    c.output_file_path = str(root / out)
    c.weights_path = "missing.weights"
    c.nn_arch.image_size = S
    c.nn_arch.dense1_dim = D
    c.hps.sim_th = 10.0  # accept every match (random embeddings)
    for k, v in fi.items():
        setattr(c, k, v)
    conf.fd_conf.weights_path = "missing.weights"
    conf.fd_conf.nn_arch.image_size = S
    conf.fd_conf.hps.face_conf_th = 0.05
    conf.fd_conf.hps.batch_size = 4
    return conf


def _share(jfi, pfi):
    """Give the port pipeline the JAX pipeline's identifier and detector."""
    pfi.model.load_state_dict(identifier_params_from_jax(*jax.device_get(
        (jfi.params, jfi.state))))
    pfi.fd.model.load_state_dict(params_from_jax(*jax.device_get(
        (jfi.fd.params, jfi.fd.state))))
    return pfi


@pytest.fixture(scope="module")
def fi(tmp_path_factory):
    root = tmp_path_factory.mktemp("fi")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        synthetic.make_fi_tree(str(root), 3, seed=0, image_size=96, face_sizes=(30, 60),
                               train_per_subj=3, hold_per_subj=1)
        jax_facedb.create_subject_db_uccs(str(root), image_size=S)
        pd.read_csv(root / "training" / "training.csv").to_csv(
            root / "training" / "validation.csv", index=False)
        jfi = JaxPipeline(_conf(JaxConf, root, "jax_test.csv"))
        pfi = _share(jfi, port_fi.FaceIdentifierPipeline(
            _conf(Conf, root, "port_test.csv"), device="cpu"))
        jfi.register_facial_ids()
        jfi.test()
        pfi.test()
        jfi.conf.output_file_path = str(root / "jax_eval.csv")
        jfi.evaluate()
        jax_overlays = sorted(os.listdir(root / "training" / "results_fi"))
        pfi.conf.output_file_path = str(root / "port_eval.csv")
        pfi.evaluate()
        port_overlays = sorted(os.listdir(root / "training" / "results_fi"))
    finally:
        os.chdir(cwd)
    return dict(root=root, jfi=jfi, pfi=pfi, overlays=(jax_overlays, port_overlays))


def _rows(path):
    out = []
    for line in open(path).read().splitlines():
        f = line.split(",")
        out.append((f[0], f[1], [float(v) for v in f[2:6]], float(f[6])))
    return out


def _same_csv(got_path, want_path):
    got, want = _rows(got_path), _rows(want_path)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for g, w in zip(got, want):
        assert abs(g[3] - w[3]) <= SCORE_ATOL
    return want


@pytest.mark.parametrize("name", ["test", "eval"])
def test_solution_csv_matches_jax_end_to_end(fi, name):
    want = _same_csv(fi["root"] / f"port_{name}.csv", fi["root"] / f"jax_{name}.csv")
    assert want, "the random detector must give some non-degenerate boxes here"


def test_evaluate_writes_the_same_overlays(fi):
    jax_overlays, port_overlays = fi["overlays"]
    assert port_overlays == jax_overlays and port_overlays


def test_device_roi_csv_matches_jax_and_the_host_path(fi, monkeypatch):
    """device_roi=True (FVY_DEVICE_ROI=1 in the JAX run, the config flag in
    the port's): the same rows as the JAX device path and as the port's
    host path, with and without the detector's device letterbox (whose
    staged upload the crops then reuse)."""
    root, jfi, pfi = fi["root"], fi["jfi"], fi["pfi"]
    monkeypatch.chdir(root)
    monkeypatch.setenv("FVY_DEVICE_ROI", "1")
    jfi.conf.output_file_path = str(root / "jax_roi.csv")
    jfi.test()
    monkeypatch.delenv("FVY_DEVICE_ROI")
    for letterbox in ("0", "1"):
        monkeypatch.setenv("FVY_DEVICE_LETTERBOX", letterbox)
        pfi.conf.device_roi = True
        pfi.conf.output_file_path = str(root / f"port_roi_{letterbox}.csv")
        try:
            pfi.test()
        finally:
            pfi.conf.device_roi = False
        _same_csv(root / f"port_roi_{letterbox}.csv", root / "jax_roi.csv")
        _same_csv(root / f"port_roi_{letterbox}.csv", root / "port_test.csv")


def _handcrafted(seed=3, n=80):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, size=(150, 200, 3)).astype(np.uint8)
    x0 = rng.uniform(0, 150, n)
    y0 = rng.uniform(0, 100, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(8, 50, n), y0 + rng.uniform(8, 50, n),
                      rng.uniform(0, 1, n)], axis=1)
    boxes[:4, :4] = [[0, 0, 0, 0], [0, 30, 40, 60], [10, 0, 40, 30], [40, 30, 40, 90]]
    return image, boxes


def _registry(pfi, image, boxes, k=3):
    crops = []
    for b in boxes[4:4 + k]:
        l, t, r, bb = (int(v) for v in b[:4])
        from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host

        crops.append(letterbox_host(image[(t - 1):(bb - 1), (l - 1):(r - 1)] / 255, S,
                                    "cubic")[0])
    return ["ann", "bob", "cid"], pfi.embed(np.asarray(crops, np.float32))


def _gate(pfi, image, boxes, reg, frac=1 / 3):
    """A sim_th between two observed match distances at least 1e-3 apart,
    past the `frac` quantile of them, so that some boxes go unmatched."""
    keep, crops = [], []
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_host

    for k, b in enumerate(boxes):
        l, t, r, bb = (int(v) for v in b[:4])
        c = image[(t - 1):(bb - 1), (l - 1):(r - 1)]
        if c.size:
            crops.append(letterbox_host(c / 255, S, "cubic")[0])
    e = pfi.embed(np.asarray(crops, np.float32))
    d = np.sort(np.linalg.norm(e[:, None] - reg[None], axis=-1).min(1))
    gaps = np.diff(d)
    start = int(len(d) * frac)
    j = start + int(np.argmax(gaps[start:] >= 1e-3))
    assert gaps[j] >= 1e-3 and j < len(d) - 1
    return float(d[j] + d[j + 1]) / 2


def test_identify_handcrafted_boxes_match_jax(fi):
    """`_identify_image` (host crops) and `_identify_chunk_device` (device
    crops, uint8 and float originals) on 40 handcrafted boxes, including a
    zero box, corners at 0 (the slice wraps), a zero-width box and a gate
    that leaves some boxes unmatched: the same rows as the JAX package."""
    jfi, pfi = fi["jfi"], fi["pfi"]
    image, boxes = _handcrafted(n=40)
    ids, reg = _registry(pfi, image, boxes)
    th = _gate(pfi, image, boxes, reg)
    for p in (jfi, pfi):
        p.hps["sim_th"] = th
    try:
        want = jfi._identify_image(image, boxes, ids, reg)
        got = pfi._identify_image(image, boxes, ids, reg)
        assert 10 < len(want) < 36
        key = [(r["box_index"], r["subject_id"]) for r in want]
        assert [(r["box_index"], r["subject_id"]) for r in got] == key
        assert all(g["xmin"] == w["xmin"] and g["score"] == w["score"]
                   for g, w in zip(got, want))
        reg_dev = torch.from_numpy(reg)
        dev = pfi._identify_chunk_device([image, image.astype(np.float64)],
                                         [boxes, boxes[::-1].copy()], ids, reg_dev)
        jdev = jfi._identify_chunk_device([image, image.astype(np.float64)],
                                          [boxes, boxes[::-1].copy()], ids,
                                          jax.numpy.asarray(reg))
        for g, w in zip(dev, jdev):
            assert [(r["box_index"], r["subject_id"]) for r in g] == \
                [(r["box_index"], r["subject_id"]) for r in w]
        assert [(r["box_index"], r["subject_id"]) for r in dev[0]] == key
        single = pfi._identify_image_device(image, boxes, ids, reg_dev)
        assert [(r["box_index"], r["subject_id"]) for r in single] == key
    finally:
        for p in (jfi, pfi):
            p.hps["sim_th"] = 10.0


@pytest.mark.parametrize("device_roi", [False, True])
def test_written_rows_cap_at_60_like_jax(fi, monkeypatch, device_roi):
    """test() on one image with 80 handcrafted boxes, some unmatched: at
    most 60 rows written, unmatched boxes not counted, as the JAX package
    (both packages' detectors replaced by the same boxes)."""
    root, jfi, pfi = fi["root"], fi["jfi"], fi["pfi"]
    monkeypatch.chdir(root)
    image, boxes = _handcrafted(seed=4, n=90)
    ids, reg = _registry(pfi, image, boxes)
    with open("ref_facial_id_db.pickle", "rb") as f:
        saved = f.read()
    import pickle

    with open("ref_facial_id_db.pickle", "wb") as f:
        pickle.dump(dict(zip(ids, reg)), f)
    th = _gate(pfi, image, boxes, reg, frac=0.8)
    fn = str(root / "training" / "s1_0.jpg")

    def chunks(self, *a, **k):
        yield [fn], [image], [None], [boxes], None

    def per_image(self, *a, **k):
        yield fn, image, None, boxes

    try:
        for p, out in ((jfi, "jax_cap.csv"), (pfi, "port_cap.csv")):
            monkeypatch.setattr(type(p.fd), "_iter_detection_chunks", chunks)
            monkeypatch.setattr(type(p.fd), "_iter_detections", per_image)
            monkeypatch.setattr(p, "hps", dict(p.hps, sim_th=th))
            p.conf.output_file_path = str(root / out)
            if device_roi:
                monkeypatch.setenv("FVY_DEVICE_ROI", "1")
            p.test()
            monkeypatch.delenv("FVY_DEVICE_ROI", raising=False)
        want = _same_csv(root / "port_cap.csv", root / "jax_cap.csv")
        # More than 60 boxes match and some do not: the cap, not the gate,
        # ends the rows.
        matched = pfi._identify_image(image, boxes, ids, reg) if not device_roi else \
            pfi._identify_chunk_device([image], [boxes], ids, torch.from_numpy(reg))[0]
        assert len(want) == 60 < len(matched) < len(boxes) - 4
    finally:
        with open("ref_facial_id_db.pickle", "wb") as f:
            f.write(saved)


@pytest.mark.parametrize("precision", ["bfloat16", "int8"])
def test_reduced_precision_embeds_match_jax(fi, precision):
    """The pipelines' bf16 embed (folded, f32 front guard 2) and int8 embed
    (each package calibrating on the first 16 images of its first embed)
    against the JAX pipeline's."""
    root, jfi = fi["root"], fi["jfi"]
    jp = JaxPipeline(_conf(JaxConf, root, "x.csv"), precision=precision)
    jp.params, jp.state = jfi.params, jfi.state
    pp = port_fi.FaceIdentifierPipeline(_conf(Conf, root, "x.csv"), precision=precision,
                                        device="cpu")
    pp.model.load_state_dict(fi["pfi"].model.state_dict())
    x = np.random.default_rng(8).uniform(0, 1, (17, S, S, 3)).astype(np.float32)
    got, want = pp.embed(x), jp.embed(x)
    assert got.shape == (17, D)
    assert float(np.abs(got - want).max()) <= EMBED_TOL
    if precision == "int8":
        assert pp._q_embed is not None and "dense1" in pp._q_embed


def test_embed_chunks_and_pads_without_changing_rows(fi):
    """Embeds run in pieces of the bucket sizes (64s, then the binary
    digits of the rest), where the JAX package pads to a power-of-two
    bucket; a row's embedding does not depend on the others in its call,
    on the piece it falls in or on the JAX padding."""
    pfi, jfi = fi["pfi"], fi["jfi"]
    x = np.random.default_rng(9).uniform(0, 1, (66, S, S, 3)).astype(np.float32)
    full = pfi.embed(x)
    assert full.shape == (66, D)
    np.testing.assert_allclose(full[:3], pfi.embed(x[:3]), atol=1e-6)
    np.testing.assert_allclose(full[64:], pfi.embed(x[64:]), atol=1e-6)
    np.testing.assert_allclose(full[:5], jfi.embed(x[:5]), atol=1e-5)
    assert pfi.embed(x[:0]).shape == (0, D)


def test_cli_modes_on_the_cpu(fi, tmp_path, monkeypatch):
    """`main` with --conf JSON: data, fid_db, test (the same CSV as the JAX
    pipeline with the same weights, from .pt checkpoints), evaluate and
    train (+ fid_db + registry), all with device='cpu'."""
    root, jfi = fi["root"], fi["jfi"]
    monkeypatch.chdir(tmp_path)
    fi_pt, fd_pt = str(tmp_path / "fi.pt"), str(tmp_path / "fd.pt")
    save_checkpoint(fi_pt, fi["pfi"].model.state_dict())
    save_checkpoint(fd_pt, fi["pfi"].fd.model.state_dict())
    (tmp_path / "training").symlink_to(root / "training")
    base = {
        "fi_conf": {"raw_data_path": str(tmp_path), "test_path": str(tmp_path / "training"),
                    "output_file_path": str(tmp_path / "cli.csv"), "model_loading": True,
                    "model_path": fi_pt, "nn_arch": {"image_size": S, "dense1_dim": D},
                    "hps": {"sim_th": 10.0, "batch_size": 2, "epochs": 1}},
        "fd_conf": {"model_loading": True, "model_path": fd_pt,
                    "nn_arch": {"image_size": S},
                    "hps": {"face_conf_th": 0.05, "batch_size": 4}},
    }
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(base))

    def run(mode, *extra):
        return port_fi.main([f"--conf={conf}", f"fi_conf.mode={mode}", *extra],
                            device="cpu")

    assert run("data") is None
    assert (tmp_path / "subject_image_db.csv").read_text() == \
        (root / "subject_image_db.csv").read_text()
    p = run("fid_db")
    assert p.device == torch.device("cpu")
    with h5py.File("subject_facial_ids.h5", "r") as f:
        assert len(f) == 9 and f[sorted(f)[0]][()].shape == (D,)
    p.register_facial_ids()
    run("test")
    _same_csv(tmp_path / "cli.csv", root / "jax_test.csv")
    run("evaluate", f"fi_conf.output_file_path={tmp_path / 'cli_eval.csv'}")
    _same_csv(tmp_path / "cli_eval.csv", root / "jax_eval.csv")
    trained = run("train", "fi_conf.model_loading=false",
                  f"fi_conf.model_path={tmp_path / 'trained.pt'}")
    assert (tmp_path / "trained.pt").exists()
    assert (tmp_path / "trained.pt_history.jsonl").read_text().count("\n") == 5
    with open("ref_facial_id_db.pickle", "rb") as f:
        import pickle

        reg = pickle.load(f)
    np.testing.assert_allclose(reg[1], trained.embed(
        np.asarray([imread(str(tmp_path / "subject_faces" / ff)) / 255 for ff in
                    pd.read_csv("subject_image_db.csv").query("subject_id == 1")
                    ["face_file"]], np.float32)).mean(0), atol=1e-6)


def test_refused_options_cite_the_roadmap(fi, tmp_path, monkeypatch):
    """Options once refused now build: the int8 front guard
    (bf16_front_mode="int8", held to the JAX package in
    tests/test_torch_hybrid_front.py); the reconstruction decoder
    now runs (its parity with the JAX
    package is tests/test_torch_recon.py); model_axis > 1, refused until
    dense1 tensor parallelism was ported, builds, and its mesh asks for
    model_axis ranks as JAX's make_mesh asks for devices (the 2-rank run is
    tests/test_torch_multiprocess.py)."""
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib

    root = fi["root"]
    hybrid = port_fi.FaceIdentifierPipeline(
        _conf(Conf, root, "x.csv", bf16_front_mode="int8"), precision="bfloat16",
        device="cpu")
    assert hybrid._hybrid_front and hybrid._q_embed is None
    tp = port_fi.FaceIdentifierPipeline(_conf(Conf, root, "x.csv", model_axis=2),
                                        device="cpu")
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        mesh_lib.default_mesh(int(tp.conf.model_axis))
    monkeypatch.chdir(tmp_path)  # the decoder's checkpoint lands here
    assert fi["pfi"].reconstruct(np.full((1, D), 0.5, np.float32)).shape == (1, S, S, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_fi.FaceIdentifierPipeline(_conf(Conf, root, "x.csv"))


def test_detect_returns_and_yields_the_staged_upload(fi, monkeypatch):
    """detect_batch_fused(return_staged=True) returns the staging tensor it
    read, bucketed to 128-multiples as the JAX package's; _iter_detection_
    chunks(yield_staged=True) yields it, padded to the batch size, on the
    device letterbox path and None on the host-letterbox path (JAX
    api/face_detection.py:543-866)."""
    fd = fi["pfi"].fd
    files = sorted(str(p) for p in (fi["root"] / "training").glob("*.jpg"))[:3]
    ims = [imread(f) for f in files]
    staged = np.stack(ims)
    from face_vijnana_yolov3_tpu.ops.letterbox import letterbox_geometry as jax_geometry
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry

    geoms = [letterbox_geometry(96, 96, S)] * 3
    c, n, st = fd.detect_batch_fused(staged, geoms, return_staged=True)
    c2, n2 = fd.detect_batch_fused(staged, geoms)
    *_, jst = fi["jfi"].fd.detect_batch_fused(staged, [jax_geometry(96, 96, S)] * 3,
                                             return_staged=True)
    assert st.dtype == torch.uint8 and st.shape == (3, 128, 128, 3)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(c, c2)
    monkeypatch.setenv("FVY_DEVICE_LETTERBOX", "1")
    monkeypatch.setattr("face_vijnana_yolov3_tpu_torch.data.native_loader.native_available",
                        lambda: False)
    (*_, st_dev), = fd._iter_detection_chunks(files, 4, yield_staged=True)
    assert st_dev.shape == (4, 128, 128, 3)
    assert torch.equal(st_dev[:3, :96, :96], torch.from_numpy(staged))
    assert int(st_dev.sum()) == int(staged.astype(np.int64).sum())  # the pad is zeros
    (*_, none), = fd._iter_detection_chunks(files, 4)
    assert none is None
    monkeypatch.setenv("FVY_DEVICE_LETTERBOX", "0")
    (*_, host), = fd._iter_detection_chunks(files, 4, yield_staged=True)
    assert host is None
    rows = list(fd._iter_detections(files, 2, device_letterbox=True, yield_staged=True))
    assert len(rows) == 3 and all(torch.equal(r[4][:96, :96], torch.from_numpy(im))
                                  for r, im in zip(rows, ims))


# ------------------------------------------------------------------ FI metrics

def test_fi_metric_functions_match_jax(fi, monkeypatch):
    root = fi["root"]
    monkeypatch.chdir(root)
    fi["pfi"].make_facial_ids_db()
    got = identification.cal_face_pairs_dists(out_h5=None, rng=np.random.default_rng(2))
    want = jax_ident.cal_face_pairs_dists(out_h5=None, rng=np.random.default_rng(2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].size == 9 and got[1].size == 9
    ths = np.arange(0.1, 1.1, 0.1)
    for g, w in zip(identification.cal_VAL_FAR(ths, out_h5=None, rng=np.random.default_rng(2)),
                    jax_ident.cal_VAL_FAR(ths, out_h5=None, rng=np.random.default_rng(2))):
        np.testing.assert_array_equal(g, w)
    gt = str(root / "training" / "validation.csv")
    for th in (0.5, 0.75):
        assert identification.cal_acc_fi(gt, str(root / "port_eval.csv"), th) == \
            jax_ident.cal_acc_fi(gt, str(root / "jax_eval.csv"), th)
    assert identification.acc_sweep(gt, str(root / "port_eval.csv"), out_h5=None) == \
        jax_ident.acc_sweep(gt, str(root / "jax_eval.csv"), out_h5=None)


def test_evaluate_cli_fi_modes_match_jax(tmp_path, monkeypatch):
    """The three FI modes of the evaluate CLI write the same h5 files as the
    JAX CLI. Two subjects, so the CLI's unseeded choice of different-subject
    pairs can only reorder the distances (compared sorted)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    rows = [{"subject_id": s, "face_file": f"f{s}_{k}.jpg", "w": 9, "h": 9}
            for s in (1, 2) for k in range(3)]
    pd.DataFrame(rows).to_csv("subject_image_db.csv")
    with h5py.File("subject_facial_ids.h5", "w") as f:
        for r in rows:
            f[r["face_file"]] = rng.normal(size=8).astype(np.float32)
    gt = pd.DataFrame([{"FACE_ID": i, "FILE": "a.jpg", "SUBJECT_ID": s, "FACE_X": 10 * i,
                        "FACE_Y": 5, "FACE_WIDTH": 8, "FACE_HEIGHT": 8}
                       for i, s in enumerate((1, 2, -1))])
    gt.to_csv("gt.csv", index=False)
    with open("sol.csv", "w") as f:
        f.write("a.jpg,1,0.5,5,8,8,0.9\na.jpg,1,10,5,8,8,0.8\nb.jpg,2,0,0,4,4,0.7\n")
    for mode, out in (("cal_face_pairs_dists", "face_pairs_dists.h5"),
                      ("cal_VAL_FAR", "val_far.h5"), ("cal_acc_fi", "fi_acc.h5")):
        jax_evaluate.main(["-m", mode, "-g", "gt.csv", "-s", "sol.csv"])
        os.rename(out, "jax_" + out)
        evaluate.main(["-m", mode, "-g", "gt.csv", "-s", "sol.csv"])
        with h5py.File(out, "r") as f, h5py.File("jax_" + out, "r") as g:
            assert set(f) == set(g)
            for k in f:
                np.testing.assert_array_equal(np.sort(f[k][()]), np.sort(g[k][()]))


def test_yolov3_base_cache_loads_in_both_packages(fi, tmp_path, monkeypatch):
    """yolov3_base_model_load: the cached trunk `yolov3_base.h5` (written by
    the port here) gives the identifier its trunk in the port and in the
    JAX package, with a fresh dense1 (the port's from init_dense1's seed 2)."""
    from face_vijnana_yolov3_tpu_torch.core.keras_import import save_trunk_keras_h5
    from face_vijnana_yolov3_tpu_torch.models.identifier import init_dense1

    monkeypatch.chdir(tmp_path)
    sd = fi["pfi"].model.state_dict()
    save_trunk_keras_h5(sd, "yolov3_base.h5")
    p = port_fi.FaceIdentifierPipeline(
        _conf(Conf, fi["root"], "x.csv", yolov3_base_model_load=True), device="cpu")
    got = p.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items() if not k.startswith("dense1"))
    want_dense = init_dense1(2, p.model.flat_dim, D)["kernel"]
    np.testing.assert_array_equal(got["dense1.weight"].numpy(), want_dense.T)
    j = JaxPipeline(_conf(JaxConf, fi["root"], "x.csv", yolov3_base_model_load=True))
    np.testing.assert_array_equal(np.asarray(j.params["conv_5"]["kernel"]),
                                  sd["conv_5.weight"].permute(2, 3, 1, 0).numpy())


def test_fi_metrics_module_is_a_copy():
    """evals/identification.py after its docstring is the JAX module's,
    but for the package it imports the IoU helper from and for
    cal_face_pairs_dists (with its imports), which also reads the
    embeddings from a mapping in memory; its results over the ids h5 are
    held to the original's by test_fi_metric_functions_match_jax."""
    import ast
    from pathlib import Path

    def kept(node):
        if getattr(node, "name", None) == "cal_face_pairs_dists":
            return False
        return not (isinstance(node, ast.Import)
                    and [a.name for a in node.names] in (["contextlib"], ["os"]))

    def body(module, package):
        tree = ast.parse(Path(module.__file__).read_text())
        tree.body = [n for n in tree.body[1:] if kept(n)]
        return ast.unparse(tree).replace(package, "PACKAGE")

    assert body(identification, "face_vijnana_yolov3_tpu_torch") == \
        body(jax_ident, "face_vijnana_yolov3_tpu")
