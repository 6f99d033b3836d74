"""The port's subject-face DB (data/facedb.py) and synthetic identity tree
(data/synthetic.make_fi_tree) vs the JAX package and its tooling.

Both packages write the same files from the same inputs: the subject crops
and their CSV (UCCS and VGGFace2 arms), the triplet pairs (the JAX class
seeded through the global `random` and a numpy Generator, the port's
through the same two seeds passed explicitly), the facial-id h5 and the
registry pickle; and each package reads what the other wrote. Everything
here is host numpy: equal means bit-equal.
"""

import os
import pickle
import random
import sys
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest

from face_vijnana_yolov3_tpu.data import facedb as jax_facedb
from face_vijnana_yolov3_tpu_torch.data import facedb, synthetic
from face_vijnana_yolov3_tpu_torch.utils.io import imread, imsave
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import synthetic_fi_e2e  # noqa: E402  (the JAX package's synthetic identity tree)

S = 64


def _tree(root, n_subjects=3):
    """A small synthetic identity tree at 96² with faces of side 30-59."""
    return synthetic.make_fi_tree(str(root), n_subjects, seed=0, image_size=96,
                                  face_sizes=(30, 60), train_per_subj=3,
                                  hold_per_subj=1)


def test_identity_tree_matches_the_jax_tooling(tmp_path):
    """At the script's defaults (416², faces 90-199, 6 + 3 per subject) the
    port's copy writes the same JPEGs and CSV and holds out the same faces,
    cropped alike."""
    hold = synthetic.make_fi_tree(str(tmp_path / "port"), 1, seed=3)
    want_hold = synthetic_fi_e2e.make_tree(str(tmp_path / "jax"), 1, seed=3)
    for sub in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / sub / "training"))[0] == "s1_0.jpg"
    names = sorted(os.listdir(tmp_path / "jax" / "training"))
    assert names == sorted(os.listdir(tmp_path / "port" / "training"))
    for name in names:
        assert (tmp_path / "port" / "training" / name).read_bytes() == \
            (tmp_path / "jax" / "training" / name).read_bytes(), name
    assert len(hold) == len(want_hold) == synthetic.FI_HOLD_PER_SUBJ
    for (sid, img, box), (wsid, wimg, wbox) in zip(hold, want_hold):
        assert (sid, box) == (wsid, wbox)
        np.testing.assert_array_equal(img, wimg)
    crops, sids = synthetic.holdout_crops(hold)
    wcrops, wsids = synthetic_fi_e2e.holdout_crops(want_hold)
    np.testing.assert_array_equal(crops, wcrops)
    np.testing.assert_array_equal(sids, wsids)


@pytest.fixture
def uccs(tmp_path, monkeypatch):
    _tree(tmp_path)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_create_subject_db_uccs_matches_jax(uccs):
    want = jax_facedb.create_subject_db_uccs(str(uccs), image_size=S)
    os.rename("subject_image_db.csv", "jax_db.csv")
    os.rename(uccs / "subject_faces", uccs / "jax_faces")
    got = facedb.create_subject_db_uccs(str(uccs), image_size=S)
    pd.testing.assert_frame_equal(got, want)
    assert Path("subject_image_db.csv").read_text() == Path("jax_db.csv").read_text()
    files = sorted(os.listdir(uccs / "subject_faces"))
    assert files == sorted(os.listdir(uccs / "jax_faces")) and len(files) == 9
    for f in files:
        assert (uccs / "subject_faces" / f).read_bytes() == (uccs / "jax_faces" / f).read_bytes()
    assert imread(str(uccs / "subject_faces" / files[0])).shape == (S, S, 3)


def test_create_subject_db_vggface2_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    rows = []
    for ident in ("n000001", "n000002"):
        d = tmp_path / "train" / ident
        d.mkdir(parents=True)
        for k in range(2):
            imsave(str(d / f"{k:04d}.jpg"), rng.uniform(0, 255, (100, 90, 3)).astype(np.uint8))
            rows.append({"NAME_ID": f"{ident}/{k:04d}", "X": 10 + k, "Y": 12,
                         "W": 40, "H": 50 - k})
    rows.append({"NAME_ID": "n000001/0000", "X": -3, "Y": 1, "W": 5, "H": 5})  # skipped
    pd.DataFrame(rows).to_csv(tmp_path / "loose_bb_train.csv", index=False)
    monkeypatch.chdir(tmp_path)
    want = jax_facedb.create_subject_db_vggface2(str(tmp_path), image_size=S, workers=2)
    os.rename(tmp_path / "subject_faces_vggface2", tmp_path / "jax_faces")
    got = facedb.create_subject_db_vggface2(str(tmp_path), image_size=S, workers=2)
    pd.testing.assert_frame_equal(got, want)
    assert got.shape[0] == 4
    for f in os.listdir(tmp_path / "jax_faces"):
        assert (tmp_path / "subject_faces_vggface2" / f).read_bytes() == \
            (tmp_path / "jax_faces" / f).read_bytes()


def test_triplet_dataset_matches_jax_under_shared_seeds(uccs):
    facedb.create_subject_db_uccs(str(uccs), image_size=S)
    random.seed(5)
    want = jax_facedb.TripletDataset(str(uccs), rng=np.random.default_rng(1),
                                     pairs_pickle="jax_pairs.pickle")
    got = facedb.TripletDataset(str(uccs), rng=np.random.default_rng(1),
                                shuffle_rng=random.Random(5))
    assert got.img_triplet_pairs == want.img_triplet_pairs
    assert len(got) == 9  # 3 subjects x C(3, 2) pairs
    for bs in (4, 9):
        assert got.steps(bs) == want.steps(bs)
        for i in range(got.steps(bs)):
            for g, w in zip(got.batch(i, bs), want.batch(i, bs)):
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, w)
            for g, w in zip(got.batch_subject_codes(i, bs), want.batch_subject_codes(i, bs)):
                np.testing.assert_array_equal(g, w)
    # Each package loads the other's pickle (load_flag).
    reloaded = jax_facedb.TripletDataset(str(uccs), load_flag=True)
    assert reloaded.img_triplet_pairs == got.img_triplet_pairs
    back = facedb.TripletDataset(str(uccs), load_flag=True, pairs_pickle="jax_pairs.pickle")
    assert back.img_triplet_pairs == want.img_triplet_pairs
    # Another shuffle seed, another order.
    other = facedb.TripletDataset(str(uccs), rng=np.random.default_rng(1),
                                  shuffle_rng=random.Random(6))
    assert sorted(other.img_triplet_pairs) == sorted(got.img_triplet_pairs)
    assert other.img_triplet_pairs != got.img_triplet_pairs


def _embed_fn(images):
    """A deterministic stand-in for the embedder: per-channel means."""
    return np.asarray(images, np.float32).mean(axis=(1, 2))


def test_facial_ids_db_and_registry_match_jax(uccs):
    facedb.create_subject_db_uccs(str(uccs), image_size=S)
    jax_facedb.make_facial_ids_db(_embed_fn, str(uccs), out_h5="jax_ids.h5", batch_size=2)
    facedb.make_facial_ids_db(_embed_fn, str(uccs), batch_size=2)
    with h5py.File("subject_facial_ids.h5", "r") as f, h5py.File("jax_ids.h5", "r") as g:
        assert sorted(f) == sorted(g) and len(f) == 9
        for k in f:
            np.testing.assert_array_equal(f[k][()], g[k][()])
            assert f[k].attrs["subject_id"] == g[k].attrs["subject_id"]
    want = jax_facedb.register_facial_ids(_embed_fn, str(uccs), out_pickle="jax_reg.pickle")
    got = facedb.register_facial_ids(_embed_fn, str(uccs))
    assert list(got) == list(want) == [1, 2, 3]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with open("ref_facial_id_db.pickle", "rb") as f:
        loaded = pickle.load(f)
    assert all(type(v) is np.ndarray for v in loaded.values())  # never a tensor
    assert Path("ref_facial_id_db.pickle").read_bytes() == Path("jax_reg.pickle").read_bytes()
