"""Serialized serving artifacts of the port (core/export.py, api/export_cli.py).

The deploy contract, as tests/test_export.py states it for the JAX
package: an artifact loaded with nothing but `load_artifact` reproduces the
live pipeline's serving outputs bit for bit on the same device, across
batch sizes (the batch is symbolic), and carries a self-describing header;
the loader rejects what is not an artifact or is newer than it. Here also:
an artifact of the port and one of the JAX package, exported from the
same weights (the port's taken from the JAX pipelines through
`convert.params_from_jax` / `qparams_from_jax` /
`identifier_params_from_jax`) and loaded through each package's own
`load_artifact`, agree within the parity bounds of
tests/test_torch_face_detection.py (f32: the same counts and boxes, scores
and objness within 5e-5), tests/test_torch_int8_pipeline.py (int8: the
trunk is bit-exact, the bf16 head conv rounds differently, so boxes within
one letterbox pixel and scores within 1e-2) and
tests/test_torch_identifier.py (embeddings within 1e-5, the same best_idx,
distances within 1e-5). 64² inputs, the whole detector and identifier.
"""

import json
import os
import struct
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu_torch.api.config import Conf, conf_to_dict
from face_vijnana_yolov3_tpu_torch.api.face_detection import FaceDetectorPipeline
from face_vijnana_yolov3_tpu_torch.api.face_identification import FaceIdentifierPipeline
from face_vijnana_yolov3_tpu_torch.core.export import (
    export_detector,
    export_embedder,
    load_artifact,
)
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
S, D = 64, 8


@pytest.fixture
def tmp_path():
    """A directory deleted after each test (in place of pytest's, which
    keeps the last runs' directories): an artifact is 40-200 MB."""
    with tempfile.TemporaryDirectory() as d:
        yield Path(d)


def _conf():
    conf = Conf()
    for c in (conf.fd_conf, conf.fi_conf):
        c.weights_path = "missing.weights"
        c.nn_arch.image_size = S
    conf.fi_conf.nn_arch.dense1_dim = D
    conf.fd_conf.hps.face_conf_th = 0.05
    conf.fd_conf.int8_pallas_blocks = True
    return conf


def _images(n, seed=0):
    return np.random.default_rng(seed).random((n, S, S, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def pipes():
    """JAX pipelines (f32, int8 calibrated without the tail ladder, FI) and
    port pipelines on the CPU holding their weights and qparams."""
    import jax

    from face_vijnana_yolov3_tpu.api.config import Conf as JaxConf
    from face_vijnana_yolov3_tpu.api.face_detection import FaceDetectorPipeline as JaxFd
    from face_vijnana_yolov3_tpu.api.face_identification import (
        FaceIdentifierPipeline as JaxFi,
    )
    from face_vijnana_yolov3_tpu_torch.convert import (
        identifier_params_from_jax,
        params_from_jax,
        qparams_from_jax,
    )
    from face_vijnana_yolov3_tpu_torch.models import quant

    jconf = JaxConf()
    for c in (jconf.fd_conf, jconf.fi_conf):
        c.weights_path = "missing.weights"
        c.nn_arch.image_size = S
    jconf.fi_conf.nn_arch.dense1_dim = D
    jconf.fd_conf.hps.face_conf_th = 0.05
    jconf.fd_conf.int8_tail_auto = False
    jfd = JaxFd(jconf.fd_conf, precision="float32")
    jfd8 = JaxFd(jconf.fd_conf, precision="int8")
    jfd8.params, jfd8.state = jfd.params, jfd.state
    jfd8.calibrate_int8(_images(4, seed=2))
    jfi = JaxFi(jconf, precision="float32")

    conf = _conf()
    conf.fd_conf.int8_tail_auto = False
    sd = params_from_jax(*jax.device_get((jfd.params, jfd.state)))
    fd = FaceDetectorPipeline(conf.fd_conf, precision="float32", device="cpu")
    fd.model.load_state_dict(sd)
    fd8 = FaceDetectorPipeline(conf.fd_conf, precision="int8", device="cpu")
    fd8.model.load_state_dict(sd)
    fd8._qparams = quant.to_device(qparams_from_jax(jax.device_get(jfd8._qparams)), "cpu")
    fi = FaceIdentifierPipeline(conf, precision="float32", device="cpu")
    fi.model.load_state_dict(identifier_params_from_jax(*jax.device_get(
        (jfi.params, jfi.state))))
    return dict(jfd=jfd, jfd8=jfd8, jfi=jfi, fd=fd, fd8=fd8, fi=fi)


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_export_detector_symbolic_batch_roundtrip(pipes, tmp_path, precision):
    """One artifact serves b = 1, 2 and 3 (traced at 2) and equals the live
    detect_batch bit for bit; the int8 program holds the three kernels."""
    fd = pipes["fd" if precision == "float32" else "fd8"]
    path = str(tmp_path / "detect.fvyx")
    header = export_detector(fd, path)
    assert header["kind"] == "face_detect" and header["batch"] is None
    art = load_artifact(path)
    assert art.meta["precision"] == precision
    assert art.meta["num_cands"] == fd._pp_cfg.num_cands
    ops = {str(n.target) for n in art.exported.graph.nodes if "fvy" in str(n.target)}
    assert ops == ({"fvy.nms_sweep.default"} if precision == "float32" else
                   {"fvy.nms_sweep.default", "fvy.conv_int8.default",
                    "fvy.block_int8.default"})
    for n, seed in ((2, 0), (1, 1), (3, 2)):
        x = _images(n, seed)
        cands, counts = fd.detect_batch(x)
        got_c, got_n = art(x)
        np.testing.assert_array_equal(got_c.numpy(), cands)
        np.testing.assert_array_equal(got_n.numpy(), counts)


def test_export_detector_int8_requires_calibration(tmp_path):
    fd = FaceDetectorPipeline(_conf().fd_conf, precision="int8", device="cpu")
    with pytest.raises(RuntimeError, match="calibrate_int8"):
        export_detector(fd, str(tmp_path / "x.fvyx"))


def test_export_detector_int8_fixed_batch(pipes, tmp_path):
    fd8 = pipes["fd8"]
    path = str(tmp_path / "detect_int8.fvyx")
    export_detector(fd8, path, batch=2)
    art = load_artifact(path)
    assert art.meta["precision"] == "int8" and art.meta["batch"] == 2
    assert art.meta["int8_pallas_blocks"] is True
    x = _images(2, seed=3)
    cands, counts = fd8.detect_batch(x)
    got_c, got_n = art(x)
    np.testing.assert_array_equal(got_c.numpy(), cands)
    np.testing.assert_array_equal(got_n.numpy(), counts)


def test_export_bf16_resolves_a_pending_auto_guard(tmp_path):
    """An unprobed bf16 "auto" guard is exported at the depth the pipeline
    serves until the probe runs (2), recorded in the header, never traced
    as a branch."""
    conf = _conf().fd_conf
    conf.bf16_f32_front = "auto"
    fd = FaceDetectorPipeline(conf, precision="bfloat16", device="cpu")
    assert fd._bf16_front_auto_pending()
    path = str(tmp_path / "bf16.fvyx")
    header = export_detector(fd, path)
    assert header["bf16_f32_front"] == 2 and fd._bf16_front_auto_pending()
    x = torch.from_numpy(_images(2, seed=4))
    want = fd._detect(x)
    for got, w in zip(load_artifact(path)(x), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("with_registry", [True, False])
def test_export_embedder(pipes, tmp_path, with_registry):
    """crops → embeddings equal the live embed program on the same batch
    (`_embed_program`, which serving replays in bucket pieces); with the
    registry, two registry sizes through one artifact (R symbolic),
    best_idx and best_dist equal match_embeddings'."""
    from face_vijnana_yolov3_tpu_torch.ops.similarity import match_embeddings

    fi = pipes["fi"]
    path = str(tmp_path / "identify.fvyx")
    header = export_embedder(fi, path, with_registry=with_registry)
    assert header["kind"] == "face_embed" and header["with_registry"] is with_registry
    art = load_artifact(path)
    crops = _images(3, seed=4)
    with torch.inference_mode():
        emb_live = fi._embed_program(torch.from_numpy(crops))
    if not with_registry:
        assert torch.equal(art(crops), emb_live)
        return
    for n_reg, seed in ((5, 5), (2, 6)):
        reg = np.random.default_rng(seed).random((n_reg, D)).astype(np.float32)
        emb, idx, dist = art(crops, reg)
        assert torch.equal(emb, emb_live)
        want_idx, want_dist = match_embeddings(emb_live, torch.from_numpy(reg))
        assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)


def test_export_embedder_int8_requires_calibration(tmp_path):
    fi = FaceIdentifierPipeline(_conf(), precision="int8", device="cpu")
    with pytest.raises(RuntimeError, match="calibration"):
        export_embedder(fi, str(tmp_path / "x.fvyx"))


@pytest.mark.parametrize("target", ["detect", "embed"])
def test_export_int8_front_guard(tmp_path, target):
    """A bf16 pipeline with the int8 guard (bf16_front_mode="int8") must be
    calibrated before it exports, and its artifact traces the quant route:
    the loaded program equals the eager `_detect_program` / `_embed_program`
    on the same batch, bit for bit."""
    conf = _conf()
    conf.fd_conf.bf16_front_mode = conf.fi_conf.bf16_front_mode = "int8"
    path = str(tmp_path / "hybrid.fvyx")
    x = torch.from_numpy(_images(3, seed=7))
    if target == "detect":
        pipe = FaceDetectorPipeline(conf.fd_conf, precision="bfloat16", device="cpu")
        with pytest.raises(RuntimeError, match="calibrate_int8"):
            export_detector(pipe, path)
        pipe.calibrate_int8(_images(4, seed=8))
        header = export_detector(pipe, path)
        assert header["bf16_front_mode"] == "int8" and header["bf16_f32_front"] == 2
        fn = pipe._detect_program
    else:
        pipe = FaceIdentifierPipeline(conf, precision="bfloat16", device="cpu")
        with pytest.raises(RuntimeError, match="calibration"):
            export_embedder(pipe, path, with_registry=False)
        pipe.embed(_images(4, seed=8))
        export_embedder(pipe, path, with_registry=False)
        fn = pipe._embed_program
    assert "tail_start" in (pipe._qparams if target == "detect" else pipe._q_embed)
    with torch.inference_mode():
        want = fn(x)
    got = load_artifact(path)(x)
    for g, w in zip(got, want) if target == "detect" else [(got, want)]:
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["float32", "int8", "identify"])
def test_artifact_matches_the_jax_artifact(pipes, tmp_path, kind):
    """The port's artifact and the JAX package's, exported from the same
    weights and qparams and loaded by each package's load_artifact, agree
    within the parity bounds of the module docstring."""
    from face_vijnana_yolov3_tpu.core import export as jax_export

    x = _images(2, seed=7)
    if kind == "identify":
        reg = np.random.default_rng(8).random((4, D)).astype(np.float32)
        export_embedder(pipes["fi"], str(tmp_path / "p.fvyx"))
        jax_export.export_embedder(pipes["jfi"], str(tmp_path / "j.fvyx"),
                                   platforms=("cpu",))
        emb, idx, dist = load_artifact(str(tmp_path / "p.fvyx"))(x, reg)
        jemb, jidx, jdist = jax_export.load_artifact(str(tmp_path / "j.fvyx"))(x, reg)
        assert np.abs(emb.numpy() - np.asarray(jemb)).max() <= 1e-5
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert np.abs(dist.numpy() - np.asarray(jdist)).max() <= 1e-5
        return
    fd, jfd = ((pipes["fd"], pipes["jfd"]) if kind == "float32"
               else (pipes["fd8"], pipes["jfd8"]))
    export_detector(fd, str(tmp_path / "p.fvyx"))
    jax_export.export_detector(jfd, str(tmp_path / "j.fvyx"), platforms=("cpu",))
    cands, counts = (t.numpy() for t in load_artifact(str(tmp_path / "p.fvyx"))(x))
    jc, jn = (np.asarray(t) for t in jax_export.load_artifact(str(tmp_path / "j.fvyx"))(x))
    np.testing.assert_array_equal(counts, jn)
    box_tol, score_tol = (0.0, 5e-5) if kind == "float32" else (1.0, 1e-2)
    assert np.abs(cands[..., :4] - jc[..., :4]).max() <= box_tol
    assert np.abs(cands[..., 4:] - jc[..., 4:]).max() <= score_tol


def test_load_artifact_rejects_non_artifact(tmp_path):
    bad = tmp_path / "bad.fvyx"
    bad.write_bytes(b"NOPE" + b"\x00" * 16)
    with pytest.raises(ValueError, match="not a FVYX"):
        load_artifact(str(bad))


def test_load_artifact_rejects_newer_format(tmp_path):
    hdr = json.dumps({"format_version": 99}).encode()
    p = tmp_path / "future.fvyx"
    p.write_bytes(b"FVYX" + struct.pack("<I", len(hdr)) + hdr + b"")
    with pytest.raises(ValueError, match="newer"):
        load_artifact(str(p))


def test_header_names_torch_version_and_device(pipes, tmp_path):
    """torch_version and device take the places of jax_version and
    platforms; the layout is the JAX file's (magic, u32 length, JSON)."""
    path = tmp_path / "h.fvyx"
    export_detector(pipes["fd8"], str(path), batch=1)
    raw = path.read_bytes()
    assert raw[:4] == b"FVYX"
    (n,) = struct.unpack("<I", raw[4:8])
    meta = json.loads(raw[8:8 + n])
    assert meta["torch_version"] == torch.__version__ and meta["device"] == "cpu"
    assert meta["format_version"] == 1 and "platforms" not in meta


def _write_conf(tmp_path):
    conf_path = tmp_path / "conf.json"
    conf_path.write_text(json.dumps(conf_to_dict(_conf())))
    return conf_path


def test_export_cli_detect(tmp_path, monkeypatch):
    """No --precision and no --calib: guarded bf16, batch 1."""
    from face_vijnana_yolov3_tpu_torch.api import export_cli

    conf_path = _write_conf(tmp_path)
    out = tmp_path / "cli_detect.fvyx"
    monkeypatch.chdir(tmp_path)
    export_cli.main(["--conf", str(conf_path), "--target", "detect", "--out", str(out),
                     "--batch", "1", "--device", "cpu"])
    art = load_artifact(str(out))
    assert art.meta["kind"] == "face_detect" and art.meta["precision"] == "bfloat16"
    cands, counts = art(_images(1, seed=7))
    assert cands.shape[0] == 1 and counts.shape == (1,)


def test_export_cli_rejects_bad_target(tmp_path):
    from face_vijnana_yolov3_tpu_torch.api import export_cli

    with pytest.raises(SystemExit, match="--target"):
        export_cli.main(["--target", "bogus", "--out", str(tmp_path / "x")])
    with pytest.raises(SystemExit, match="unknown argument"):
        export_cli.main(["--platforms", "cpu"])


def test_export_cli_int8_selfcheck_fallback(tmp_path, monkeypatch):
    """An auto-chosen int8 falls back to guarded bf16 when the calibration
    self-check fails; an explicit --precision int8 is exported anyway."""
    from PIL import Image

    from face_vijnana_yolov3_tpu_torch.api import export_cli

    orig = FaceDetectorPipeline.calibrate_int8

    def bad_calibrate(self, images, percentile=None):
        orig(self, images, percentile=percentile)
        self.int8_calib_err = 0.5
        self.int8_tail_chosen = 8

    monkeypatch.setattr(FaceDetectorPipeline, "calibrate_int8", bad_calibrate)
    conf_path = _write_conf(tmp_path)
    for i in range(3):
        Image.fromarray((np.random.default_rng(i).random((64, 64, 3)) * 255)
                        .astype(np.uint8)).save(tmp_path / f"c{i}.jpg")
    common = ["--conf", str(conf_path), "--target", "detect", "--calib",
              str(tmp_path / "*.jpg"), "--batch", "1", "--device", "cpu",
              "--set", "fd_conf.int8_tail_auto=false"]
    export_cli.main(common + ["--out", str(tmp_path / "auto.fvyx")])
    assert load_artifact(str(tmp_path / "auto.fvyx")).meta["precision"] == "bfloat16"
    export_cli.main(common + ["--out", str(tmp_path / "explicit.fvyx"),
                              "--precision", "int8"])
    assert load_artifact(str(tmp_path / "explicit.fvyx")).meta["precision"] == "int8"


def test_fi_int8_flip_rate_gate():
    """Each int8 calibration embedding must nearest-match its own f32 twin:
    distinct random crops stay separated (rate ~0); permuted embeddings
    flip every match (rate 1)."""
    from face_vijnana_yolov3_tpu_torch.api.export_cli import _fi_int8_flip_rate

    conf = _conf()
    calib = np.random.default_rng(0).uniform(0, 1, (6, S, S, 3)).astype(np.float32)
    fi8 = FaceIdentifierPipeline(conf, precision="int8", device="cpu")
    rate = _fi_int8_flip_rate(fi8, conf, calib)
    assert 0.0 <= rate <= 0.05

    class Permuted:
        device = torch.device("cpu")

        def embed(self, x):
            return np.roll(fi8.embed(x), 1, axis=0)

    assert _fi_int8_flip_rate(Permuted(), conf, calib) == 1.0


def test_artifact_loads_in_fresh_process(pipes, tmp_path):
    """The deploy host: a fresh interpreter that imports core/export.py's
    loader only (no pipeline, no jax) loads the int8 artifact and
    reproduces this process's outputs."""
    path = str(tmp_path / "fresh.fvyx")
    export_detector(pipes["fd8"], path)
    x = _images(3, seed=9)
    want_c, want_n = load_artifact(path)(x)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "c.npy", want_c.numpy())
    np.save(tmp_path / "n.npy", want_n.numpy())
    script = f"""
import sys
import numpy as np
import torch
from face_vijnana_yolov3_tpu_torch.core.export import load_artifact
art = load_artifact({path!r})
cands, counts = art(np.load({str(tmp_path / 'x.npy')!r}))
assert np.array_equal(cands.numpy(), np.load({str(tmp_path / 'c.npy')!r}))
assert np.array_equal(counts.numpy(), np.load({str(tmp_path / 'n.npy')!r}))
bad = [m for m in sys.modules if m == "jax" or m.startswith("face_vijnana_yolov3_tpu.")
       or m.startswith("face_vijnana_yolov3_tpu_torch.api")]
assert not bad, bad
print("FRESH_OK")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FRESH_OK" in out.stdout
