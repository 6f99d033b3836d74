"""Captured serving programs (core/programs.py) and the shape buckets and
padding around them, vs the JAX package's jitted programs, on the CPU.

On the CPU a program runs its eager function, so these tests hold what the
graphs are keyed on and fed with: the staging buckets (`_stage_bucket`,
FVY_STAGE_BUCKET), the batch padding of `detect_batch_fused` and of the CLI
loop's short last chunk, the embed buckets (split, where the JAX package
pads) and the ROI identify programs. Each against the JAX package's path on the same
weights: f32 candidates at tests/test_torch_face_detection.py's rule
(boxes exact, scores within 5e-5); int8 with the JAX package's qparams,
the trunk bit-exact on the program's own letterboxed input and the
candidates at tests/test_torch_int8_pipeline.py's rule (bf16 head: the
same counts, box edges within one letterbox pixel, scores within 1e-2);
identify rows equal (box, subject), program keys equal to the JAX
`_roi_cache` keys but for its n_sub and the bucket split. The `test_cuda_*`
cases need the card: replay against the eager `_detect_program`, and a
capture error that must raise.
"""

import jax
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.api import face_detection as jax_fd
from face_vijnana_yolov3_tpu.api import face_identification as jax_fi
from face_vijnana_yolov3_tpu.api.config import Conf as JaxConf
from face_vijnana_yolov3_tpu.api.config import FdConf as JaxFdConf
from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu.ops.letterbox import letterbox_geometry as jax_geometry
from face_vijnana_yolov3_tpu_torch.api import face_detection as port_fd
from face_vijnana_yolov3_tpu_torch.api import face_identification as port_fi
from face_vijnana_yolov3_tpu_torch.api.config import Conf, FdConf
from face_vijnana_yolov3_tpu_torch.convert import (
    identifier_params_from_jax,
    params_from_jax,
    qparams_from_jax,
)
from face_vijnana_yolov3_tpu_torch.core.checkpoints import save_checkpoint
from face_vijnana_yolov3_tpu_torch.core import programs
from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache, ProgramError
from face_vijnana_yolov3_tpu_torch.models import darknet, quant
from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry, letterbox_host
from face_vijnana_yolov3_tpu_torch.ops.resize import letterbox_device_matmul
from face_vijnana_yolov3_tpu_torch.utils.io import imread, imsave
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)
port_fd.DEBUG = False
port_fi.DEBUG = False

S = 64
SCORE_ATOL = 5e-5  # f32: tests/test_torch_face_detection.py
INT8_BOX_ATOL = 1.0  # int8 (bf16 head): one letterbox pixel
INT8_SCORE_ATOL = 1e-2  # tests/test_torch_int8_pipeline.py
SIZES = ((240, 320), (236, 320), (230, 300), (200, 320), (240, 300))  # one 128 bucket


def _conf(cls, testdir, out, **kw):
    conf = cls(mode="test", test_path=str(testdir), output_file_path=str(out),
               weights_path="does_not_exist.weights", **kw)
    conf.nn_arch.image_size = S
    conf.hps.face_conf_th = 0.05  # random trunk scores hover near 0.25
    conf.hps.batch_size = 2
    return conf


@pytest.fixture(scope="module")
def det(tmp_path_factory):
    """Five JPEGs of five sizes within one 128 bucket; a JAX f32 pipeline
    on random weights and the port's on the same weights."""
    tmp = tmp_path_factory.mktemp("programs")
    testdir = tmp_path_factory.mktemp("set")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(SIZES):
        imsave(str(testdir / f"img_{i}.jpg"),
               rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
    jfd = jax_fd.FaceDetectorPipeline(_conf(JaxFdConf, testdir, tmp / "jax.csv"))
    ckpt = str(tmp / "fd.pt")
    save_checkpoint(ckpt, params_from_jax(jfd.params, jfd.state), meta={})
    files = sorted(str(p) for p in testdir.glob("*.jpg"))
    ims = [imread(f) for f in files]
    return dict(tmp=tmp, testdir=testdir, jfd=jfd, ckpt=ckpt, ims=ims)


def _port(det, precision="float32", **kw):
    conf = _conf(FdConf, det["testdir"], det["tmp"] / "port.csv", model_loading=True,
                 model_path=det["ckpt"], **kw)
    return port_fd.FaceDetectorPipeline(conf, precision=precision, device="cpu")


def _staged(ims):
    """(n, maxH, maxW, 3) uint8, each image top-left; the port's and the
    JAX package's geometries."""
    h, w = max(im.shape[0] for im in ims), max(im.shape[1] for im in ims)
    staged = np.zeros((len(ims), h, w, 3), np.uint8)
    for k, im in enumerate(ims):
        staged[k, : im.shape[0], : im.shape[1]] = im
    return (staged, [letterbox_geometry(*im.shape[:2], S) for im in ims],
            [jax_geometry(*im.shape[:2], S) for im in ims])


@pytest.mark.parametrize("bucket", [None, "16"])
def test_copies_equal_the_jax_originals(monkeypatch, bucket):
    """`_stage_bucket` (with FVY_STAGE_BUCKET) and `_EMBED_BUCKETS` are the
    JAX package's."""
    if bucket is None:
        monkeypatch.delenv("FVY_STAGE_BUCKET", raising=False)
    else:
        monkeypatch.setenv("FVY_STAGE_BUCKET", bucket)
    assert port_fd._stage_bucket() == jax_fd._stage_bucket() == int(bucket or 128)
    assert port_fi._EMBED_BUCKETS == jax_fi._EMBED_BUCKETS


@pytest.mark.parametrize("bucket", [None, "16"])
def test_padded_fused_detect_matches_jax_f32(det, monkeypatch, bucket):
    """detect_batch_fused with the staging bucket and pad_batch_to: the real
    rows of the JAX padded path, the same padded staging tensor, and one
    program per (bucketed shape, geometry mode)."""
    if bucket is None:
        monkeypatch.delenv("FVY_STAGE_BUCKET", raising=False)
    else:
        monkeypatch.setenv("FVY_STAGE_BUCKET", bucket)
    pfd, jfd = _port(det), det["jfd"]
    staged, geoms, jgeoms = _staged(det["ims"][:3])
    for pad in (None, 4):
        c, n, st = pfd.detect_batch_fused(staged, geoms, pad_batch_to=pad,
                                          return_staged=True)
        jc, jn, jst = jfd.detect_batch_fused(staged, jgeoms, pad_batch_to=pad,
                                             return_staged=True)
        assert c.shape[0] == n.shape[0] == 3
        np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(c[..., :4], jc[..., :4])
        np.testing.assert_allclose(c[..., 5], jc[..., 5], rtol=0, atol=SCORE_ATOL)
    assert n.sum() > 0, "the random detector must find candidates at face_conf_th 0.05"
    hw = (256, 384) if bucket is None else (240, 320)
    assert pfd.programs.keys() == [("fused", "float32", None, (3,) + hw + (3,),
                                    "torch.uint8", False),
                                   ("fused", "float32", None, (4,) + hw + (3,),
                                    "torch.uint8", False)]


def test_padded_fused_detect_matches_jax_int8(det):
    """int8 (fused blocks on) on the JAX package's qparams: the trunk of the
    padded program's letterboxed input bit-exact with the jitted JAX trunk,
    the candidates of the padded path at the int8 pipeline's rule."""
    jfd = jax_fd.FaceDetectorPipeline(
        _conf(JaxFdConf, det["testdir"], det["tmp"] / "x.csv"), precision="int8")
    params, state = FaceDetectorModel(image_size=S, device="cpu").init_params(0)
    jfd.params, jfd.state = darknet.perturb_batchnorm(params, state, jfd.model.ops, 1)
    lb = np.asarray([letterbox_host(im / 255, S, "cubic")[0] for im in det["ims"]],
                    np.float32)
    jfd._ckpt_int8_tail = 0  # one self-check candidate, as a pinned sidecar
    jfd.calibrate_int8(lb)
    ckpt = str(det["tmp"] / "fd8.pt")
    save_checkpoint(ckpt, params_from_jax(jfd.params, jfd.state), meta={})
    pfd = port_fd.FaceDetectorPipeline(
        _conf(FdConf, det["testdir"], det["tmp"] / "x.csv", model_loading=True,
              model_path=ckpt, int8_pallas_blocks=True), precision="int8", device="cpu")
    pfd._qparams = quant.to_device(qparams_from_jax(jfd._qparams), "cpu")
    staged, geoms, jgeoms = _staged(det["ims"][:3])
    c, n, st = pfd.detect_batch_fused(staged, geoms, pad_batch_to=4, return_staged=True)
    jc, jn = jfd.detect_batch_fused(staged, jgeoms, pad_batch_to=4)
    assert st.shape == (4, 256, 384, 3) and c.shape[0] == 3
    np.testing.assert_array_equal(n, jn)
    for k in range(3):
        np.testing.assert_allclose(c[k, : n[k], :4], jc[k, : jn[k], :4], rtol=0,
                                   atol=INT8_BOX_ATOL)
        np.testing.assert_allclose(c[k, : n[k], 5], jc[k, : jn[k], 5], rtol=0,
                                   atol=INT8_SCORE_ATOL)
    mats = [pfd._matrices(g, 256, 384) for g in geoms + geoms[-1:]]
    x = letterbox_device_matmul(st.float() / 255, torch.stack([m[0] for m in mats]),
                                torch.stack([m[1] for m in mats]))
    want = np.asarray(jax.jit(lambda a: jax_quant.apply_graph_quant(
        jfd._qparams, a, jfd.model.ops)["trunk"])(x.numpy()))
    got = quant.apply_graph_quant(pfd._qparams, x, pfd.model.ops, fused_blocks=True)
    np.testing.assert_array_equal(got["trunk"].numpy(), want)
    assert pfd.programs.keys() == [("fused", "int8", True, (4, 256, 384, 3), "torch.uint8",
                                    False)]


def test_short_last_chunk_builds_one_program(det, monkeypatch, tmp_path):
    """test() on five images of five sizes in chunks of 3 through the device
    letterbox: the JAX package's solution_fd.csv, and the short last chunk
    pads to the batch size, so one program serves both chunks, as the JAX
    package compiles one `_fused_cache` entry. (A last chunk of one image
    would repeat one geometry and take the one-matrix program, in both
    packages.)"""
    monkeypatch.setenv("FVY_DEVICE_LETTERBOX", "1")
    monkeypatch.delenv("FVY_STAGE_BUCKET", raising=False)
    monkeypatch.setattr("face_vijnana_yolov3_tpu.data.native_loader.native_available",
                        lambda: False)
    monkeypatch.setattr("face_vijnana_yolov3_tpu_torch.data.native_loader.native_available",
                        lambda: False)
    jfd = jax_fd.FaceDetectorPipeline(_conf(JaxFdConf, det["testdir"], tmp_path / "j.csv"))
    jfd.hps["batch_size"] = 3
    jfd.test()
    pfd = _port(det)
    pfd.hps["batch_size"] = 3
    pfd.conf.output_file_path = str(tmp_path / "p.csv")
    pfd.test()
    rows = {k: [r.split(",") for r in open(tmp_path / f"{k}.csv").read().splitlines()]
            for k in ("j", "p")}
    assert rows["j"] and [r[:5] for r in rows["p"]] == [r[:5] for r in rows["j"]]
    for g, w in zip(rows["p"], rows["j"]):
        assert abs(float(g[5]) - float(w[5])) <= SCORE_ATOL
    assert len(jfd._fused_cache) == 1
    assert pfd.programs.keys() == [("fused", "float32", None, (3, 256, 384, 3),
                                    "torch.uint8", False)]


def _fi_conf(cls, root, out, dim=8):
    conf = cls()
    c = conf.fi_conf
    c.raw_data_path = str(root)
    c.test_path = str(root)
    c.output_file_path = str(root / out)
    c.weights_path = "missing.weights"
    c.nn_arch.image_size = S
    c.nn_arch.dense1_dim = dim
    c.hps.sim_th = 10.0
    conf.fd_conf.weights_path = "missing.weights"
    conf.fd_conf.nn_arch.image_size = S
    conf.fd_conf.hps.face_conf_th = 0.05
    conf.fd_conf.hps.batch_size = 2
    return conf


def _boxes(rng, n, h, w):
    x0, y0 = rng.uniform(0, w * 0.7, n), rng.uniform(0, h * 0.7, n)
    b = np.stack([x0, y0, x0 + rng.uniform(8, 60, n), y0 + rng.uniform(8, 60, n),
                  rng.uniform(0.05, 1, n)], axis=1)
    b[0, :4] = [0, 0, 0, 0]  # a zero box: its crop is empty and skipped
    return b


def test_identify_chunks_match_jax(det, tmp_path):
    """`_identify_chunk_device` over a sequence of chunks: 68 non-empty
    ROIs on two images (the JAX package: bucket 64, two sub-batches, 60
    black pad crops; the port: pieces of 64 and 4), then a short chunk
    staged by the detector with pad_batch_to=2 (4 ROIs, which reuse the
    4-piece program): the JAX package's rows, and the program keys equal
    to its `_roi_cache` keys but for the bucket split and n_sub."""
    jfi = jax_fi.FaceIdentifierPipeline(_fi_conf(JaxConf, tmp_path, "j.csv"))
    pfi = port_fi.FaceIdentifierPipeline(_fi_conf(Conf, tmp_path, "p.csv"), device="cpu")
    pfi.model.load_state_dict(identifier_params_from_jax(*jax.device_get(
        (jfi.params, jfi.state))))
    pfi.fd.model.load_state_dict(params_from_jax(*jax.device_get(
        (jfi.fd.params, jfi.fd.state))))
    rng = np.random.default_rng(5)
    ims = det["ims"]
    reg = pfi.embed(np.asarray([letterbox_host(im[40:120, 60:140] / 255, S, "cubic")[0]
                                for im in ims[:3]], np.float32))
    ids = ["ann", "bob", "cid"]
    chunks = [([ims[0], ims[2]], [_boxes(rng, 36, 230, 300), _boxes(rng, 36, 230, 300)]),
              ([ims[3]], [_boxes(rng, 5, 200, 320)])]
    for j, (images, boxes) in enumerate(chunks):
        if j == 0:
            got = pfi._identify_chunk_device(images, boxes, ids, torch.from_numpy(reg))
            want = jfi._identify_chunk_device(images, boxes, ids, jax.numpy.asarray(reg))
        else:
            staged, geoms, jgeoms = _staged(images)
            *_, st = pfi.fd.detect_batch_fused(staged, geoms, pad_batch_to=2,
                                               return_staged=True)
            *_, jst = jfi.fd.detect_batch_fused(staged, jgeoms, pad_batch_to=2,
                                                return_staged=True)
            got = pfi._identify_chunk_device(images, boxes, ids, torch.from_numpy(reg),
                                             staged_dev=st)
            want = jfi._identify_chunk_device(images, boxes, ids, jax.numpy.asarray(reg),
                                              staged_dev=jst)
        assert [[(r["box_index"], r["subject_id"]) for r in rows] for rows in got] == \
            [[(r["box_index"], r["subject_id"]) for r in rows] for rows in want]
        assert sum(len(rows) for rows in got) >= 4 * len(images)
    (j0, j1) = list(jfi._roi_cache)
    assert j0[:3] == (64, 2, 2) and j1[:3] == (4, 1, 2) and j0[2:] == j1[2:]
    assert [k for k in pfi.programs.keys() if k[0] == "roi"] == [
        ("roi", 64) + j0[2:], ("roi", 4) + j0[2:]]


def test_programs_drop_with_new_weights_and_calibrations(det, tmp_path):
    """calibrate_int8, a weight reload (model.load_state_dict) and
    autoselect_bf16_front each empty the cache, as the JAX package's
    `_invalidate_jits`; the next call serves the new parameters. The
    identifier's int8 calibration and reload too."""
    lb = np.asarray([letterbox_host(im / 255, S, "cubic")[0] for im in det["ims"]],
                    np.float32)
    pfd = _port(det, "int8", int8_tail_auto=False)
    first = pfd.detect_batch(lb)
    assert len(pfd.programs) == 1 and pfd.programs.keys()[0][:3] == ("detect", "int8", False)
    pfd.calibrate_int8(lb)
    assert len(pfd.programs) == 0
    pfd.detect_batch(lb)
    params, state = FaceDetectorModel(image_size=S, device="cpu").init_params(3)
    darknet.perturb_batchnorm(params, state, pfd.model.ops, 4)
    pfd.model.load_state_dict(params_from_jax(params, state))
    assert len(pfd.programs) == 0
    pfd.calibrate_int8(lb)
    cands, counts = pfd.detect_batch(lb)
    want = pfd._detect_program(torch.from_numpy(lb))
    np.testing.assert_array_equal(cands, want[0].numpy())
    np.testing.assert_array_equal(counts, want[1].numpy())
    assert not np.array_equal(cands, first[0])

    pfb = _port(det, "bfloat16", bf16_f32_front="auto")
    x16 = np.concatenate([lb] * 4)[:16]
    pfb.detect_batch(x16)
    assert len(pfb.programs) == 1 and pfb._folded is not None
    pfb.autoselect_bf16_front(x16)
    assert len(pfb.programs) == 0
    pfb.detect_batch(x16)
    pfb.model.load_state_dict(params_from_jax(params, state))
    assert len(pfb.programs) == 0 and pfb._folded is None

    fi = port_fi.FaceIdentifierPipeline(_fi_conf(Conf, tmp_path, "x.csv"),
                                        precision="int8", device="cpu")
    fi.embed(lb[:3])
    assert fi.programs.keys() == [("embed", 2), ("embed", 1)] and fi._q_embed is not None
    fi._calibrate_int8(torch.from_numpy(lb))
    assert len(fi.programs) == 0
    fi.embed(lb)
    fi.model.load_state_dict(fi.model.state_dict())
    assert len(fi.programs) == 0


def test_cuda_replay_equals_eager():
    """On the card: the int8 (blocks on) and f32 programs replay the eager
    `_detect_program`'s candidates (int8 torch.equal; f32 torch.equal too,
    the same kernels on the same shapes), a second replay counts the
    kernels again, and a new key captures anew."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_int8
    from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep

    conf = FdConf(weights_path="does_not_exist.weights", int8_pallas_blocks=True,
                  int8_tail_auto=False)
    conf.nn_arch.image_size = 128
    conf.hps.face_conf_th = 0.05
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(size=(4, 128, 128, 3)).astype(np.float32)).cuda()
    for precision in ("int8", "float32"):
        fd = port_fd.FaceDetectorPipeline(conf, precision=precision, device="cuda")
        if precision == "int8":
            fd.calibrate_int8(x)
        got = fd._detect(x)
        before = (conv_int8.launches, block_int8.launches, nms_sweep.launches)
        again = fd._detect(x)
        after = (conv_int8.launches, block_int8.launches, nms_sweep.launches)
        with torch.inference_mode():
            want = fd._detect_program(x)
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(a, w)
        assert after[2] == before[2] + 1
        if precision == "int8":
            assert after[0] > before[0] and after[1] > before[1]
        fd._detect(x[:3])
        assert len(fd.programs) == 2


def test_cuda_capture_error_raises():
    """A program whose function syncs with the host (`.item()`) raises
    ProgramError at capture, naming its key, and is never served eagerly;
    the cache captures other programs afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    cache = ProgramCache("cuda")
    x = torch.arange(8.0, device="cuda")
    with pytest.raises(ProgramError, match="host_sync"):
        cache.run(("host_sync", 8), lambda t: t * float(t.sum().item()), x)
    assert len(cache) == 0
    out = cache.run(("double", 8), lambda t: t * 2.0, x)
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2.0) and cache.keys() == [("double", 8)]


def test_cpu_cache_runs_eagerly_and_records_keys():
    """On the CPU a program is its eager function: every call runs it, the
    cache records the key once, invalidate() empties it."""
    cache = ProgramCache("cpu")
    calls = []

    def fn(t):
        calls.append(1)
        return t + 1.0, t * 2.0

    x = torch.ones(3)
    a, b = cache.run(("k", 3), fn, x)
    cache.run(("k", 3), fn, x)
    assert torch.equal(a, x + 1) and torch.equal(b, x * 2) and len(calls) == 2
    assert cache.keys() == [("k", 3)]
    cache.invalidate()
    assert len(cache) == 0


def test_program_inputs_must_match_their_key():
    """A call whose inputs differ in shape or dtype from those its key was
    first seen with raises ProgramError (the card's graph would read them
    into its static inputs by broadcasting and casting), on the CPU too."""
    cache = ProgramCache("cpu")
    cache.run(("k",), lambda t: t + 1.0, torch.zeros(4))
    with pytest.raises(ProgramError, match="takes"):
        cache.run(("k",), lambda t: t + 1.0, torch.zeros(5))
    with pytest.raises(ProgramError, match="takes"):
        cache.run(("k",), lambda t: t + 1.0, torch.zeros(4, dtype=torch.float64))
    assert torch.equal(cache.run(("k",), lambda t: t + 1.0, torch.zeros(4)), torch.ones(4))


def test_cache_keeps_the_most_recently_used(monkeypatch):
    """The cache keeps MAX_PROGRAMS programs and drops the least recently
    used first."""
    monkeypatch.setattr(programs, "MAX_PROGRAMS", 2)
    cache = ProgramCache("cpu")
    x = torch.zeros(2)
    for k in ("a", "b", "a", "c"):
        cache.run((k,), lambda t: t, x)
    assert cache.keys() == [("a",), ("c",)]


@pytest.mark.parametrize("n,want", [(1, [1]), (17, [16, 1]), (64, [64]), (70, [64, 4, 2]),
                                    (81, [64, 16, 1]), (200, [64, 64, 64, 8])])
def test_bucket_split(n, want):
    """`_bucket_split` cuts n rows into the JAX package's embed bucket sizes
    without padding; every n up to 300 is covered exactly."""
    assert port_fi._bucket_split(n) == want
    for m in range(1, 301):
        parts = port_fi._bucket_split(m)
        assert sum(parts) == m and set(parts) <= set(jax_fi._EMBED_BUCKETS)


def test_every_kernel_is_registered_with_its_trace_names():
    """Each `__global__` kernel under csrc/ is named by exactly one
    registered wrapper's trace names (kernels.LAUNCH_COUNTERS), which the
    programs' launch counts and chip_smoke.py's trace count rely on."""
    import re

    from face_vijnana_yolov3_tpu_torch import kernels
    from face_vijnana_yolov3_tpu_torch.ops import (  # noqa: F401  (registers)
        block_int8,
        conv_int8,
        front_fused,
        nms_sweep,
    )

    defined = set()
    for src in kernels.CSRC.glob("*.cu"):
        defined |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            src.read_text()))
    names = [n for fn in kernels.LAUNCH_COUNTERS for n in fn.trace_names]
    assert sorted(names) == sorted(defined) and len(kernels.LAUNCH_COUNTERS) == 4
    assert all(hasattr(fn, "launches") for fn in kernels.LAUNCH_COUNTERS)
