"""Data-parallel serving and spatially split detection of the port on 2 and
4 CPU processes (gloo), against one process and against the JAX package.

`parallel/serving.py` (`detect_quant_dp`, `identify_roi_dp`) and
`parallel/spatial.py` (`detect_spatial`) run in worker processes (this
file run as a script, importing neither jax nor the JAX package): one
group of 2 ranks (mesh data 2 for serving, model 2 for the spatial split)
and one of 4 (spatial over model 4, and data 2 x model 2 for both), started
once for the module and together, while the parent computes the
references. Every function with mesh=None is the one-process program.

Weights: the JAX detector's initialiser at 64² with perturbed BN
statistics; the int8 qparams are the JAX package's calibration
(`model.quantize`, full int8 and a bf16 tail of 2 blocks) carried over by
`convert.qparams_from_jax`, so the JAX `detect_quant_dp` on the 8-device
virtual mesh (tests/conftest.py) serves the same int8 program.

Tolerances:
- DP int8 serving vs one process: bit for bit (integer trunk, per-image
  head and postprocess), the mixed-tail qparams included. Both serve
  through programs keyed on the shape and the mesh (on the CPU a program
  is its eager function); the head also equals the eager `apply_quant`
  of the whole batch bit for bit.
- DP int8 vs JAX `detect_quant_dp`: the trunk is bit-exact and the head
  conv is bf16 on both sides in other summation orders: 2e-2 of max |head|
  (tests/test_torch_int8_pipeline.py's bound) [measured 1.1e-2].
- `identify_roi_dp` vs one process: bit for bit; vs JAX: the same
  best_idx, distances within 1e-5 (tests/test_torch_identifier.py's
  embedding bound: unit vectors 1e-5 apart) [1.3e-6].
- `detect_spatial` f32 vs the unsharded port head: 1e-5 absolute (the
  JAX test's bound: a band's conv sums the same terms as the whole
  image's, in an order the conv library picks per shape) [4.3e-6 of a
  max |head| of 3.9]; vs JAX `detect_spatial` on make_mesh(8,
  model_axis=2 and 4): 1e-4 of max |head| (tests/
  test_torch_face_detection.py's f32 head bound) [1.7e-6]. Counts after
  postprocess equal the unsharded port's.
"""

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
S, D = 64, 8
SERVE_B, SPATIAL_B = 8, 4
BUCKET = 8


def _pp_cfg():
    from face_vijnana_yolov3_tpu_torch.ops.postprocess import FacePostprocessConfig

    return FacePostprocessConfig(image_size=S, grid=S // 32, conf_th=0.05,
                                 nms_iou_th=0.5, num_cands=8)


def _serve(case, mesh):
    """Every serving program of the module on `mesh` (None: one process)."""
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel
    from face_vijnana_yolov3_tpu_torch.parallel.serving import (
        detect_quant_dp,
        identify_roi_dp,
    )

    out = {"keys": []}
    det = FaceDetectorModel(image_size=S, device="cpu")
    det.load_state_dict(case["det"])
    x = case["images"]
    for name, qp, blocks in (("full", case["q_full"], True), ("tail", case["q_tail"], False)):
        head = detect_quant_dp(det, mesh, qp, fused_blocks=blocks)
        out[f"head_{name}"] = head(x)
        out[f"pp_{name}"] = detect_quant_dp(det, mesh, qp, postprocess_cfg=_pp_cfg(),
                                            fused_blocks=blocks)(x)
        out["keys"] += head.programs.keys()
    idm = FaceIdentifierModel(image_size=S, dense1_dim=D, device="cpu")
    idm.load_state_dict(case["id"])
    staged, packed, reg, (wh, ww) = case["roi"]
    fn = identify_roi_dp(idm.embed, mesh, image_size=S, window_h=wh, window_w=ww)
    out["roi"] = fn(staged, packed, reg)
    out["keys"] += fn.programs.keys()
    return out


def _spatial(case, mesh):
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
    from face_vijnana_yolov3_tpu_torch.parallel.spatial import detect_spatial

    det = FaceDetectorModel(image_size=S, device="cpu")
    det.load_state_dict(case["det"])
    folded = det.fold()
    x = case["spatial_images"]
    return {"head": detect_spatial(det, mesh, compute_dtype=torch.float32)(folded, x),
            "pp": detect_spatial(det, mesh, compute_dtype=torch.float32,
                                 postprocess_cfg=_pp_cfg())(folded, x)}


def _worker(rank: int, world: int, port: str, workdir: str) -> None:
    torch.set_num_threads(1)
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib

    assert mesh_lib.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    case = torch.load(os.path.join(workdir, "case.pt"), weights_only=False)
    out = {}
    if world == 2:
        out["serve"] = _serve(case, mesh_lib.make_mesh())
        out["spatial_m2"] = _spatial(case, mesh_lib.make_mesh(model_axis=2))
    else:
        out["spatial_m4"] = _spatial(case, mesh_lib.make_mesh(model_axis=4))
        dm = mesh_lib.make_mesh(model_axis=2)
        out["spatial_d2m2"] = _spatial(case, dm)
        out["serve_d2m2"] = _serve(case, dm)
    torch.save(out, os.path.join(workdir, f"w{world}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


# ------------------------------------------------------------------ parent

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _roi_case(rng):
    """Two staged uint8 images and BUCKET windows packed for the windowed
    crops (ops/roi), plus a registry of 5 rows."""
    from face_vijnana_yolov3_tpu_torch.ops import roi

    bh, bw = 96, 128
    staged = rng.integers(0, 256, (2, bh, bw, 3)).astype(np.uint8)
    wins = [(int(rng.integers(0, 40)), int(rng.integers(0, 60)),
             int(rng.integers(12, 50)), int(rng.integers(12, 60))) for _ in range(BUCKET)]
    wins = [(y0, x0, min(h, bh - y0), min(w, bw - x0)) for y0, x0, h, w in wins]
    wh = roi.window_bucket(max(w[2] for w in wins), bh)
    ww = roi.window_bucket(max(w[3] for w in wins), bw)
    origins = np.array([(k % 2, min(y0, bh - wh), min(x0, bw - ww))
                        for k, (y0, x0, _, _) in enumerate(wins)], np.int32)
    taps = roi.stack_roi_taps(wins, S, origins[:, 1:])
    packed = roi.pack_roi_operands(origins, *taps)[None]   # (1, BUCKET, F)
    reg = rng.normal(0, 1, (5, D)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=1, keepdims=True)
    return staged, packed, reg, (wh, ww)


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp

    from face_vijnana_yolov3_tpu.models.detector import FaceDetectorModel as JaxDet
    from face_vijnana_yolov3_tpu.models.identifier import FaceIdentifierModel as JaxId
    from face_vijnana_yolov3_tpu_torch.convert import (
        identifier_params_from_jax,
        params_from_jax,
        qparams_from_jax,
    )
    from face_vijnana_yolov3_tpu_torch.models import darknet

    torch.set_num_threads(2)
    jd = JaxDet(image_size=S)
    params, state = jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(0)))
    params = {k: dict(v) for k, v in params.items()}
    state = {k: dict(v) for k, v in state.items()}
    darknet.perturb_batchnorm(params, state, jd.ops, 3)
    rng = np.random.default_rng(3)
    calib = jnp.asarray(rng.uniform(size=(4, S, S, 3)), jnp.float32)
    folded = jd.fold(params, state)
    jq = {"full": jax.device_get(jd.quantize(folded, calib)),
          "tail": jax.device_get(jd.quantize(folded, calib, bf16_tail_blocks=2))}
    ji = JaxId(image_size=S, dense1_dim=D)
    iparams, istate = jax.tree.map(np.asarray, ji.init(jax.random.PRNGKey(4)))
    case = {"det": params_from_jax(params, state),
            "q_full": qparams_from_jax(jq["full"]), "q_tail": qparams_from_jax(jq["tail"]),
            "images": rng.uniform(size=(SERVE_B, S, S, 3)).astype(np.float32),
            "spatial_images": rng.uniform(size=(SPATIAL_B, S, S, 3)).astype(np.float32),
            "id": identifier_params_from_jax(iparams, istate),
            "roi": _roi_case(rng)}
    tmp = tempfile.TemporaryDirectory()
    torch.save(case, os.path.join(tmp.name, "case.pt"))
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("XLA_FLAGS", None)
    procs = []
    for world in (2, 4):
        port = str(_free_port())
        procs += [subprocess.Popen([sys.executable, __file__, str(r), str(world), port,
                                    tmp.name], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True, env=env)
                  for r in range(world)]
    try:
        refs = _references(case, jd, params, state, jq, ji, iparams, istate)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = {w: [torch.load(os.path.join(tmp.name, f"w{w}_rank{r}.pt"), weights_only=False)
                 for r in range(w)] for w in (2, 4)}
    yield {"ranks": ranks, "refs": refs}
    tmp.cleanup()


def _references(case, jd, params, state, jq, ji, iparams, istate):
    import jax
    import jax.numpy as jnp

    from face_vijnana_yolov3_tpu.parallel import mesh as jax_mesh
    from face_vijnana_yolov3_tpu.parallel import spatial as jax_spatial
    from face_vijnana_yolov3_tpu.parallel.serving import detect_quant_dp, identify_roi_dp
    from face_vijnana_yolov3_tpu_torch.models import quant
    from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel

    refs = {"serve": _serve(case, None)}
    det = FaceDetectorModel(image_size=S, device="cpu")
    det.load_state_dict(case["det"])
    with torch.inference_mode():
        refs["unsharded"] = det.apply_folded(det.fold(), torch.from_numpy(
            case["spatial_images"]), compute_dtype=torch.float32)
        for name, blocks in (("full", True), ("tail", False)):
            qp = case[f"q_{name}"]
            tail = qp.get("tail_start")
            qp = quant.to_device({k: v for k, v in qp.items() if k != "tail_start"}, "cpu")
            if tail is not None:
                qp["tail_start"] = int(tail)
            refs[f"eager_head_{name}"] = det.apply_quant(
                qp, torch.from_numpy(case["images"]), fused_blocks=blocks)
    refs["spatial_pp"] = _spatial(case, None)["pp"]
    mesh8 = jax_mesh.make_mesh(8)
    x = jnp.asarray(case["images"])
    refs["jax_head"] = {k: np.asarray(jax.device_get(detect_quant_dp(jd, mesh8, q)(x)),
                                      np.float32) for k, q in jq.items()}
    staged, packed, reg, (wh, ww) = case["roi"]

    def embed(crops):
        return ji.embed(iparams, istate, crops, train=False)[0]

    refs["jax_roi"] = np.asarray(identify_roi_dp(embed, mesh8, image_size=S, window_h=wh,
                                                 window_w=ww)(
        jnp.asarray(staged), jnp.asarray(packed), jnp.asarray(reg)))
    folded = jd.fold(params, state)
    xs = jnp.asarray(case["spatial_images"])
    refs["jax_spatial"] = {m: np.asarray(jax_spatial.detect_spatial(
        jd, jax_mesh.make_mesh(8, model_axis=m), compute_dtype=jnp.float32)(folded, xs))
        for m in (2, 4)}
    return refs


# ------------------------------------------------------------------ checks

def _serving_runs(runs):
    """(label, rank results) of every DP serving run: 2 ranks over data 2,
    4 ranks over data 2 x model 2."""
    return [("d2", [r["serve"] for r in runs["ranks"][2]]),
            ("d2m2", [r["serve_d2m2"] for r in runs["ranks"][4]])]


@pytest.mark.parametrize("qp", ["full", "tail"])
def test_detect_quant_dp_equals_one_process_bit_for_bit(runs, qp):
    """Every rank returns the whole batch's head and candidates, equal bit
    for bit to one process (full int8 with the fused blocks; the mixed
    bf16-tail qparams with its Python-int tail_start)."""
    one = runs["refs"]["serve"]
    for label, results in _serving_runs(runs):
        for r in results:
            assert torch.equal(r[f"head_{qp}"], one[f"head_{qp}"]), label
            for got, want in zip(r[f"pp_{qp}"], one[f"pp_{qp}"]):
                assert torch.equal(got, want), label
    assert one[f"head_{qp}"].shape == (SERVE_B, S // 32, S // 32, 6)


def test_dp_serving_runs_one_program_per_shape_and_mesh(runs):
    """detect_quant_dp and identify_roi_dp replay one program per key: the
    rank's input shape and `mesh.mesh_key` (the mesh's shape, the rank's
    coordinates); one process keys on the shape alone."""
    staged = runs["refs"]["serve"]["roi"]
    assert staged.shape == (1, BUCKET, 2)
    for label, results, shape in (("d2", runs["ranks"][2], (2, 1)),
                                  ("d2m2", runs["ranks"][4], (2, 2))):
        for rank, r in enumerate(results):
            coords = (rank // shape[1], rank % shape[1])
            keys = (r["serve"] if label == "d2" else r["serve_d2m2"])["keys"]
            mesh = ("mesh", shape, coords)
            assert keys[:2] == [("dp-detect", (SERVE_B // 2, S, S, 3), *mesh)] * 2, label
            assert keys[2][0] == "dp-roi" and keys[2][-3:] == mesh, label
            assert keys[2][3] == (1, BUCKET // 2, keys[2][3][2]), label
    assert runs["refs"]["serve"]["keys"][0] == ("dp-detect", (SERVE_B, S, S, 3))


@pytest.mark.parametrize("qp", ["full", "tail"])
def test_dp_detect_program_equals_the_eager_int8_forward(runs, qp):
    """The DP detect program's head equals the single-process eager int8
    forward (`apply_quant` on the whole batch) bit for bit."""
    want = runs["refs"][f"eager_head_{qp}"]
    for label, results in _serving_runs(runs):
        for r in results:
            assert torch.equal(r[f"head_{qp}"], want), label


@pytest.mark.parametrize("qp", ["full", "tail"])
def test_detect_quant_dp_matches_jax(runs, qp):
    """The 2-rank head vs JAX detect_quant_dp on the 8-device mesh with the
    same qparams: within 2e-2 of max |head| (bf16 head conv)."""
    got = runs["ranks"][2][0]["serve"][f"head_{qp}"].numpy()
    want = runs["refs"]["jax_head"][qp]
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_detect_quant_dp_refuses_an_indivisible_batch():
    """B must split evenly over the data axis (the one-process program
    takes any B)."""
    from face_vijnana_yolov3_tpu_torch.parallel.mesh import batch_sharded

    class Two:  # a 2-rank data axis, rank 1
        def __getitem__(self, axis):
            return type("A", (), {"size": lambda self: 2})()

        def get_local_rank(self, axis):
            return 1

    with pytest.raises(ValueError, match="not divisible by the data axis"):
        batch_sharded(torch.zeros(3, 1), Two())
    assert torch.equal(batch_sharded(torch.arange(4), Two()), torch.tensor([2, 3]))


def test_identify_roi_dp_matches_one_process_and_jax(runs):
    """[best_idx, best_dist] rows of the bucket split over the data axis:
    bit for bit against one process, and the JAX identify_roi_dp's indices
    with distances within 1e-5."""
    one = runs["refs"]["serve"]["roi"]
    for label, results in _serving_runs(runs):
        for r in results:
            assert torch.equal(r["roi"], one), label
    want = runs["refs"]["jax_roi"]
    assert one.shape == want.shape == (1, BUCKET, 2)
    np.testing.assert_array_equal(one[..., 0].numpy(), want[..., 0])
    assert np.abs(one[..., 1].numpy() - want[..., 1]).max() <= 1e-5


@pytest.mark.parametrize("split", ["m2", "m4", "d2m2"])
def test_detect_spatial_matches_unsharded_and_jax(runs, split):
    """The height split over 2 and 4 model ranks (a 64-row image over 4
    leaves bands of 0 and 1 rows at the 2-row head grid) and data 2 x
    model 2: every rank's head within 1e-5 of the unsharded program, the
    postprocess counts equal, and the head within 1e-4 of max |head| of
    JAX detect_spatial."""
    results = [r[f"spatial_{split}"] for r in runs["ranks"][2 if split == "m2" else 4]]
    want = runs["refs"]["unsharded"]
    pp = runs["refs"]["spatial_pp"]
    for r in results:
        assert r["head"].shape == want.shape
        assert float((r["head"] - want).abs().max()) <= 1e-5
        assert torch.equal(r["pp"][1], pp[1])
    jax_head = runs["refs"]["jax_spatial"][4 if split == "m4" else 2]
    assert np.abs(results[0]["head"].numpy() - jax_head).max() <= 1e-4 * np.abs(jax_head).max()


def test_init_distributed_contract(monkeypatch):
    """One process with nothing asked for is a no-op; a CUDA group without
    a card raises (NCCL or nothing: no gloo fallback); a mesh needs a group
    and a world divisible by the model axis."""
    from face_vijnana_yolov3_tpu_torch.parallel import mesh as mesh_lib

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_lib.init_distributed() is False
    assert mesh_lib.default_mesh() is None and mesh_lib.world_size() == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.init_distributed("localhost:1", 1, 0)
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.init_distributed()
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        mesh_lib.make_mesh(model_axis=2)
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh_lib.make_mesh()


def test_bands_cover_every_row_once():
    """The even bands of every level partition its rows, and each 3x3
    conv's needed input rows are those its output band reads."""
    from face_vijnana_yolov3_tpu_torch.parallel.spatial import _needed, band

    for h in (1, 2, 3, 13, 64, 416):
        for m in (1, 2, 3, 4, 8):
            rows = [r for i in range(m) for r in range(*band(h, m, i))]
            assert rows == list(range(h))
    assert _needed(6, 13, 2, 26) == (11, 26)
    assert _needed(0, 7, 1, 13) == (0, 8)
    assert _needed(3, 3, 1, 13) == (0, 0)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
