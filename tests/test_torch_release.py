"""The release loop of the PyTorch port (face_vijnana_yolov3_tpu_torch/
scripts/, core/checkpoints.checkpoint_exists, models/quant.
int8_error_profile) vs the JAX package and the JAX repo's scripts/, on the
CPU.

The same numpy weights (the JAX package's init or its perturbed BN, through
`convert.params_from_jax`) and the same seeded JPEGs go through both.
Tolerances, each measured here (in brackets):
- int8_error_profile at the JAX test's 96² setup (tests/test_quant.py:471):
  the same convs in the same order, each relative error within 1e-5
  relative [3.3e-6]. Both walks carry the same int8 activations; the rest
  is f32 rounding: the f32 twin's convs sum in another order, and the JAX
  walk takes its means in f32 over ~3e5 elements (against the port's own
  walk in f64 the JAX values sit 3.3e-6 away, the port's f32 ones 1.7e-6;
  at 64² one conv's JAX mean lands 2e-5 away, so the setup matters).
- select_tail on a stubbed AP table: the same choice and table, except on
  the constructed near-tie named in its case.
- measure_tail_ap at f32 and int8 tails 0 and 1 (each package calibrating
  itself on the same first batch): the same AP50 [equal], and 0.0 on an
  empty CSV.
- The recipe's bookkeeping with the pipeline stubbed: the same chunks,
  confs and meta json (the port's meta adds recipe_ver).
- A real two-phase run at 64² (2 plain epochs at lr 1e-4 from shared
  weights, then 1 fake-quant epoch --init-from them, 8 images, one step an
  epoch), each step's loss within a bound of tests/test_torch_train.py:
  the first step, from the same weights, its f32 rtol 1e-5 [equal to 7
  digits]; the later ones its fake-quant rtol 1e-3 [plain 4.6e-5,
  fake-quant 3.7e-4], because the weights have parted: Keras Adam's first
  update moves each parameter by about lr times the sign of its
  gradient, and where a gradient is near 0 the two packages' rounding can
  give it opposite signs (1-2 % of the parameters at 416²), the
  same kind of flip as a fake-quant rounding point.
- Recipe v3 for tens of epochs at 64² (30 plain + 10 fake-quant, 48
  images, 3 steps an epoch) from the same weights: each epoch's mean loss
  within 15 % of JAX's [6.7 %], the held-out f32 AP50 of each phase within
  0.1 [0.030 on 16 images]: the runs part chaotically after the first
  steps (above), so a tolerance on the curve, not on a step.
- top1_acc on the same identifier weights and crops: the same right/wrong
  per crop and accuracy, distances within 1e-5 [4e-7].
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from face_vijnana_yolov3_tpu.api import config as jax_config
from face_vijnana_yolov3_tpu.api import face_detection as jax_fd
from face_vijnana_yolov3_tpu.core import checkpoints as jax_checkpoints
from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu.models.detector import FaceDetectorModel as JaxModel
from face_vijnana_yolov3_tpu.utils import runtime as jax_runtime
from face_vijnana_yolov3_tpu_torch.api import config, face_detection, face_identification
from face_vijnana_yolov3_tpu_torch.convert import (
    folded_from_jax,
    identifier_params_from_jax,
    params_from_jax,
    qparams_from_jax,
)
from face_vijnana_yolov3_tpu_torch.core.checkpoints import (
    checkpoint_exists,
    load_train_meta,
    save_checkpoint,
)
from face_vijnana_yolov3_tpu_torch.data import synthetic
from face_vijnana_yolov3_tpu_torch.data.facedb import facial_ids
from face_vijnana_yolov3_tpu_torch.evals import identification
from face_vijnana_yolov3_tpu_torch.evals.detection import map_sweep, match_images
from face_vijnana_yolov3_tpu_torch.models import darknet, quant
from face_vijnana_yolov3_tpu_torch.models.detector import FaceDetectorModel
from face_vijnana_yolov3_tpu_torch.scripts import (
    release_ap,
    select_serving_tail,
    synthetic_e2e,
    synthetic_fi_e2e,
    train_qat_recipe,
)

from test_torch_folded import perturbed_params
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)
face_detection.DEBUG = jax_fd.DEBUG = False

PROFILE_RTOL = 1e-5
F32_LOSS_RTOL = 1e-5  # tests/test_torch_train.py TOL["float32"]
UPDATED_LOSS_RTOL = 1e-3  # tests/test_torch_train.py TOL["fakequant"] / ["bfloat16"]
DIST_ATOL = 1e-5
S = 64
TOOLS = (train_qat_recipe, select_serving_tail, release_ap, synthetic_e2e,
         synthetic_fi_e2e)


def _jax_script(name):
    """A module of the JAX repo's scripts/ (not a package), loaded by path."""
    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _small(cls, **over):
    """An FdConf class at image_size S (and the given hps), for the tools
    that build their confs inside."""
    @dataclasses.dataclass
    class Small(cls):
        def __post_init__(self):
            self.nn_arch.image_size = S
            for k, v in over.items():
                setattr(self.hps, k, v)
    return Small


# ------------------------------------------------------------------ checkpoint_exists


def test_checkpoint_exists(tmp_path):
    path = str(tmp_path / "ck.pt")
    assert not checkpoint_exists(path)
    save_checkpoint(path, {"w": torch.zeros(2)})
    assert checkpoint_exists(path)
    os.mkdir(tmp_path / "orbax_dir")  # the JAX package's layout is not a .pt
    assert not checkpoint_exists(str(tmp_path / "orbax_dir"))
    assert jax_checkpoints.checkpoint_exists(str(tmp_path / "orbax_dir"))


# ------------------------------------------------------------------ int8_error_profile


@pytest.fixture(scope="module")
def trunk_setup():
    """tests/test_quant.py's trunk_setup, with the JAX package's qparams."""
    m = JaxModel(image_size=96)
    params, state = m.init(jax.random.PRNGKey(0))
    folded = jax.device_get(m.fold(params, state))
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (2, 96, 96, 3)))
    q = jax.device_get(m.quantize(folded, x))
    return m, folded, x, q


def test_int8_error_profile_matches_jax(trunk_setup):
    """One relative error per int8 conv in op order, each within
    PROFILE_RTOL of the JAX package's; a poisoned kernel (conv_5's int8
    weights x8, clipped) is the top error, as in the JAX test."""
    m, folded, x, q = trunk_setup
    want = jax_quant.int8_error_profile(q, folded, x, m.ops)
    got = quant.int8_error_profile(qparams_from_jax(q), folded_from_jax(folded),
                                   torch.from_numpy(x), m.ops)
    assert list(got) == list(want) == [op[1] for op in m.ops if op[0] == "conv"]
    for k, w in want.items():
        assert np.isfinite(got[k]) and got[k] >= 0
        assert got[k] == pytest.approx(w, rel=PROFILE_RTOL), k

    bad = qparams_from_jax(q)
    bad["conv_5"] = dict(bad["conv_5"])
    bad["conv_5"]["kernel_q"] = torch.clamp(
        bad["conv_5"]["kernel_q"].to(torch.int16) * 8, -127, 127).to(torch.int8)
    prof = quant.int8_error_profile(bad, folded_from_jax(folded), torch.from_numpy(x),
                                    m.ops)
    assert max(prof, key=prof.get) == 5


def test_int8_error_profile_honours_the_tail_and_islands(trunk_setup):
    """A bf16 tail stops the walk at its cut (a tail_start of 0 profiles
    nothing), and bf16-island convs get no row, as the JAX walk's rules."""
    m, folded, x, _ = trunk_setup
    pm_folded = folded_from_jax(folded)
    xs = torch.from_numpy(x[:1])
    q = quant.quantize_folded(pm_folded, xs, m.ops, bf16_tail_blocks=2)
    cut = q["tail_start"]
    prof = quant.int8_error_profile(q, pm_folded, xs, m.ops)
    assert list(prof) == [op[1] for op in m.ops[:cut] if op[0] == "conv"]
    assert quant.int8_error_profile(dict(q, tail_start=0), pm_folded, xs, m.ops) == {}
    q = quant.quantize_folded(pm_folded, xs, m.ops, bf16_ops=(1, 5))
    prof = quant.int8_error_profile(q, pm_folded, xs, m.ops)
    assert list(prof) == [op[1] for op in m.ops if op[0] == "conv" and op[1] not in (1, 5)]
    assert all(np.isfinite(v) and v >= 0 for v in prof.values())


# ------------------------------------------------------------------ select_tail


@pytest.mark.parametrize("case", ["first_clears", "none_clears", "f32_given", "near_tie"])
def test_select_tail_matches_jax(case, monkeypatch):
    """select_tail on the same stubbed AP table in both modules (tail None =
    f32): the first tail within the drift bar; none within it (the best
    falls back); f32 given instead of measured (it is not measured); and
    the near-tie. There AP50 is 0.70004 at tail 0 and 0.70002 at tail 3,
    2e-5 apart and both rounding to 0.7000, with f32 far above: the JAX
    script compares tail 3's unrounded 0.70002 with tail 0's rounded
    0.7000 and falls back to tail 3; the port ranks the unrounded APs and
    falls back to tail 0, the better one. Only this case differs."""
    tables = {
        "first_clears": ({None: 0.91, 0: 0.90, 3: 0.905, 4: 0.91}, (0, 3, 4), None),
        "none_clears": ({None: 0.91, 0: 0.80, 3: 0.86, 4: 0.84}, (0, 3, 4), None),
        "f32_given": ({0: 0.70, 3: 0.885, 4: 0.89}, (0, 3, 4), 0.90),
        "near_tie": ({None: 0.90, 0: 0.70004, 3: 0.70002}, (0, 3), None),
    }
    aps, tails, f32 = tables[case]
    jax_sel = _jax_script("select_serving_tail")
    calls = {"jax": [], "port": []}

    def stub(who):
        def measure(workdir, ckpt_name, tail, **_):
            calls[who].append(tail)
            return aps[tail]
        return measure

    monkeypatch.setattr(jax_sel, "measure_tail_ap", stub("jax"))
    monkeypatch.setattr(select_serving_tail, "measure_tail_ap", stub("port"))
    want = jax_sel.select_tail("w", "ck", tails, f32_ap50=f32, log=lambda *_: None)
    got = select_serving_tail.select_tail("w", "ck", tails, f32_ap50=f32,
                                          log=lambda *_: None)
    assert got[1] == want[1] and calls["port"] == calls["jax"]
    if case == "near_tie":
        assert want[0] == 3 and got[0] == 0
    else:
        assert got[0] == want[0]
    assert got[0] == {"first_clears": 0, "none_clears": 3, "f32_given": 3,
                      "near_tie": 0}[case]


# ------------------------------------------------------------------ measure_tail_ap


@pytest.fixture(scope="module")
def valset(tmp_path_factory):
    """4 seeded val JPEGs (make_dataset at 128²) with seeded weights saved
    for both packages."""
    root = tmp_path_factory.mktemp("release")
    work = str(root / "work")
    synthetic.make_dataset(work, n_train=0, n_val=4, image_size=128, seed=3)
    valdir = synthetic_e2e.make_valset(work)
    # Seeded kernels with seeded BN statistics whose scores spread around
    # 0.25 (tests/test_torch_int8_pipeline.py's weights).
    model = FaceDetectorModel(image_size=S, device="cpu")
    params, state = darknet.perturb_batchnorm(*model.init_params(0), model.ops, 1)
    save_checkpoint(os.path.join(work, "ck.pt"), params_from_jax(params, state))
    jax_checkpoints.save_checkpoint(os.path.join(work, "ck"),
                                    {"params": params, "state": state})
    return dict(work=work, valdir=valdir, weights=(params, state))


@pytest.fixture
def small_confs(monkeypatch):
    def use(**over):
        monkeypatch.setattr(jax_config, "FdConf", _small(jax_config.FdConf, **over))
        for tool in TOOLS:
            if hasattr(tool, "FdConf"):
                monkeypatch.setattr(tool, "FdConf", _small(config.FdConf, **over))
    return use


@pytest.mark.parametrize("tail", [None, pytest.param(0, marks=pytest.mark.slow),
                                  pytest.param(1, marks=pytest.mark.slow)])
def test_measure_tail_ap_matches_jax(tail, valset, small_confs, monkeypatch):
    """AP50 at f32 and at full int8 (tail 0) equal to the JAX script's,
    each package serving its own checkpoint of the same weights; at tail 1
    the solution rows within the int8 pipeline test's rule. The GT rows are
    the top non-degenerate box of each image in the port's f32 CSV, so that
    the APs are not 0 by construction. The int8 cases are marked slow: the
    JAX package's int8 program compiles for ~20 s of the CPU each."""
    small_confs(face_conf_th=0.05)
    work, valdir = valset["work"], valset["valdir"]
    jax_sel = _jax_script("select_serving_tail")
    select_serving_tail.measure_tail_ap(work, "ck", None, device="cpu")
    sol = pd.read_csv(os.path.join(work, "solution_seltail_f32.csv"), header=None)
    sol = sol[(sol[3] > 0) & (sol[4] > 0)]  # random heads give zero-area boxes too
    top = sol.sort_values(5, ascending=False).groupby(0).head(1)
    pd.DataFrame({"FACE_ID": range(len(top)), "FILE": top[0].to_numpy(),
                  "SUBJECT_ID": 1, "FACE_X": top[1].to_numpy(), "FACE_Y": top[2].to_numpy(),
                  "FACE_WIDTH": top[3].to_numpy(), "FACE_HEIGHT": top[4].to_numpy()}
                 ).to_csv(os.path.join(valdir, "validation.csv"), index=False)
    # int8: the port calibrates with the JAX package's scales on the same
    # batch (their own agree to rtol 1e-4, tests/test_torch_quant.py, and
    # one requant apart moves a 2 px box at 64²), so both serve the same
    # integer trunk and the bf16 heads alone differ.
    jm = JaxModel(image_size=S)
    jax_folded = jax.device_get(jm.fold(*valset["weights"]))
    monkeypatch.setattr(quant, "calibrate_folded", lambda folded, x, ops, **kw:
                        jax_quant.calibrate_folded(jax_folded, np.asarray(x.cpu()), ops,
                                                   **kw))
    sol = os.path.join(work, f"solution_seltail_{'f32' if tail is None else f'tail{tail}'}.csv")
    want = jax_sel.measure_tail_ap(work, "ck", tail)
    want_rows = pd.read_csv(sol, header=None)
    got = select_serving_tail.measure_tail_ap(work, "ck", tail, device="cpu")
    got_rows = pd.read_csv(sol, header=None)
    if tail == 1:
        # The bf16 tail block and head sum in another order in each
        # package: the rows of tests/test_torch_int8_pipeline.py's rule
        # (files and counts equal, box corners within one letterbox pixel,
        # 128 / S px of these originals, scores within 1e-2); a box of these
        # random heads is 2-16 px, so a pixel moves its IoU across 0.5 and
        # the AP50s are not compared.
        def corners(r):
            x, y, w, h = (r[c].to_numpy() for c in (1, 2, 3, 4))
            return np.stack([x, y, x + w, y + h], axis=1)

        assert got_rows[0].tolist() == want_rows[0].tolist()
        np.testing.assert_allclose(corners(got_rows), corners(want_rows), rtol=0,
                                   atol=128 / S)
        np.testing.assert_allclose(got_rows[5], want_rows[5], rtol=0, atol=1e-2)
    else:
        assert got == want
        assert 0.0 < got <= 1.0


def test_measure_tail_ap_scores_an_empty_csv_as_zero(valset, small_confs):
    """A threshold no detection clears writes an empty CSV: AP 0.0 in both."""
    small_confs(face_conf_th=1.1)
    jax_sel = _jax_script("select_serving_tail")
    for tail in (None, 0):
        assert select_serving_tail.measure_tail_ap(valset["work"], "ck", tail,
                                                   device="cpu") == 0.0
    assert jax_sel.measure_tail_ap(valset["work"], "ck", None) == 0.0
    assert os.path.getsize(os.path.join(valset["work"], "solution_seltail_f32.csv")) == 0


# ------------------------------------------------------------------ the recipe


class _StubPipeline:
    """Records the conf each chunk trains with; train() writes the
    checkpoint in its package's layout (a directory or a .pt file)."""

    def __init__(self, seen, make):
        self.seen, self.make = seen, make

    def __call__(self, conf, **kw):
        self.conf = conf
        return self

    def train(self):
        c = self.conf
        self.seen.append((c.hps.epochs, c.hps.lr, c.train_qat, c.model_loading,
                          c.hps.batch_size, c.checkpoint_every, c.dataset_cache))
        self.make(c.model_path)
        return [1.0, 0.5]


def _touch(path):
    open(path, "a").close()


@pytest.mark.parametrize("run", ["plain_250", "init_from"])
def test_recipe_bookkeeping_matches_jax(run, tmp_path, monkeypatch):
    """The chunks (epochs, lr, train_qat, model_loading, batch_size,
    checkpoint_every, dataset_cache) and the meta json against the JAX
    script, the pipeline stubbed in both: a plain run to 250 epochs
    (chunks 120/120/10), and a finetune seeded --init-from a plain
    checkpoint (copied with its sidecar) at lr 1e-4."""
    argv = {"plain_250": ["250", "--plain"],
            "init_from": ["100", "--init-from", "fd_ckpt_plain", "--lr", "1e-4"]}[run]
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jax_runtime, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(jax_fd, "FaceDetectorPipeline",
                        _StubPipeline(seen["jax"], lambda p: os.makedirs(p, exist_ok=True)))
    monkeypatch.setattr(train_qat_recipe, "FaceDetectorPipeline",
                        _StubPipeline(seen["port"], _touch))
    dirs = {who: tmp_path / who for who in seen}
    for who, d in dirs.items():
        d.mkdir()
        (d / "training.csv").write_text("FACE_ID,FILE\n")
    sidecar = {"qat": False, "int8_tail": 3}
    if run == "init_from":  # the converged plain artifact, in each layout
        os.mkdir(dirs["jax"] / "fd_ckpt_plain")
        _touch(dirs["port"] / "fd_ckpt_plain.pt")
        for src in (dirs["jax"] / "fd_ckpt_plain", dirs["port"] / "fd_ckpt_plain.pt"):
            Path(str(src) + ".trainmeta.json").write_text(json.dumps(sidecar))

    monkeypatch.setattr(sys, "argv", ["train_qat_recipe.py", str(dirs["jax"])] + argv)
    _jax_script("train_qat_recipe").main()
    meta, losses = train_qat_recipe.main([str(dirs["port"])] + argv + ["--device", "cpu"])

    assert seen["port"] == seen["jax"]
    want_chunks = {"plain_250": [(120, 1e-3, False, False), (120, 1e-3, False, True),
                                 (10, 1e-3, False, True)],
                   "init_from": [(100, 1e-4, True, True)]}[run]
    assert [s[:4] for s in seen["port"]] == want_chunks
    assert all(s[4:] == (16, 20, "disk") for s in seen["port"])
    name = {"plain_250": "meta_plain.json", "init_from": "meta_qat.json"}[run]
    want = json.loads((dirs["jax"] / name).read_text())
    got = json.loads((dirs["port"] / name).read_text())
    assert got == meta and got.pop("recipe_ver") == 3
    assert set(got) == set(want) and got["epochs_done"] == want["epochs_done"]
    assert losses == [1.0, 0.5] * len(want_chunks)
    if run == "init_from":
        assert json.loads((dirs["jax"] / "fd_ckpt_qat.trainmeta.json").read_text()) == \
            load_train_meta(str(dirs["port"] / "fd_ckpt_qat.pt")) == sidecar


@pytest.mark.slow
def test_two_phase_run_matches_jax(tmp_path, monkeypatch):
    """Recipe v3 for real at 64² on 8 images (one step an epoch): 2 plain
    epochs from the same weights (placed as the plain checkpoint, which the
    recipe resumes), then 1 fake-quant epoch --init-from it at lr 1e-4 in
    both packages; each step's loss within test_torch_train's bounds.
    Marked slow: the JAX package's two train-step compiles take ~60 s of
    the CPU (test_recipe_bookkeeping_matches_jax holds the same loop with
    the pipeline stubbed, test_tool_mains_run_on_the_cpu runs it for
    real)."""
    monkeypatch.setattr(jax_runtime, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(jax_config, "FdConf", _small(jax_config.FdConf))
    monkeypatch.setattr(train_qat_recipe, "FdConf", _small(config.FdConf))
    model = FaceDetectorModel(image_size=S, device="cpu")
    params, state = darknet.perturb_batchnorm(*model.init_params(1), model.ops, 2)
    losses = {}
    for who in ("jax", "port"):
        work = str(tmp_path / who)
        synthetic.make_dataset(work, n_train=8, n_val=0, image_size=128, seed=5)
        if who == "jax":
            jax_checkpoints.save_checkpoint(os.path.join(work, "fd_ckpt_plain"),
                                            {"params": params, "state": state})
            jax_recipe = _jax_script("train_qat_recipe")
            history = []
            real = jax_fd.FaceDetectorPipeline

            class Recording(real):
                def train(self):
                    out = super().train()
                    history.extend(out)
                    return out

            monkeypatch.setattr(jax_fd, "FaceDetectorPipeline", Recording)
            for argv in (["2", "--plain", "--lr", "1e-4"],
                         ["1", "--init-from", "fd_ckpt_plain", "--lr", "1e-4"]):
                monkeypatch.setattr(sys, "argv", ["train_qat_recipe.py", work] + argv)
                jax_recipe.main()
            losses[who] = [float(v) for v in history]
        else:
            save_checkpoint(os.path.join(work, "fd_ckpt_plain.pt"),
                            params_from_jax(params, state))
            _, lp = train_qat_recipe.main([work, "2", "--plain", "--lr", "1e-4",
                                           "--device", "cpu"])
            _, lq = train_qat_recipe.main([work, "1", "--init-from", "fd_ckpt_plain",
                                           "--lr", "1e-4", "--device", "cpu"])
            losses[who] = lp + lq
            assert load_train_meta(os.path.join(work, "fd_ckpt_qat.pt")) == {"qat": True}
    got, want = losses["port"], losses["jax"]
    assert len(got) == len(want) == 3
    assert got[0] == pytest.approx(want[0], rel=F32_LOSS_RTOL)
    assert got[1:] == pytest.approx(want[1:], rel=UPDATED_LOSS_RTOL)


PARITY_PLAIN, PARITY_FT, PARITY_TRAIN, PARITY_VAL = 30, 10, 48, 16
CURVE_RTOL = 0.15  # an epoch's mean loss, port vs JAX [0.067 over 40 epochs]
CURVE_AP_ATOL = 0.1  # held-out f32 AP50 on PARITY_VAL images at 64² [0.030]


@pytest.mark.slow
def test_recipe_tracks_jax_over_tens_of_epochs(tmp_path, small_confs, monkeypatch):
    """Recipe v3 as the tools run it, at 64² for tens of epochs, in both
    packages from the same weights and the same seeded data: PARITY_PLAIN
    plain epochs at the recipe's lr 1e-3 (the weights placed as the plain
    checkpoint, which the recipe resumes), then PARITY_FT fake-quant epochs
    at 1e-4 --init-from it, 3 steps an epoch; then the held-out f32 AP50
    of both phases' checkpoints (measure_tail_ap). The runs part after a
    few steps (test_two_phase_run_matches_jax: Adam's sign flips), so the
    curves are compared by epoch means, each within CURVE_RTOL of JAX's,
    and the APs within CURVE_AP_ATOL. Prints both curves and the APs.
    Marked slow: ~2 x 120 training steps of the full detector on the CPU
    (~13 min)."""
    small_confs()
    monkeypatch.setattr(jax_runtime, "enable_compile_cache", lambda *a, **k: None)
    model = FaceDetectorModel(image_size=S, device="cpu")
    params, state = model.init_params(0)
    jax_recipe, jax_sel = _jax_script("train_qat_recipe"), _jax_script("select_serving_tail")
    history = []
    real = jax_fd.FaceDetectorPipeline

    class Recording(real):
        def train(self):
            out = super().train()
            history.extend(float(v) for v in out)
            return out

    monkeypatch.setattr(jax_fd, "FaceDetectorPipeline", Recording)
    phases = (([str(PARITY_PLAIN), "--plain"], PARITY_PLAIN, "fd_ckpt_plain"),
              ([str(PARITY_FT), "--init-from", "fd_ckpt_plain", "--lr", "1e-4"], PARITY_FT,
               "fd_ckpt_qat"))
    curves, aps = {}, {}
    for who in ("jax", "port"):
        work = str(tmp_path / who)
        synthetic.make_dataset(work, n_train=PARITY_TRAIN, n_val=PARITY_VAL,
                               image_size=128, seed=0)
        synthetic_e2e.make_valset(work)
        if who == "jax":
            jax_checkpoints.save_checkpoint(os.path.join(work, "fd_ckpt_plain"),
                                            {"params": params, "state": state})
        else:
            save_checkpoint(os.path.join(work, "fd_ckpt_plain.pt"),
                            params_from_jax(params, state))
        for argv, epochs, ckpt in phases:
            if who == "jax":
                history.clear()
                monkeypatch.setattr(sys, "argv", ["train_qat_recipe.py", work] + argv)
                jax_recipe.main()
                losses = list(history)
                ap = jax_sel.measure_tail_ap(work, ckpt, None)
            else:
                _, losses = train_qat_recipe.main([work] + argv + ["--device", "cpu"])
                ap = select_serving_tail.measure_tail_ap(work, ckpt, None, device="cpu")
            steps = len(losses) // epochs
            curves[who, ckpt] = np.asarray(losses).reshape(epochs, steps).mean(axis=1)
            aps[who, ckpt] = ap
    for _, _, ckpt in phases:
        j, p = curves["jax", ckpt], curves["port", ckpt]
        print(f"\n[{ckpt}] epoch-mean loss, JAX | port | port/JAX:")
        for e, (a, b) in enumerate(zip(j, p)):
            print(f"  {e + 1:3d} {a:.6f} {b:.6f} {b / a:.4f}")
        print(f"[{ckpt}] held-out f32 AP50 on {PARITY_VAL} images: JAX "
              f"{aps['jax', ckpt]:.4f}, port {aps['port', ckpt]:.4f}")
    for _, _, ckpt in phases:
        for who in ("jax", "port"):
            assert curves[who, ckpt][-1] < curves[who, ckpt][0], (who, ckpt)
        np.testing.assert_allclose(curves["port", ckpt], curves["jax", ckpt],
                                   rtol=CURVE_RTOL, err_msg=ckpt)
        assert aps["port", ckpt] == pytest.approx(aps["jax", ckpt], abs=CURVE_AP_ATOL), ckpt


# ------------------------------------------------------------------ FI: top1_acc, VAL/FAR


@pytest.fixture(scope="module")
def fi_pair(tmp_path_factory):
    """A JAX and a port FaceIdentifierPipeline with the same identifier
    weights (random init, 64², dense1 8), a 3-subject tree's subject DB
    and its held-out crops."""
    from face_vijnana_yolov3_tpu.api.config import Conf as JaxConf
    from face_vijnana_yolov3_tpu.api.face_identification import (
        FaceIdentifierPipeline as JaxFi,
    )
    from face_vijnana_yolov3_tpu.data import facedb as jax_facedb

    root = tmp_path_factory.mktemp("fi")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        holdout = synthetic.make_fi_tree(str(root), 3, seed=0, image_size=96,
                                         face_sizes=(30, 60), train_per_subj=3,
                                         hold_per_subj=2)
        crops, sids = synthetic.holdout_crops(holdout, S)
        jax_facedb.create_subject_db_uccs(str(root), image_size=S)
        confs = []
        for cls in (JaxConf, config.Conf):
            conf = cls()
            conf.fi_conf.raw_data_path = str(root)
            conf.fi_conf.weights_path = "missing.weights"
            conf.fi_conf.nn_arch.image_size = S
            conf.fi_conf.nn_arch.dense1_dim = 8
            conf.fd_conf.weights_path = "missing.weights"
            conf.fd_conf.nn_arch.image_size = S
            confs.append(conf)
        jfi = JaxFi(confs[0])
        pfi = face_identification.FaceIdentifierPipeline(confs[1], device="cpu")
        pfi.model.load_state_dict(identifier_params_from_jax(
            *jax.device_get((jfi.params, jfi.state))))
        registry = pfi.register_facial_ids()
        pfi.make_facial_ids_db()
    finally:
        os.chdir(cwd)
    return dict(root=root, jfi=jfi, pfi=pfi, crops=crops, sids=sids, registry=registry)


def test_top1_acc_matches_jax(fi_pair):
    """Per crop right or wrong, the accuracy, and the match distances
    (DIST_ATOL) of the port's top1_acc against the JAX script's on the same
    weights, crops and registry."""
    jax_fi_e2e = _jax_script("synthetic_fi_e2e")
    jfi, pfi, crops, sids, reg = (fi_pair[k] for k in ("jfi", "pfi", "crops", "sids",
                                                       "registry"))
    acc, dists = synthetic_fi_e2e.top1_acc(pfi, crops, sids, reg)
    want_acc, want_dists = jax_fi_e2e.top1_acc(jfi, crops, sids, reg)
    assert acc == want_acc
    np.testing.assert_allclose(dists, np.asarray(want_dists), rtol=0, atol=DIST_ATOL)
    right = [synthetic_fi_e2e.top1_acc(pfi, crops[k:k + 1], sids[k:k + 1], reg)[0]
             for k in range(len(sids))]
    want_right = [jax_fi_e2e.top1_acc(jfi, crops[k:k + 1], sids[k:k + 1], reg)[0]
                  for k in range(len(sids))]
    assert right == want_right and np.mean(right) == acc


def test_val_far_in_memory_equals_cal_val_far(fi_pair, monkeypatch):
    """Without h5py the FI loop gives cal_VAL_FAR the embeddings in memory
    (facedb.facial_ids as a mapping of face file to embedding): the same
    pairs, distances and rates as over the ids h5 (both on one seeded draw
    of different-subject pairs)."""
    monkeypatch.chdir(fi_pair["root"])
    pfi = fi_pair["pfi"]
    want = identification.cal_VAL_FAR(synthetic_fi_e2e.SIM_THS, out_h5=None,
                                      rng=np.random.default_rng(4))
    ids = {ff: emb for _, ff, emb in facial_ids(pfi.embed, pfi.conf.raw_data_path)}
    assert len(ids) == 9
    got = identification.cal_VAL_FAR(synthetic_fi_e2e.SIM_THS, out_h5=None, ids_h5=ids,
                                     rng=np.random.default_rng(4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ release_ap


def test_per_image_matches_reproduce_the_harness(tmp_path):
    """AP50 over every image from the harness's per-image matches
    (evals/detection.match_images) equals map_sweep's; the bootstrap
    interval holds it and is seeded, and an empty CSV gives (0, 0)."""
    gt = tmp_path / "gt.csv"
    sol = tmp_path / "sol.csv"
    rng = np.random.default_rng(2)
    gt_rows, sol_rows = [], []
    for i in range(12):
        for j in range(int(rng.integers(1, 3))):
            x, y = rng.uniform(0, 200, 2)
            gt_rows.append({"FACE_ID": len(gt_rows), "FILE": f"v{i}.jpg", "SUBJECT_ID": 1,
                            "FACE_X": x, "FACE_Y": y, "FACE_WIDTH": 40, "FACE_HEIGHT": 50})
            for _ in range(3):
                dx, dy = rng.normal(0, 15, 2)
                sol_rows.append(f"v{i}.jpg,{x + dx},{y + dy},40,50,{rng.uniform()}")
    sol_rows.append("v_absent.jpg,1,1,5,5,0.9")
    pd.DataFrame(gt_rows).to_csv(gt, index=False)
    sol.write_text("\n".join(sol_rows) + "\n")
    matches, counts = match_images(str(gt), str(sol))
    want = map_sweep(str(gt), str(sol), out_h5=None)[2][0]
    assert release_ap.ap50_of(matches, counts, np.arange(len(matches))) == \
        pytest.approx(want, rel=1e-12)
    lo, hi = release_ap.bootstrap_ap50(str(gt), str(sol), resamples=50)
    assert 0.0 <= lo <= want <= hi <= 1.0 and lo < hi
    assert release_ap.bootstrap_ap50(str(gt), str(sol), resamples=50) == (lo, hi)
    sol.write_text("")
    assert release_ap.bootstrap_ap50(str(gt), str(sol), resamples=20) == (0.0, 0.0)


# ------------------------------------------------------------------ the tools' mains


def test_tool_mains_run_on_the_cpu(tmp_path, small_confs, monkeypatch):
    """Each tool's main with --device cpu at a tiny scale: the detection
    loop, recipe v3 (plain, then --init-from), select_serving_tail (its
    pin lands in the sidecar) and release_ap (the int8 pass serves the
    pin), and the FI loop at 64². Each stage's workdir is removed once
    checked: a detector checkpoint with its Adam state is ~490 MB at any
    image size, and the suite keeps its temporary files to the end."""
    small_confs(face_conf_th=0.05)
    monkeypatch.chdir(tmp_path)
    maps = synthetic_e2e.main([str(tmp_path / "e2e"), "1", "4", "2", "--device", "cpu"])
    assert maps.shape == (10,) and np.isfinite(maps).all()
    assert checkpoint_exists(str(tmp_path / "e2e" / "fd_ckpt.pt"))
    shutil.rmtree(tmp_path / "e2e")

    work = str(tmp_path / "rel")
    synthetic.make_dataset(work, n_train=4, n_val=2, image_size=128, seed=0)
    synthetic_e2e.make_valset(work)
    meta, _ = train_qat_recipe.main([work, "1", "--plain", "--device", "cpu"])
    assert meta == {"epochs_done": 1, "sec_per_epoch": meta["sec_per_epoch"],
                    "recipe_ver": 3}
    meta, _ = train_qat_recipe.main([work, "1", "--init-from", "fd_ckpt_plain", "--lr",
                                     "1e-4", "--device", "cpu"])
    assert load_train_meta(os.path.join(work, "fd_ckpt_qat.pt")) == {"qat": True}
    tail, table = select_serving_tail.main([work, "--tails", "0,1", "--drift-bar", "-0.02",
                                            "--device", "cpu"])
    side = load_train_meta(os.path.join(work, "fd_ckpt_qat.pt"))
    assert side["int8_tail"] == tail and side["int8_tail_table"] == \
        {str(k): v for k, v in table.items()}
    out = release_ap.main([work, "--resamples", "20", "--device", "cpu"])
    assert set(out) == {"float32", "bfloat16", "int8"}
    assert out["int8"]["int8_tail"] == tail and out["bfloat16"]["guard_depth"] in (0, 1, 2)
    for r in out.values():
        assert 0.0 <= r["ci95"][0] <= r["ci95"][1] <= 1.0
    shutil.rmtree(work)

    monkeypatch.setattr(synthetic_fi_e2e, "IMG", S)
    fi = synthetic_fi_e2e.main([str(tmp_path / "fi"), "1", "4", "--device", "cpu"])
    assert os.getcwd() == str(tmp_path)
    assert 0.0 <= fi["top1_untrained"] <= 1.0 and 0.0 <= fi["top1"] <= 1.0
    assert fi["losses"] and len(fi["val_far"][0]) == len(synthetic_fi_e2e.SIM_THS)
    assert (tmp_path / "fi" / "subject_facial_ids.h5").exists()
    shutil.rmtree(tmp_path / "fi")


@pytest.mark.parametrize("tool", TOOLS, ids=lambda t: t.__name__.rsplit(".", 1)[-1])
def test_tools_raise_without_a_card(tool, tmp_path, monkeypatch):
    """Without a card and without --device cpu, each tool raises before it
    writes anything (the entry points' rule: no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()
