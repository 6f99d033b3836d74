"""Training through captured programs (core/programs.py, train/trainer.
program_step) and the deterministic training flags, on the CPU.

On the CPU a training program is its eager step, so these tests hold what
the programs are built on: the carry's layout (params, BN state and Adam
state flattened in and out), the key each trainer gives its program, the
donated carry, and the flags `trainer.deterministic` sets and restores.
Each trainer (train_detector, train_identifier, models/qat.distill_folded)
runs twice on the same seeded data: through its program, and with
`program_step` replaced by the eager step it wraps. Params, BN state, Adam
state (the last step's carry) and every loss must be torch.equal: the same
kernels on the same inputs. The models are cut to conv_0..conv_12 at 64²
(a linear 1x1 head for the detector, dense1 of 8 for the identifier) and
the data are in memory, so the file runs in seconds. The JAX-parity tests
of the same steps are tests/test_torch_train.py,
tests/test_torch_train_identifier.py and tests/test_torch_qat.py. The
`test_cuda_*` cases need the card: the same comparisons over 3 steps,
replay against eager bit for bit, two seeded runs bit-equal, and a capture
that syncs with the host raising ProgramError.
"""

import numpy as np
import pytest
import torch
import torch.utils.deterministic  # noqa: F401  (fill_uninitialized_memory)

from face_vijnana_yolov3_tpu_torch.convert import params_from_jax
from face_vijnana_yolov3_tpu_torch.core.programs import ProgramCache, ProgramError
from face_vijnana_yolov3_tpu_torch.models import darknet, qat, quant
from face_vijnana_yolov3_tpu_torch.models.identifier import FaceIdentifierModel
from face_vijnana_yolov3_tpu_torch.train import trainer
from face_vijnana_yolov3_tpu_torch.train.optimizer import AdamState
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)

S = 64
CUT = darknet.trunk_graph()[:16]  # conv_0..conv_12: (B, 64, 64, 3) → (B, 8, 8, 256)
DET_OPS = CUT + [darknet._conv(13, 6, k=1, bn=False, leaky=False), ("output", "head")]
ID_OPS = CUT + [("output", "trunk")]
DENSE = 8


class _Detector:
    """FaceDetectorModel's training interface (`apply_train`) on the cut
    trunk and a linear 1x1 head: (B, 64, 64, 3) → (B, 8, 8, 6)."""

    ops = DET_OPS

    def apply_train(self, params, state, x, **kw):
        outs, new_state = darknet.apply_graph_train(params, state, x, self.ops, **kw)
        return outs["head"], new_state


class _Identifier:
    """FaceIdentifierModel's training interface on the cut trunk + dense1."""

    ops, dense1_dim = ID_OPS, DENSE
    embed_train = FaceIdentifierModel.embed_train
    apply_train = FaceIdentifierModel.apply_train
    triplet_forward = FaceIdentifierModel.triplet_forward


class _Set:
    """In-memory rows in the trainers' dataset interface: batch i is rows
    [i * bs, (i + 1) * bs) of each array, the last one the remainder."""

    def __init__(self, *arrays, codes=()):
        self.arrays, self.codes = arrays, codes

    def steps(self, bs):
        return -(-len(self.arrays[0]) // bs)

    def batch(self, i, bs):
        return tuple(a[i * bs:(i + 1) * bs] for a in self.arrays)

    def batch_subject_codes(self, i, bs):
        return tuple(c[i * bs:(i + 1) * bs] for c in self.codes)


def _params(ops, seed, device):
    params, state = darknet.init_graph_params(ops, seed)
    params, state = darknet.perturb_batchnorm(params, state, ops, seed + 1)
    p, s = darknet.split_state_dict(params_from_jax(params, state))
    return {k: v.to(device) for k, v in p.items()}, {k: v.to(device) for k, v in s.items()}


def _detector_case(device, n=5):
    rng = np.random.default_rng(3)
    ds = _Set(rng.uniform(0, 1, (n, S, S, 3)).astype(np.float32),
              rng.uniform(0, 1, (n, 8, 8, 6)).astype(np.float32))
    return _Detector(), *_params(DET_OPS, 5, device), ds


def _identifier_case(device, n=5):
    rng = np.random.default_rng(4)
    apn = [rng.uniform(0, 1, (n, S, S, 3)).astype(np.float32) for _ in range(3)]
    sa = rng.integers(0, 3, n).astype(np.int32)
    ds = _Set(*apn, codes=(sa, (sa + 1 + rng.integers(0, 2, n)).astype(np.int32) % 3))
    p, s = _params(ID_OPS, 6, device)
    p["dense1.weight"] = torch.from_numpy(
        rng.normal(0, 0.01, (DENSE, 8 * 8 * 256)).astype(np.float32)).to(device)
    p["dense1.bias"] = torch.zeros(DENSE, device=device)
    return _Identifier(), p, s, ds


def _hps(**kw):
    return dict({"lr": 1e-3, "beta_1": 0.99, "beta_2": 0.99, "decay": 0.0, "epochs": 2,
                 "batch_size": 2}, **kw)


def _record(monkeypatch, eager: bool) -> list:
    """Replace trainer.program_step by a wrapper that records each call's
    cache and the last (carry, loss) its step returned; eager=True runs the
    wrapped step itself, the eager reference."""
    seen, real = [], trainer.program_step

    def record(programs, key, step, n_carry):
        rec = {"programs": programs, "key": key}
        seen.append(rec)
        run = step if eager else real(programs, key, step, n_carry)

        def wrapped(*args):
            rec["last"] = run(*args)
            return rec["last"]

        return wrapped

    monkeypatch.setattr(trainer, "program_step", record)
    return seen


def _both(monkeypatch, fn):
    """[(result, records) of fn() through the programs, the same of the
    eager reference]."""
    runs = []
    for eager in (False, True):
        seen = _record(monkeypatch, eager)
        runs.append((fn(), seen))
    return runs


def _assert_carry_equal(got, want):
    like = want[:-1]
    a = trainer._carry_leaves(got[:-1], like)
    b = trainer._carry_leaves(like, like)
    assert len(a) == len(b) > 0
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), i
    assert torch.equal(got[-1], want[-1])


def _train_detector(device, mode, device_data, epochs=2):
    model, p, s, ds = _detector_case(device)
    dtype = torch.bfloat16 if mode == "bfloat16" else torch.float32
    return trainer.train_detector(model, p, s, ds, _hps(epochs=epochs), log_every=0,
                                  finalize_bn=False, compute_dtype=dtype,
                                  fakequant=mode == "fakequant", device_data=device_data)


def _train_identifier(device, mining, remat, dtype, device_data, epochs=2):
    model, p, s, ds = _identifier_case(device)
    return trainer.train_identifier(model, p, s, ds, _hps(epochs=epochs, lr=1e-4),
                                    finalize_bn=False, compute_dtype=dtype,
                                    mining=mining, remat=remat, device_data=device_data)


def _tiny_graph():
    _conv = darknet._conv
    return [_conv(0, 8), ("save", "b0"), _conv(1, 4, k=1), _conv(2, 8),
            ("add", "b0"), _conv(3, 6, bn=False, leaky=False), ("output", "out")]


def _distill(device, tail_blocks, steps=5):
    ops = _tiny_graph()
    params, state = darknet.init_graph_params(ops, 0)
    folded = darknet.fold_graph_params(params_from_jax(params, state), ops)
    folded = {k: {n: t.to(device) for n, t in v.items()} for k, v in folded.items()}
    images = np.random.default_rng(4).uniform(size=(8, 16, 16, 3)).astype(np.float32)
    scales = quant.calibrate_folded(folded, torch.from_numpy(images).to(device), ops)
    return qat.distill_folded(folded, images, ops, act_scales=scales, steps=steps,
                              batch_size=4, lr=1e-3, seed=3, tail_blocks=tail_blocks)


# ------------------------------------------------------------------ the CPU

@pytest.mark.parametrize("device_data", [True, False], ids=["device_data", "streaming"])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "fakequant"])
def test_train_detector_program_equals_eager(monkeypatch, mode, device_data):
    """Through its program, train_detector ends on the eager step's params,
    BN state and Adam state with the same losses; one program, keyed on the
    dtype, fakequant and the batch shapes, whose carry is donated."""
    (got, seen), (want, seen_e) = _both(
        monkeypatch, lambda: _train_detector("cpu", mode, device_data))
    assert got[2] == want[2] and len(got[2]) == 6  # 3 steps (5 rows at b2) x 2 epochs
    _assert_carry_equal(seen[0]["last"], seen_e[0]["last"])
    dtype = "torch.bfloat16" if mode == "bfloat16" else "torch.float32"
    assert seen[0]["programs"].keys() == [
        ("detector", dtype, mode == "fakequant", (2, S, S, 3), (2, 8, 8, 6), (2,))]
    assert seen[0]["programs"].train


@pytest.mark.parametrize("mining,remat,dtype,device_data", [
    ("random", False, torch.float32, True),
    ("semi_hard", False, torch.float32, False),
    ("semi_hard", True, torch.float32, True),
    ("random", 2, torch.float32, False),
], ids=["random", "semi_hard", "semi_hard-remat", "random-remat2"])
def test_train_identifier_program_equals_eager(monkeypatch, mining, remat, dtype,
                                               device_data):
    """Through its program, train_identifier ends on the eager triplet
    step's params, BN state and Adam state with the same losses, for random
    and semi-hard mining and remat (checkpointed segments that stash no RNG
    state); the key names the dtype, mining, remat and fakequant."""
    (got, seen_p), (want, seen_e) = _both(
        monkeypatch, lambda: _train_identifier("cpu", mining, remat, dtype, device_data))
    assert got[2] == want[2] and len(got[2]) == 6 and np.isfinite(got[2]).all()
    _assert_carry_equal(seen_p[0]["last"], seen_e[0]["last"])
    key = seen_p[0]["programs"].keys()
    assert len(key) == 1 and key[0][:5] == ("identifier", str(dtype), mining, remat, False)


@pytest.mark.parametrize("tail_blocks", [0, 1])
def test_distill_program_equals_eager(monkeypatch, tail_blocks):
    """distill_folded through its program (the drawn indices its input, the
    images and teacher closed over) equals its eager step: the refined
    params, the Adam state and every printed loss."""
    ((got, gl), seen_p), ((want, wl), seen_e) = _both(
        monkeypatch, lambda: _distill("cpu", tail_blocks))
    assert gl == wl and len(gl) == 5
    for k in want:
        for n in want[k]:
            assert torch.equal(got[k][n], want[k][n]), (k, n)
    _assert_carry_equal(seen_p[0]["last"], seen_e[0]["last"])
    assert seen_p[0]["programs"].keys() == [("distill", 4, tail_blocks, (4,))]


def test_detector_record_helper_reads_the_eager_carry(monkeypatch):
    """The eager recorder sees the carry the loop ends on: its params are
    the ones train_detector returns."""
    seen = _record(monkeypatch, eager=True)
    params, state, losses = _train_detector("cpu", "float32", True, epochs=1)
    last = seen[0]["last"]
    assert all(torch.equal(last[0][k], params[k]) for k in params)
    assert all(torch.equal(last[1][k], state[k]) for k in state)
    assert isinstance(last[2], AdamState) and int(last[2].count) == 3 == len(losses)


def _flags():
    cudnn = torch.backends.cudnn
    return (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
            torch.get_float32_matmul_precision(),
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory)


def _set_flags(flags):
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = flags[:3]
    torch.set_float32_matmul_precision(flags[3])
    torch.use_deterministic_algorithms(flags[4], warn_only=flags[5])
    torch.utils.deterministic.fill_uninitialized_memory = flags[6]


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
@pytest.mark.parametrize("entry", ["detector", "identifier", "distill"])
def test_training_sets_and_restores_global_flags(monkeypatch, entry, raises):
    """Inside a training call deterministic algorithms are on (cuDNN
    deterministic, no autotuning, torch.use_deterministic_algorithms
    without the fill of uninitialised memory) and TF32 off; after it every
    flag is what it was, also when it raises."""
    default = _flags()
    before = (False, True, True, "high", False, False, True)
    inside = []
    real = trainer.program_step

    def probe(programs, key, step, n_carry):
        run = real(programs, key, step, n_carry)

        def wrapped(*args):
            inside.append(_flags())
            if raises:
                raise _Boom("the step failed")
            return run(*args)

        return wrapped

    monkeypatch.setattr(trainer, "program_step", probe)
    _set_flags(before)
    try:
        call = {"detector": lambda: _train_detector("cpu", "float32", True, epochs=1),
                "identifier": lambda: _train_identifier("cpu", "random", False,
                                                        torch.float32, False, epochs=1),
                "distill": lambda: _distill("cpu", 0, steps=2)}[entry]
        if raises:
            with pytest.raises(_Boom):
                call()
        else:
            call()
        after = _flags()
    finally:
        _set_flags(default)
    assert inside and all(f[:5] + f[6:] == (True, False, False, "highest", True, False)
                          for f in inside)
    assert after == before


def test_training_key_fixes_its_shapes():
    """A training program's key fixes every input's shape and dtype (the
    donated carry's too): another shape under the same key raises
    ProgramError, on the CPU as on the card."""
    cache = ProgramCache("cpu", train=True)

    def step(w, x):
        return w - 0.1 * x.mean(), (w * x).sum()

    w, x = torch.ones(3), torch.arange(6.0).reshape(2, 3)
    w2, loss = cache.run(("k",), step, w, x, donate=1)
    assert torch.equal(w2, w - 0.1 * x.mean()) and torch.equal(loss, (w * x).sum())
    with pytest.raises(ProgramError, match="takes"):
        cache.run(("k",), step, w2, torch.zeros(4, 3), donate=1)
    with pytest.raises(ProgramError, match="takes"):
        cache.run(("k",), step, torch.ones(4), x, donate=1)
    assert cache.keys() == [("k",)]


def test_training_cache_runs_autograd_inside_inference_mode():
    """A training program has autograd on even when its caller is in
    inference mode (calibrate_int8 runs distillation there); a serving
    program stays in inference mode."""

    def grad_of(w):
        leaf = w.detach().requires_grad_(True)
        return torch.autograd.grad((leaf * leaf).sum(), leaf)[0]

    w = torch.arange(3.0)
    with torch.inference_mode():
        assert torch.equal(ProgramCache("cpu", train=True).run(("g",), grad_of, w), 2 * w)
        with pytest.raises(RuntimeError):
            ProgramCache("cpu").run(("g",), grad_of, w)


def test_carry_layout_round_trips():
    """program_step's flattening: dicts by the reference carry's key order
    (a step may return its dicts in another order), an AdamState as its
    count and its moments by its own keys, and back."""
    p = {"b": torch.ones(2), "a": torch.zeros(3)}
    st = AdamState(count=torch.tensor(4, dtype=torch.int32),
                   mu={"b": torch.full((2,), 2.0), "a": torch.full((3,), 3.0)},
                   nu={"a": torch.full((3,), 5.0), "b": torch.full((2,), 4.0)})
    leaves = trainer._carry_leaves((dict(reversed(p.items())), st), (p, st))
    assert [t.tolist() for t in leaves] == [[1.0, 1.0], [0.0, 0.0, 0.0], 4, [2.0, 2.0],
                                            [3.0, 3.0, 3.0], [4.0, 4.0], [5.0, 5.0, 5.0]]
    back_p, back_st = trainer._carry_like((p, st), leaves)
    assert list(back_p) == ["b", "a"] and all(torch.equal(back_p[k], p[k]) for k in p)
    assert all(torch.equal(back_st.nu[k], st.nu[k]) for k in st.nu)
    assert back_st.count is leaves[2]


# ------------------------------------------------------------------ the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", ["f32", "bf16", "fakequant", "f32-streaming",
                                  "semi_hard", "semi_hard-remat", "distill"])
def test_cuda_replay_equals_eager_steps(monkeypatch, case):
    """On the card: 3 replayed steps of each training program equal 3 eager
    steps bit for bit (params, BN state, Adam state, losses), and each
    program is a captured graph, not the eager function."""
    dev = _cuda()

    def run():
        if case == "distill":
            out = _distill(dev, 0, steps=3)
        elif case.startswith("semi_hard"):
            out = _train_identifier(dev, "semi_hard", case.endswith("remat"),
                                    torch.float32, True, epochs=1)
        else:
            mode = {"f32": "float32", "bf16": "bfloat16"}.get(case.split("-")[0], case)
            out = _train_detector(dev, mode, not case.endswith("streaming"), epochs=1)
        torch.cuda.synchronize()
        return out

    (got, seen_p), (want, seen_e) = _both(monkeypatch, run)
    _assert_carry_equal(seen_p[0]["last"], seen_e[0]["last"])
    assert (got[1] if case == "distill" else got[2]) == \
        (want[1] if case == "distill" else want[2])
    programs = seen_p[0]["programs"]
    assert len(programs) == 1 and all(
        g is not None for _sig, g in programs._programs.values())


def test_cuda_two_runs_are_bit_equal():
    """On the card: two train_detector runs from the same seeds (fake-quant,
    the deepest kernel mix) end on the same bits."""
    dev = _cuda()
    a = _train_detector(dev, "fakequant", True)
    b = _train_detector(dev, "fakequant", True)
    assert a[2] == b[2]
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])


def test_cuda_training_capture_error_raises():
    """A training step that syncs with the host (`.item()`) raises
    ProgramError at capture naming its key; nothing runs it eagerly. The
    failed capture leaves the thread's stream and the card's random
    generator as they were: random draws and later captures work."""
    dev = _cuda()
    cache = ProgramCache(dev, train=True)
    w = torch.ones(4, device=dev)

    def step(w):
        return w * float(w.sum().item()), w.sum()

    with pytest.raises(ProgramError, match="host_sync"):
        cache.run(("host_sync", 4), step, w, donate=1)
    assert len(cache) == 0
    assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    assert torch.isfinite(torch.rand(8, device=dev)).all()
    w2, total = cache.run(("double", 4), lambda t: (t * 2.0, t.sum()), w, donate=1)
    torch.cuda.synchronize()
    assert torch.equal(w2, 2 * w) and float(total) == 4.0
