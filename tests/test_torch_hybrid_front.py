"""The int8 front guard (`bf16_front_mode="int8"`) in the port vs the JAX
package, on the CPU: FaceDetectorPipeline(precision="bfloat16") and the
identifier's bf16 embed with the guard segments calibrated int8 and the
rest folded bf16 (the int8 program's bf16 tail).

Both packages hold the same weights (seeded random kernels with seeded BN
statistics, models/darknet.perturb_batchnorm) at 64² and calibrate on the
same batch, with maxabs scales (int8_calib_percentile 0): the JAX
package's "auto" percentile costs five times as long, and the two
packages' "auto" calibration is held together in test_torch_quant.py.
Tolerances, measured on these seeds:
- the guard's int8 kernels (kernel_q) are torch.equal to the JAX
  pipeline's, and tail_start and the ops on each side of it are the JAX
  package's rules at guard depths 2 and 1 (tests/test_quant.py:343, :390);
- the scales each package calibrates itself agree within 1e-5 relative
  (measured 2.4e-6 at depth 2, 5.4e-8 at depth 1): the f32 convs that
  produce the maxabs statistics round their sums in their own orders, so
  they are not bit-equal (test_torch_quant.py's calibration test finds
  the same);
- with the JAX package's qparams carried across (convert.qparams_from_jax)
  the int8 front rows, the activation where the bf16 tail begins, are
  bit-exact against the jitted JAX program (an integer program), and the
  head within 2e-2 of max |head| (the bf16 head rule of
  test_torch_int8_pipeline.py: the tail's bf16 convs round their sums in
  other orders);
- the identifier's hybrid embed within 3e-2 abs of the JAX pipeline's
  (test_torch_identification.py's reduced-precision embed bound).
"""

import jax
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.api.config import Conf as JaxConf
from face_vijnana_yolov3_tpu.api.config import FdConf as JaxFdConf
from face_vijnana_yolov3_tpu.api.face_detection import FaceDetectorPipeline as JaxFd
from face_vijnana_yolov3_tpu.api.face_identification import FaceIdentifierPipeline as JaxFi
from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu_torch.api import face_detection as port_fd
from face_vijnana_yolov3_tpu_torch.api import face_identification as port_fi
from face_vijnana_yolov3_tpu_torch.api.config import Conf, FdConf
from face_vijnana_yolov3_tpu_torch.convert import (
    identifier_params_from_jax,
    params_from_jax,
    qparams_from_jax,
)
from face_vijnana_yolov3_tpu_torch.models import darknet, quant
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)
S = 64
HEAD_TOL = 2e-2
SCALE_RTOL = 1e-5
EMBED_TOL = 3e-2


def _fd_conf(cls, front, **kw):
    conf = cls(weights_path="missing.weights", bf16_front_mode="int8",
               int8_calib_percentile=0.0, **kw)
    conf.nn_arch.image_size = S
    conf.bf16_f32_front = front
    return conf


def _images(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, S, S, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=[2, 1], ids=["depth2", "depth1"])
def pipes(request):
    """The JAX and the port's hybrid detectors at guard depth `front`,
    calibrated on the same 4 images: the port's by its first detect_batch,
    the JAX one by the calibrate_int8 call its first detect_batch makes
    (face_vijnana_yolov3_tpu/api/face_detection.py:464-466), without
    compiling its detect program."""
    front = request.param
    x = _images(4, 0)
    jfd = JaxFd(_fd_conf(JaxFdConf, front), precision="bfloat16")
    params, state = port_fd.FaceDetectorModel(image_size=S, device="cpu").init_params(0)
    jfd.params, jfd.state = darknet.perturb_batchnorm(params, state, jfd.model.ops, 1)
    jfd.calibrate_int8(x)
    pfd = port_fd.FaceDetectorPipeline(_fd_conf(FdConf, front), precision="bfloat16",
                                       device="cpu")
    pfd.model.load_state_dict(params_from_jax(jfd.params, jfd.state))
    assert pfd._hybrid_front and not pfd._bf16_front_auto_pending()
    pfd.detect_batch(x)
    return dict(front=front, x=x, jfd=jfd, pfd=pfd,
                jq=qparams_from_jax(jax.device_get(jfd._qparams)))


def test_guard_scope_follows_the_knob(pipes):
    """Depth 2: int8 through the first residual block and the stage-2
    downsample (conv_0, 1, 2, 3, 5), bf16 from the second block opener;
    depth 1: conv_0 and conv_1 only. tail_start is JAX's and the f32
    guard's boundary, darknet.front_end_index(ops, front)."""
    pfd, jq, front = pipes["pfd"], pipes["jq"], pipes["front"]
    q, ops = pfd._qparams, pfd.model.ops
    n_blocks = sum(1 for op in ops if op[0] == "save")
    assert q["tail_start"] == jq["tail_start"] == darknet.front_end_index(ops, front)
    assert q["tail_start"] == quant.tail_start_index(ops, n_blocks - (front - 1))
    int8 = (0, 1, 2, 3, 5) if front == 2 else (0, 1)
    first_bf16 = "conv_6" if front == 2 else "conv_2"
    assert sorted(k for k in q if k.startswith("conv_")) == [f"conv_{i}" for i in int8]
    assert first_bf16 in q["tail"] and first_bf16 not in q
    assert torch.equal(q["head"]["kernel"], pfd.model.head.weight)


def test_guard_kernels_and_scales_follow_jax(pipes):
    """The port's own calibration: every guard conv's int8 kernel
    torch.equal to the JAX pipeline's, the scales up to the cut within
    SCALE_RTOL."""
    q, jq = pipes["pfd"]._qparams, pipes["jq"]
    for k in (k for k in jq if k.startswith("conv_")):
        assert torch.equal(q[k]["kernel_q"], jq[k]["kernel_q"]), k
        torch.testing.assert_close(q[k]["bias"], jq[k]["bias"], rtol=0, atol=0)
    for g, w in list(zip(q["act_scales"], jq["act_scales"]))[:q["tail_start"] + 1]:
        np.testing.assert_allclose(g, w, rtol=SCALE_RTOL)


def test_front_rows_bit_exact_and_head_close(pipes):
    """On the JAX package's qparams: the int8 rows where the bf16 tail
    begins are bit-exact against the jitted JAX program; the served head
    (`_detect_program`'s route) within HEAD_TOL of the JAX pipeline's."""
    jfd, pfd, x, jq = pipes["jfd"], pipes["pfd"], pipes["x"], pipes["jq"]
    cut = jq["tail_start"]
    front_ops = list(pfd.model.ops[:cut]) + [("output", "__cut")]
    jfront = {k: v for k, v in jfd._qparams.items() if k not in ("tail_start", "tail")}
    want_rows, want = (np.asarray(a) for a in jax.jit(lambda xx: (  # one compile
        jax_quant.apply_graph_quant(jfront, xx, front_ops)["__cut"],
        jfd.model.apply_quant(jfd._qparams, xx)))(x))
    pfront = {k: v for k, v in jq.items() if k not in ("tail_start", "tail")}
    got_rows = quant.apply_graph_quant(pfront, torch.from_numpy(x), front_ops)["__cut"]
    np.testing.assert_array_equal(got_rows.numpy(), want_rows)
    pfd._qparams = quant.to_device(jq, "cpu")
    try:
        got = pfd.model.apply_quant(pfd._qparams, torch.from_numpy(x)).numpy()
    finally:
        pfd.calibrate_int8(x)
    err = float(np.abs(got - want).max())
    assert err <= HEAD_TOL * float(np.abs(want).max()), err


def test_calibrates_on_the_first_fused_batch_and_keys_its_programs():
    """detect_batch_fused calibrates a hybrid pipeline on its first batch
    (an "auto" guard is not probed: its depth is 2); its programs are keyed
    apart from the f32-guard bf16 program's; before calibration a detect
    raises."""
    from face_vijnana_yolov3_tpu_torch.ops.letterbox import letterbox_geometry

    conf = _fd_conf(FdConf, "auto")
    fd = port_fd.FaceDetectorPipeline(conf, precision="bfloat16", device="cpu")
    assert not fd._bf16_front_auto_pending()
    with pytest.raises(RuntimeError, match="bf16_front_mode"):
        fd._detect(torch.from_numpy(_images(2, 1)))
    staged = (np.random.default_rng(2).uniform(0, 255, (3, 96, 128, 3))).astype(np.uint8)
    geoms = [letterbox_geometry(96, 128, S)] * 3
    cands, counts = fd.detect_batch_fused(staged, geoms)
    assert fd._qparams is not None and cands.shape[0] == 3 and counts.shape == (3,)
    assert fd._qparams["tail_start"] == darknet.front_end_index(fd.model.ops, 2)
    (key,) = fd.programs.keys()
    assert key[:3] == ("fused", "bfloat16", ("int8-front", 2))
    plain = port_fd.FaceDetectorPipeline(_fd_conf(FdConf, 2, ), precision="bfloat16",
                                         device="cpu")
    plain.conf.bf16_front_mode = "f32"
    plain.detect_batch_fused(staged, geoms)
    (plain_key,) = plain.programs.keys()
    assert plain_key[2] == 2 and plain_key != key


def test_identifier_hybrid_embed_matches_jax():
    """fi_conf.bf16_front_mode="int8": the bf16 embed calibrates an int8
    guard (depth fi_conf.bf16_f32_front) and the folded bf16 rest on its
    first call; its embeddings follow the JAX pipeline's within EMBED_TOL
    and stay unit vectors (test_quant.py:410)."""
    def conf(cls):
        c = cls()
        for sub in (c.fi_conf, c.fd_conf):
            sub.weights_path = "missing.weights"
            sub.nn_arch.image_size = S
        c.fi_conf.int8_calib_percentile = 0.0
        c.fi_conf.nn_arch.dense1_dim = 8
        c.fi_conf.bf16_front_mode = "int8"
        return c

    jfi = JaxFi(conf(JaxConf), precision="bfloat16")
    params = {k: dict(v) for k, v in jax.device_get(jfi.params).items()}
    state = {k: dict(v) for k, v in jax.device_get(jfi.state).items()}
    jfi.params, jfi.state = darknet.perturb_batchnorm(params, state, jfi.model.ops, 7)
    pfi = port_fi.FaceIdentifierPipeline(conf(Conf), precision="bfloat16", device="cpu")
    pfi.model.load_state_dict(identifier_params_from_jax(jfi.params, jfi.state))
    assert pfi._hybrid_front
    x = _images(4, 3)
    got, want = pfi.embed(x), jfi.embed(x)
    q = pfi._q_embed
    assert q["tail_start"] == darknet.front_end_index(pfi.model.ops, 2)
    assert sorted(k for k in q if k.startswith("conv_")) == sorted(
        k for k in jfi._q_embed if k.startswith("conv_"))
    assert got.shape == (4, 8)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-2)
    assert float(np.abs(got - want).max()) <= EMBED_TOL
