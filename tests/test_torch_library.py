"""The four kernels as `torch.library` custom ops (ops/library.py), on the CPU.

`fvy::conv_int8`, `fvy::block_int8`, `fvy::nms_sweep` and `fvy::fused_front`
each pass `torch.library.opcheck` (schema, fake implementation, autograd
registration, AOT dispatch with dynamic shapes) on small inputs; the op
route (the dispatcher, which exported programs take) and the direct
route give
the same tensors bit for bit (one implementation: the CPU kernel of each op
is the module's plain version), neither counts a launch on the CPU, and
`torch.export` records the ops with a symbolic batch. Registration builds
nothing. The card's side (each op's CUDA kernel is the launch that counts,
and matches the plain version) is `test_cuda_ops_launch_the_kernels`, which
skips without a card.
"""

import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu_torch import kernels
from face_vijnana_yolov3_tpu_torch.ops import library  # noqa: F401  (registers fvy::*)
from face_vijnana_yolov3_tpu_torch.ops.block_int8 import block_int8
from face_vijnana_yolov3_tpu_torch.ops.conv_int8 import conv_int8
from face_vijnana_yolov3_tpu_torch.ops.front_fused import fused_front
from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)


def _cases(device="cpu"):
    """{name: (op overload, op args, the wrapper's call)} at small shapes."""
    g = torch.Generator().manual_seed(0)

    def i8(*s):
        return torch.randint(-127, 128, s, dtype=torch.int8, generator=g).to(device)

    def pos(*s, scale=1.0):
        return (torch.rand(s, generator=g) * 0.01 + 0.001).mul(scale).to(device)

    cases = {}
    x, w = i8(2, 5, 7, 32), i8(16, 3, 3, 32)
    a = (x, w, pos(16), pos(16), pos(16, scale=1e3), None, None, 2, True)
    cases["conv_int8_k3s2"] = (torch.ops.fvy.conv_int8.default, a,
                               lambda: conv_int8(*a[:5], stride=2, leaky=True))
    skip = i8(2, 5, 7, 16)
    b = (x, i8(16, 1, 1, 32), pos(16), pos(16), pos(16, scale=1e3), skip, pos(16), 1, False)
    cases["conv_int8_skip"] = (torch.ops.fvy.conv_int8.default, b,
                               lambda: conv_int8(*b[:5], stride=1, leaky=False,
                                                 skip_q=b[5], skip_s=b[6]))
    c = (i8(2, 3, 4, 128), i8(128, 1, 1, 128), i8(128, 3, 3, 128), pos(128), pos(128),
         pos(128, scale=1e3), pos(128), pos(128), pos(128), pos(128, scale=1e3))
    cases["block_int8"] = (torch.ops.fvy.block_int8.default, c, lambda: block_int8(*c))
    boxes = torch.sort(torch.rand(2, 9, 4, generator=g) * 10, dim=-1).values.to(device)
    scores = torch.sort(torch.rand(2, 9, generator=g), descending=True).values.to(device)
    d = (boxes.contiguous(), scores.contiguous(), 0.45)
    cases["nms_sweep"] = (torch.ops.fvy.nms_sweep.default, d, lambda: nms_sweep(*d))
    folded = {"conv_0": {"kernel": torch.randn(32, 3, 3, 3, generator=g).to(device),
                         "bias": torch.randn(32, generator=g).to(device)},
              "conv_1": {"kernel": (torch.randn(64, 32, 3, 3, generator=g) * 0.1).to(device),
                         "bias": torch.randn(64, generator=g).to(device)}}
    xf = torch.rand(2, 8, 8, 3, generator=g).to(device)
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import front_kernel_weights

    e = (xf, *front_kernel_weights(folded))
    cases["fused_front"] = (torch.ops.fvy.fused_front.default, e,
                            lambda: fused_front(xf, folded))
    return cases


NAMES = ["conv_int8_k3s2", "conv_int8_skip", "block_int8", "nms_sweep", "fused_front"]


@pytest.mark.parametrize("name", NAMES)
def test_opcheck(name):
    op, args, _ = _cases()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name", NAMES)
def test_op_route_equals_direct_route(name, monkeypatch):
    """Through the dispatcher or straight to the implementation: the same
    tensor, and on the CPU no kernel launch counted either way."""
    op, args, call = _cases()[name]
    wrapper = {"conv": conv_int8, "bloc": block_int8, "nms_": nms_sweep,
               "fuse": fused_front}[name[:4]]
    before = wrapper.launches
    direct = call()
    monkeypatch.setattr(kernels, "direct_route", lambda: False)
    routed = call()
    assert torch.equal(direct, routed) and direct.dtype == routed.dtype
    assert torch.equal(op(*args), direct)
    assert wrapper.launches == before


def test_export_records_the_ops_with_a_symbolic_batch():
    """torch.export of calls of all four wrappers holds one fvy:: node each,
    the batch stays symbolic (traced at 2, run at 1 and 3), and the
    exported program equals the eager calls."""
    cases = _cases()
    _, a, _ = cases["conv_int8_k3s2"]
    _, c, _ = cases["block_int8"]
    g = torch.Generator().manual_seed(1)
    folded = {"conv_0": {"kernel": torch.randn(32, 3, 3, 3, generator=g),
                         "bias": torch.randn(32, generator=g)},
              "conv_1": {"kernel": torch.randn(64, 32, 3, 3, generator=g) * 0.1,
                         "bias": torch.randn(64, generator=g)}}

    class Calls(torch.nn.Module):
        def forward(self, xq, xb, boxes, scores, xf):
            return (conv_int8(xq, *a[1:5], stride=2, leaky=True), block_int8(xb, *c[1:]),
                    nms_sweep(boxes, scores, 0.45), fused_front(xf, folded))

    def inputs(b):
        return (torch.randint(-127, 128, (b, 5, 7, 32), dtype=torch.int8, generator=g),
                torch.randint(-127, 128, (b, 3, 4, 128), dtype=torch.int8, generator=g),
                torch.sort(torch.rand(b, 9, 4, generator=g) * 10, dim=-1).values.contiguous(),
                torch.sort(torch.rand(b, 9, generator=g), descending=True).values.contiguous(),
                torch.rand(b, 8, 8, 3, generator=g))

    b = torch.export.Dim("b", min=1)
    ep = torch.export.export(Calls(), inputs(2), dynamic_shapes=({0: b},) * 5)
    targets = [str(n.target) for n in ep.graph.nodes if "fvy" in str(n.target)]
    assert sorted(targets) == sorted(f"fvy.{k}.default" for k in
                                     ("conv_int8", "block_int8", "nms_sweep", "fused_front"))
    mod = ep.module()
    for n in (1, 3):
        x = inputs(n)
        for got, want in zip(mod(*x), Calls()(*x)):
            assert got.shape[0] == n and torch.equal(got, want)


def test_registration_builds_nothing():
    """Importing ops/library.py (done above) registers the ops and never
    builds or loads the CUDA library."""
    assert kernels.load.cache_info().currsize == 0
    for name in ("conv_int8", "block_int8", "nms_sweep", "fused_front"):
        assert hasattr(torch.ops.fvy, name)


def test_cuda_ops_launch_the_kernels():
    """On the card: each op's CUDA kernel launches the hand-written kernel
    (its wrapper's count moves by one) and equals the plain version on the
    same inputs (fused_front within one bf16 step); an op given tensors on
    two devices raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cpu = _cases("cpu")
    for name, (op, args, _) in _cases("cuda").items():
        wrapper = {"conv": conv_int8, "bloc": block_int8, "nms_": nms_sweep,
                   "fuse": fused_front}[name[:4]]
        before = wrapper.launches
        got = op(*args).cpu()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name
        want = cpu[name][0](*cpu[name][1])
        if name == "fused_front":
            step = 2.0 ** -7 * want.float().abs().clamp_min(1e-3)
            assert bool(((got.float() - want.float()).abs() <= step).all()), name
        else:
            assert torch.equal(got, want), name
    op, args, _ = _cases("cuda")["nms_sweep"]
    with pytest.raises(ValueError):
        op(args[0], args[1].cpu(), args[2])


def test_plain_versions_are_the_cpu_kernels():
    """The CPU kernel of each op is the plain twin the wrappers name."""
    from face_vijnana_yolov3_tpu_torch.ops import conv_int8 as conv_mod
    from face_vijnana_yolov3_tpu_torch.ops import nms_sweep as nms_mod

    op, args, _ = _cases()["conv_int8_k3s2"]
    want = conv_mod.conv_int8_reference(*args[:5], stride=2, leaky=True)
    assert torch.equal(op(*args), want)
    op, args, _ = _cases()["nms_sweep"]
    assert torch.equal(op(*args), nms_mod.nms_sweep_reference(*args))
    assert np.isfinite(op(*args).numpy()).all()
