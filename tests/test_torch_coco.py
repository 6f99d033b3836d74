"""The COCO YOLOv3 demo of the PyTorch port vs the JAX package.

Seeded numpy inputs and weights go through the JAX function and the port's
on the CPU (the port's NMS wrapper then takes the plain sweep). The JAX
reference is the jitted program, the one its demo runs: XLA turns `x / c`
into `x * f32(1/c)` and folds a product of constants there, and eager JAX
differs in the last bit (ops/decode.py).

Tolerances, each measured on these cases:
- decode: mask bit-exact; objness and class scores within 2 ULP (torch's
  and XLA's CPU `exp` differ by at most 1 ULP; measured max 2); box corners
  within 3e-7 relative plus 2e-6 absolute (normalized coords; a 1-ULP
  `exp` difference in w moves x - w/2, which cancels near 0, and XLA's
  CPU backend contracts one product of x ± w/2 into an FMA, a different
  one per scale's fusion: measured 1.2e-7 relative where the absolute
  part does not cover it);
- correct_coco_boxes, nms_multi_class, top-k order: bit-exact (integer
  coordinates, comparisons, sorts);
- coco_postprocess: boxes and valid bit-exact, objness and classes within
  2 ULP (measured max 2);
- the full 75-conv graph at 128²: int8 heads bit-exact on the JAX package's
  qparams, fused blocks on and off; the port's own int8 calibration: scales
  within 1e-4 relative (measured 4.7e-5), qparams bit-exact on the JAX
  package's scales, heads within 5e-2 of max |head| (measured 2.9e-2); f32 heads within 2e-5 of max |head|
  (conv summation order; measured 2.5e-6); bf16 heads within 5e-2 of max
  |head| (bf16 rounding points; measured 2.2e-2);
- detect_coco, the CLI image and YOLOV3.detect_object at f32: the same
  valid rows in the same order, boxes within 1 pixel plus 1e-4 relative
  (`exp` of a head logit magnifies the heads' 2.5e-6: measured 2 pixels at
  4.5e5, on boxes that random weights stretch far outside the image),
  objness and class scores within 1e-4.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_vijnana_yolov3_tpu.api import yolov3_detect as jax_yd
from face_vijnana_yolov3_tpu.core import keras_import as jax_keras
from face_vijnana_yolov3_tpu.core.weights import load_darknet_weights as jax_load_weights
from face_vijnana_yolov3_tpu.models import darknet as jax_darknet
from face_vijnana_yolov3_tpu.models import quant as jax_quant
from face_vijnana_yolov3_tpu.ops import decode as jax_decode
from face_vijnana_yolov3_tpu.ops import nms as jax_nms
from face_vijnana_yolov3_tpu.ops import postprocess as jax_pp
from face_vijnana_yolov3_tpu.utils import box_select as jax_box_select
from face_vijnana_yolov3_tpu_torch.api import yolov3_detect as yd
from face_vijnana_yolov3_tpu_torch.convert import params_from_jax, qparams_from_jax
from face_vijnana_yolov3_tpu_torch.core import keras_import
from face_vijnana_yolov3_tpu_torch.core.weights import (
    load_darknet_weights,
    save_darknet_weights,
)
from face_vijnana_yolov3_tpu_torch.models import darknet, quant
from face_vijnana_yolov3_tpu_torch.ops import decode, nms, postprocess
from face_vijnana_yolov3_tpu_torch.ops.boxes import BoundBox
from face_vijnana_yolov3_tpu_torch.utils import box_select, profiling
from face_vijnana_yolov3_tpu_torch.utils.io import imread, imsave

from oracles import oracle_coco_decode, oracle_correct_coco_boxes, oracle_nms_multi
from test_torch_postprocess import ulp_distance
from torch_cleanup import clean_up_module  # noqa: F401  (autouse)

torch.set_num_threads(2)

NET = 128  # the smallest net whose three scales hold the 256 top-k candidates
GRIDS = (NET // 32, NET // 16, NET // 8)
CLS_ULP = 2
BOX_ATOL, BOX_RTOL = 2e-6, 3e-7
F32_HEAD_TOL = 2e-5
BF16_HEAD_TOL = 5e-2
CALIB_SCALE_RTOL = 1e-4
INT8_OWN_CALIB_TOL = 5e-2
SCORE_ATOL = 1e-4
BOX_PIXEL_RTOL = 1e-4


def _assert_ulp(got, want, ulps):
    assert np.shape(got) == np.shape(want)
    d = ulp_distance(got, want)
    assert d.max(initial=0) <= ulps, f"{d.max()} ULP apart"


def _jit(fn, *args):
    return [np.asarray(a) for a in jax.jit(fn)(*args)]


def _netouts(seed, obj_shift=0.0):
    """Three seeded (G, G, 255) heads; obj_shift moves every objectness logit."""
    rng = np.random.default_rng(seed)
    outs = []
    for g in GRIDS:
        t = rng.normal(0, 1.5, (g, g, 3, 85)).astype(np.float32)
        t[..., 4] += obj_shift
        outs.append(t.reshape(g, g, 255))
    return outs


# ------------------------------------------------------------------ copies


def test_box_select_is_the_original():
    """utils/box_select.py is a copy: the same source and the same picks."""
    assert (inspect.getsource(box_select.get_person_boxes)
            == inspect.getsource(jax_box_select.get_person_boxes))
    rng = np.random.default_rng(0)
    boxes = []
    for k in range(40):
        c = rng.dirichlet(np.full(80, 0.3)).astype(np.float32)
        if k % 3 == 0:
            c[[0, 39][k % 2]] += 2.0  # person or bottle on top
        boxes.append(BoundBox(0, 0, 1, 1, classes=c))
    for th in ((0.1, 3.0, 3.0), (0.5, 2.0, 4.0), (0.0, 100.0, 0.5)):
        want = jax_box_select.get_person_boxes(boxes, yd.COCO_LABELS, *th)
        got = box_select.get_person_boxes(boxes, yd.COCO_LABELS, *th)
        assert [id(b) for b in got] == [id(b) for b in want]
    assert yd.COCO_LABELS == jax_yd.COCO_LABELS


def test_profiling_helpers(tmp_path, capsys):
    """stage_timer prints the reference's line and records the stage;
    device_trace writes a Chrome trace in which annotate's range shows."""
    out = []
    with profiling.stage_timer("stage", out=out):
        torch.ones(8).sum()
    assert "Elasped time:" in capsys.readouterr().out
    assert out[0][0] == "stage" and out[0][1] >= 0
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("coco_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").exists()
    assert "coco_region" in [e.key for e in prof.key_averages()]


# ------------------------------------------------------------------ decode


@pytest.mark.parametrize("scale", [0, 1, 2])
def test_decode_coco_scale_matches_jax_and_oracle(scale):
    net = 416
    g = net // (32 >> scale)
    t = np.random.default_rng(scale).normal(0, 2, (g, g, 255)).astype(np.float32)
    want = _jit(lambda a: jax_decode.decode_coco_scale(a, scale, 0.3), t)
    got = [a.numpy() for a in decode.decode_coco_scale(torch.from_numpy(t), scale, 0.3)]
    kept = len(decode.KEPT_ANCHOR_IDS[scale])
    assert got[0].shape == (g * g * kept, 4) and got[2].shape == (g * g * kept, 80)
    np.testing.assert_array_equal(got[3], want[3])
    _assert_ulp(got[1], want[1], CLS_ULP)
    _assert_ulp(got[2], want[2], CLS_ULP)
    np.testing.assert_allclose(got[0], want[0], rtol=BOX_RTOL, atol=BOX_ATOL)
    # The loop oracle (float64) keeps the same candidates in the same order.
    ref = oracle_coco_decode(t, scale, 0.3)
    sel = got[3]
    assert len(ref) == int(sel.sum())
    np.testing.assert_allclose(
        got[0][sel], [[r["xmin"], r["ymin"], r["xmax"], r["ymax"]] for r in ref],
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2][sel], [r["classes"] for r in ref], rtol=1e-5)


GEOMETRIES = [(480, 640, 416), (640, 360, 416), (416, 416, 416), (100, 150, 128),
              (333, 127, 128)]


@pytest.mark.parametrize("image_h,image_w,net", GEOMETRIES)
def test_correct_coco_boxes_matches_jax_and_oracle(image_h, image_w, net):
    rng = np.random.default_rng(image_h)
    b = rng.uniform(-0.3, 1.3, (500, 4)).astype(np.float32)
    b[:5] = [[np.inf, -np.inf, 0.5, np.inf]] * 5
    b[5:10] = 0.5  # zero area
    want = _jit(lambda a: (jax_decode.correct_coco_boxes(a, image_h, image_w, net, net),),
                b)[0]
    got = decode.correct_coco_boxes(torch.from_numpy(b), image_h, image_w, net, net).numpy()
    np.testing.assert_array_equal(got, want)
    ref = oracle_correct_coco_boxes(
        [dict(zip(("xmin", "ymin", "xmax", "ymax"), map(float, r))) for r in b[5:]],
        image_h, image_w, net, net)
    np.testing.assert_allclose(
        got[5:], [[r["xmin"], r["ymin"], r["xmax"], r["ymax"]] for r in ref], atol=1.0)


# ------------------------------------------------------------------ NMS


def _nms_case(kind, n=256, c=80, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 300, (n, 2)).astype(np.float32)
    wh = rng.integers(1, 120, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = rng.uniform(0, 1, (n, c)).astype(np.float32)
    scores[rng.uniform(size=(n, c)) < 0.5] = 0.0
    if kind == "ties":
        scores = np.round(scores * 4) / 4
        boxes[n // 2:] = boxes[: n - n // 2]  # duplicate boxes
    elif kind == "nonfinite":
        boxes[::7, 2] = np.inf
        boxes[3::11, 0] = -np.inf
        boxes[5::13] = np.inf
    elif kind == "zero_area":
        boxes[::3, 2] = boxes[::3, 0]
        boxes[1::5] = 0.0
    return boxes, scores


@pytest.mark.parametrize("kind", ["float", "ties", "nonfinite", "zero_area"])
def test_nms_multi_class_matches_jax_and_oracle(kind):
    boxes, scores = _nms_case(kind)
    want = _jit(lambda b, s: (jax_nms.nms_multi_class(b, s, 0.45),), boxes, scores)[0]
    got = nms.nms_multi_class(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "float":  # distinct scores: the oracle's unstable sort agrees
        ref = oracle_nms_multi(
            [{"xmin": b[0], "ymin": b[1], "xmax": b[2], "ymax": b[3],
              "classes": s.astype(np.float64)} for b, s in zip(boxes, scores.copy())],
            0.45)
        np.testing.assert_array_equal(got.numpy(), [r["classes"] for r in ref])


def test_topk_tie_order_is_lax_top_k():
    """jax.lax.top_k puts the lower index first among equal values; the
    port's stable descending sort does the same, on the -1 padding too."""
    v = np.array([-1, 3, -1, 3, -1], np.float32)
    assert np.asarray(jax.lax.top_k(jnp.asarray(v), 4)[1]).tolist() == [1, 3, 0, 2]
    rng = np.random.default_rng(1)
    g = np.where(rng.uniform(size=2000) < 0.05, rng.integers(0, 4, 2000) / 4, -1.0)
    g = g.astype(np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(g), 256)[1])
    got = torch.sort(torch.from_numpy(g), descending=True, stable=True).indices[:256]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["fewer_than_top_k", "more_than_top_k"])
def test_coco_postprocess_matches_jax(case):
    outs = _netouts(3, obj_shift=-3.0 if case == "fewer_than_top_k" else 3.0)
    want = _jit(lambda a, b, c: jax_pp.coco_postprocess((a, b, c), 100, 150, 0.5, 0.45,
                                                        net_h=NET, net_w=NET), *outs)
    got = [t.numpy() for t in postprocess.coco_postprocess(
        [torch.from_numpy(o) for o in outs], 100, 150, 0.5, 0.45, net_h=NET, net_w=NET)]
    n_valid = int(want[3].sum())
    assert (0 < n_valid < 256) if case == "fewer_than_top_k" else n_valid == 256
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])
    _assert_ulp(got[1], want[1], CLS_ULP)
    _assert_ulp(got[2], want[2], CLS_ULP)
    assert ((got[2] == 0) == (want[2] == 0)).all()


# ------------------------------------------------------------------ weights and graph


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    """Seeded YOLOv3 weights with perturbed BN statistics (live heads), as
    JAX trees, the port's state dict and a darknet .weights file."""
    root = tmp_path_factory.mktemp("coco")
    ops = darknet.yolov3_graph()
    params, state = darknet.init_graph_params(ops, 3)
    darknet.perturb_batchnorm(params, state, ops, 4)
    for idx in (81, 93, 105):
        params[f"conv_{idx}"]["bias"] = np.random.default_rng(idx).normal(
            0, 0.5, 255).astype(np.float32)
    sd = params_from_jax(params, state)
    weights = str(root / "yolov3.weights")
    save_darknet_weights(weights, sd, ops)
    image = np.random.default_rng(5).uniform(0, 255, (100, 150, 3)).astype(np.uint8)
    x = yd.preprocess_coco(image, NET, NET)
    return {"root": root, "ops": ops, "params": params, "state": state, "sd": sd,
            "weights": weights, "image": image, "x": x}


def test_darknet_weights_read_the_whole_file(net):
    """A whole yolov3.weights reads into the 75 convs, the three linear
    heads (bias, no BN) included, equal to the JAX reader's trees."""
    sd = load_darknet_weights(net["weights"], net["ops"])
    assert set(sd) == set(net["sd"])
    for k, v in net["sd"].items():
        np.testing.assert_array_equal(sd[k], v.numpy())
    jp, js = jax_load_weights(net["weights"], jax_darknet.yolov3_graph())
    want = params_from_jax(jax.device_get(jp), jax.device_get(js))
    for idx, cin in ((81, 1024), (93, 512), (105, 256)):
        assert want[f"conv_{idx}.weight"].shape == (255, cin, 1, 1)
        assert f"bnorm_{idx}.gamma" not in want and want[f"conv_{idx}.bias"].shape == (255,)
    for k, v in want.items():
        np.testing.assert_array_equal(v.numpy(), sd[k])


@pytest.fixture(scope="module")
def jax_heads(net):
    """The JAX package's jitted heads at f32, int8 (its own calibration,
    qparams closed over as the demo's program does) and bf16."""
    ops = jax_darknet.yolov3_graph()
    params, state, x = net["params"], net["state"], net["x"]
    f32 = jax.jit(lambda xx: jax_darknet.apply_graph(params, state, xx, ops)[0])(x)
    folded = jax.device_get(jax_darknet.fold_graph_params(params, state, ops))
    qp = jax_quant.quantize_folded(folded, x, ops)
    int8 = jax.jit(lambda xx: jax_quant.apply_graph_quant(qp, xx, ops))(x)
    bf16 = jax.jit(lambda xx: jax_darknet.apply_graph_folded(
        folded, xx, ops, compute_dtype=jnp.bfloat16))(x)
    as_np = lambda d: [np.asarray(d[k]) for k in yd.YOLO_OUTPUTS]  # noqa: E731
    return {"float32": as_np(f32), "int8": as_np(int8), "bfloat16": as_np(bf16), "qp": qp}


@pytest.mark.parametrize("precision", ["float32", "int8_blocks_on", "int8_blocks_off",
                                       "bfloat16"])
def test_full_graph_heads_match_jax(net, jax_heads, precision):
    """The three heads of the 75-conv graph at 128²: int8 bit-exact on the
    JAX package's qparams (A0 at Cout 255 and Cin 768/384, A on the blocks),
    f32 and bf16 within the module's tolerances."""
    x = torch.from_numpy(net["x"])
    if precision.startswith("int8"):
        outs = quant.apply_graph_quant(qparams_from_jax(jax_heads["qp"]), x, net["ops"],
                                       fused_blocks=precision == "int8_blocks_on")
        for k, want in zip(yd.YOLO_OUTPUTS, jax_heads["int8"]):
            np.testing.assert_array_equal(outs[k].numpy(), want)
        return
    got = yd.coco_forward(net["sd"], precision, "cpu")(x)
    tol = F32_HEAD_TOL if precision == "float32" else BF16_HEAD_TOL
    for g, want, grid in zip(got, jax_heads[precision], GRIDS):
        assert g.shape == (1, grid, grid, 255)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= tol * float(np.abs(want).max()), err


def test_quantize_folded_on_the_routed_graph_matches_jax(net, jax_heads):
    """The port's int8 calibration on the routed YOLOv3 graph (the concat
    and upsample positions included) against the JAX package's, leaf by
    leaf: every position's scales within CALIB_SCALE_RTOL (two f32 forwards
    whose convs sum in another order, as tests/test_torch_quant.py bounds
    the trunk's; measured 4.7e-5). On the JAX package's scales the port's
    quantize_folded is bit-exact: kernel_q (input scales pre-folded),
    w_scale and bias of all 75 convs."""
    folded = darknet.fold_graph_params(net["sd"], net["ops"])
    want = qparams_from_jax(jax_heads["qp"])
    own = quant.quantize_folded(folded, torch.from_numpy(net["x"]), net["ops"])
    assert len(own["act_scales"]) == len(want["act_scales"]) == len(net["ops"]) + 1
    for g, w in zip(own["act_scales"], want["act_scales"]):
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=CALIB_SCALE_RTOL, atol=0)
    got = quant.quantize_folded(folded, None, net["ops"], act_scales=want["act_scales"])
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(a, b) for a, b in zip(got["act_scales"], want["act_scales"]))
    for name, w in want.items():
        if name != "act_scales":
            for k, t in w.items():
                assert got[name][k].dtype == t.dtype and torch.equal(got[name][k], t), (name, k)


def test_int8_forward_calibrates_on_the_image(net, jax_heads):
    """coco_forward('int8') calibrates on the image with the port's own
    calibration, whose scales are CALIB_SCALE_RTOL from the JAX package's
    (above), so a requantisation may land one int8 step apart and the
    difference runs on through the graph: the heads within
    INT8_OWN_CALIB_TOL of the JAX heads' largest value (measured 2.9e-2).
    Bit-exactness on shared scales is held above and in
    test_full_graph_heads_match_jax."""
    x = torch.from_numpy(net["x"])
    got = yd.coco_forward(net["sd"], "int8", "cpu", x_calib=x)(x)
    for g, want in zip(got, jax_heads["int8"]):
        assert g.shape == want.shape and np.isfinite(g.numpy()).all()
        err = float(np.abs(g.numpy() - want).max())
        assert err <= INT8_OWN_CALIB_TOL * float(np.abs(want).max()), err


def _same_rows(got, want):
    """detect_coco outputs: the same valid rows, boxes within 1 pixel plus
    BOX_PIXEL_RTOL, objness and class scores within SCORE_ATOL."""
    np.testing.assert_array_equal(got[3], want[3])
    v = want[3]
    assert v.any()
    np.testing.assert_allclose(got[0][v], want[0][v], rtol=BOX_PIXEL_RTOL, atol=1.0)
    np.testing.assert_allclose(got[1][v], want[1][v], atol=SCORE_ATOL)
    np.testing.assert_allclose(got[2][v], want[2][v], atol=SCORE_ATOL)


def test_detect_coco_matches_jax(net):
    got = yd.detect_coco(net["weights"], net["image"], 0.3, 0.45, net_size=NET,
                         device="cpu")
    want = jax_yd.detect_coco(net["weights"], net["image"], 0.3, 0.45, net_size=NET)
    assert got[0].shape == (256, 4) and got[2].shape == (256, 80)
    assert np.all(got[0] == np.trunc(got[0]))
    _same_rows(got, want)


def test_cli_writes_the_image_and_round_trips_h5(net, tmp_path, monkeypatch, capsys):
    """-w writes `<img>_detected.jpg` (at 416², the CLI's size; detect_coco
    is held to the JAX package's above); -s writes yolov3_model.h5, which
    equals the darknet import in the port's reader and in the JAX
    package's; -l runs from it and draws the same image."""
    monkeypatch.chdir(tmp_path)
    img = str(tmp_path / "scene.jpg")
    image = np.random.default_rng(1).uniform(0, 255, (160, 240, 3)).astype(np.uint8)
    imsave(img, image)
    out = yd.main(["-w", net["weights"], "-i", img, "-s", "1", "--obj-thresh", "0.3"],
                  device="cpu")
    assert out == str(tmp_path / "scene_detected.jpg")
    first = imread(out).copy()
    assert first.shape == (160, 240, 3)
    assert int(capsys.readouterr().out.split(" detections")[0].split()[-1]) > 0
    h5 = keras_import.yolov3_from_keras_h5("yolov3_model.h5")
    jp, js = jax_keras.yolov3_from_keras_h5("yolov3_model.h5")
    from_jax = params_from_jax(jax.device_get(jp), jax.device_get(js))
    assert set(h5) == set(net["sd"]) == set(from_jax)
    for k, v in net["sd"].items():
        np.testing.assert_array_equal(h5[k].numpy(), v.numpy())
        np.testing.assert_array_equal(from_jax[k].numpy(), v.numpy())
    os.remove(out)
    yd.main(["-l", "1", "-i", img, "--obj-thresh", "0.3"], device="cpu")
    np.testing.assert_array_equal(imread(out), first)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_yolov3_class_keeps_one_program_per_shape_and_thresholds(net, tmp_path,
                                                                monkeypatch, precision):
    """YOLOV3 at f32 and bf16 serves through its ProgramCache: one key per
    (precision, net size, image shape, thresholds), the same key for a
    second image of that shape, another for another shape or threshold;
    its boxes match the JAX YOLOV3's within the tolerances of
    test_yolov3_class_detect_object_matches_jax and equal the eager
    detect_coco's."""
    monkeypatch.chdir(tmp_path)
    keras_import.save_yolov3_keras_h5(net["sd"], "yolov3_model.h5")
    kw = dict(obj_thresh=0.3, cls_thresh=0.0, nms_thresh=0.45,
              human_entropy_thresh=100.0, bottle_entropy_thresh=100.0)
    rng = np.random.default_rng(8)
    images = [rng.uniform(0, 255, shape).astype(np.uint8)
              for shape in ((100, 140, 3), (100, 140, 3), (90, 120, 3))]
    model = yd.YOLOV3(net_size=NET, precision=precision, device="cpu")
    jax_model = jax_yd.YOLOV3(net_size=NET, precision=precision)
    for image in images:
        got = model.detect_person(image, **kw)
        eager = yd.detect_coco("", image, 0.3, 0.45, precision, net_size=NET,
                               params_state=net["sd"], device="cpu")
        again = yd.detect_coco("", image, 0.3, 0.45, precision, net_size=NET,
                               device="cpu", forward=model._forward,
                               programs=model.programs)
        for a, b in zip(again, eager, strict=True):
            np.testing.assert_array_equal(a, b)
        if precision == "float32":
            want = jax_model.detect_person(image, **kw)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                np.testing.assert_allclose([g.xmin, g.ymin, g.xmax, g.ymax],
                                           [w.xmin, w.ymin, w.xmax, w.ymax],
                                           rtol=BOX_PIXEL_RTOL, atol=1.0)
                np.testing.assert_allclose(g.classes, w.classes, atol=SCORE_ATOL)
    model.detect_person(images[0], **dict(kw, obj_thresh=0.4))
    assert model.programs.keys() == [
        ("coco", precision, NET, 100, 140, 0.3, 0.45),
        ("coco", precision, NET, 90, 120, 0.3, 0.45),
        ("coco", precision, NET, 100, 140, 0.4, 0.45)]  # least recently used first
    with pytest.raises(ValueError, match="program cache"):
        yd.detect_coco("", images[0], precision="int8", device="cpu",
                       forward=model._forward, programs=model.programs)


def test_yolov3_class_detect_object_matches_jax(net, tmp_path, monkeypatch):
    """YOLOV3.detect_object (docker variant): the entropy-filtered boxes and
    the `[:-5]` output name equal the JAX package's; detect_person agrees."""
    monkeypatch.chdir(tmp_path)
    keras_import.save_yolov3_keras_h5(net["sd"], "yolov3_model.h5")
    img = str(tmp_path / "scene.jpeg")
    imsave(img, np.random.default_rng(4).uniform(0, 255, (100, 140, 3)).astype(np.uint8))
    kw = dict(obj_thresh=0.3, cls_thresh=0.0, nms_thresh=0.45,
              human_entropy_thresh=100.0, bottle_entropy_thresh=100.0)
    _, want = jax_yd.YOLOV3(net_size=NET).detect_object(img, **kw)
    image, got = yd.YOLOV3(net_size=NET, device="cpu").detect_object(img, **kw)
    assert image.shape == (100, 140, 3)
    assert os.path.exists(str(tmp_path / "scene_detected.jpeg"))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose([g.xmin, g.ymin, g.xmax, g.ymax],
                                   [w.xmin, w.ymin, w.xmax, w.ymax],
                                   rtol=BOX_PIXEL_RTOL, atol=1.0)
        np.testing.assert_allclose(g.classes, w.classes, atol=SCORE_ATOL)
    persons = yd.YOLOV3(net_size=NET, device="cpu").detect_person(image, **kw)
    assert all(b.classes.shape == (80,) for b in persons)
