"""The port's copies of the mAP harness (evals/detection.py) and of the
evaluate CLI's detection modes (api/evaluate.py) held to the JAX package's.

Both are jax-free modules the port may not import. The harness is a copy:
its source after the module docstring equals the original's, and on the
same solution files both give the same P-R curves and APs, bit for bit. The
CLI's detection modes write the same p_r_curve.h5 and render a PNG (its
identification modes: tests/test_torch_identification.py).
"""

import ast
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest

from face_vijnana_yolov3_tpu.api import evaluate as jax_evaluate
from face_vijnana_yolov3_tpu.evals import detection as jax_detection
from face_vijnana_yolov3_tpu_torch.api import evaluate
from face_vijnana_yolov3_tpu_torch.evals import detection


def _body(module) -> str:
    """The module's source without its docstring."""
    tree = ast.parse(Path(module.__file__).read_text())
    tree.body = tree.body[1:]
    return ast.unparse(tree)


def test_harness_source_equals_the_original():
    assert _body(detection) == _body(jax_detection)


def _fixture(tmp_path, seed):
    """A validation.csv and a solution_fd.csv of 12 images: each GT face
    found with some jitter or missed, plus false positives."""
    rng = np.random.default_rng(seed)
    gt_rows, sol = [], []
    for i in range(12):
        name = f"im{i}.jpg"
        for _ in range(int(rng.integers(1, 4))):
            x, y = rng.integers(0, 300, 2)
            w, h = rng.integers(15, 80, 2)
            gt_rows.append({"FACE_ID": len(gt_rows), "FILE": name, "SUBJECT_ID": 1,
                            "FACE_X": x, "FACE_Y": y, "FACE_WIDTH": w, "FACE_HEIGHT": h})
            if rng.uniform() < 0.8:
                j = rng.normal(0, 4, 4)
                sol.append(f"{name},{x + j[0]},{y + j[1]},{w + j[2]},{h + j[3]},"
                           f"{rng.uniform(0.3, 1.0)}")
        for _ in range(int(rng.integers(0, 3))):
            x, y, w, h = rng.uniform(0, 300, 4)
            sol.append(f"{name},{x},{y},{w},{h},{rng.uniform(0.0, 0.6)}")
    gt = tmp_path / "validation.csv"
    pd.DataFrame(gt_rows).to_csv(gt, index=False)
    sol_path = tmp_path / "solution_fd.csv"
    sol_path.write_text("\n".join(sol) + "\n")
    return str(gt), str(sol_path)


@pytest.mark.parametrize("seed", [0, 1])
def test_map_sweep_equals_the_original(tmp_path, seed):
    gt, sol = _fixture(tmp_path, seed)
    got = detection.map_sweep(gt, sol, out_h5=None)
    want = jax_detection.map_sweep(gt, sol, out_h5=None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < got[2][0] <= 1
    for th in (0.5, 0.75):
        for g, w in zip(detection.cal_mAP_fd(gt, sol, th), jax_detection.cal_mAP_fd(gt, sol, th)):
            np.testing.assert_array_equal(g, w)


def test_cli_detection_modes_equal_the_original(tmp_path, monkeypatch):
    gt, sol = _fixture(tmp_path, 2)
    monkeypatch.chdir(tmp_path)
    jax_evaluate.main(["-m", "cal_map_fd", "-g", gt, "-s", sol])
    (tmp_path / "p_r_curve.h5").rename(tmp_path / "jax.h5")
    evaluate.main(["-m", "cal_map_fd", "-g", gt, "-s", sol, "--plot", "pr.png"])
    with h5py.File(tmp_path / "p_r_curve.h5", "r") as f, \
            h5py.File(tmp_path / "jax.h5", "r") as g:
        assert set(f) == set(g) == {"ps_ls", "rs_ls", "mAP_ls"}
        for k in f:
            np.testing.assert_array_equal(f[k][()], g[k][()])
    assert (tmp_path / "pr.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    evaluate.main(["-m", "plot_p_r_curve", "-s", "p_r_curve.h5", "--plot", "cli.png"])
    assert (tmp_path / "cli.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(SystemExit):
        evaluate.main(["-m", "nope"])
