"""Identification metrics — VAL/FAR and accuracy harnesses.

A copy of face_vijnana_yolov3_tpu/evals/identification.py:15-210
(tests/test_torch_evals.py holds it to the original), file formats included
(face_pairs_dists.h5, val_far.h5, fi_acc.h5). Parity with reference
src/space/evaluate.py:129-329, with the JAX package's one fix: the
reference writes the python builtin `vars` into val_far.h5 (`f['vals'] =
vars`, evaluate.py:220 — a crash); here the computed VAL array is written.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def cal_face_pairs_dists(
    db_csv: str = "subject_image_db.csv",
    ids_h5: str = "subject_facial_ids.h5",
    out_h5: str | None = "face_pairs_dists.h5",
    rng: np.random.Generator | None = None,
):
    """Same/different-subject embedding L2 distances (evaluate.py:129-194)."""
    import h5py

    db = pd.read_csv(db_csv)
    db = db.iloc[:, 1:]
    db_g = db.groupby("subject_id")
    same_dists: list[float] = []
    diff_dists: list[float] = []
    rng = rng or np.random.default_rng()

    with h5py.File(ids_h5, "r") as f:
        subject_ids = list(db_g.groups.keys())

        for subject_id in subject_ids:
            if subject_id == -1:
                continue
            df = db_g.get_group(subject_id)
            file_names = list(df.iloc[:, 1])
            if len(file_names) < 2:
                continue
            embs = np.stack([f[fn][()] for fn in file_names])
            # all i<j pairs — vectorized equivalent of the reference's loops
            d = np.linalg.norm(embs[:, None, :] - embs[None, :, :], axis=-1)
            iu = np.triu_indices(len(file_names), k=1)
            same_dists.extend(d[iu].tolist())

        idxes = range(len(subject_ids))
        num_pairs = len(subject_ids) // 2
        pairs = rng.choice(idxes, size=(num_pairs, 2), replace=False)

        for i in range(pairs.shape[0]):
            k, l = int(pairs[i, 0]), int(pairs[i, 1])
            if subject_ids[k] == -1 or subject_ids[l] == -1:
                continue
            ref_files = list(db_g.get_group(subject_ids[k]).iloc[:, 1])
            comp_files = list(db_g.get_group(subject_ids[l]).iloc[:, 1])
            ref_embs = np.stack([f[fn][()] for fn in ref_files])
            comp_embs = np.stack([f[fn][()] for fn in comp_files])
            d = np.linalg.norm(
                ref_embs[:, None, :] - comp_embs[None, :, :], axis=-1
            )
            diff_dists.extend(d.reshape(-1).tolist())

    same_dists = np.asarray(same_dists)
    diff_dists = np.asarray(diff_dists)
    if out_h5:
        import h5py

        with h5py.File(out_h5, "w") as f:
            f["same_dists"] = same_dists
            f["diff_dists"] = diff_dists
    return same_dists, diff_dists


def cal_VAL_FAR(sim_th_range, out_h5: str | None = "val_far.h5", **pair_kwargs):
    """VAL/FAR sweep (evaluate.py:196-223, with the `vars` bug fixed)."""
    same_dists, diff_dists = cal_face_pairs_dists(out_h5=None, **pair_kwargs)
    sim_ths, vals, fars = [], [], []
    for sim_th in sim_th_range:
        sim_ths.append(sim_th)
        vals.append((same_dists <= sim_th).sum() / same_dists.shape[0])
        fars.append((diff_dists <= sim_th).sum() / diff_dists.shape[0])
    sim_ths, vals, fars = map(np.asarray, (sim_ths, vals, fars))
    if out_h5:
        import h5py

        with h5py.File(out_h5, "w") as f:
            f["sim_ths"] = sim_ths
            f["vals"] = vals  # reference wrote the builtin `vars` here (bug)
            f["fars"] = fars
    return sim_ths, vals, fars


def cal_acc_fi(gt_path: str, sol_path: str, iou_th: float):
    """Identification accuracy via greedy IoU matching + subject equality
    (evaluate.py:225-329), including the reference's exact branch order and its
    unmatched-row bookkeeping. Returns (tp, fp, tn, fn, acc)."""
    from face_vijnana_yolov3_tpu_torch.evals.detection import (
        _pairwise_iou_np,
    )

    tp = fp = tn = fn = 0
    sol_df = pd.read_csv(sol_path, header=None)
    gt_df = pd.read_csv(gt_path)
    sol_groups = sol_df.groupby(0)
    gt_groups = gt_df.groupby("FILE")

    for image_id in list(gt_groups.groups.keys()):
        df = gt_groups.get_group(image_id)
        gt_sids = df.iloc[:, 2].to_numpy()
        try:
            rel = sol_groups.get_group(image_id)
        except KeyError:
            for sid in gt_sids:
                if sid == -1:
                    tn += 1
                else:
                    fn += 1
            continue

        sol_sids = rel.iloc[:, 1].to_numpy()
        gt_boxes = np.stack(
            [
                df.iloc[:, 3].to_numpy(float),
                df.iloc[:, 4].to_numpy(float),
                df.iloc[:, 3].to_numpy(float) + df.iloc[:, 5].to_numpy(float),
                df.iloc[:, 4].to_numpy(float) + df.iloc[:, 6].to_numpy(float),
            ],
            axis=1,
        )
        sol_boxes = np.stack(
            [
                rel.iloc[:, 2].to_numpy(float),
                rel.iloc[:, 3].to_numpy(float),
                rel.iloc[:, 2].to_numpy(float) + rel.iloc[:, 4].to_numpy(float),
                rel.iloc[:, 3].to_numpy(float) + rel.iloc[:, 5].to_numpy(float),
            ],
            axis=1,
        )
        ious = np.nan_to_num(
            _pairwise_iou_np(gt_boxes, sol_boxes), nan=0.0, posinf=0.0, neginf=0.0
        )
        gi, pj = np.nonzero(ious > 0.0)
        if gi.size == 0:
            continue  # reference quirk: neither side's rows are counted (:283)
        vals = ious[gi, pj]
        order = np.argsort(-vals, kind="stable")
        used_g: set[int] = set()
        used_p: set[int] = set()
        gt_flag = np.zeros(df.shape[0], bool)
        sol_flag = np.zeros(rel.shape[0], bool)
        for k in order:
            i, j = int(gi[k]), int(pj[k])
            if i in used_g or j in used_p:
                continue
            iou = float(vals[k])
            g_sid, s_sid = gt_sids[i], sol_sids[j]
            if iou >= iou_th and g_sid != -1 and s_sid != -1 and g_sid == s_sid:
                tp += 1
            elif iou >= iou_th and s_sid != -1 and g_sid != s_sid:
                fp += 1
            elif g_sid == -1:
                tn += 1
            else:
                fn += 1
            gt_flag[i] = True
            sol_flag[j] = True
            used_g.add(i)
            used_p.add(j)

        for i in range(df.shape[0]):
            if gt_flag[i]:
                continue
            if gt_sids[i] == -1:
                tn += 1
            else:
                fn += 1
        for j in range(rel.shape[0]):
            if sol_flag[j]:
                continue
            if sol_sids[j] == -1:
                tn += 1
            else:
                fp += 1

    acc = (tp + tn) / (tp + tn + fp + fn)
    return tp, fp, tn, fn, acc


def acc_sweep(gt_path: str, sol_path: str, out_h5: str | None = "fi_acc.h5"):
    """IoU-threshold sweep 0.50:0.05:0.95 → fi_acc.h5 (evaluate.py:362-390)."""
    tp_ls, fp_ls, tn_ls, fn_ls, acc_ls = [], [], [], [], []
    for iou_th in np.arange(0.5, 1.0, 0.05):
        tp, fp, tn, fn, acc = cal_acc_fi(gt_path, sol_path, iou_th)
        print(f"\n{iou_th:1.2f}", tp, fp, tn, fn, acc)
        tp_ls.append(tp)
        fp_ls.append(fp)
        tn_ls.append(tn)
        fn_ls.append(fn)
        acc_ls.append(acc)
    if out_h5:
        import h5py

        with h5py.File(out_h5, "w") as f:
            f["tp_ls"] = np.asarray(tp_ls)
            f["fp_ls"] = np.asarray(fp_ls)
            f["tn_ls"] = np.asarray(tn_ls)
            f["fn_ls"] = np.asarray(fn_ls)
            f["acc_ls"] = np.asarray(acc_ls)
    return tp_ls, fp_ls, tn_ls, fn_ls, acc_ls
