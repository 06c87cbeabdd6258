"""Host-side metrics and ROC reporting, in numpy.

The artifacts and their schemas are the JAX package's (``utils/metrics.py``):
per-task accuracy, weighted precision / recall / F1 and confusion matrix,
macro, micro and per-class ROC-AUC with binary and multiclass branches
that tolerate absent classes, and the JSON, CSV and PNG files.  The JAX
package computes them with scikit-learn; here the same functions are
written in numpy (the card's machine has no scikit-learn), each with
scikit-learn's semantics as the JAX package calls it:

- ``precision_recall_fscore``: ``zero_division=0``, over the sorted union
  of the labels in ``y_true`` and ``y_pred`` unless ``labels`` is given;
  ``average`` None, "macro" or "weighted" (weights: each label's true
  count, the plain mean when they sum to zero);
- ``confusion_matrix``: rows true, columns predicted, on the same labels;
- ``roc_curve``: distinct-score thresholds, ``drop_intermediate=True``, a
  leading ``inf`` threshold; ``auc``: the trapezoid rule with the
  direction check; ``roc_auc_score``: None where only one class is
  present (scikit-learn raised there when the reference was written).

The ROC figures are drawn with matplotlib, imported only when one is.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import IGNORE_INDEX, UNKNOWN_PRED


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# ---------------------------------------------------------------------------
# scikit-learn's metrics, as the workloads call them
# ---------------------------------------------------------------------------


def unique_labels(*ys) -> np.ndarray:
    """Sorted union of the labels in the given arrays."""
    return np.unique(np.concatenate([np.asarray(y) for y in ys]))


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den in float64, 0 where den is 0 (``zero_division=0``)."""
    num = num.astype(np.float64)
    den = den.astype(np.float64)
    out = num / np.where(den == 0, 1.0, den)
    out[den == 0] = 0.0
    return out


def precision_recall_fscore(y_true, y_pred, labels=None, average: Optional[str] = "weighted"):
    """(precision, recall, F1): per label when ``average`` is None, else
    their "macro" or "weighted" average as floats."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = unique_labels(y_true, y_pred) if labels is None else np.asarray(labels)
    t = y_true[:, None] == labels[None, :]
    p = y_pred[:, None] == labels[None, :]
    tp, pred, true = (t & p).sum(axis=0), p.sum(axis=0), t.sum(axis=0)
    scores = (_divide(tp, pred), _divide(tp, true), _divide(2.0 * tp, 1.0 * true + pred))
    if average is None:
        return scores
    if average not in ("macro", "weighted"):
        raise ValueError(f"average must be None, 'macro' or 'weighted', got {average!r}")
    w = true.astype(np.float64) if average == "weighted" else None
    if w is not None and w.sum() == 0.0:
        w = None
    return tuple(float(np.mean(s) if w is None else np.sum(s * w) / np.sum(w)) for s in scores)


def confusion_matrix(y_true, y_pred, labels=None) -> np.ndarray:
    """[L, L] int64 counts, rows the true label, columns the predicted one;
    samples whose labels are not in ``labels`` are left out."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = unique_labels(y_true, y_pred) if labels is None else np.asarray(labels)
    t = (y_true[:, None] == labels[None, :]).astype(np.int64)
    p = (y_pred[:, None] == labels[None, :]).astype(np.int64)
    return t.T @ p


def roc_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) of 0/1 labels against scores, positive
    class 1."""
    y = (np.asarray(y_true) == 1).astype(np.float64)
    score = np.asarray(y_score)
    order = np.argsort(-score, kind="stable")
    score, y = score[order], y[order]
    idx = np.r_[np.nonzero(np.diff(score))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    thresholds = score[idx]
    if fps.shape[0] > 2:  # drop points on a straight segment
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """Area under the curve (x, y) by the trapezoid rule; x must be
    monotonic, either way."""
    x, y = np.asarray(x), np.asarray(y)
    if x.shape[0] < 2:
        raise ValueError(f"at least 2 points are needed to compute an area, got {x.shape}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing: {x}")
        direction = -1
    return float(direction * np.sum(dx * (y[1:] + y[:-1]) / 2.0))


def roc_auc_score(y_true, y_score) -> Optional[float]:
    """ROC-AUC of 0/1 labels; None when only one class is present."""
    if len(np.unique(y_true)) != 2:
        return None
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


# ---------------------------------------------------------------------------
# The workloads' metric dicts and artifacts
# ---------------------------------------------------------------------------


def task_metrics_and_roc(
    task: str,
    class_names: Sequence[str],
    preds: np.ndarray,
    labels: np.ndarray,
    probs: np.ndarray,
    roc_dir: Optional[str] = None,
) -> Dict:
    """One task's metric dict (the ``metrics_test.json`` per-task schema).

    preds may hold UNKNOWN_PRED (-1, below threshold): the discrete scores
    are computed on the non-Unknown subset; ROC uses every labeled sample.
    """
    class_names = list(class_names)
    valid = preds != UNKNOWN_PRED
    if valid.sum() > 0:
        acc = float(np.mean(preds[valid] == labels[valid]))
        prec, rec, f1 = precision_recall_fscore(labels[valid], preds[valid], average="weighted")
        conf = confusion_matrix(labels[valid], preds[valid]).tolist()
    else:
        acc = prec = rec = f1 = 0.0
        conf = []

    auc_macro, auc_micro, auc_per_class, roc_png = _roc_analysis(
        task, class_names, labels, probs, roc_dir
    )
    return {
        "accuracy": acc,
        "precision": prec,
        "recall": rec,
        "f1_score": f1,
        "confusion_matrix": conf,
        "auc_macro": auc_macro,
        "auc_micro": auc_micro,
        "auc_per_class": auc_per_class if auc_per_class else None,
        "roc_png": roc_png,
        "class_names": class_names,
    }


def _roc_analysis(
    task: str,
    class_names: List[str],
    labels: np.ndarray,
    probs: np.ndarray,
    roc_dir: Optional[str],
) -> Tuple[Optional[float], Optional[float], Dict[str, float], Optional[str]]:
    """Binary or one-vs-rest ROC with the CSV and PNG artifacts; classes
    absent from the labels get no curve."""
    auc_macro = auc_micro = None
    auc_per_class: Dict[str, float] = {}
    roc_png = None
    if roc_dir:
        os.makedirs(roc_dir, exist_ok=True)  # before any savefig below
    if probs.shape[0] == 0:
        return auc_macro, auc_micro, auc_per_class, roc_png

    rows: List[List] = []
    keep = labels != IGNORE_INDEX
    y_true, p = labels[keep], probs[keep]
    n_classes = len(class_names)
    present = np.unique(y_true)

    if len(present) >= 2 and p.shape[1] == n_classes:
        if n_classes == 2:
            if {0, 1}.issubset(set(present.tolist())):
                pos_name = class_names[1]
                fpr, tpr, _ = roc_curve((y_true == 1).astype(int), p[:, 1])
                a = auc(fpr, tpr)
                auc_per_class[pos_name] = a
                auc_macro = auc_micro = a
                rows += [["binary", pos_name, float(x), float(y)] for x, y in zip(fpr, tpr)]
                if roc_dir:
                    plt = _plt()
                    plt.figure(figsize=(7, 6))
                    plt.plot(fpr, tpr, lw=2, label=f"{pos_name} (AUC={a:.3f})")
                    plt.plot([0, 1], [0, 1], "--", color="gray", lw=1)
                    plt.xlim([0, 1]); plt.ylim([0, 1.05])
                    plt.xlabel("False Positive Rate"); plt.ylabel("True Positive Rate")
                    plt.title(f"ROC - Task: {task} (binary)")
                    plt.legend(loc="lower right", fontsize=9)
                    roc_png = os.path.join(roc_dir, f"{task}_roc.png")
                    plt.tight_layout(); plt.savefig(roc_png, dpi=150); plt.close()
        else:
            y_bin = (y_true[:, None] == np.arange(n_classes)[None, :]).astype(int)
            curves, aucs, valid_idx = {}, {}, []
            for c in range(n_classes):
                y_c = y_bin[:, c]
                if 0 < y_c.sum() < y_c.shape[0]:
                    fpr, tpr, _ = roc_curve(y_c, p[:, c])
                    curves[c], aucs[c] = (fpr, tpr), auc(fpr, tpr)
                    auc_per_class[class_names[c]] = aucs[c]
                    valid_idx.append(c)
                    rows += [
                        ["ovr", class_names[c], float(x), float(y)]
                        for x, y in zip(fpr, tpr)
                    ]
            if valid_idx:
                auc_macro = float(np.mean([aucs[c] for c in valid_idx]))
                y_mi = y_bin[:, valid_idx].ravel()
                p_mi = p[:, valid_idx].ravel()
                fpr_mi, tpr_mi, _ = roc_curve(y_mi, p_mi)
                auc_micro = auc(fpr_mi, tpr_mi)
                rows += [["micro", "micro", float(x), float(y)] for x, y in zip(fpr_mi, tpr_mi)]
                if roc_dir:
                    plt = _plt()
                    plt.figure(figsize=(9, 7))
                    for c in valid_idx:
                        fpr, tpr = curves[c]
                        plt.plot(fpr, tpr, lw=1.2, alpha=0.8,
                                 label=f"{class_names[c]} (AUC={aucs[c]:.3f})")
                    plt.plot(fpr_mi, tpr_mi, lw=2.0, color="black",
                             label=f"micro-avg (AUC={auc_micro:.3f})")
                    plt.plot([0, 1], [0, 1], "--", color="gray", lw=1)
                    plt.xlim([0, 1]); plt.ylim([0, 1.05])
                    plt.xlabel("False Positive Rate"); plt.ylabel("True Positive Rate")
                    plt.title(f"ROC - Task: {task} (multiclass)")
                    plt.legend(loc="lower right", fontsize=8)
                    roc_png = os.path.join(roc_dir, f"{task}_roc.png")
                    plt.tight_layout(); plt.savefig(roc_png, dpi=150); plt.close()

    if roc_dir:
        with open(os.path.join(roc_dir, f"{task}_roc_data.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["curve_type", "class_name", "fpr", "tpr"])
            w.writerows(rows)
    return auc_macro, auc_micro, auc_per_class, roc_png


def family_confusion(preds: np.ndarray, labels: np.ndarray, k: int) -> list:
    """The PM and RTM artifacts' confusion matrix: the full k x k
    (``labels=range(k)``) on the non-Unknown predictions, a zero k x k
    float matrix when every prediction is Unknown."""
    valid = preds != UNKNOWN_PRED
    if valid.sum() == 0:
        return np.zeros((k, k)).tolist()
    return confusion_matrix(labels[valid], preds[valid], labels=list(range(k))).tolist()


def write_metrics_summary_csv(path: str, metrics: Dict[str, Dict]) -> None:
    """metrics_test_summary.csv."""
    fieldnames = [
        "task", "accuracy", "precision", "recall", "f1_score",
        "auc_macro", "auc_micro", "roc_png",
    ]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        for task, m in metrics.items():
            w.writerow(
                {
                    "task": task,
                    "accuracy": m["accuracy"],
                    "precision": m["precision"],
                    "recall": m["recall"],
                    "f1_score": m["f1_score"],
                    "auc_macro": m["auc_macro"] if m["auc_macro"] is not None else "",
                    "auc_micro": m["auc_micro"] if m["auc_micro"] is not None else "",
                    "roc_png": m["roc_png"] or "",
                }
            )
