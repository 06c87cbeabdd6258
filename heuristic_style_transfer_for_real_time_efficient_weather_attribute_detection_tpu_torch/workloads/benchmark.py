"""External-benchmark evaluation with class mapping.

The JAX package's ``workloads/benchmark.py`` on the port's engine, with its
artifacts: best_mapping.json, benchmark_summary.json and roc_<task>.png.
The folder walk stays on the host; the images go through the engine in
prefetched batches.

Every stage works on one object per task, the assignment vector
``assign[m] -> b`` sending model class ``m`` to benchmark class ``b``: the
mapping JSON, the auto-mapping search, the probability projection (a
one-hot matmul) and the confusion scoring all read or produce it.
Auto-mapping scores small instances exhaustively, as batches of
assignment vectors through one einsum, and large ones by restarted
coordinate ascent on macro-F1.  The metrics are computed in numpy
(``utils.metrics``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import BatchLoader
from ..engine.executor import Engine
from ..ops.preprocess import is_image_name
from ..utils.metrics import precision_recall_fscore, roc_auc_score, roc_curve

EXHAUSTIVE_LIMIT = 2_000_000  # max B**M states for brute force
_CHUNK = 8192  # assignment vectors scored per einsum batch


def walk_benchmark_folder(
    benchmark_folder: str, bench_classes: Dict[str, List[str]]
) -> List[Tuple[str, str]]:
    """[(image_path, top_level_class_dir)] for images under a top-level
    directory named by a benchmark class (case-sensitive)."""
    known_tops = {c for names in bench_classes.values() for c in names}
    images = []
    for root, _, files in os.walk(benchmark_folder):
        rel = os.path.relpath(root, benchmark_folder)
        top = rel.split(os.sep)[0]
        if rel == "." or top not in known_tops:
            continue
        images.extend(
            (os.path.join(root, fn), top) for fn in files if is_image_name(fn)
        )
    return images


# ---------------------------------------------------------------------------
# Assignment-vector algebra
# ---------------------------------------------------------------------------


def _one_hot(assign: np.ndarray, B: int) -> np.ndarray:
    """(..., M) int assignment -> (..., M, B) float one-hot projection."""
    return (np.asarray(assign)[..., None] == np.arange(B)).astype(np.float64)


def _batch_macro_f1(C: np.ndarray, assigns: np.ndarray) -> np.ndarray:
    """Macro-F1 of each assignment vector in a (K, M) batch against the
    model-class x bench-class count matrix C (M, B), as the reference's
    scalar scoring computes it: a class with zero predicted+true mass
    contributes F1 = 0.

    Fully vectorized: the bench-space confusion for all K candidates is one
    einsum over the one-hot projections.
    """
    C = np.asarray(C, dtype=np.float64)
    B = C.shape[1]
    onehot = _one_hot(assigns, B)  # (K, M, B)
    # A[k, p, t] = count of samples sent to bench class p with true class t.
    A = np.einsum("kmp,mt->kpt", onehot, C)
    tp = np.diagonal(A, axis1=1, axis2=2)  # (K, B)
    mass = A.sum(axis=2) + A.sum(axis=1)  # predicted + true totals
    f1 = np.divide(2.0 * tp, mass, out=np.zeros_like(tp), where=mass > 0)
    return f1.mean(axis=1)


def _macro_f1_from_assignment(C: np.ndarray, vec: Sequence[int], B: int) -> float:
    """Scalar convenience wrapper over the batch scorer."""
    del B  # implied by C's second axis
    return float(_batch_macro_f1(C, np.asarray(vec)[None, :])[0])


def _assignment_chunks(M: int, B: int) -> Iterator[np.ndarray]:
    """Yield every assignment vector in {0..B-1}^M as (<=_CHUNK, M) arrays,
    in mixed-radix order (last model class varies fastest)."""
    total = B**M
    radix = B ** np.arange(M - 1, -1, -1, dtype=np.int64)
    for start in range(0, total, _CHUNK):
        idx = np.arange(start, min(start + _CHUNK, total), dtype=np.int64)
        yield (idx[:, None] // radix) % B


def auto_map_task(C: np.ndarray) -> Tuple[List[int], float]:
    """Best model->bench assignment vector maximizing macro-F1.

    Exhaustive (batched einsum) when B**M is small, the reference's
    optimum; otherwise multi-restart coordinate ascent, where each sweep's
    rescoring of one model class evaluates all B candidates as a batch.
    """
    M, B = C.shape
    if B**M <= EXHAUSTIVE_LIMIT:
        best_s, best_v = -1.0, None
        for cand in _assignment_chunks(M, B):
            scores = _batch_macro_f1(C, cand)
            k = int(scores.argmax())
            if scores[k] > best_s:
                best_s, best_v = float(scores[k]), list(map(int, cand[k]))
        return best_v, best_s

    rng = np.random.RandomState(0)
    starts = np.vstack(
        [np.argmax(C, axis=1)] + [rng.randint(0, B, size=M) for _ in range(7)]
    )
    best_s, best_v = -1.0, None
    for vec in starts:
        vec = vec.copy()
        score = float(_batch_macro_f1(C, vec[None, :])[0])
        improved = True
        while improved:
            improved = False
            for mc in range(M):
                cand = np.repeat(vec[None, :], B, axis=0)
                cand[:, mc] = np.arange(B)
                scores = _batch_macro_f1(C, cand)
                k = int(scores.argmax())
                if scores[k] > score + 1e-12 and k != vec[mc]:
                    score, vec[mc], improved = float(scores[k]), k, True
        if score > best_s:
            best_s, best_v = score, list(map(int, vec))
    return best_v, best_s


def _assignment_from_json(
    mapping_for_task: Dict[str, List[str]],
    model_names: Sequence[str],
    bench_names: Sequence[str],
) -> np.ndarray:
    """Assignment vector from the user's bench->model-classes JSON.

    Case-insensitive membership; a model class listed nowhere falls into the
    catch-all last bench class.
    """
    B = len(bench_names)
    lowered = [n.lower() for n in model_names]
    assign = np.full(len(model_names), B - 1, dtype=np.int64)
    for b, bench_cls in enumerate(bench_names):
        members = {n.lower() for n in mapping_for_task.get(bench_cls, ())}
        hits = [i for i, n in enumerate(lowered) if n in members]
        assign[hits] = b
    return assign


def _assignment_to_json(
    assign: np.ndarray, model_names: Sequence[str], bench_names: Sequence[str]
) -> Dict[str, List[str]]:
    """Group model classes by their assigned bench class (best_mapping.json
    schema: bench class -> ordered list of model-class names)."""
    return {
        bench: [model_names[i] for i in np.flatnonzero(assign == b)]
        for b, bench in enumerate(bench_names)
    }


# ---------------------------------------------------------------------------
# Metrics + plotting in benchmark space
# ---------------------------------------------------------------------------


def _named(names: Sequence[str], values) -> Dict[str, Optional[float]]:
    return {
        n: (None if v is None else float(v)) for n, v in zip(names, values)
    }


def _roc_figure(
    path: str, task: str, bench_names: Sequence[str], y_true: np.ndarray,
    p_bench: np.ndarray, auc_pc: List[Optional[float]]
) -> None:
    """One-vs-rest ROC curves for every bench class with a defined AUC."""
    from ..utils.metrics import _plt

    plt = _plt()
    fig, ax = plt.subplots()
    cmap = plt.get_cmap("tab10")
    for b, name in enumerate(bench_names):
        if auc_pc[b] is None:
            continue
        fpr, tpr, _ = roc_curve((y_true == b).astype(int), p_bench[:, b])
        ax.plot(fpr, tpr, color=cmap(b % 10), label=f"{name} AUC={auc_pc[b]:.2f}")
    ax.plot([0, 1], [0, 1], linestyle="--", color="black", linewidth=0.8)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.set_title(f"{task}: one-vs-rest ROC")
    ax.legend(loc="lower right")
    fig.savefig(path)
    plt.close(fig)


def _task_summary(
    task: str, bench_names: Sequence[str], y_true: np.ndarray,
    p_bench: np.ndarray, roc_dir: str
) -> Dict:
    """Per-task block of benchmark_summary.json (the reference's summary
    schema)."""
    B = len(bench_names)
    y_pred = p_bench.argmax(axis=1)
    # one-vs-rest AUC per class; None where y_true holds one class only
    auc_pc: List[Optional[float]] = [
        roc_auc_score((y_true == b).astype(int), p_bench[:, b]) for b in range(B)
    ]
    defined = [a for a in auc_pc if a is not None]

    _roc_figure(
        os.path.join(roc_dir, f"roc_{task.replace(' ', '_')}.png"),
        task, bench_names, y_true, p_bench, auc_pc,
    )
    prec, rec, f1 = precision_recall_fscore(y_true, y_pred, labels=list(range(B)), average=None)
    prec_m, rec_m, f1_m = precision_recall_fscore(y_true, y_pred, average="macro")
    return {
        "n_samples": int(len(y_true)),
        "per_class": {
            "precision": _named(bench_names, prec),
            "recall": _named(bench_names, rec),
            "f1_score": _named(bench_names, f1),
            "auc": _named(bench_names, auc_pc),
        },
        "global": {
            "precision_macro": prec_m,
            "recall_macro": rec_m,
            "f1_macro": f1_m,
            # The reference's truthiness test (``if any(auc_pc)``): when
            # every defined per-class AUC is exactly 0.0 it reports None.
            "auc_macro": float(np.mean(defined)) if any(auc_pc) else None,
        },
    }


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def run_benchmark(
    engine: Engine,
    benchmark_folder: str,
    mapping_path: str,
    save_dir: str,
    roc_dir: str,
    auto_mapping: bool = False,
    num_samples: Optional[int] = None,
    num_workers: int = 4,
    save_pred_images: bool = False,
    pred_images_dir: Optional[str] = None,
    overlay_topk: int = 1,
    draw_prob_threshold: Optional[float] = None,
) -> Dict:
    """Full benchmark mode -> best_mapping.json + benchmark_summary.json +
    roc_<task>.png, returning the summary dict.

    ``save_pred_images`` writes GT/Pred overlays (with ``cv2``) to
    ``pred_images_dir`` (default <save_dir>/pred_images): ``overlay_topk``
    classes per task line, and task lines whose top probability is below
    ``draw_prob_threshold`` left out."""
    tasks = engine.tasks
    tasks_json = tasks.as_dict()
    with open(mapping_path, "r") as f:
        initial_mapping = json.load(f)
    unknown = [t for t in initial_mapping if t not in tasks_json]
    if unknown:
        # name the mistake up front rather than fail later on a KeyError
        raise ValueError(
            f"benchmark mapping names task(s) not in the model's registry: "
            f"{unknown}; available tasks: {list(tasks_json)}"
        )
    bench_classes = {t: list(initial_mapping[t].keys()) for t in initial_mapping}

    images = walk_benchmark_folder(benchmark_folder, bench_classes)
    if num_samples and num_samples < len(images):
        rng = np.random.RandomState(0)
        images = [images[i] for i in rng.permutation(len(images))[:num_samples]]

    # Ground-truth bench index per task (case-insensitive; unmatched -> the
    # last class).
    gt: Dict[str, np.ndarray] = {}
    for task in initial_mapping:
        lowers = [b.lower() for b in bench_classes[task]]
        idxs = []
        for _, bench_cls in images:
            low = bench_cls.lower()
            idxs.append(lowers.index(low) if low in lowers else len(lowers) - 1)
        gt[task] = np.asarray(idxs, np.int64)

    # Batched device forwards; raw frames, which the stem kernel reads
    loader = BatchLoader([p for p, _ in images], batch_size=engine.batch_size,
                         num_workers=num_workers)
    res, _ = engine.run_stream(loader, collect=("probs",))
    probs_all = (
        res["probs"]
        if len(res["probs"])
        else np.zeros((0, len(tasks), tasks.max_classes))
    )

    model_probs = {}
    model_preds = {}
    for task in initial_mapping:
        ti = tasks.names.index(task)
        k = tasks.num_classes[ti]
        p = probs_all[:, ti, :k]
        model_probs[task] = p
        model_preds[task] = p.argmax(axis=1) if len(p) else np.zeros((0,), np.int64)

    # Model-class x bench-class confusion, one one-hot matmul per task.
    confusion = {
        task: (
            _one_hot(model_preds[task], len(tasks_json[task])).T  # (M, N)
            @ _one_hot(gt[task], len(bench_classes[task]))  # (N, B)
        ).astype(np.int64)
        for task in initial_mapping
    }

    # Per-task assignment vector: searched, or decoded from the mapping JSON.
    assignment: Dict[str, np.ndarray] = {}
    for task in initial_mapping:
        if auto_mapping:
            vec, score = auto_map_task(confusion[task])
            assignment[task] = np.asarray(vec, np.int64)
            print(f"[auto-map] best macro-F1 '{task}' = {score:.4f}")
        else:
            assignment[task] = _assignment_from_json(
                initial_mapping[task], tasks_json[task], bench_classes[task]
            )

    final_mapping = {
        task: _assignment_to_json(assignment[task], tasks_json[task], bench_classes[task])
        for task in initial_mapping
    }
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "best_mapping.json"), "w") as f:
        json.dump(final_mapping, f, indent=2)

    # Benchmark-space probabilities: one one-hot projection matmul per task.
    os.makedirs(roc_dir, exist_ok=True)
    proj = {t: _one_hot(assignment[t], len(bench_classes[t])) for t in initial_mapping}
    bench_space = {t: model_probs[t] @ proj[t] for t in initial_mapping}
    summary = {}
    for task in initial_mapping:
        p_bench = bench_space[task]
        if p_bench.shape[0] == 0:
            print(f"[Warning] no probabilities for task '{task}', metrics skipped.")
            continue
        summary[task] = _task_summary(
            task, bench_classes[task], gt[task], p_bench, roc_dir
        )

    with open(os.path.join(save_dir, "benchmark_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"benchmark summary saved to {os.path.join(save_dir, 'benchmark_summary.json')}")

    if save_pred_images:
        # GT/Pred overlays, green when correct / red when wrong per task.
        import cv2

        pred_dir = pred_images_dir or os.path.join(save_dir, "pred_images")
        os.makedirs(pred_dir, exist_ok=True)
        for i, (path, bench_cls) in enumerate(images):
            img = cv2.imread(path)
            if img is None:
                continue
            y = 24
            for task in initial_mapping:
                pb = bench_space[task][i]
                pred_idx = int(pb.argmax())
                if (draw_prob_threshold is not None
                        and pb[pred_idx] < draw_prob_threshold):
                    continue
                ok = pred_idx == gt[task][i]
                color = (0, 200, 0) if ok else (0, 0, 255)
                k = max(1, min(int(overlay_topk), len(pb)))
                # stable descending sort: top[0] == pb.argmax()
                # even under tied maxima (color/text agree)
                top = np.argsort(-pb, kind="stable")[:k]
                pred_txt = " | ".join(
                    f"{bench_classes[task][j]} ({pb[j]:.2f})" for j in top
                )
                line = (
                    f"{task}: GT={bench_classes[task][gt[task][i]]} "
                    f"Pred={pred_txt}"
                )
                cv2.putText(img, line, (8, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                            color, 1, cv2.LINE_AA)
                y += 20
            cv2.imwrite(
                os.path.join(pred_dir, f"{i:05d}_{os.path.basename(path)}"), img
            )
    return summary
