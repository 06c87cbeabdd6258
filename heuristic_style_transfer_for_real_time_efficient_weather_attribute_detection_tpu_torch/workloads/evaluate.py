"""Batch dataset evaluation (the CLI's "classifier" mode).

One engine-driven pass over a loader: prefetched uint8 batches, the masked
cross entropy and softmax / threshold on the device, the metrics in numpy
on the host, and the JAX package's artifacts: metrics_test.json,
metrics_test_summary.csv, roc/<task>_roc.png and <task>_roc_data.csv,
times_classifier.json; for PM and RTM also test_metrics.json and
times_test.json.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import IGNORE_INDEX
from ..engine.executor import Engine
from ..utils import trace
from ..utils.metrics import family_confusion, task_metrics_and_roc, write_metrics_summary_csv

_PROFILED_BATCHES = 3  # batches a profile=True trace covers


def _start_profiler(engine: Engine):
    import torch.profiler as tp

    acts = [tp.ProfilerActivity.CPU]
    if engine.device.type == "cuda":
        acts.append(tp.ProfilerActivity.CUDA)
    prof = tp.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, prof_dir: str) -> None:
    """Write the device trace and, beside it, the summary of the program's
    spans in the session (``utils.trace``), which is also printed."""
    prof.stop()
    os.makedirs(prof_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
    summ = trace.summary()
    with open(os.path.join(prof_dir, "spans.json"), "w") as f:
        json.dump(summ, f, indent=1)
    print(trace.format_summary(summ))
    print(f"profiler trace and span summary written under {prof_dir}")


def evaluate(
    engine: Engine,
    loader,
    save_dir: str,
    measure_time: bool = False,
    tensorboard_writer=None,
    save_test_images: bool = False,
    group_task: Optional[str] = None,
    profile: bool = False,
    show_gt_labels: bool = True,
    scan_chunk="off",
) -> Tuple[float, Dict, float, list]:
    """Returns (avg_loss, metrics, overall_f1, per_batch_times), the
    reference's ``test_model_optimized`` contract.

    ``save_test_images`` writes annotated copies grouped into subfolders
    named by the ground-truth class of ``group_task`` (default: the first
    task).  ``profile`` records a ``torch.profiler`` trace of the first
    three batches to <save_dir>/profile/trace.json and the program's spans
    in it (per span: count, mean host and device ms; the counters) to
    spans.json beside it, also printed as a table.  ``show_gt_labels=False``
    drops the "True:" parts from the RTM overlay lines.

    ``scan_chunk`` ("off" default, "auto" or an int k) sends k consecutive
    full micro-batches through one ``Engine.step_scan`` dispatch; the
    metrics are the same bit for bit.  ``measure_time`` keeps per-batch
    dispatch: its telemetry is one wall time per batch.
    """
    tasks = engine.tasks
    os.makedirs(save_dir, exist_ok=True)
    roc_dir = os.path.join(save_dir, "roc")
    os.makedirs(roc_dir, exist_ok=True)
    if save_test_images:
        from PIL import Image

        from .inference import annotate_and_save

        group_task = group_task or tasks.names[0]
        gi = tasks.names.index(group_task)
        img_dir = os.path.join(save_dir, "test_images")
    prof_dir = os.path.join(save_dir, "profile")
    prof = _start_profiler(engine) if profile else None

    nt = len(tasks)
    all_preds = [[] for _ in range(nt)]
    all_labels = [[] for _ in range(nt)]
    all_probs = [[] for _ in range(nt)]
    loss_sum = 0.0
    total = 0
    times = []

    inflight = deque()
    _last_done = [time.perf_counter()]
    k_scan = 1 if measure_time else engine.resolve_scan_chunk(scan_chunk)
    if measure_time and engine.resolve_scan_chunk(scan_chunk) > 1:
        print("[evaluate] --measure_time needs per-batch telemetry; "
              "scan_chunk disabled for this run")
    keys = ("probs", "preds", "loss_per_task", "count_per_task")

    def _resolve():
        """Pop the oldest in-flight dispatch -> list of per-micro-batch
        (imgs, labs, batch_idx, result) tuples (one for a per-batch
        dispatch, k for a scanned one, split back into per-batch leaves)."""
        kind, payload = inflight.popleft()
        now = time.perf_counter()
        interval = now - _last_done[0]
        _last_done[0] = now
        if kind == "batch":
            imgs, labs, bidx, handle = payload
            # per-batch time = completion interval (the sum is about the
            # wall time; the first entry includes the pipeline fill)
            times.append(interval)
            return [(imgs, labs, bidx, engine.fetch(handle))]
        pairs, bidx0, handle = payload  # scanned: leaves are [k, bs, ...]
        host = engine.fetch(handle)
        times.extend([interval / len(pairs)] * len(pairs))
        return [
            (ci, cl, bidx0 + j, {key: v[j] for key, v in host.items()})
            for j, (ci, cl) in enumerate(pairs)
        ]

    def _completed():
        """Dispatch batches with up to 3 in flight; yield results in order.
        Each dispatch starts its results' copy to the host when it is
        enqueued.  Loader batches larger than the engine batch are split
        into micro-batches.  With ``scan_chunk`` active, consecutive full
        micro-batches go k at a time through one ``step_scan``; short and
        tail batches flush the buffer first, so row order is kept."""
        bidx = -1
        bs = engine.batch_size
        buf = []

        def _dispatch_one(ci, cl):
            nonlocal bidx
            bidx += 1
            inflight.append(("batch", (ci, cl, bidx, engine.dispatch(ci, cl, collect=keys[:2]))))

        def _flush_buf():
            while buf:
                _dispatch_one(*buf.pop(0))

        def _dispatch_scan():
            nonlocal bidx
            pairs = list(buf)
            buf.clear()
            stack = np.stack([engine._validate_and_pack(ci) for ci, _ in pairs])
            lstack = np.stack([cl for _, cl in pairs]).astype(np.int32)
            inflight.append(("scan", (pairs, bidx + 1, engine.dispatch_scan(stack, lstack, keys))))
            bidx += len(pairs)

        for imgs, labs, _paths in loader:
            for s in range(0, imgs.shape[0], bs):
                ci, cl = imgs[s : s + bs], labs[s : s + bs]
                if k_scan > 1 and ci.shape[0] == bs:
                    buf.append((ci, cl))
                    if len(buf) == k_scan:
                        _dispatch_scan()
                else:
                    _flush_buf()
                    _dispatch_one(ci, cl)
                if len(inflight) >= 3:
                    yield from _resolve()
        _flush_buf()
        while inflight:
            yield from _resolve()

    for images, labels, batch_idx, res in _completed():
        if prof is not None and batch_idx == _PROFILED_BATCHES - 1:
            _stop_profiler(prof, prof_dir)
            prof = None
        b = images.shape[0]
        if save_test_images:
            if images.shape[-1] != 3:  # packed wire format -> pixels back
                from ..ops.preprocess import s2d_unpack_uint8

                images_px = s2d_unpack_uint8(images, engine.pack_k)
            else:
                images_px = images
            for i in range(b):
                gt = labels[i, gi]
                gt_name = (
                    tasks.class_names[gi][gt]
                    if 0 <= gt < tasks.num_classes[gi]
                    else "Unlabeled"
                )
                out_path = os.path.join(img_dir, gt_name, f"b{batch_idx:04d}_i{i:03d}.png")
                if engine.family == "rtm":
                    # RTM writes "True/Pred/Prob" lines through the
                    # auto-layout multi-column bar
                    from .inference import render_task_overlay

                    lines = []
                    for ti, t in enumerate(tasks.names):
                        k = tasks.num_classes[ti]
                        p = res["probs"][i, ti, :k]
                        pi = int(res["preds"][i, ti])
                        li = int(labels[i, ti])
                        tl = tasks.class_names[ti][li] if 0 <= li < k else "Unknown"
                        pl = tasks.class_names[ti][pi] if 0 <= pi < k else "Unknown"
                        if show_gt_labels:
                            lines.append(f"{t} - True: {tl}, Pred: {pl}, Prob: {p.max():.2f} ")
                        else:
                            lines.append("")
                            lines.append(f"{t} - Pred: {pl} ({p.max():.2f})")
                    import cv2

                    os.makedirs(os.path.dirname(out_path), exist_ok=True)
                    cv2.imwrite(
                        out_path,
                        cv2.cvtColor(render_task_overlay(images_px[i], lines), cv2.COLOR_RGB2BGR),
                    )
                    continue
                lines = []
                for ti, t in enumerate(tasks.names):
                    k = tasks.num_classes[ti]
                    p = res["probs"][i, ti, :k]
                    idx = int(p.argmax())
                    lines.append(f"{t}: {tasks.class_names[ti][idx]} ({p[idx]:.2f})")
                annotate_and_save(Image.fromarray(images_px[i]), lines, out_path)
        # Reference loss accounting: batch_loss = sum over labeled tasks of
        # their mean CE; total_loss += batch_loss * batch_size.
        counts = res["count_per_task"]
        batch_loss = float(np.sum(res["loss_per_task"][counts > 0]))
        loss_sum += batch_loss * b
        total += b
        for ti in range(nt):
            m = labels[:, ti] != IGNORE_INDEX
            if not m.any():
                continue
            k = tasks.num_classes[ti]
            all_preds[ti].extend(res["preds"][m, ti].tolist())
            all_labels[ti].extend(labels[m, ti].tolist())
            all_probs[ti].extend(res["probs"][m, ti, :k].tolist())

    if prof is not None:  # fewer batches than the trace covers
        _stop_profiler(prof, prof_dir)

    avg_loss = loss_sum / total if total else 0.0
    metrics: Dict[str, Dict] = {}
    raw_preds: Dict[str, tuple] = {}
    for ti, task in enumerate(tasks.names):
        k = tasks.num_classes[ti]
        preds = np.asarray(all_preds[ti], np.int64)
        labels_arr = np.asarray(all_labels[ti], np.int64)
        probs = np.asarray(all_probs[ti], np.float64) if all_probs[ti] else np.zeros((0, k))
        m = task_metrics_and_roc(task, tasks.class_names[ti], preds, labels_arr, probs, roc_dir)
        metrics[task] = m
        raw_preds[task] = (preds, labels_arr, k)
        msg = (
            f"[Task {task}] Acc={m['accuracy']:.4f}, Prec={m['precision']:.4f}, "
            f"Recall={m['recall']:.4f}, F1={m['f1_score']:.4f}"
        )
        if m["auc_macro"] is not None:
            msg += f", AUC_macro={m['auc_macro']:.4f}"
        if m["auc_micro"] is not None:
            msg += f", AUC_micro={m['auc_micro']:.4f}"
        print(msg)

    f1s = [m["f1_score"] for m in metrics.values() if m["f1_score"] is not None]
    overall_f1 = float(np.mean(f1s)) if f1s else 0.0
    print(f"Overall F1: {overall_f1:.4f}")

    if tensorboard_writer is not None:
        tensorboard_writer.add_scalar("Test/Loss", avg_loss)
        tensorboard_writer.add_scalar("Test/Overall_F1", overall_f1)
        for task, m in metrics.items():
            for key in ("accuracy", "precision", "recall", "f1_score"):
                tensorboard_writer.add_scalar(f"Test/{task}/{key}", m[key])

    with open(os.path.join(save_dir, "metrics_test.json"), "w") as f:
        json.dump(
            {"test_loss": float(avg_loss), "overall_f1": overall_f1, "tasks": metrics},
            f,
            indent=2,
        )
    write_metrics_summary_csv(os.path.join(save_dir, "metrics_test_summary.csv"), metrics)
    if measure_time:
        with open(os.path.join(save_dir, "times_classifier.json"), "w") as f:
            json.dump(times, f, indent=2)
    if engine.family in ("pm", "rtm"):
        # The PM/RTM reference evaluations also write test_metrics.json =
        # {task: {..., "confusion_matrix"}, "average": ...} and
        # times_test.json.  Their confusion matrix is the full k x k (a
        # zero matrix when every prediction is Unknown), a task with no
        # samples records None for every field, and the average block
        # holds accuracy only for PM, all four means for RTM.
        fam_metrics: Dict[str, Dict] = {}
        for t, m in metrics.items():
            preds, labels_arr, k = raw_preds[t]
            if len(preds) == 0:
                fam_metrics[t] = {
                    key: None
                    for key in ("accuracy", "precision", "recall", "f1_score", "confusion_matrix")
                }
                continue
            fam_metrics[t] = {key: m[key] for key in ("accuracy", "precision", "recall", "f1_score")}
            fam_metrics[t]["confusion_matrix"] = family_confusion(preds, labels_arr, k)

        def _mean(key):
            vals = [m[key] for m in fam_metrics.values() if m[key] is not None]
            return float(np.mean(vals)) if vals else 0.0

        if engine.family == "pm":
            fam_metrics["average"] = {"accuracy": _mean("accuracy")}
        else:
            fam_metrics["average"] = {
                k: _mean(k) for k in ("accuracy", "precision", "recall", "f1_score")
            }
        with open(os.path.join(save_dir, "test_metrics.json"), "w") as f:
            json.dump(fam_metrics, f, indent=4)
        if measure_time:
            with open(os.path.join(save_dir, "times_test.json"), "w") as f:
                json.dump(times, f, indent=4)
    return avg_loss, metrics, overall_f1, times
