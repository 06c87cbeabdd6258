"""Folder inference, folder predictions with ground truth, and the
watch-folder service, on the port's engine.

- ``run_inference``: recursive folder inference -> inference_results.json
  (and Grad-CAM fusion copies under GradCAM/);
- ``test_folder_predictions``: folder-name ground truth -> per-class
  counts and F1 in folder_predictions.json (+ all_predictions.json);
- ``WatchFolderService`` / ``watch_folders_predictions``: polls folders
  for timestamped frames -> last_prediction.json, prediction_history.csv,
  WeatherInfos.json, and with sensor-annotation truth rules
  performance.json and performance_history.csv.

The artifacts and schemas are the JAX package's; the F1 and precision /
recall scores are computed in numpy (``utils.metrics``).
"""

from __future__ import annotations

import datetime
import json
import os
import random
import re
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from ..data.dataset import BatchLoader, collect_image_paths, map_folder_to_class
from ..engine.executor import Engine
from ..ops.preprocess import VALID_EXTS, is_image_name, load_image_uint8
from ..utils.metrics import precision_recall_fscore

TIMESTAMP_RE = re.compile(r"^\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2}$")


# ---------------------------------------------------------------------------
# Annotated-image writer (PIL's ``textbbox``; Pillow 10 removed the
# ``textsize`` the reference called)
# ---------------------------------------------------------------------------


def annotate_and_save(img: Image.Image, lines: Sequence[str], out_path: str) -> None:
    img = img.copy()
    draw = ImageDraw.Draw(img)
    size = max(12, img.height // 24)
    try:
        font = ImageFont.truetype(
            "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf", size
        )
    except OSError:
        font = ImageFont.load_default()
    y = 8
    for line in lines:
        bbox = draw.textbbox((8, y), line, font=font)
        draw.rectangle(bbox, fill=(0, 0, 0))
        draw.text((8, y), line, fill=(0, 255, 0), font=font)
        y = bbox[3] + 4
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    img.save(out_path)


def render_task_overlay(
    img_rgb: "np.ndarray",
    lines: Sequence[str],
    *,
    base_scale: float = 0.48,
    min_scale: float = 0.34,
    max_cols: int = 6,
    bar_height_frac: float = 0.20,
    width_frac: float = 0.90,
    alpha: float = 0.45,
    text_color=(0, 150, 0),
) -> "np.ndarray":
    """RTM-style auto-layout multi-column text bar.

    Finds the largest (columns, font scale) whose column-major layout fits a
    translucent bar capped at ``bar_height_frac`` of the image height and
    ``width_frac`` of its width — many-task overlays wrap into up to
    ``max_cols`` columns and shrink the font down to ``min_scale`` before
    giving up and clipping.  Returns a new annotated RGB array.
    """
    import cv2
    import math

    if not lines:
        return img_rgb.copy()
    font, thick = cv2.FONT_HERSHEY_SIMPLEX, 1
    pad_x, pad_y, margin, gap_x = 8, 6, 8, 8
    H, W = img_rgb.shape[:2]
    budget_w = int(width_frac * W)
    budget_h = int(bar_height_frac * H)

    def measure(scale):
        sizes = [cv2.getTextSize(t, font, scale, thick)[0] for t in lines]
        line_h = max(h for _, h in sizes)
        return sizes, line_h, max(int(line_h * 1.15), line_h)

    def fits(cols, scale):
        sizes, line_h, y_step = measure(scale)
        rows = math.ceil(len(lines) / cols)
        widest = max(w for w, _ in sizes) + 2 * pad_x
        total_w = cols * widest + (cols - 1) * gap_x
        total_h = line_h + (rows - 1) * y_step + 2 * pad_y
        return total_w <= budget_w and total_h <= budget_h

    widest0 = max(cv2.getTextSize(t, font, base_scale, thick)[0][0] for t in lines)
    col_cap = min(max_cols, max(1, (budget_w + gap_x) // (widest0 + 2 * pad_x + gap_x)))
    chosen = None
    for cols in range(col_cap, 0, -1):
        scale = base_scale
        while scale >= min_scale:
            if fits(cols, scale):
                chosen = (cols, scale)
                break
            scale = round(scale - 0.03, 4)
        if chosen:
            break
    cols, scale = chosen or (1, min_scale)

    sizes, line_h, y_step = measure(scale)
    rows = math.ceil(len(lines) / cols)
    # column-major fill; each column as wide as its own longest line
    columns = [list(range(c * rows, min((c + 1) * rows, len(lines))))
               for c in range(cols)]
    col_w = [
        (max(sizes[k][0] for k in idxs) + 2 * pad_x) if idxs else 0
        for idxs in columns
    ]
    _, baseline = cv2.getTextSize("Ag", font, scale, thick)
    bar_w = min(sum(col_w) + (cols - 1) * gap_x, W - 2 * margin)
    bar_h = line_h + (rows - 1) * y_step + 2 * pad_y + baseline

    out = img_rgb.copy()
    bar = out.copy()
    cv2.rectangle(bar, (margin, margin),
                  (min(W - margin, margin + bar_w), min(H - margin, margin + bar_h)),
                  (255, 255, 255), thickness=-1)
    cv2.addWeighted(bar, alpha, out, 1 - alpha, 0, out)

    x = margin
    for idxs, cw in zip(columns, col_w):
        for r, k in enumerate(idxs):
            cv2.putText(out, lines[k], (x + pad_x, margin + pad_y + line_h + r * y_step),
                        font, scale, text_color, thick, cv2.LINE_AA)
        x += cw + gap_x
    return out


def _predict_batched(engine: Engine, paths: List[str], num_workers: int = 4):
    """Batched device inference over arbitrary paths.

    Returns (probs [N', T, Kmax], kept_paths); unreadable images are skipped
    with a warning.  The loader yields raw frames, which the stem kernel reads.
    """
    loader = BatchLoader(paths, batch_size=engine.batch_size, num_workers=num_workers,
                         skip_errors=True)
    res, kept = engine.run_stream(loader, collect=("probs",))
    probs = (
        res["probs"]
        if len(res["probs"])
        else np.zeros((0, len(engine.tasks), engine.tasks.max_classes))
    )
    return probs, kept


def _pred_entry(engine: Engine, probs_row: np.ndarray) -> Dict[str, Dict]:
    """{task: {"predicted_class", "probability"}} for one image."""
    tasks = engine.tasks
    out = {}
    for ti, t in enumerate(tasks.names):
        k = tasks.num_classes[ti]
        p = probs_row[ti, :k]
        idx = int(p.argmax())
        out[t] = {
            "predicted_class": tasks.class_names[ti][idx],
            "probability": float(p[idx]),
        }
    return out


# ---------------------------------------------------------------------------
# run_inference
# ---------------------------------------------------------------------------


def run_inference(
    engine: Engine,
    image_folder: str,
    save_dir: Optional[str] = None,
    num_samples: Optional[int] = None,
    save_test_images: bool = False,
    num_workers: int = 4,
    visualize_gradcam: bool = False,
    gradcam_task: Optional[str] = None,
    colormap: str = "hot",
) -> Dict[str, Dict]:
    """Recursive folder inference -> inference_results.json
    ``{path: {task: {predicted_class, probability}}}``.

    ``visualize_gradcam`` adds 50/50 heatmap-fusion copies sorted into
    ``GradCAM/<predicted class>/<name>_fusion.jpg`` with a text line (the
    target class is the prediction), on the engine's device.
    """
    paths = collect_image_paths(image_folder)
    if not paths:
        raise RuntimeError(f"No image found in '{image_folder}'")
    if num_samples and num_samples < len(paths):
        paths = random.sample(paths, num_samples)

    probs, paths = _predict_batched(engine, paths, num_workers)
    results = {}
    for i, path in enumerate(paths):
        preds = _pred_entry(engine, probs[i])
        results[path] = preds
        if save_dir and save_test_images:
            lines = [
                f"{t}: {d['predicted_class']} ({d['probability']:.2f})"
                for t, d in preds.items()
            ]
            rel = os.path.relpath(path, image_folder)
            annotate_and_save(
                Image.open(path).convert("RGB"), lines, os.path.join(save_dir, rel)
            )
    if save_dir and visualize_gradcam:
        _gradcam_fusions(engine, paths, probs, save_dir, gradcam_task, colormap, num_workers)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "inference_results.json"), "w") as f:
            json.dump(results, f, indent=2, ensure_ascii=False)
    return results


def _gradcam_fusions(engine, paths, probs, save_dir, gradcam_task, colormap, num_workers):
    from .explain import Explainer, overlay_cam

    tasks = engine.tasks
    task = gradcam_task or tasks.names[0]
    ti = tasks.names.index(task)
    k = tasks.num_classes[ti]
    names = tasks.class_names[ti]
    explainer = Explainer(engine.family, engine.spec, engine.params, device=engine.device)
    loader = BatchLoader(paths, batch_size=engine.batch_size, num_workers=num_workers)
    pos = 0
    for imgs, _, batch_paths in loader:
        n = imgs.shape[0]
        targets = probs[pos : pos + n, ti, :k].argmax(-1).astype("int32")
        cam, _ = explainer.gradcam(imgs, task, targets)
        for j in range(n):
            cls = int(targets[j])
            prob = float(probs[pos + j, ti, cls])
            fused = overlay_cam(imgs[j], cam[j], colormap, alpha=0.5)
            out_dir = os.path.join(save_dir, "GradCAM", names[cls])
            fname = os.path.splitext(os.path.basename(batch_paths[j]))[0]
            annotate_and_save(
                Image.fromarray(fused),
                [f"{task}: {names[cls]} ({prob:.2f})"],
                os.path.join(out_dir, f"{fname}_fusion.jpg"),
            )
        pos += n


# ---------------------------------------------------------------------------
# test_folder_predictions (GT from folder names)
# ---------------------------------------------------------------------------


def test_folder_predictions(
    engine: Engine,
    test_folder: str,
    save_dir: str,
    save_test_images: bool = False,
    target_task: Optional[str] = None,
    num_workers: int = 4,
) -> Dict:
    """Recursive predictions with folder-name ground truth -> per-class
    counts + F1 in folder_predictions.json (+ all_predictions.json)."""
    tasks = engine.tasks
    tasks_dict = tasks.as_dict()
    eval_tasks = [target_task] if target_task else list(tasks.names)
    folder_task = target_task or tasks.names[0]

    # Suffix-filter walk, not collect_image_paths: as in the reference's
    # folder mode a dotfile named exactly ".jpg" is an image here, unlike
    # in run_inference's splitext-based walk.
    paths = [
        os.path.join(root, fn)
        for root, _, files in os.walk(test_folder)
        for fn in files
        if is_image_name(fn)
    ]
    probs, paths = _predict_batched(engine, paths, num_workers)

    results: Dict[str, Dict] = {}
    predictions_by_task = {t: {} for t in eval_tasks}
    gt_by_task = {t: [] for t in eval_tasks}
    pred_gt_by_task = {t: [] for t in eval_tasks}
    os.makedirs(save_dir, exist_ok=True)
    annotated_base = os.path.join(save_dir, "annotated_images")

    for i, path in enumerate(paths):
        rel = os.path.relpath(path, test_folder)
        entry = _pred_entry(engine, probs[i])
        results[rel] = {t: entry[t] for t in eval_tasks} if target_task else entry
        pred_folder_cls = entry[folder_task]["predicted_class"]
        predictions_by_task[folder_task].setdefault(pred_folder_cls, []).append(rel)

        root = os.path.dirname(path)
        if os.path.abspath(root) != os.path.abspath(test_folder):
            folder_name = os.path.basename(root)
            for t in eval_tasks:
                gt_cls = map_folder_to_class(folder_name, tasks_dict[t])
                if gt_cls is not None:
                    gt_by_task[t].append(gt_cls)
                    pred_gt_by_task[t].append(entry[t]["predicted_class"])

        if save_test_images:
            lines = [
                f"{t}: {d['predicted_class']} ({d['probability']:.2f})"
                for t, d in results[rel].items()
            ]
            dest = os.path.join(annotated_base, pred_folder_cls, os.path.basename(path))
            annotate_and_save(Image.open(path).convert("RGB"), lines, dest)

    final: Dict[str, Dict] = {}
    for t in eval_tasks:
        f1_dict, global_f1 = {}, None
        if gt_by_task[t]:
            uniq = list(set(gt_by_task[t]))
            scores = precision_recall_fscore(
                gt_by_task[t], pred_gt_by_task[t], labels=uniq, average=None)[2]
            f1_dict = {c: float(s) for c, s in zip(uniq, scores)}
            global_f1 = precision_recall_fscore(
                gt_by_task[t], pred_gt_by_task[t], average="weighted")[2]
        counts = {
            cls: len(predictions_by_task[t].get(cls, [])) for cls in tasks_dict[t]
        }
        final[t] = {"by_class": counts, "f1_score": f1_dict, "global_f1": global_f1}

    with open(os.path.join(save_dir, "folder_predictions.json"), "w") as f:
        json.dump(final, f, indent=4)
    if target_task is None:
        with open(os.path.join(save_dir, "all_predictions.json"), "w") as f:
            json.dump(results, f, indent=4)
    return final


# ---------------------------------------------------------------------------
# watch-folder service (+ optional sensor-annotation truth rules)
# ---------------------------------------------------------------------------


def eval_rule(rule: Dict, sensors: Dict) -> bool:
    """Sensor condition evaluator: all ``when`` clauses must hold (ops
    eq/neq/gt/lt/gte/lte/in)."""
    for cond in rule.get("when", []):
        val = sensors.get(cond.get("sensor"))
        if val is None:
            return False
        op = cond.get("op")
        ok = (
            val == cond.get("value") if op == "eq"
            else val != cond.get("value") if op == "neq"
            else val > cond.get("value") if op == "gt"
            else val < cond.get("value") if op == "lt"
            else val >= cond.get("value") if op == "gte"
            else val <= cond.get("value") if op == "lte"
            else val in cond.get("list", []) if op == "in"
            else False
        )
        if not ok:
            return False
    return True


def derive_truth(truth_rules: Dict, task: str, sensors: Dict) -> str:
    rules = truth_rules.get(task, {})
    gt = rules.get("default", "Unknown")
    for rule in rules.get("rules", []):
        if eval_rule(rule, sensors):
            return rule["class"]
    return gt


class WatchFolderService:
    """Continuous polling service over one or more folders.

    One daemon thread per watched folder, all sharing the engine.  Per folder, writes
    last_prediction.json + prediction_history.csv; the first folder also
    mirrors to <canon>/WeatherInfos.json (home-automation handoff).  With
    ``truth_mapping_path`` + ``annotations_folder``, sensor-derived ground
    truth drives rolling P/R/F1 -> performance.json + performance_history.csv
    every ``metrics_every`` images.
    """

    def __init__(
        self,
        engine: Engine,
        watch_folders: Sequence[str],
        poll_intervals: Sequence[float],
        save_dir: str,
        save_dir_to_canon: Optional[str] = None,
        truth_mapping_path: Optional[str] = None,
        annotations_folder: Optional[str] = None,
        metrics_every: int = 10,
        max_load_retries: int = 5,
    ):
        if len(watch_folders) != len(poll_intervals):
            raise ValueError("watch_folders and poll_intervals must have equal length")
        self.engine = engine
        self.watch_folders = list(watch_folders)
        self.poll_intervals = list(poll_intervals)
        self.save_dir = save_dir
        self.save_dir_to_canon = save_dir_to_canon
        self.annotations_folder = annotations_folder
        self.metrics_every = metrics_every
        self.max_load_retries = max_load_retries
        self.truth_rules = None
        if truth_mapping_path:
            with open(truth_mapping_path, "r") as f:
                self.truth_rules = json.load(f)
        self._stop = threading.Event()
        self.threads: List[threading.Thread] = []

    def stop(self):
        self._stop.set()

    def start(self, block: bool = True):
        for idx, folder in enumerate(self.watch_folders):
            sub = os.path.join(
                self.save_dir, os.path.basename(os.path.normpath(folder))
            )
            t = threading.Thread(
                target=self._watch_one,
                args=(folder, sub, self.poll_intervals[idx], idx == 0),
                daemon=True,
            )
            t.start()
            self.threads.append(t)
            print(f"watching {folder} every {self.poll_intervals[idx]}s -> {sub}")
        if block:
            for t in self.threads:
                t.join()

    # -- single-folder loop ----------------------------------------------

    def _latest_valid(self, folder: str) -> Optional[str]:
        files = [
            f
            for f in os.listdir(folder)
            if os.path.splitext(f)[1].lower() in VALID_EXTS
            and TIMESTAMP_RE.match(os.path.splitext(f)[0])
        ]
        return sorted(files)[-1] if files else None

    def _sensors_for(self, image_file: str) -> Dict:
        if not self.annotations_folder:
            return {}
        ann_path = os.path.join(
            self.annotations_folder, os.path.splitext(image_file)[0] + ".json"
        )
        if not os.path.isfile(ann_path):
            return {}
        with open(ann_path) as f:
            ann = json.load(f)
        return {sv["name"]: sv.get("value") for sv in ann.get("sensorValues", [])}

    @staticmethod
    def _write_json_atomic(path: str, obj) -> None:
        """temp + rename: the watcher's JSON outputs are read concurrently by
        home-automation consumers (and the tests); a plain open(...,'w')
        lets a reader see a torn file mid-dump."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=4)
        os.replace(tmp, path)

    @staticmethod
    def _append_csv_row(path: str, cols: List[str], row: Dict) -> None:
        """Append one row, writing the header iff the file is new (stdlib
        csv, append-only: watcher threads run concurrently, and resuming
        costs O(1) instead of a rewrite per frame).

        Resuming onto a CSV written with a DIFFERENT task set would silently
        misalign appended rows with the old header, so an existing file's
        header is verified first and a mismatched file is rotated aside to
        ``<path>.stale-<n>`` before a fresh one is started."""
        import csv

        new = not os.path.exists(path)
        if not new:
            with open(path, newline="") as f:
                header = next(csv.reader(f), None)
            if header is None:  # empty file: just write the header
                new = True
            elif header != cols:
                n = 0
                while os.path.exists(f"{path}.stale-{n}"):
                    n += 1
                os.replace(path, f"{path}.stale-{n}")
                new = True
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols)
            if new:
                w.writeheader()
            w.writerow(row)

    def _watch_one(self, folder: str, sub_save_dir: str, interval: float, is_first: bool):
        tasks = self.engine.tasks
        os.makedirs(sub_save_dir, exist_ok=True)
        history_file = os.path.join(sub_save_dir, "prediction_history.csv")
        cols = ["timestamp", "image"]
        for t in tasks.names:
            cols += [f"{t}_predicted_class", f"{t}_probability"]

        eval_on = self.truth_rules is not None
        y_true = {t: [] for t in tasks.names}
        y_pred = {t: [] for t in tasks.names}
        n_eval = 0
        perf_file = os.path.join(sub_save_dir, "performance.json")
        perf_hist_file = os.path.join(sub_save_dir, "performance_history.csv")
        metric_cols = ["timestamp"]
        for t in tasks.names:
            metric_cols += [f"{t}_precision", f"{t}_recall", f"{t}_f1"]
        metric_cols.append("global_f1")

        last_processed = None
        pending_file, pending_tries = None, 0
        while not self._stop.is_set():
            last_file = self._latest_valid(folder)
            if last_file is None or last_file == last_processed:
                self._stop.wait(interval)
                continue
            full_path = os.path.join(folder, last_file)
            try:
                img = load_image_uint8(full_path)
            except Exception as e:
                # A frame caught mid-write (camera/home-automation writers save
                # in place) must be retried, not dropped: only mark it processed
                # after a bounded number of failures so a truly corrupt file
                # can't wedge the folder.
                if last_file == pending_file:
                    pending_tries += 1
                else:
                    pending_file, pending_tries = last_file, 1
                if pending_tries >= self.max_load_retries:
                    print(
                        f"[{folder}] giving up on {full_path} after "
                        f"{pending_tries} attempts: {e}"
                    )
                    last_processed = last_file
                    pending_file, pending_tries = None, 0
                else:
                    print(
                        f"[{folder}] error loading {full_path} (attempt "
                        f"{pending_tries}/{self.max_load_retries}, will retry): {e}"
                    )
                self._stop.wait(interval)
                continue
            pending_file, pending_tries = None, 0
            last_processed = last_file

            probs = self.engine.run(img[None], collect=("probs",))["probs"][0]
            prediction = _pred_entry(self.engine, probs)

            ts = os.path.splitext(last_file)[0]
            try:
                datetime.datetime.strptime(ts, "%Y-%m-%d_%H-%M-%S")
            except ValueError:
                ts = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")

            payload = {"timestamp": ts, "image": last_file, "prediction": prediction}
            self._write_json_atomic(
                os.path.join(sub_save_dir, "last_prediction.json"), payload
            )
            if is_first and self.save_dir_to_canon:
                os.makedirs(self.save_dir_to_canon, exist_ok=True)
                self._write_json_atomic(
                    os.path.join(self.save_dir_to_canon, "WeatherInfos.json"),
                    payload,
                )

            row = {"timestamp": ts, "image": last_file}
            for t, pred in prediction.items():
                row[f"{t}_predicted_class"] = pred["predicted_class"]
                row[f"{t}_probability"] = pred["probability"]
            self._append_csv_row(history_file, cols, row)

            if eval_on:
                sensors = self._sensors_for(last_file)
                if sensors:
                    n_eval += 1
                    for t in tasks.names:
                        y_true[t].append(derive_truth(self.truth_rules, t, sensors))
                        y_pred[t].append(prediction[t]["predicted_class"])
                    if n_eval % self.metrics_every == 0:
                        perf = {"timestamp": ts}
                        for t in tasks.names:
                            (perf[f"{t}_precision"], perf[f"{t}_recall"],
                             perf[f"{t}_f1"]) = precision_recall_fscore(
                                y_true[t], y_pred[t], average="weighted")
                        perf["global_f1"] = float(
                            np.mean([perf[f"{t}_f1"] for t in tasks.names])
                        )
                        self._write_json_atomic(perf_file, perf)
                        self._append_csv_row(perf_hist_file, metric_cols, perf)

            self._stop.wait(interval)


def watch_folders_predictions(
    engine: Engine,
    watch_folders: Sequence[str],
    poll_intervals: Sequence[float],
    save_dir: str,
    save_dir_to_canon: Optional[str] = None,
    **kwargs,
) -> WatchFolderService:
    """The reference's name for the service, blocking as it did."""
    svc = WatchFolderService(
        engine, watch_folders, poll_intervals, save_dir, save_dir_to_canon, **kwargs
    )
    svc.start(block=True)
    return svc
