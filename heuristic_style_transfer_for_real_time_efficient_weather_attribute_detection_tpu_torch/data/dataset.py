"""Multi-task dataset and host input pipeline of the port.

Dataset manifest (the reference's ``MultiTaskDataset``): a JSON
``{folder: {img_name: {"image_path": ..., "<task>": label|null, ...}}}``
and the task registry.  Labels match the registry's class lists
case-insensitively; missing or unknown labels become IGNORE_INDEX.
``search_folder`` flattens paths to their basename under a new root;
``find_images_by_sub_folder`` keeps the last subfolder component.

The loader is a threaded, double-buffered decode and preprocess
prefetcher yielding uint8 NHWC batches (normalization happens on the
device).  PIL decode releases the GIL, so threads overlap it with the
consumer's device step.  Any object with ``paths()``, ``load(i) ->
(uint8 HWC image, labels | None)`` and ``task_names`` can be loaded.
"""

from __future__ import annotations

import json
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DEFAULT_IMG_SIZE, IGNORE_INDEX
from ..ops.preprocess import VALID_EXTS, load_image_uint8, s2d_pack_uint8


def collect_image_paths(folder: str) -> List[str]:
    """All image files under ``folder``, recursively (extension test)."""
    paths = []
    for root, _, files in os.walk(folder):
        for fn in files:
            if os.path.splitext(fn)[1].lower() in VALID_EXTS:
                paths.append(os.path.join(root, fn))
    return paths


def map_folder_to_class(folder_name: str, class_list: Sequence[str]) -> Optional[str]:
    """Folder-name -> class via case-insensitive substring containment
    (folder name contained in class name)."""
    low = folder_name.lower()
    for cls in class_list:
        if low in cls.lower():
            return cls
    return None


class MultiTaskDataset:
    """Manifest-driven multi-task image dataset.

    ``samples``: list of (path, labels[T] int32) with IGNORE_INDEX for
    unannotated tasks (both reference ignore conventions, -1 and -100,
    normalize to it).
    """

    def __init__(
        self,
        data_json: str,
        classes_json,
        search_folder: Optional[str] = None,
        find_images_by_sub_folder: Optional[str] = None,
        img_size: int = DEFAULT_IMG_SIZE,
    ):
        with open(data_json, "r") as f:
            data = json.load(f)
        if isinstance(classes_json, str):
            with open(classes_json, "r") as f:
                self.classes = json.load(f)
        else:
            self.classes = dict(classes_json)
        self.img_size = img_size
        self.task_names = list(self.classes.keys())
        self.class_to_idx = {
            t: {c.lower(): i for i, c in enumerate(cl)}
            for t, cl in self.classes.items()
        }

        self.samples: List[Tuple[str, np.ndarray]] = []
        for folder, images in data.items():
            for img_name, info in images.items():
                orig = info["image_path"]
                if search_folder:
                    path = os.path.join(search_folder, os.path.basename(orig))
                elif find_images_by_sub_folder:
                    sub = os.path.basename(os.path.dirname(orig))
                    path = os.path.join(
                        find_images_by_sub_folder, sub, os.path.basename(orig)
                    )
                else:
                    path = orig
                labels = np.full(len(self.task_names), IGNORE_INDEX, np.int32)
                for ti, t in enumerate(self.task_names):
                    val = info.get(t)
                    if val is not None:
                        idx = self.class_to_idx[t].get(str(val).lower())
                        if idx is None:
                            print(f"Warning: label '{val}' for task '{t}' not found")
                        else:
                            labels[ti] = idx
                self.samples.append((path, labels))

    def __len__(self) -> int:
        return len(self.samples)

    def paths(self) -> List[str]:
        return [p for p, _ in self.samples]

    def subsample(self, num_samples: Optional[int], seed: Optional[int] = None):
        """Random subset: the first N after a (seeded) shuffle."""
        if not num_samples or num_samples <= 0 or num_samples >= len(self.samples):
            return self
        idxs = list(range(len(self.samples)))
        (random.Random(seed) if seed is not None else random).shuffle(idxs)
        self.samples = [self.samples[i] for i in idxs[:num_samples]]
        return self

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        path, labels = self.samples[idx]
        if not os.path.exists(path):
            raise FileNotFoundError(f"Image not found: {path}")
        return load_image_uint8(path, self.img_size), labels


class BatchLoader:
    """Double-buffered threaded prefetcher over a dataset (or path list).

    Yields (images uint8 [B,H,W,3], labels int32 [B,T] | None, paths).  The
    tail batch is not padded: the Engine pads it.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 32,
        num_workers: int = 4,
        prefetch: int = 2,
        img_size: int = DEFAULT_IMG_SIZE,
        skip_errors: bool = False,
        pack_k: Optional[int] = None,
    ):
        if isinstance(dataset, (list, tuple)):  # bare path list, no labels
            self.paths = list(dataset)
            self._loadfn = lambda i: (load_image_uint8(self.paths[i], img_size), None)
            self.num_tasks = 0
        else:
            self.paths = dataset.paths()
            self._loadfn = dataset.load
            self.num_tasks = len(dataset.task_names)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        # skip_errors: drop undecodable images with a warning instead of
        # raising, as the reference's folder and watch modes do
        self.skip_errors = skip_errors
        # pack_k: emit space-to-depth-packed batches (the JAX package's
        # wire format), packed in the producer thread.  The port's Engine
        # takes them, but its stem kernel reads raw frames, so the port's
        # workloads leave this None.
        self.pack_k = pack_k

    def _loadfn_safe(self, i: int):
        try:
            return self._loadfn(i)
        except Exception as e:  # noqa: BLE001
            print(f"Warning: skipping unreadable image {self.paths[i]}: {e}")
            return None

    def __len__(self) -> int:
        return (len(self.paths) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], List[str]]]:
        n = len(self.paths)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # A decode failure must reach the consumer: a dead producer with
            # no sentinel would block the consumer's q.get() forever.
            try:
                loadfn = self._loadfn_safe if self.skip_errors else self._loadfn
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for s in range(0, n, self.batch_size):
                        if stop.is_set():
                            return
                        idxs = list(range(s, min(s + self.batch_size, n)))
                        items = list(pool.map(loadfn, idxs))
                        if self.skip_errors:
                            kept = [(i, it) for i, it in zip(idxs, items) if it is not None]
                            if not kept:
                                continue
                            idxs = [i for i, _ in kept]
                            items = [it for _, it in kept]
                        imgs = np.stack([it[0] for it in items])
                        if self.pack_k:
                            imgs = s2d_pack_uint8(imgs, self.pack_k)
                        labels = (
                            np.stack([it[1] for it in items])
                            if items[0][1] is not None
                            else None
                        )
                        q.put((imgs, labels, [self.paths[i] for i in idxs]))
            except BaseException as e:  # noqa: BLE001, re-raised in the consumer
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit if we stopped early.
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
