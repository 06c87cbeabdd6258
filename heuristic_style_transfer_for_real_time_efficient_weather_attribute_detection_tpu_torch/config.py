"""Config / task-registry layer of the PyTorch port.

The task registry ``{task_name: [class_name, ...]}`` parameterizes the
model heads and the label encoding; hyperparameters come from an explicit
config file or from JSON sidecars discovered next to a checkpoint.  Same
contract and precedence as the JAX package's ``config.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

# -100 marks a missing label; -1 is the below-threshold ("Unknown") prediction.
IGNORE_INDEX = -100
UNKNOWN_PRED = -1

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DEFAULT_IMG_SIZE = 224
DEFAULT_RESIZE = 256


def enable_parity_precision() -> None:
    """Full-f32 matmuls and convolutions ("parity mode").

    PyTorch runs float32 matmuls in full precision by default but lets cuDNN
    convolutions use TF32 (about three decimal digits), so both switches are
    set explicitly before any comparison against the f32 reference.  bf16
    products keep float32 sums throughout, as the JAX package's do: cuBLAS
    may not reduce split-K partial sums in bf16.
    """
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def load_tasks(path: str) -> Dict[str, List[str]]:
    """Load the task registry ``{task: [class, ...]}`` from JSON."""
    with open(path, "r") as f:
        tasks = json.load(f)
    if not isinstance(tasks, dict):
        raise ValueError(f"Task registry {path} must be a JSON object")
    for t, classes in tasks.items():
        if not isinstance(classes, list) or not classes:
            raise ValueError(f"Task {t!r} must map to a non-empty class list")
    return tasks


def default_tasks_path() -> str:
    """Path of the bundled 12-task weather registry."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "configs", "tasks.json")


def load_hparams(
    config_path: Optional[str] = None, model_path: Optional[str] = None
) -> Dict[str, Any]:
    """Resolve hyperparameters: explicit config file, else checkpoint sidecar.

    An explicit ``config_path`` wins and may wrap the dict as
    ``{"hparams": {...}}``; otherwise sidecar JSONs are searched next to
    ``model_path``; otherwise empty (model-family defaults apply).
    """
    if config_path is not None:
        if not os.path.isfile(config_path):
            raise FileNotFoundError(f"No config file at {config_path}")
        with open(config_path, "r") as f:
            cfg = json.load(f)
        return cfg.get("hparams", cfg) if isinstance(cfg, dict) else cfg
    if model_path is not None:
        sidecar = find_sidecar_hparams(model_path)
        if sidecar is not None:
            return sidecar
    return {}


def find_sidecar_hparams(model_path: str) -> Optional[Dict[str, Any]]:
    """Search for an hparams JSON next to a checkpoint.

    Candidates, in order: ``best_overall_hyperparameters.json``,
    ``best_hyperparameters.json``, ``<checkpoint stem>.json``, then any
    ``hyperparameters*.json``; a ``{"hparams": ...}`` wrapper is unwrapped.
    """
    base_dir = os.path.dirname(os.path.abspath(model_path))
    stem = os.path.splitext(model_path)[0]
    candidates = [
        os.path.join(base_dir, "best_overall_hyperparameters.json"),
        os.path.join(base_dir, "best_hyperparameters.json"),
        stem + ".json",
    ]
    for fn in sorted(os.listdir(base_dir)) if os.path.isdir(base_dir) else []:
        if fn.startswith("hyperparameters") and fn.endswith(".json"):
            candidates.append(os.path.join(base_dir, fn))
    for p in candidates:
        if os.path.isfile(p):
            try:
                with open(p, "r") as f:
                    data = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(data, dict):
                if isinstance(data.get("hparams"), dict):
                    return data["hparams"]
                return data
    return None


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Static, hashable view of the task registry.

    ``names``/``num_classes`` keep the registry's insertion order: class
    index i is the position in the registry list.
    """

    names: Tuple[str, ...]
    num_classes: Tuple[int, ...]
    class_names: Tuple[Tuple[str, ...], ...]

    @classmethod
    def from_tasks(cls, tasks: Mapping[str, List[str]]) -> "TaskSpec":
        names = tuple(tasks.keys())
        first = tasks[names[0]] if names else []
        if names and isinstance(first, int):
            # {task: n_classes} shorthand
            return cls(
                names=names,
                num_classes=tuple(int(tasks[t]) for t in names),
                class_names=tuple(
                    tuple(f"class_{i}" for i in range(int(tasks[t]))) for t in names
                ),
            )
        return cls(
            names=names,
            num_classes=tuple(len(tasks[t]) for t in names),
            class_names=tuple(tuple(tasks[t]) for t in names),
        )

    def __len__(self) -> int:
        return len(self.names)

    @property
    def max_classes(self) -> int:
        return max(self.num_classes) if self.num_classes else 0

    def n_classes(self, task: str) -> int:
        return self.num_classes[self.names.index(task)]

    def classes(self, task: str) -> Tuple[str, ...]:
        return self.class_names[self.names.index(task)]

    def as_dict(self) -> Dict[str, List[str]]:
        return {t: list(c) for t, c in zip(self.names, self.class_names)}

    def split_logits(self, stacked) -> Dict[str, Any]:
        """Slice stacked per-task logits ``[B, T, Kmax]`` into ``{task: [B, K_t]}``."""
        return {
            t: stacked[:, i, : self.num_classes[i]] for i, t in enumerate(self.names)
        }
