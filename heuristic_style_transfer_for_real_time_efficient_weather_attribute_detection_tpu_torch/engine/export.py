"""AOT export of the engine's serving forward (``torch.export``).

The engine's uint8 -> probs/preds forward is traced once, with the
run-precision params, the stem fold and the class mask held as buffers of
the exported program, saved to a self-describing artifact directory, and
reloaded WITHOUT the model code or a checkpoint: the program and a small
JSON sidecar are everything a serving box needs.  The hand-written kernels
of the batch path (K1, K2 and, in bf16, K5) sit in the program as the
``torch.ops.wadt_torch`` operators (``ops/cuda_kernels.py``), so the loaded
program launches them on the card and runs their plain versions on the CPU.

An artifact holds one platform, the engine's device type: the program's
buffers, and any device the trace fixed, live on the device it was exported
from.  (The JAX package lowers one artifact for several platforms; here
each platform is exported from an engine on that platform.)

Artifact layout (``export_engine``):
    <dir>/forward.pt2         torch.export.save of the forward (weights as buffers)
    <dir>/export_meta.json    wire format, batch size, tasks, thresholds

Usage:
    export_engine(engine, "artifact/")                      # build side
    pred = ExportedPredictor("artifact/")                   # serving side
    out = pred.run(images_uint8)                            # probs/preds
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import TaskSpec
from .wire import pad_batch, to_host_async, validate_and_pack, wait_host

_FORMAT_VERSION = 1
_BLOB = "forward.pt2"
_META = "export_meta.json"
_JAX_BLOB = "forward.jaxexport"  # the JAX package's artifact, which the port does not load

# the exported forward returns exactly these (label-dependent outputs like
# loss_per_task need labels and stay engine-only); capture taps the engine
# was built with ride along
_SERVE_KEYS = ("logits", "probs", "max_probs", "preds")


class _ServeForward(torch.nn.Module):
    """The engine's label-free step (``Engine._outputs``) on constants held
    as buffers: the run params, the stem fold and the class mask, flattened
    (nested dicts cannot be buffer names) and rebuilt into the tree in
    ``forward``.  Buffers are clones made outside inference mode."""

    def __init__(self, engine, keep: Sequence[str]):
        super().__init__()
        from torch.utils import _pytree as pytree

        leaves, self._treedef = pytree.tree_flatten(
            {"params": engine._run_params, "stem": engine._stem, "mask": engine._mask}
        )
        self._slots = []  # buffer name per leaf, None for a None leaf
        for i, leaf in enumerate(leaves):
            if leaf is None:
                self._slots.append(None)
            else:
                self.register_buffer(f"c{i}", leaf.detach().clone())
                self._slots.append(f"c{i}")
        self._engine = engine
        self._keep = tuple(keep)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        from torch.utils import _pytree as pytree

        c = pytree.tree_unflatten(
            [None if s is None else getattr(self, s) for s in self._slots], self._treedef
        )
        out = self._engine._outputs(images, c["params"], c["stem"], c["mask"])
        return {k: out[k] for k in self._keep if k in out}


def export_engine(
    engine,
    out_dir: str,
    platforms: Optional[Sequence[str]] = None,
    img_size: int = 224,
) -> Dict[str, object]:
    """Save ``engine``'s forward to ``out_dir`` (``forward.pt2`` and
    ``export_meta.json``); returns the meta.

    ``platforms`` defaults to the engine's device type and may name only
    that one.  Mesh engines are refused: an exported program pins the
    device it was traced on.  The program takes raw uint8 frames
    [batch, img_size, img_size, 3]."""
    if getattr(engine, "mesh", None) is not None:
        raise ValueError(
            "export_engine needs a single-device engine (mesh=None); "
            "exported programs pin the device they were traced on"
        )
    dev = engine.device.type
    platforms = list(platforms) if platforms else [dev]
    if platforms != [dev]:
        raise ValueError(
            f"an artifact holds one platform, the engine's device type ({dev!r}); asked for "
            f"{platforms}: export from an engine on each platform instead"
        )
    bs = engine.batch_size
    in_shape = (bs, img_size, img_size, 3)
    module = _ServeForward(engine, _SERVE_KEYS + tuple(engine.capture))
    example = torch.zeros(in_shape, dtype=torch.uint8, device=engine.device)
    program = torch.export.export(module, (example,))
    meta = {
        "format_version": _FORMAT_VERSION,
        "family": engine.family,
        "batch_size": bs,
        "input_shape": list(in_shape),
        "pack_k": engine.pack_k,
        "prob_threshold": engine.prob_threshold,
        "dtype": str(engine.dtype).replace("torch.", ""),
        # a capture tap may be absent from the family's aux dict: record what
        # the program really returns, so meta["outputs"] is trustworthy
        "outputs": list(program.call_spec.out_spec.context),
        "platforms": platforms,
        "torch_version": torch.__version__,
        "tasks": {
            "names": list(engine.tasks.names),
            "num_classes": list(engine.tasks.num_classes),
            "class_names": [list(c) for c in engine.tasks.class_names],
        },
    }
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _BLOB))
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ExportedPredictor:
    """Serving-side loader for an :func:`export_engine` artifact.

    Mirrors the host-side contract of ``Engine``: ``run`` (uint8 NHWC in,
    host numpy out, tail batch padded) and the pipelined
    ``dispatch``/``fetch`` pair the AsyncBatcher drives, without the model
    code or a checkpoint: it imports only the port's operator registrations
    (``ops/cuda_kernels.py``).  ``InferenceServer(ExportedPredictor(dir))``
    serves straight from the artifact (CLI: ``--mode serve --exported``).
    ``device`` defaults to the CUDA card and must be the artifact's platform.
    """

    def __init__(self, artifact_dir: str, device="cuda"):
        from ..ops import cuda_kernels  # noqa: F401  registers the wadt_torch operators

        blob = os.path.join(artifact_dir, _BLOB)
        if not os.path.isfile(blob) and os.path.isfile(os.path.join(artifact_dir, _JAX_BLOB)):
            raise ValueError(
                f"{artifact_dir} holds a JAX artifact ({_JAX_BLOB}), which the port does not "
                "load; export the port's own with engine.export.export_engine"
            )
        with open(os.path.join(artifact_dir, _META)) as f:
            self.meta = json.load(f)
        if self.meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported export format {self.meta.get('format_version')} "
                f"(this build reads {_FORMAT_VERSION})"
            )
        self.device = torch.device(device)
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(
                f"artifact was exported for {self.meta['platforms']}, not {self.device.type}; "
                "export it again from an engine on that device"
            )
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ExportedPredictor: no CUDA device is available; load a CPU artifact with "
                "device='cpu'"
            )
        self._program = torch.export.load(blob)
        self._call = self._program.module()
        self.batch_size = int(self.meta["batch_size"])
        self.pack_k = self.meta["pack_k"]
        self.family = self.meta["family"]
        t = self.meta["tasks"]
        self.tasks = TaskSpec(
            names=tuple(t["names"]),
            num_classes=tuple(int(k) for k in t["num_classes"]),
            class_names=tuple(tuple(c) for c in t["class_names"]),
        )
        self.task_names = list(t["names"])
        self.class_names = [list(c) for c in t["class_names"]]

    def warmup(self, img_size: int = 224) -> None:
        """One forward run to its end, so that the first request does not
        pay for the first call (on the card: the kernel build)."""
        self.fetch(self.dispatch(np.zeros(tuple(self.meta["input_shape"]), np.uint8)))

    def _pack(self, images: np.ndarray) -> np.ndarray:
        from ..ops.preprocess import s2d_unpack_uint8

        images = validate_and_pack(images, self.pack_k)
        if images.shape[-1] != 3:  # packed frames: the program takes raw ones
            images = s2d_unpack_uint8(images, self.pack_k)
        # stricter than the live Engine: the exported program pins H/W too
        expect = tuple(self.meta["input_shape"][1:])
        if tuple(images.shape[1:]) != expect:
            raise ValueError(
                f"exported program takes [N,{','.join(map(str, expect))}] uint8 "
                f"(packed frames accepted too); got {images.shape}"
            )
        return images

    def dispatch(
        self,
        images: np.ndarray,
        labels=None,
        collect: Sequence[str] = ("probs", "preds"),
    ):
        """Engine.dispatch-compatible: enqueue one micro-batch and start its
        device->host result copy (pinned, asynchronous); returns a handle
        for :meth:`fetch`.  The program takes no labels; passing any raises."""
        if labels is not None:
            raise ValueError(
                "exported programs carry no label inputs; evaluate with the live Engine instead"
            )
        images = self._pack(images)
        n = images.shape[0]
        bs = self.batch_size
        if n > bs:
            raise ValueError(f"micro-batch {n} > exported batch {bs}")
        images, _ = pad_batch(images, bs)
        x = torch.as_tensor(images).to(self.device, non_blocking=True)
        with torch.inference_mode():
            res = self._call(x)
        return (n,) + to_host_async(res, collect)

    def fetch(self, handle) -> Dict[str, np.ndarray]:
        """Wait for a :meth:`dispatch` handle -> host arrays [n, ...]."""
        take, host, event = handle
        return {k: v[:take] for k, v in wait_host(host, event).items()}

    def run(
        self,
        images: np.ndarray,
        collect: Sequence[str] = ("probs", "preds"),
    ) -> Dict[str, np.ndarray]:
        """Forward N images (any N) -> host dict of stacked arrays [N, ...].

        Pipelined like ``Engine.run``: each batch's result copy starts at
        dispatch and up to 4 batches stay in flight."""
        images = self._pack(images)
        n = images.shape[0]
        bs = self.batch_size
        outs = {k: [] for k in collect}
        inflight = []

        def _drain_one() -> None:
            host = self.fetch(inflight.pop(0))
            for k in collect:
                outs[k].append(host[k])

        for i in range(0, n, bs):
            inflight.append(self.dispatch(images[i : i + bs], collect=collect))
            if len(inflight) >= 4:
                _drain_one()
        while inflight:
            _drain_one()
        return {k: np.concatenate(v) if v else np.empty((0,)) for k, v in outs.items()}
