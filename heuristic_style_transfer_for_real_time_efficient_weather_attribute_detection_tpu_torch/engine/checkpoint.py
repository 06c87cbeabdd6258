"""Checkpoint loading: PyTorch ``.pth`` state dicts -> the port's PMG, PM
and RTM params.

The params are the JAX package's tree with torch tensors at the leaves:
conv OIHW -> HWIO, Linear [out, in] -> [in, out], the packed transformer
``in_proj`` split into q/k/v, per-task modules stacked on a leading task
axis and zero-padded to Kmax.  RTM backbones arrive under three key
schemas (``truncated_encoder.<seq>.``, ``backbone.``, raw ResNet roots),
all accepted.  PM checkpoints carry SE weights or not
(``checkpoint_has_se``).  ``convert`` is strict by default (a missing key
raises); ``strict=False`` fills missing tensors from the port's own
``init`` and prints the missing and unexpected keys, as the JAX package does.

The reverse direction, ``export_state_dict`` / ``save_torch_checkpoint``,
writes the reference's exact key schema (``.pth`` or ``.npz``).  The port's
native format (``save_native`` / ``load_native``) is a directory holding
``params.pt`` (``torch.save`` of the param tree, or of a whole train state,
as CPU tensors, read back with ``weights_only=True``) and
``native_meta.json`` (a format version, what it holds, and the tree's key
-> shape and dtype manifest).  A native directory that the JAX package
wrote with Orbax is refused with the way across: a ``.pth`` from the JAX
package's ``save_torch_checkpoint``.  ``train_state_from_jax`` carries the
JAX package's train state (params and optax AdamW state) into the port's.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models import get_family
from ..models import pm as pm_mod
from ..models import pmg as pmg_mod
from ..models import resnet as resnet_mod
from ..models import rtm as rtm_mod

StateDict = Dict[str, np.ndarray]


def load_state_dict(path: str) -> StateDict:
    """Load a ``.pth`` (torch pickle) or ``.npz`` of named arrays -> numpy.

    Unwraps ``{'model': ...}`` / ``{'state_dict': ...}`` containers and strips
    ``module.`` (DataParallel) prefixes.
    """
    if path.endswith(".npz"):
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
    else:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and not all(hasattr(v, "numpy") for v in obj.values()):
            obj = obj.get("model", obj.get("state_dict", obj))
        raw = {
            k: v.detach().cpu().numpy()
            for k, v in obj.items()
            if hasattr(v, "detach")
        }
    return {k[7:] if k.startswith("module.") else k: v for k, v in raw.items()}


def checkpoint_has_se(state: StateDict) -> bool:
    """The PM SE probe: a checkpoint has SE blocks when a key holds ``.se.mlp.``."""
    return any(".se.mlp." in k for k in state)


def _t(a) -> torch.Tensor:
    """A contiguous float32 tensor (a transposed weight is copied in its new order)."""
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)


def _conv(w: np.ndarray, b: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    p = {"w": _t(np.transpose(w, (2, 3, 1, 0)))}  # OIHW -> HWIO
    if b is not None:
        p["b"] = _t(b)
    return p


def _linear(w: np.ndarray, b: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    p = {"w": _t(w.T)}
    if b is not None:
        p["b"] = _t(b)
    return p


def _norm(state: StateDict, prefix: str, kind: str) -> Dict[str, torch.Tensor]:
    p = {"scale": _t(state[f"{prefix}.weight"]), "bias": _t(state[f"{prefix}.bias"])}
    if kind == "batch":
        p["mean"] = _t(state[f"{prefix}.running_mean"])
        p["var"] = _t(state[f"{prefix}.running_var"])
    return p


def _stack_padded(
    ws: List[np.ndarray], bs: List[np.ndarray], kmax: int
) -> Dict[str, torch.Tensor]:
    """Per-task Linear [K_t, D] torch weights -> {"w": [T,D,Kmax], "b": [T,Kmax]}."""
    nt, d = len(ws), ws[0].shape[1]
    w = np.zeros((nt, d, kmax), np.float32)
    b = np.zeros((nt, kmax), np.float32)
    for i, (wi, bi) in enumerate(zip(ws, bs)):
        if wi.shape[0] > kmax:
            raise ValueError(
                f"checkpoint head #{i} has {wi.shape[0]} classes but the task "
                f"registry's widest task has {kmax}: the registry does not match "
                f"the one this checkpoint was trained with"
            )
        w[i, :, : wi.shape[0]] = wi.T
        b[i, : bi.shape[0]] = bi
    return {"w": _t(w), "b": _t(b)}


def convert_pmg(state: StateDict, spec: pmg_mod.Spec) -> Dict[str, Any]:
    """Map a ``MultiTaskPatchGANGramModelNonOverlapV2`` state dict (CPU tensors)."""
    t = spec.tasks
    params: Dict[str, Any] = {"trunk": []}
    for i in range(len(spec.plan)):
        ci, ni = 3 * i, 3 * i + 1  # Sequential indices: conv, norm, LeakyReLU
        params["trunk"].append(
            {
                "conv": _conv(state[f"feature_extractor.{ci}.weight"]),
                "norm": _norm(state, f"feature_extractor.{ni}", spec.norm),
            }
        )
    if spec.use_channel_attention:
        # SEBlock.fc = Sequential(Linear, ReLU, Linear, Sigmoid), bias-free
        params["se"] = {
            "fc1": _linear(state["se.fc.0.weight"]),
            "fc2": _linear(state["se.fc.2.weight"]),
        }
    params["chan_proj"] = _conv(state["chan_proj.weight"])
    params["token_proj"] = _linear(state["token_proj.weight"], state["token_proj.bias"])
    if spec.has_transformer:
        d = spec.d_model
        layers = []
        for li in range(spec.transformer_layers):
            pre = f"transformer.encoder.layers.{li}"
            inw = state[f"{pre}.self_attn.in_proj_weight"]  # [3D, D]
            inb = state[f"{pre}.self_attn.in_proj_bias"]  # [3D]
            layers.append(
                {
                    "attn": {
                        "wq": _t(inw[:d].T),
                        "wk": _t(inw[d : 2 * d].T),
                        "wv": _t(inw[2 * d :].T),
                        "bq": _t(inb[:d]),
                        "bk": _t(inb[d : 2 * d]),
                        "bv": _t(inb[2 * d :]),
                        "wo": _t(state[f"{pre}.self_attn.out_proj.weight"].T),
                        "bo": _t(state[f"{pre}.self_attn.out_proj.bias"]),
                    },
                    "norm1": {
                        "scale": _t(state[f"{pre}.norm1.weight"]),
                        "bias": _t(state[f"{pre}.norm1.bias"]),
                    },
                    "norm2": {
                        "scale": _t(state[f"{pre}.norm2.weight"]),
                        "bias": _t(state[f"{pre}.norm2.bias"]),
                    },
                    "ffn1": _linear(state[f"{pre}.linear1.weight"], state[f"{pre}.linear1.bias"]),
                    "ffn2": _linear(state[f"{pre}.linear2.weight"], state[f"{pre}.linear2.bias"]),
                }
            )
        params["transformer"] = layers
    params["queries"] = torch.stack(
        [_t(state[f"task_pool.query.{name}"]) for name in t.names]
    )
    params["heads"] = _stack_padded(
        [state[f"classifiers.{n}.weight"] for n in t.names],
        [state[f"classifiers.{n}.bias"] for n in t.names],
        t.max_classes,
    )
    return params


def convert_pm(state: StateDict, spec: pm_mod.Spec) -> Dict[str, Any]:
    """Map a ``MultiTaskPatchGAN`` state dict.  Per-task heads are stacked on
    a leading task axis; SE weights stay zero where the spec has no SE or
    the checkpoint carries none."""
    t = spec.tasks
    nt, kmax, c = len(t), t.max_classes, spec.trunk_channels
    params: Dict[str, Any] = {"trunk": []}
    for i in range(len(spec.plan)):
        ci, ni = 3 * i, 3 * i + 1  # Sequential indices: conv, norm, LeakyReLU
        params["trunk"].append({
            "conv": _conv(state[f"trunk.{ci}.weight"], state.get(f"trunk.{ci}.bias")),
            "norm": _norm(state, f"trunk.{ni}", spec.norm),
        })
    hid = max(c // 16, 1)
    heads = {
        "se1_w": np.zeros((nt, c, hid), np.float32),
        "se1_b": np.zeros((nt, hid), np.float32),
        "se2_w": np.zeros((nt, hid, c), np.float32),
        "se2_b": np.zeros((nt, c), np.float32),
        "attn_w": np.zeros((nt, c), np.float32),
        "attn_b": np.zeros((nt,), np.float32),
        "cls_w": np.zeros((nt, c, kmax), np.float32),
    }
    for i, name in enumerate(t.names):
        pre = f"task_heads.{name}"
        if spec.attn_use_se and f"{pre}.se.mlp.0.weight" in state:
            heads["se1_w"][i] = state[f"{pre}.se.mlp.0.weight"].T
            heads["se1_b"][i] = state[f"{pre}.se.mlp.0.bias"]
            heads["se2_w"][i] = state[f"{pre}.se.mlp.2.weight"].T
            heads["se2_b"][i] = state[f"{pre}.se.mlp.2.bias"]
        heads["attn_w"][i] = state[f"{pre}.attn_conv.weight"][0, :, 0, 0]
        heads["attn_b"][i] = state[f"{pre}.attn_conv.bias"][0]
        kw = state[f"{pre}.cls_conv.weight"][:, :, 0, 0]  # [K, C]
        if kw.shape[0] > kmax:
            raise ValueError(
                f"checkpoint head {name!r} has {kw.shape[0]} classes but the task registry's "
                f"widest task has {kmax}"
            )
        heads["cls_w"][i, :, : kw.shape[0]] = kw.T
    params["heads"] = {k: _t(v) for k, v in heads.items()}
    return params


# torchvision children order inside the truncated Sequential
# (root-name map {conv1: 0, bn1: 1, ..., layer4: 7}).
_SEQ_TO_NAME = {0: "conv1", 1: "bn1", 4: "layer1", 5: "layer2", 6: "layer3", 7: "layer4"}
_NAME_TO_SEQ = {v: k for k, v in _SEQ_TO_NAME.items()}


def _canon_backbone_keys(state: StateDict) -> StateDict:
    """Normalize the accepted RTM backbone key forms to raw ResNet root
    names: ``truncated_encoder.<seq>.rest``, ``backbone.<root>.rest`` and
    raw ``<root>.rest``.  Other keys are dropped."""
    out: StateDict = {}
    for k, v in state.items():
        if k.startswith("truncated_encoder."):
            seq, _, tail = k[len("truncated_encoder."):].partition(".")
            name = _SEQ_TO_NAME.get(int(seq)) if seq.isdigit() else None
            if name is not None:
                out[f"{name}.{tail}"] = v
        elif k.startswith("backbone."):
            out[k[len("backbone."):]] = v
        elif k.split(".")[0] in _NAME_TO_SEQ:
            out[k] = v
    return out


def convert_resnet(state: StateDict) -> Dict[str, Any]:
    """Raw torchvision-ResNet-50-named state dict -> backbone params.
    Truncated checkpoints lack the later stages, and so does the tree."""
    params: Dict[str, Any] = {"conv1": _conv(state["conv1.weight"]), "bn1": _norm(state, "bn1", "batch")}
    for si, (nblocks, _) in enumerate(resnet_mod.STAGES):
        if f"layer{si + 1}.0.conv1.weight" not in state:
            break
        blocks = []
        for bi in range(nblocks):
            pre = f"layer{si + 1}.{bi}"
            block = {}
            for ci in (1, 2, 3):
                block[f"conv{ci}"] = _conv(state[f"{pre}.conv{ci}.weight"])
                block[f"bn{ci}"] = _norm(state, f"{pre}.bn{ci}", "batch")
            if f"{pre}.downsample.0.weight" in state:
                block["downsample"] = {
                    "conv": _conv(state[f"{pre}.downsample.0.weight"]),
                    "bn": _norm(state, f"{pre}.downsample.1", "batch"),
                }
            blocks.append(block)
        params[f"layer{si + 1}"] = blocks
    return params


def convert_rtm(state: StateDict, spec: rtm_mod.Spec, partial_copy: bool = True) -> Dict[str, Any]:
    """Map a ``MultiHeadAttentionPerTaskModel`` state dict.

    ``partial_copy=True`` copies the overlapping slice of a classifier
    tensor whose shape disagrees with the registry and leaves the rest
    zero, as the reference loader does; ``False`` raises instead.
    """
    t = spec.tasks
    nt, kmax = len(t), t.max_classes
    params: Dict[str, Any] = {"backbone": convert_resnet(_canon_backbone_keys(state))}
    c, d = spec.num_features, spec.token_dim
    if spec.use_attention:
        proj_w = np.zeros((nt, c, d), np.float32)
        out_w = np.zeros((nt, d, c), np.float32)
        qs = np.zeros((nt, d), np.float32)
        for i, name in enumerate(t.names):
            pre = f"attentions.attention_{name.replace(' ', '_')}"
            proj_w[i] = state[f"{pre}.proj.weight"].T
            out_w[i] = state[f"{pre}.out.weight"].T
            qs[i] = state[f"{pre}.q"].reshape(-1)
        params["attn"] = {"proj_w": _t(proj_w), "q": _t(qs), "out_w": _t(out_w)}
    # classifier Sequential: [Linear, ReLU] * n_hidden + final Linear, so the
    # Linear modules sit at even indices 0, 2, ..., 2*n_hidden
    dims = spec.mlp_dims
    n_hidden = len(dims) - 1
    mlp: List[Dict[str, torch.Tensor]] = []
    for li in range(n_hidden):
        w = np.zeros((nt, dims[li], dims[li + 1]), np.float32)
        b = np.zeros((nt, dims[li + 1]), np.float32)
        for i, name in enumerate(t.names):
            pre = f"classifiers.classifier_{name.replace(' ', '_')}.{2 * li}"
            w[i] = state[f"{pre}.weight"].T
            b[i] = state[f"{pre}.bias"]
        mlp.append({"w": _t(w), "b": _t(b)})
    fw = np.zeros((nt, dims[-1], kmax), np.float32)
    fb = np.zeros((nt, kmax), np.float32)
    for i, name in enumerate(t.names):
        key = f"classifiers.classifier_{name.replace(' ', '_')}.{2 * n_hidden}"
        if f"{key}.weight" not in state:
            # a bare Linear saved flat as ``classifier_<task>.weight``
            key = f"classifiers.classifier_{name.replace(' ', '_')}"
        wsrc, bsrc = state[f"{key}.weight"], state[f"{key}.bias"]
        k_t, d_in = t.num_classes[i], dims[-1]
        if wsrc.shape != (k_t, d_in):
            if not partial_copy:
                raise ValueError(f"shape mismatch for {key}.weight: {wsrc.shape} vs {(k_t, d_in)}")
            rows, cols = min(k_t, wsrc.shape[0]), min(d_in, wsrc.shape[1])
            fw[i, :cols, :rows] = wsrc[:rows, :cols].T
            nb = min(k_t, bsrc.shape[0])
            fb[i, :nb] = bsrc[:nb]
        else:
            fw[i, :, :k_t] = wsrc.T
            fb[i, :k_t] = bsrc
    params["mlp"] = mlp
    params["final"] = {"w": _t(fw), "b": _t(fb)}
    return params


_CONVERTERS = {"pmg": convert_pmg, "pm": convert_pm, "rtm": convert_rtm}


def sniff_family(state: Mapping[str, Any]) -> Optional[str]:
    """Best-effort family guess from checkpoint key roots (``module.``
    prefixes stripped): PMG has ``feature_extractor.*``, PM ``trunk.*`` /
    ``task_heads.*``, RTM ``truncated_encoder.`` / ``backbone.`` / bare
    torchvision roots."""
    roots = set()
    for k in state:
        if k.startswith("module."):
            k = k[len("module."):]
        roots.add(k.split(".", 1)[0])
    if "feature_extractor" in roots:
        return "pmg"
    if {"truncated_encoder", "backbone", "conv1", "layer1"} & roots:
        return "rtm"
    if {"trunk", "task_heads"} & roots:
        return "pm"
    return None


# ---------------------------------------------------------------------------
# Reverse conversion: params -> the reference's state dict (interop/export)
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    """A float32 numpy copy of a tensor on any device (bf16 upcast, exact)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _export_conv(p) -> np.ndarray:
    return np.transpose(_np(p["w"]), (3, 2, 0, 1))  # HWIO -> OIHW


def _export_norm(out: StateDict, prefix: str, p, kind: str) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])
    if kind == "batch":
        out[f"{prefix}.running_mean"] = _np(p["mean"])
        out[f"{prefix}.running_var"] = _np(p["var"])
        out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def export_pmg(params, spec: pmg_mod.Spec) -> StateDict:
    """Inverse of :func:`convert_pmg`: the reference's exact key schema, so
    an exported checkpoint loads into the PyTorch reference unmodified."""
    t = spec.tasks
    out: StateDict = {}
    for i, lp in enumerate(params["trunk"]):
        out[f"feature_extractor.{3 * i}.weight"] = _export_conv(lp["conv"])
        _export_norm(out, f"feature_extractor.{3 * i + 1}", lp["norm"], spec.norm)
    if spec.use_channel_attention and "se" in params:
        out["se.fc.0.weight"] = _np(params["se"]["fc1"]["w"]).T
        out["se.fc.2.weight"] = _np(params["se"]["fc2"]["w"]).T
    out["chan_proj.weight"] = _export_conv(params["chan_proj"])
    out["token_proj.weight"] = _np(params["token_proj"]["w"]).T
    out["token_proj.bias"] = _np(params["token_proj"]["b"])
    if spec.has_transformer:
        for li, lp in enumerate(params["transformer"]):
            pre = f"transformer.encoder.layers.{li}"
            a = lp["attn"]
            out[f"{pre}.self_attn.in_proj_weight"] = np.concatenate(
                [_np(a["wq"]).T, _np(a["wk"]).T, _np(a["wv"]).T], axis=0
            )
            out[f"{pre}.self_attn.in_proj_bias"] = np.concatenate(
                [_np(a["bq"]), _np(a["bk"]), _np(a["bv"])]
            )
            out[f"{pre}.self_attn.out_proj.weight"] = _np(a["wo"]).T
            out[f"{pre}.self_attn.out_proj.bias"] = _np(a["bo"])
            out[f"{pre}.norm1.weight"] = _np(lp["norm1"]["scale"])
            out[f"{pre}.norm1.bias"] = _np(lp["norm1"]["bias"])
            out[f"{pre}.norm2.weight"] = _np(lp["norm2"]["scale"])
            out[f"{pre}.norm2.bias"] = _np(lp["norm2"]["bias"])
            out[f"{pre}.linear1.weight"] = _np(lp["ffn1"]["w"]).T
            out[f"{pre}.linear1.bias"] = _np(lp["ffn1"]["b"])
            out[f"{pre}.linear2.weight"] = _np(lp["ffn2"]["w"]).T
            out[f"{pre}.linear2.bias"] = _np(lp["ffn2"]["b"])
    q = _np(params["queries"])
    hw, hb = _np(params["heads"]["w"]), _np(params["heads"]["b"])
    for i, name in enumerate(t.names):
        k = t.num_classes[i]
        out[f"task_pool.query.{name}"] = q[i]
        out[f"classifiers.{name}.weight"] = hw[i, :, :k].T
        out[f"classifiers.{name}.bias"] = hb[i, :k]
    return out


def export_pm(params, spec: pm_mod.Spec) -> StateDict:
    t = spec.tasks
    out: StateDict = {}
    for i, lp in enumerate(params["trunk"]):
        out[f"trunk.{3 * i}.weight"] = _export_conv(lp["conv"])
        if "b" in lp["conv"]:
            out[f"trunk.{3 * i}.bias"] = _np(lp["conv"]["b"])
        _export_norm(out, f"trunk.{3 * i + 1}", lp["norm"], spec.norm)
    hp = {k: _np(v) for k, v in params["heads"].items()}
    for i, name in enumerate(t.names):
        pre = f"task_heads.{name}"
        k = t.num_classes[i]
        if spec.attn_use_se:
            out[f"{pre}.se.mlp.0.weight"] = hp["se1_w"][i].T
            out[f"{pre}.se.mlp.0.bias"] = hp["se1_b"][i]
            out[f"{pre}.se.mlp.2.weight"] = hp["se2_w"][i].T
            out[f"{pre}.se.mlp.2.bias"] = hp["se2_b"][i]
        out[f"{pre}.attn_conv.weight"] = hp["attn_w"][i][None, :, None, None]
        out[f"{pre}.attn_conv.bias"] = hp["attn_b"][i][None]
        out[f"{pre}.cls_conv.weight"] = hp["cls_w"][i, :, :k].T[:, :, None, None]
    return out


def export_rtm(params, spec: rtm_mod.Spec) -> StateDict:
    """Exports with the model's own ``truncated_encoder.<seq>`` naming (what
    ``torch.save(model.state_dict())`` produces for the reference)."""
    t = spec.tasks
    out: StateDict = {}
    bb = params["backbone"]
    raw: StateDict = {}
    raw["conv1.weight"] = _export_conv(bb["conv1"])
    _export_norm(raw, "bn1", bb["bn1"], "batch")
    for si in range(len(resnet_mod.STAGES)):
        name = f"layer{si + 1}"
        if name not in bb:
            continue
        for bi, bp in enumerate(bb[name]):
            pre = f"{name}.{bi}"
            for ci in (1, 2, 3):
                raw[f"{pre}.conv{ci}.weight"] = _export_conv(bp[f"conv{ci}"])
                _export_norm(raw, f"{pre}.bn{ci}", bp[f"bn{ci}"], "batch")
            if "downsample" in bp:
                raw[f"{pre}.downsample.0.weight"] = _export_conv(bp["downsample"]["conv"])
                _export_norm(raw, f"{pre}.downsample.1", bp["downsample"]["bn"], "batch")
    for k, v in raw.items():
        root, _, tail = k.partition(".")
        out[f"truncated_encoder.{_NAME_TO_SEQ[root]}.{tail}"] = v
    if spec.use_attention and "attn" in params:
        a = {k: _np(v) for k, v in params["attn"].items()}
        for i, name in enumerate(t.names):
            pre = f"attentions.attention_{name.replace(' ', '_')}"
            out[f"{pre}.q"] = a["q"][i][None, None, :]
            out[f"{pre}.proj.weight"] = a["proj_w"][i].T
            out[f"{pre}.out.weight"] = a["out_w"][i].T
    dims = spec.mlp_dims
    mlp = [{k: _np(v) for k, v in lp.items()} for lp in params["mlp"]]
    fw, fb = _np(params["final"]["w"]), _np(params["final"]["b"])
    for i, name in enumerate(t.names):
        pre = f"classifiers.classifier_{name.replace(' ', '_')}"
        for li, lp in enumerate(mlp):
            out[f"{pre}.{2 * li}.weight"] = lp["w"][i].T
            out[f"{pre}.{2 * li}.bias"] = lp["b"][i]
        k = t.num_classes[i]
        out[f"{pre}.{2 * (len(dims) - 1)}.weight"] = fw[i, :, :k].T
        out[f"{pre}.{2 * (len(dims) - 1)}.bias"] = fb[i, :k]
    return out


_EXPORTERS = {"pmg": export_pmg, "pm": export_pm, "rtm": export_rtm}


def export_state_dict(family: str, params, spec) -> StateDict:
    """Params (tensors on any device, float32 or bf16) -> the reference's
    state dict as float32 numpy arrays (``num_batches_tracked`` int64 0)."""
    return _EXPORTERS[family.lower()](params, spec)


def save_torch_checkpoint(family: str, params, spec, path: str) -> None:
    """Export params as a reference-loadable ``.pth`` (or ``.npz``)."""
    state = export_state_dict(family, params, spec)
    if path.endswith(".npz"):
        np.savez(path, **state)
    else:
        # np.array keeps num_batches_tracked 0-d (np.ascontiguousarray would
        # make it [1], a shape the reference's BatchNorm does not have)
        torch.save({k: torch.from_numpy(np.array(v, order="C")) for k, v in state.items()}, path)


# ---------------------------------------------------------------------------
# Family dispatch, strict and non-strict
# ---------------------------------------------------------------------------


def _canon_state_keys(family: str, state: StateDict) -> StateDict:
    """Normalize accepted key aliases to the export manifest's naming.

    RTM checkpoints arrive in three backbone forms (``truncated_encoder.<seq>``
    / ``backbone.<root>`` / raw ``<root>``) while the export manifest uses
    ``truncated_encoder.<seq>``; without this the non-strict
    missing/unexpected comparison would classify every aliased backbone
    tensor as unexpected and re-initialize it.
    """
    if family != "rtm":
        return state
    out: StateDict = {}
    for k, v in state.items():
        root = k.split(".", 1)[0]
        if not (k.startswith(("truncated_encoder.", "backbone.")) or root in _NAME_TO_SEQ):
            out[k] = v
    for k, v in _canon_backbone_keys(state).items():
        root, _, tail = k.partition(".")
        seq = _NAME_TO_SEQ.get(root)
        if seq is None:
            out[k] = v
        else:
            out[f"truncated_encoder.{seq}.{tail}"] = v
    return out


def convert(
    family: str, state: StateDict, spec, strict: bool = True, init_key: int = 0
) -> Dict[str, Any]:
    """State dict -> params (CPU tensors).

    Strict: a missing key raises; when the key schema belongs to another
    family, the error names it.  ``strict=False`` reproduces the reference
    loaders' fallback: missing tensors come from a fresh initialization
    (``init(torch.Generator().manual_seed(init_key), spec)``), unexpected
    ones are ignored, and both lists are printed.  A present tensor whose
    shape disagrees with the manifest is an error (torch
    ``load_state_dict(strict=False)`` semantics), except RTM classifier
    tensors, which the converter partial-copies.
    """
    family = family.lower()
    mod = get_family(family)  # raises for an unknown family
    if strict:
        try:
            return _CONVERTERS[family](state, spec)
        except KeyError as e:
            guessed = sniff_family(state)
            if guessed and guessed != family:
                raise ValueError(
                    f"checkpoint does not look like a {family.upper()} "
                    f"checkpoint (missing key {e.args[0]!r}); its key "
                    f"schema matches {guessed.upper()} — rerun with the "
                    f"'{guessed}' family"
                ) from e
            raise
    full = export_state_dict(family, mod.init(torch.Generator().manual_seed(init_key), spec), spec)
    state = _canon_state_keys(family, state)
    missing = [k for k in full if k not in state]
    unexpected = [k for k in state if k not in full and "num_batches_tracked" not in k]
    mismatched = [
        k for k in state
        if k in full
        and tuple(np.shape(state[k])) != tuple(np.shape(full[k]))
        and not (family == "rtm" and k.startswith("classifiers."))
    ]
    if mismatched:
        raise ValueError(
            f"shape mismatch for {len(mismatched)} tensors, e.g. "
            + ", ".join(
                f"{k}: {tuple(np.shape(state[k]))} vs {tuple(np.shape(full[k]))}"
                for k in mismatched[:4]
            )
        )
    if missing:
        print(f"[load] Missing keys ({len(missing)}): {missing[:8]}"
              f"{' ...' if len(missing) > 8 else ''}")
    if unexpected:
        print(f"[load] Unexpected keys ({len(unexpected)}): {unexpected[:8]}"
              f"{' ...' if len(unexpected) > 8 else ''}")
    merged = {**full, **{k: v for k, v in state.items() if k in full}}
    return _CONVERTERS[family](merged, spec)


def load_torch_checkpoint(family: str, path: str, spec, strict: bool = True) -> Dict[str, Any]:
    """``.pth`` / ``.npz`` path -> params (CPU tensors).  With
    ``strict=False`` a strict conversion that misses a key falls back to the
    non-strict one; a wrong-family schema raises ``ValueError`` either way."""
    state = load_state_dict(path)
    try:
        return convert(family, state, spec, strict=True)
    except KeyError:
        if strict:
            raise
        print("[WARN] strict conversion failed, falling back to strict=False")
        return convert(family, state, spec, strict=False)


# ---------------------------------------------------------------------------
# Native checkpoints: params.pt + native_meta.json
# ---------------------------------------------------------------------------

NATIVE_FORMAT_VERSION = 1
_NATIVE_PARAMS = "params.pt"
_NATIVE_META = "native_meta.json"
# files an Orbax checkpoint directory (the JAX package's native format) holds
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict/list tree, paths joined by "/"."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _manifest(tree: Any) -> Dict[str, Dict[str, Any]]:
    """{path: {"shape", "dtype"}} of every leaf, dtypes named as in torch."""
    return {k: {"shape": list(v.shape), "dtype": str(v.dtype).replace("torch.", "")}
            for k, v in _leaves(tree)}


def _is_train_state(obj) -> bool:
    return hasattr(obj, "opt_state") and hasattr(obj, "step") and hasattr(obj, "params")


def _train_state_tree(state) -> Dict[str, Any]:
    """A ``parallel.train.TrainState`` as one tree: params, the optimizer's
    state tree and the step."""
    return {"params": state.params, "opt_state": state.opt_state.tree(),
            "step": torch.tensor(int(state.step))}


def save_native(params, path: str) -> None:
    """Save a param tree, or a whole ``parallel.train.TrainState`` (params,
    optimizer state and step: what a resume needs), in the port's native
    format (a directory; the tensors are copied to the CPU)."""
    from ..parallel.train import snapshot

    os.makedirs(path, exist_ok=True)
    kind = "train_state" if _is_train_state(params) else "params"
    tree = snapshot(_train_state_tree(params) if kind == "train_state" else params)
    torch.save(tree, os.path.join(path, _NATIVE_PARAMS))
    meta = {"format_version": NATIVE_FORMAT_VERSION, "kind": kind, "manifest": _manifest(tree)}
    with open(os.path.join(path, _NATIVE_META), "w") as f:
        json.dump(meta, f, indent=1)


def load_native(path: str, like=None):
    """Load a :func:`save_native` directory -> the param tree (CPU tensors),
    or for a saved ``TrainState`` its tree ({"params", "opt_state", "step"}).

    The saved tree must match its own manifest, and ``like`` (a param tree,
    or a ``TrainState``), where given, key for key and shape for shape; a
    difference raises ``ValueError``.  With a ``TrainState`` for ``like``
    the result is a ``TrainState`` too: the params copied to like's device
    for training, and a fresh state of like's optimizer loaded with the
    saved moments, accumulation and step.  A directory in the JAX
    package's Orbax format is refused."""
    params_path = os.path.join(path, _NATIVE_PARAMS)
    if not os.path.isfile(params_path):
        if any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
            raise ValueError(
                f"{path} is an Orbax checkpoint (the JAX package's native format), which "
                "the port does not read; export it with the JAX package's "
                "engine.checkpoint.save_torch_checkpoint to a .pth and load that"
            )
        raise ValueError(f"{path} is not a native checkpoint directory (no {_NATIVE_PARAMS})")
    with open(os.path.join(path, _NATIVE_META)) as f:
        meta = json.load(f)
    if meta.get("format_version") != NATIVE_FORMAT_VERSION:
        raise ValueError(
            f"unsupported native checkpoint format {meta.get('format_version')} "
            f"(this build reads {NATIVE_FORMAT_VERSION})"
        )
    tree = torch.load(params_path, map_location="cpu", weights_only=True)
    got = _manifest(tree)
    _check_same_tree(got, meta["manifest"], "its manifest", path, dtypes=True)
    if like is None:
        return tree
    state_like = _is_train_state(like)
    if state_like != (meta.get("kind") == "train_state"):
        raise ValueError(f"native checkpoint {path} holds {meta.get('kind', 'params')}, "
                         f"`like` is {'a TrainState' if state_like else 'a param tree'}")
    _check_same_tree(got, _manifest(_train_state_tree(like) if state_like else like), "`like`",
                     path, dtypes=False)
    return _as_train_state(tree, like) if state_like else tree


def _as_train_state(tree: Dict[str, Any], like):
    """A TrainState from its saved tree, on like's device, with like's optimizer."""
    from ..parallel.train import TrainState, trainable_params

    leaf = like.opt_state.leaves[0]
    params = trainable_params(tree["params"], leaf.device)
    opt_state = like.opt_state.optimizer.init(params)
    opt_state.load_tree(tree["opt_state"])
    return TrainState(params, opt_state, int(tree["step"]))


def _check_same_tree(got: Dict, want: Dict, against: str, path: str, dtypes: bool) -> None:
    missing = [k for k in want if k not in got]
    extra = [k for k in got if k not in want]
    differ = [k for k in want if k in got and (
        got[k]["shape"] != want[k]["shape"] or (dtypes and got[k]["dtype"] != want[k]["dtype"]))]
    if missing or extra or differ:
        raise ValueError(
            f"native checkpoint {path} does not match {against}: missing {missing[:8]}, "
            f"unexpected {extra[:8]}, differing "
            + str([f"{k}: {got[k]['shape']} {got[k]['dtype']} vs {want[k]['shape']} "
                   f"{want[k]['dtype']}" for k in differ[:4]])
        )


def params_from_jax(tree: Any, spec) -> Dict[str, Any]:
    """The JAX package's param tree (numpy or JAX arrays at the leaves) ->
    the port's params (CPU tensors), leaf for leaf.

    Takes a PMG tree, a PM tree, an RTM tree, or an RTM
    ``fold_stream_weights`` tree (float32 or int8-quantized).  Both packages share one tree layout, so
    this is a structural copy: float leaves become float32 tensors, int8
    leaves stay int8.  It checks that the tree has the entries ``spec``
    implies.
    """
    keys = set(tree)
    if isinstance(spec, rtm_mod.Spec):
        if "attn_pq" in keys:  # a fold_stream_weights tree
            q8 = "attn_fold_q8" in keys
            want = {"backbone", "attn_pq", "final"} | (keys & {"stem_w"})
            want |= {"attn_fold_q8", "attn_fold_scale", "mlp_q8"} if q8 else {"attn_fold", "mlp"}
            layers = "mlp_q8" if q8 else "mlp"
        else:
            want = {"backbone", "mlp", "final"} | ({"attn"} if spec.use_attention else set())
            layers = "mlp"
        planned, what = len(spec.mlp_dims) - 1, "MLP layers"
    elif isinstance(spec, pm_mod.Spec):
        want = {"trunk", "heads"}
        layers, planned, what = "trunk", len(spec.plan), "trunk blocks"
    else:
        want = {"trunk", "chan_proj", "token_proj", "queries", "heads"}
        want |= {"se"} if spec.use_channel_attention else set()
        want |= {"transformer"} if spec.has_transformer else set()
        layers, planned, what = "trunk", len(spec.plan), "trunk blocks"
    if keys != want:
        raise ValueError(f"param tree keys {sorted(tree)} do not match the spec's {sorted(want)}")
    if len(tree[layers]) != planned:
        raise ValueError(f"param tree has {len(tree[layers])} {what}, the spec plans {planned}")

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        a = np.asarray(node)
        return torch.tensor(a) if a.dtype == np.int8 else _t(a)

    return conv(tree)


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def train_state_from_jax(state, spec, optimizer=None, device="cpu"):
    """The JAX package's ``TrainState`` (params, an ``optax.adamw`` state,
    optionally inside ``optax.MultiSteps``, and the step) -> the port's
    ``parallel.train.TrainState`` on ``device``, as :func:`params_from_jax`
    carries params: AdamW's moments, its update count, and the
    accumulation's running mean and mini-step, leaf for leaf.  The optax
    objects are read by their fields; nothing of JAX is imported.
    ``optimizer`` (default ``make_optimizer()``) must accumulate exactly
    when the JAX state does (``accum_steps > 1``)."""
    from ..parallel.train import TrainState, leaf_dict, make_optimizer, trainable_params

    optimizer = optimizer or make_optimizer()
    ost = state.opt_state
    multi = hasattr(ost, "inner_opt_state") and hasattr(ost, "acc_grads")
    if multi != (optimizer.accum_steps > 1):
        raise ValueError(
            f"the JAX optimizer state {'is' if multi else 'is not'} an optax.MultiSteps state, "
            f"the port's optimizer has accum_steps={optimizer.accum_steps}"
        )
    adam = _adam_state(ost.inner_opt_state if multi else ost)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) in the JAX optimizer state")
    params = trainable_params(params_from_jax(state.params, spec), device)
    opt_state = optimizer.init(params)
    tree = {
        "count": torch.tensor(float(np.asarray(adam.count))),
        "exp_avg": leaf_dict(params_from_jax(adam.mu, spec)),
        "exp_avg_sq": leaf_dict(params_from_jax(adam.nu, spec)),
        "mini_step": torch.tensor(int(np.asarray(ost.mini_step)) if multi else 0),
    }
    if multi:
        tree["acc"] = leaf_dict(params_from_jax(ost.acc_grads, spec))
    opt_state.load_tree(tree)
    return TrainState(params, opt_state, int(np.asarray(state.step)))


def to_device(params: Any, device) -> Any:
    """Move every tensor of a param tree to ``device``."""
    if isinstance(params, Mapping):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [to_device(v, device) for v in params]
    return params.to(device)


def grad_ready(params: Any, device) -> Any:
    """A param tree on ``device`` as tensors autograd may save, for a
    workload that differentiates through the model with respect to its
    input: every leaf detached, and inference tensors (made under
    ``torch.inference_mode``) cloned outside that mode."""
    if isinstance(params, Mapping):
        return {k: grad_ready(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [grad_ready(v, device) for v in params]
    t = params.to(device)
    if t.is_inference():
        with torch.inference_mode(False):
            return t.clone()
    return t.detach()
