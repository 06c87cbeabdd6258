"""What the benchmark needs to know of the RTM family besides its reference:
the port's spec for a configuration, the FLOPs of a forward, and which
reference tensors make up each leaf of the port's param tree."""

from __future__ import annotations

from typing import Dict

from ..reference.rtm import STAGES, _slug, children
from .pmg import PORT, Parts


def port_spec(cfg: dict):
    """The port's ``models.rtm.Spec`` for the configuration."""
    from importlib import import_module

    family = import_module(f"{PORT}.models").get_family("rtm")
    return family.build_spec(cfg["tasks"], cfg["hparams"])


def _dims(cfg: dict):
    h = cfg["hparams"]
    return list(h.get("cls_hidden_dims") or [])[: int(h.get("cls_num_layers") or 0)]


def forward_flops(cfg: dict, batch: int) -> float:
    """Multiply-adds of one forward, counted twice, over ``batch`` images:
    every convolution of the truncated trunk, and per task the attention
    as its cheapest exact order computes it (the scores and the pooling
    over the tokens in C-space, then the pooled vector through ``proj`` and
    ``out``; ``proj q`` needs no image) and the classifier.  Norms,
    activations, pooling and softmaxes are left out."""
    h, kids = cfg["hparams"], children(cfg)
    s = cfg["img_size"] // 2
    macs, c = s * s * 64 * 3 * 49, 64
    if "maxpool" in kids:
        s = (s + 1) // 2
    for si, (nblocks, planes) in enumerate(STAGES):
        if f"layer{si + 1}" not in kids:
            break
        for bi in range(nblocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            so = (s + stride - 1) // stride
            macs += s * s * planes * c + so * so * planes * (9 * planes + 4 * planes)
            if bi == 0:
                macs += so * so * planes * 4 * c
            s, c = so, planes * 4
    n, d = s * s, h.get("attn_token_dim") or c
    dims = [c] + _dims(cfg)
    per_task = sum(a * b for a, b in zip(dims, dims[1:]))
    if h.get("use_attention", True):
        per_task += 2 * n * c + 2 * c * d
    macs += len(cfg["tasks"]) * per_task + sum(len(v) for v in cfg["tasks"].values()) * dims[-1]
    return 2.0 * macs * batch


def leaf_map(cfg: dict) -> Dict[str, Parts]:
    """Port leaf path -> the reference tensors (key, optional row range)
    whose elements it holds: the trunk one to one, the per-task attention
    and classifier tensors stacked over the tasks."""
    h, tasks, kids = cfg["hparams"], list(cfg["tasks"]), children(cfg)
    norm = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    out: Dict[str, Parts] = {"backbone/conv1/w": [("truncated_encoder.0.weight", None)]}
    if "bn1" in kids:
        for mine, theirs in norm.items():
            out[f"backbone/bn1/{mine}"] = [(f"truncated_encoder.1.{theirs}", None)]
    for si, (nblocks, _) in enumerate(STAGES):
        if f"layer{si + 1}" not in kids:
            break
        for bi in range(nblocks):
            pre, mine = f"truncated_encoder.{4 + si}.{bi}", f"backbone/layer{si + 1}/{bi}"
            for ci in (1, 2, 3):
                out[f"{mine}/conv{ci}/w"] = [(f"{pre}.conv{ci}.weight", None)]
                for m, t in norm.items():
                    out[f"{mine}/bn{ci}/{m}"] = [(f"{pre}.bn{ci}.{t}", None)]
            if bi == 0:
                out[f"{mine}/downsample/conv/w"] = [(f"{pre}.downsample.0.weight", None)]
                for m, t in norm.items():
                    out[f"{mine}/downsample/bn/{m}"] = [(f"{pre}.downsample.1.{t}", None)]
    if h.get("use_attention", True):
        for mine, theirs in (("proj_w", "proj.weight"), ("q", "q"), ("out_w", "out.weight")):
            out[f"attn/{mine}"] = [(f"attentions.attention_{_slug(t)}.{theirs}", None)
                                   for t in tasks]
    n_hidden = len(_dims(cfg))
    for li in range(n_hidden):
        for m in ("w", "b"):
            key = "weight" if m == "w" else "bias"
            out[f"mlp/{li}/{m}"] = [(f"classifiers.classifier_{_slug(t)}.{2 * li}.{key}", None)
                                    for t in tasks]
    for m in ("w", "b"):
        key = "weight" if m == "w" else "bias"
        out[f"final/{m}"] = [(f"classifiers.classifier_{_slug(t)}.{2 * n_hidden}.{key}", None)
                             for t in tasks]
    return out
