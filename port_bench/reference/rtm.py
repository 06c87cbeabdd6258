"""Plain PyTorch RTM (the reference toolkit's
``MultiHeadAttentionPerTaskModel``, ``Models/models_RTM.py:27``), computed
from the checkpoint's own keys.

A torchvision ResNet-50 (arXiv:1512.03385; bottleneck blocks, the stride on
the 3x3 convolution) cut after its first ``truncate_layer`` children
(``truncated_encoder.<i>``: conv1, bn1, relu, maxpool, layer1..layer4) ->
the feature map as tokens [B, HW, C] -> per task, in the order the paper's
attention is written: ``Tp = tokens proj^T``, ``a = softmax(Tp q /
sqrt(d))`` over the tokens, ``out((a Tp))`` -> per-task classifier
(``[Linear, ReLU] * n`` then Linear).  Without attention, the tokens' mean.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import Precision

STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))  # (blocks, planes), expansion 4
CHILDREN = ("conv1", "bn1", "relu", "maxpool", "layer1", "layer2", "layer3", "layer4")


def children(cfg: dict) -> Tuple[str, ...]:
    n = max(1, min(int(cfg["hparams"]["truncate_layer"]), len(CHILDREN)))
    return CHILDREN[:n]


def _slug(name: str) -> str:
    return name.replace(" ", "_")


def _bn_shapes(out: dict, pre: str, c: int) -> None:
    for k in ("weight", "bias", "running_mean", "running_var"):
        out[f"{pre}.{k}"] = (c,)


def state_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the toolkit's state dict for ``cfg`` and its shape."""
    h, kids = cfg["hparams"], children(cfg)
    out: Dict[str, Tuple[int, ...]] = {"truncated_encoder.0.weight": (64, 3, 7, 7)}
    c = 64
    if "bn1" in kids:
        _bn_shapes(out, "truncated_encoder.1", 64)
    for si, (nblocks, planes) in enumerate(STAGES):
        if f"layer{si + 1}" not in kids:
            break
        for bi in range(nblocks):
            pre = f"truncated_encoder.{4 + si}.{bi}"
            cout = planes * 4
            convs = ((c, planes, 1), (planes, planes, 3), (planes, cout, 1))
            for ci, (a, b, k) in enumerate(convs, 1):
                out[f"{pre}.conv{ci}.weight"] = (b, a, k, k)
                _bn_shapes(out, f"{pre}.bn{ci}", b)
            if bi == 0:
                out[f"{pre}.downsample.0.weight"] = (cout, c, 1, 1)
                _bn_shapes(out, f"{pre}.downsample.1", cout)
            c = cout
    d = h.get("attn_token_dim") or c
    dims = [c] + list(h.get("cls_hidden_dims") or [])[: int(h.get("cls_num_layers") or 0)]
    for name, classes in cfg["tasks"].items():
        if h.get("use_attention", True):
            pre = f"attentions.attention_{_slug(name)}"
            out[f"{pre}.q"] = (1, 1, d)
            out[f"{pre}.proj.weight"] = (d, c)
            out[f"{pre}.out.weight"] = (c, d)
        pre = f"classifiers.classifier_{_slug(name)}"
        for li in range(len(dims) - 1):
            out[f"{pre}.{2 * li}.weight"] = (dims[li + 1], dims[li])
            out[f"{pre}.{2 * li}.bias"] = (dims[li + 1],)
        out[f"{pre}.{2 * (len(dims) - 1)}.weight"] = (len(classes), dims[-1])
        out[f"{pre}.{2 * (len(dims) - 1)}.bias"] = (len(classes),)
    return out


def _bn(x: torch.Tensor, sd: dict, pre: str, train: bool) -> torch.Tensor:
    return F.batch_norm(x, sd[f"{pre}.running_mean"], sd[f"{pre}.running_var"],
                        sd[f"{pre}.weight"], sd[f"{pre}.bias"], train, 0.1, 1e-5)


def _conv(x: torch.Tensor, w: torch.Tensor, p: Precision, stride: int = 1, pad: int = 0):
    return F.conv2d(p.q(x), p.q(w), stride=stride, padding=pad)


def _block(x: torch.Tensor, sd: dict, pre: str, stride: int, p: Precision, train: bool):
    h = torch.relu(_bn(_conv(x, sd[f"{pre}.conv1.weight"], p), sd, f"{pre}.bn1", train))
    h = torch.relu(_bn(_conv(h, sd[f"{pre}.conv2.weight"], p, stride, 1), sd, f"{pre}.bn2", train))
    h = _bn(_conv(h, sd[f"{pre}.conv3.weight"], p), sd, f"{pre}.bn3", train)
    if f"{pre}.downsample.0.weight" in sd:
        x = _bn(_conv(x, sd[f"{pre}.downsample.0.weight"], p, stride), sd, f"{pre}.downsample.1",
                train)
    return torch.relu(h + x)


def features(sd: dict, x: torch.Tensor, cfg: dict, p: Precision = Precision(),
             train: bool = False) -> torch.Tensor:
    """Normalized NCHW images -> the truncated trunk's NCHW features."""
    for child in children(cfg):
        if child == "conv1":
            x = _conv(x, sd["truncated_encoder.0.weight"], p, 2, 3)
        elif child == "bn1":
            x = _bn(x, sd, "truncated_encoder.1", train)
        elif child == "relu":
            x = torch.relu(x)
        elif child == "maxpool":
            x = F.max_pool2d(x, 3, 2, 1)
        else:
            si = int(child[-1]) - 1
            for bi in range(STAGES[si][0]):
                x = _block(x, sd, f"truncated_encoder.{4 + si}.{bi}",
                           2 if (si > 0 and bi == 0) else 1, p, train)
    return x


def forward(sd: dict, x: torch.Tensor, cfg: dict, p: Precision = Precision(),
            train: bool = False) -> Dict[str, torch.Tensor]:
    """Normalized NCHW images -> {task: logits [B, K_task]}."""
    h = cfg["hparams"]
    f = features(sd, x, cfg, p, train)
    tokens = f.flatten(2).transpose(1, 2)  # [B, HW, C]
    n_hidden = len(list(h.get("cls_hidden_dims") or [])[: int(h.get("cls_num_layers") or 0)])
    out = {}
    for name in cfg["tasks"]:
        if h.get("use_attention", True):
            pre = f"attentions.attention_{_slug(name)}"
            tp = p.q(tokens) @ p.q(sd[f"{pre}.proj.weight"]).t()  # [B, N, d]
            q = sd[f"{pre}.q"].reshape(-1)
            a = torch.softmax(tp @ q / math.sqrt(q.shape[0]), dim=-1)  # [B, N]
            emb = p.q((a[:, :, None] * tp).sum(dim=1)) @ p.q(sd[f"{pre}.out.weight"]).t()
        else:
            emb = tokens.mean(dim=1)
        pre = f"classifiers.classifier_{_slug(name)}"
        for li in range(n_hidden + 1):
            emb = p.q(emb) @ p.q(sd[f"{pre}.{2 * li}.weight"]).t() + sd[f"{pre}.{2 * li}.bias"]
            if li < n_hidden:
                emb = torch.relu(emb)
        out[name] = emb
    return out
