"""Plain PyTorch PM (the reference toolkit's ``MultiTaskPatchGAN``,
``Models/models_PM.py:79``), computed from the checkpoint's own keys in the
toolkit's order of operations.

The trunk is pix2pix's PatchGAN (arXiv:1611.07004): per planned block
``Conv2d(k4, s2, p1)`` (``trunk.<3i>``) -> the norm (``trunk.<3i+1>``:
affine ``InstanceNorm2d`` by default, eps 1e-5, arXiv:1607.08022; or an
eval-mode ``BatchNorm2d``) -> ``LeakyReLU(0.2)``, the filters doubling from
``ndf`` while the receptive-field counter stays above 4 and the filters at
most 512, then one ``k4 s1 p1`` block.  Per task (``TaskHeadImproved``,
``:27-76``): ``x = SE(feat)`` (``:11``: ``feat * sigmoid(mlp(mean_hw
feat))``, ``mlp`` = Linear(C, C/16), ReLU, Linear(C/16, C)), the attention
logits ``a = attn_conv(x)`` [B, 1, H, W], ``A = softmax(a / tau)`` over
H x W (or ``sigmoid(a)`` normalized to sum 1), the class map ``M =
cls_conv(x)`` [B, K, H, W], and ``logits = sum_hw(M * A) / (sum_hw(A) +
1e-6)``.  With ``ablate_attention`` A is uniform (1 / HW) and SE is
bypassed.

Departures from the toolkit's module: weights come as a state dict rather
than ``nn.Module`` parameters (so a plain function computes the forward),
and the norm kinds are the two the configurations use (instance, batch).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import Precision

DEFAULTS = {"ndf": 64, "norm": "instance", "patch_size": 70, "attn_tau": 0.7,
            "attn_use_se": True, "attn_softmax_spatial": True, "ablate_attention": False}
EPS = 1e-5


def hparams(cfg: dict) -> dict:
    """The configuration's hparams over the toolkit's defaults."""
    return {**DEFAULTS, **cfg["hparams"]}


def trunk_blocks(cfg: dict) -> List[Tuple[int, int, int, int]]:
    """(cin, cout, stride, pad) of each block, all with 4 x 4 kernels."""
    h = hparams(cfg)
    out, cin, nf, rf = [], 3, int(h["ndf"]), float(h["patch_size"])
    while rf > 4 and nf <= 512:
        out.append((cin, nf, 2, 1))
        cin, nf, rf = nf, nf * 2, rf / 2
    out.append((cin, nf, 1, 1))
    return out


def state_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the toolkit's state dict for ``cfg`` and its shape."""
    h = hparams(cfg)
    if h["norm"] not in ("instance", "batch"):
        raise ValueError(f"unknown norm {h['norm']!r}")
    out: Dict[str, Tuple[int, ...]] = {}
    for i, (cin, cout, _, _) in enumerate(trunk_blocks(cfg)):
        out[f"trunk.{3 * i}.weight"] = (cout, cin, 4, 4)
        out[f"trunk.{3 * i}.bias"] = (cout,)
        keys = ("weight", "bias") + (("running_mean", "running_var")
                                     if h["norm"] == "batch" else ())
        for k in keys:
            out[f"trunk.{3 * i + 1}.{k}"] = (cout,)
    c = cout
    hid = max(c // 16, 1)
    for name, classes in cfg["tasks"].items():
        pre = f"task_heads.{name}"
        if h["attn_use_se"]:
            out[f"{pre}.se.mlp.0.weight"] = (hid, c)
            out[f"{pre}.se.mlp.0.bias"] = (hid,)
            out[f"{pre}.se.mlp.2.weight"] = (c, hid)
            out[f"{pre}.se.mlp.2.bias"] = (c,)
        out[f"{pre}.attn_conv.weight"] = (1, c, 1, 1)
        out[f"{pre}.attn_conv.bias"] = (1,)
        out[f"{pre}.cls_conv.weight"] = (len(classes), c, 1, 1)
    return out


def features(sd: dict, x: torch.Tensor, cfg: dict, p: Precision = Precision()) -> torch.Tensor:
    """Normalized NCHW images -> the trunk's NCHW features."""
    norm = hparams(cfg)["norm"]
    for i, (_, _, stride, pad) in enumerate(trunk_blocks(cfg)):
        c, n = f"trunk.{3 * i}", f"trunk.{3 * i + 1}"
        x = F.conv2d(p.q(x), p.q(sd[f"{c}.weight"]), sd[f"{c}.bias"], stride, pad)
        if norm == "instance":
            x = F.instance_norm(x, weight=sd[f"{n}.weight"], bias=sd[f"{n}.bias"], eps=EPS)
        else:
            x = F.batch_norm(x, sd[f"{n}.running_mean"], sd[f"{n}.running_var"],
                             sd[f"{n}.weight"], sd[f"{n}.bias"], False, 0.1, EPS)
        x = F.leaky_relu(x, 0.2)
    return x


def _se(x: torch.Tensor, sd: dict, pre: str, p: Precision) -> torch.Tensor:
    s = x.mean(dim=(2, 3))
    s = torch.relu(F.linear(p.q(s), p.q(sd[f"{pre}.0.weight"]), sd[f"{pre}.0.bias"]))
    s = torch.sigmoid(F.linear(p.q(s), p.q(sd[f"{pre}.2.weight"]), sd[f"{pre}.2.bias"]))
    return x * s[:, :, None, None]


def forward(sd: dict, x: torch.Tensor, cfg: dict,
            p: Precision = Precision()) -> Dict[str, torch.Tensor]:
    """Normalized NCHW images -> {task: logits [B, K_task]}."""
    h = hparams(cfg)
    ablate = bool(h["ablate_attention"])
    f = features(sd, x, cfg, p)
    b, _, hh, ww = f.shape
    out = {}
    for name in cfg["tasks"]:
        pre = f"task_heads.{name}"
        xt = _se(f, sd, f"{pre}.se.mlp", p) if h["attn_use_se"] and not ablate else f
        if ablate:
            a = torch.full((b, 1, hh, ww), 1.0 / (hh * ww), device=f.device)
        else:
            logit = F.conv2d(p.q(xt), p.q(sd[f"{pre}.attn_conv.weight"]),
                             sd[f"{pre}.attn_conv.bias"])
            if h["attn_softmax_spatial"]:
                a = torch.softmax(logit.flatten(2) / float(h["attn_tau"]), dim=-1)
            else:
                a = torch.sigmoid(logit.flatten(2))
                a = a / (a.sum(dim=-1, keepdim=True) + 1e-6)
            a = a.view(b, 1, hh, ww)
        m = F.conv2d(p.q(xt), p.q(sd[f"{pre}.cls_conv.weight"]))  # [B, K, H, W]
        out[name] = (m * a).sum(dim=(2, 3)) / (a.sum(dim=(2, 3)) + 1e-6)
    return out
