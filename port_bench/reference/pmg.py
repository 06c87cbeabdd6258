"""Plain PyTorch PMG (the reference toolkit's
``MultiTaskPatchGANGramModelNonOverlapV2``, ``Models/models_PMG.py:77``),
computed from the checkpoint's own keys.

Non-overlapping conv trunk (Conv k=s, no bias -> norm -> LeakyReLU 0.2, the
last block 1x1) -> optional SE -> 1x1 ``chan_proj`` -> replicate-pad the
bottom and right to a multiple of ``patch_div`` -> ``patch_div**2`` patches,
row-major -> per-patch Gram ``F F^T / N`` flattened row-major -> ``token_proj``
-> pre-norm transformer encoder (ReLU FFN, no final norm) -> per-task
query pooling (softmax over tokens, unscaled) -> per-task Linear heads.
NCHW throughout, as the toolkit runs it.  In train mode every batch norm
uses the batch's statistics and moves its running statistics in place
(momentum 0.1, unbiased variance), as ``nn.BatchNorm2d`` does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import Precision

EPS = 1e-5


def trunk_blocks(cfg: dict) -> List[Tuple[int, int, int]]:
    """(cin, cout, kernel) of each trunk block: doubling from ``ndf`` while
    the receptive-field counter (``patch_size`` divided by 4 a block) stays
    above 4 and the width at most 512, then one 1x1 block."""
    h = cfg["hparams"]
    blocks, cin, nf, rf = [], 3, h["ndf"], float(h["patch_size"])
    while rf > 4 and nf <= 512:
        blocks.append((cin, nf, 4))
        cin, nf, rf = nf, nf * 2, rf / 4
    blocks.append((cin, nf, 1))
    return blocks


def state_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the toolkit's state dict for ``cfg`` and its shape."""
    h, tasks = cfg["hparams"], cfg["tasks"]
    out: Dict[str, Tuple[int, ...]] = {}
    blocks = trunk_blocks(cfg)
    for i, (cin, cout, k) in enumerate(blocks):
        out[f"feature_extractor.{3 * i}.weight"] = (cout, cin, k, k)
        out[f"feature_extractor.{3 * i + 1}.weight"] = (cout,)
        out[f"feature_extractor.{3 * i + 1}.bias"] = (cout,)
        if h["norm"] == "batch":
            out[f"feature_extractor.{3 * i + 1}.running_mean"] = (cout,)
            out[f"feature_extractor.{3 * i + 1}.running_var"] = (cout,)
    c, g, d = blocks[-1][1], h["gram_channels"], h["d_model"]
    if h["use_channel_attention"]:
        out["se.fc.0.weight"] = (max(1, c // 16), c)
        out["se.fc.2.weight"] = (c, max(1, c // 16))
    out["chan_proj.weight"] = (g, c, 1, 1)
    out["token_proj.weight"] = (d, g * g)
    out["token_proj.bias"] = (d,)
    layers = h["transformer_layers"] if h["use_token_attention"] else 0
    for li in range(layers):
        pre = f"transformer.encoder.layers.{li}"
        out[f"{pre}.self_attn.in_proj_weight"] = (3 * d, d)
        out[f"{pre}.self_attn.in_proj_bias"] = (3 * d,)
        out[f"{pre}.self_attn.out_proj.weight"] = (d, d)
        out[f"{pre}.self_attn.out_proj.bias"] = (d,)
        for n in ("norm1", "norm2"):
            out[f"{pre}.{n}.weight"] = (d,)
            out[f"{pre}.{n}.bias"] = (d,)
        out[f"{pre}.linear1.weight"] = (2 * d, d)
        out[f"{pre}.linear1.bias"] = (2 * d,)
        out[f"{pre}.linear2.weight"] = (d, 2 * d)
        out[f"{pre}.linear2.bias"] = (d,)
    for name, classes in tasks.items():
        out[f"task_pool.query.{name}"] = (d,)
        out[f"classifiers.{name}.weight"] = (len(classes), d)
        out[f"classifiers.{name}.bias"] = (len(classes),)
    return out


def _norm(x: torch.Tensor, sd: dict, pre: str, kind: str, train: bool) -> torch.Tensor:
    if kind == "batch":
        return F.batch_norm(x, sd[f"{pre}.running_mean"], sd[f"{pre}.running_var"],
                            sd[f"{pre}.weight"], sd[f"{pre}.bias"], train, 0.1, EPS)
    if kind == "instance":
        return F.instance_norm(x, weight=sd[f"{pre}.weight"], bias=sd[f"{pre}.bias"], eps=EPS)
    raise ValueError(f"the reference PMG has no {kind!r} norm")


def _lin(x: torch.Tensor, w: torch.Tensor, b, p: Precision) -> torch.Tensor:
    y = p.q(x) @ p.q(w).t()
    return y if b is None else y + b


def _mha(x: torch.Tensor, sd: dict, pre: str, heads: int, p: Precision) -> torch.Tensor:
    b, n, d = x.shape
    hd = d // heads
    w, bias = sd[f"{pre}.in_proj_weight"], sd[f"{pre}.in_proj_bias"]
    q, k, v = (_lin(x, w[i * d:(i + 1) * d], bias[i * d:(i + 1) * d], p)
               .reshape(b, n, heads, hd).transpose(1, 2) for i in range(3))
    a = torch.softmax((q / math.sqrt(hd)) @ k.transpose(-1, -2), dim=-1) @ v
    a = a.transpose(1, 2).reshape(b, n, d)
    return _lin(a, sd[f"{pre}.out_proj.weight"], sd[f"{pre}.out_proj.bias"], p)


def forward(sd: dict, x: torch.Tensor, cfg: dict, p: Precision = Precision(),
            train: bool = False) -> Dict[str, torch.Tensor]:
    """Normalized NCHW images -> {task: logits [B, K_task]}."""
    h = cfg["hparams"]
    for i, (_, _, k) in enumerate(trunk_blocks(cfg)):
        x = F.conv2d(p.q(x), p.q(sd[f"feature_extractor.{3 * i}.weight"]), stride=k)
        x = F.leaky_relu(_norm(x, sd, f"feature_extractor.{3 * i + 1}", h["norm"], train), 0.2)
    if h["use_channel_attention"]:
        s = x.mean(dim=(2, 3))
        s = torch.sigmoid(_lin(torch.relu(_lin(s, sd["se.fc.0.weight"], None, p)),
                               sd["se.fc.2.weight"], None, p))
        x = x * s[:, :, None, None]
    z = F.conv2d(p.q(x), p.q(sd["chan_proj.weight"]))
    div = h["patch_div"]
    b, c, hh, ww = z.shape
    z = F.pad(z, (0, (-ww) % div, 0, (-hh) % div), mode="replicate")
    ph, pw = z.shape[2] // div, z.shape[3] // div
    patches = (z.reshape(b, c, div, ph, div, pw).permute(0, 2, 4, 1, 3, 5)
               .reshape(b, div * div, c, ph * pw))
    patches = p.q(patches)
    tokens = (patches @ patches.transpose(-1, -2) / (ph * pw)).reshape(b, div * div, c * c)
    tokens = _lin(tokens, sd["token_proj.weight"], sd["token_proj.bias"], p)
    layers = h["transformer_layers"] if h["use_token_attention"] else 0
    for li in range(layers):
        pre = f"transformer.encoder.layers.{li}"
        y = F.layer_norm(tokens, (tokens.shape[-1],), sd[f"{pre}.norm1.weight"],
                         sd[f"{pre}.norm1.bias"], EPS)
        tokens = tokens + _mha(y, sd, f"{pre}.self_attn", h["transformer_heads"], p)
        y = F.layer_norm(tokens, (tokens.shape[-1],), sd[f"{pre}.norm2.weight"],
                         sd[f"{pre}.norm2.bias"], EPS)
        y = torch.relu(_lin(y, sd[f"{pre}.linear1.weight"], sd[f"{pre}.linear1.bias"], p))
        tokens = tokens + _lin(y, sd[f"{pre}.linear2.weight"], sd[f"{pre}.linear2.bias"], p)
    out = {}
    for name in cfg["tasks"]:
        w = torch.softmax(tokens @ sd[f"task_pool.query.{name}"], dim=-1)
        pooled = (w[:, :, None] * tokens).sum(dim=1)
        pre = f"classifiers.{name}"
        out[name] = _lin(pooled, sd[f"{pre}.weight"], sd[f"{pre}.bias"], p)
    return out
