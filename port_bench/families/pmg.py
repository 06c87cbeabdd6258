"""What the benchmark needs to know of the PMG family besides its reference:
the port's spec for a configuration, the FLOPs of a forward, K1's least
time at the cell's shapes, and which reference tensors make up each leaf of
the port's param tree (for the train step's per-leaf comparison)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..reference.pmg import trunk_blocks
from ..yardstick import bound_s

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"


def port_spec(cfg: dict):
    """The port's ``models.pmg.Spec`` for the configuration."""
    from importlib import import_module

    family = import_module(f"{PORT}.models").get_family("pmg")
    return family.build_spec(cfg["tasks"], cfg["hparams"])


def _feature_side(cfg: dict) -> int:
    s = cfg["img_size"]
    for _, _, k in trunk_blocks(cfg):
        s //= k
    return s


def forward_flops(cfg: dict, batch: int) -> float:
    """Multiply-adds of one forward, counted twice, over ``batch`` images:
    the trunk's convolutions, SE, ``chan_proj``, the Grams (each patch's
    whole C x C product over its padded area), ``token_proj``, the
    transformer's products, the task pooling and the heads.  Norms,
    activations and softmaxes are left out."""
    h = cfg["hparams"]
    macs, s = 0, cfg["img_size"]
    for cin, cout, k in trunk_blocks(cfg):
        s //= k
        macs += s * s * cout * cin * k * k
    c, g, d, div = trunk_blocks(cfg)[-1][1], h["gram_channels"], h["d_model"], h["patch_div"]
    if h["use_channel_attention"]:
        macs += 2 * c * max(1, c // 16)
    macs += s * s * g * c
    n, area = div * div, math.ceil(s / div) ** 2
    macs += n * area * g * g + n * g * g * d
    if h["use_token_attention"]:
        macs += h["transformer_layers"] * (8 * n * d * d + 2 * n * n * d)
    macs += len(cfg["tasks"]) * 2 * n * d + sum(len(v) for v in cfg["tasks"].values()) * d
    return 2.0 * macs * batch


def patch_gram_bound(cfg: dict, batch: int, dtype: str) -> float:
    """K1's least time in seconds for one launch at the cell's shapes: its
    input [B, S, S, gram_channels] read once and its Gram tokens written
    once, against its multiply-adds (each patch's C x C product over the
    padded area, and one scaling a token value); the arithmetic of
    ``chip_smoke.bound_ms``."""
    h = cfg["hparams"]
    s, g, div = _feature_side(cfg), h["gram_channels"], h["patch_div"]
    es = 2 if dtype == "bfloat16" else 4
    out = batch * div * div * g * g
    flops = 2.0 * batch * div * div * math.ceil(s / div) ** 2 * g * g + out
    return bound_s(es * (batch * s * s * g + out), flops, dtype)


Parts = List[Tuple[str, Optional[Tuple[int, int]]]]


def leaf_map(cfg: dict) -> Dict[str, Parts]:
    """Port leaf path -> the reference tensors (key, optional row range)
    whose elements it holds: the trunk and norms one to one, the packed
    attention projection split into q, k, v, and the per-task queries and
    heads stacked."""
    h, tasks = cfg["hparams"], list(cfg["tasks"])
    out: Dict[str, Parts] = {}
    norm = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    for i in range(len(trunk_blocks(cfg))):
        out[f"trunk/{i}/conv/w"] = [(f"feature_extractor.{3 * i}.weight", None)]
        for mine, theirs in norm.items():
            if mine in ("mean", "var") and h["norm"] != "batch":
                continue
            out[f"trunk/{i}/norm/{mine}"] = [(f"feature_extractor.{3 * i + 1}.{theirs}", None)]
    if h["use_channel_attention"]:
        out["se/fc1/w"] = [("se.fc.0.weight", None)]
        out["se/fc2/w"] = [("se.fc.2.weight", None)]
    out["chan_proj/w"] = [("chan_proj.weight", None)]
    out["token_proj/w"] = [("token_proj.weight", None)]
    out["token_proj/b"] = [("token_proj.bias", None)]
    d = h["d_model"]
    for li in range(h["transformer_layers"] if h["use_token_attention"] else 0):
        pre, mine = f"transformer.encoder.layers.{li}", f"transformer/{li}"
        for j, n in enumerate("qkv"):
            out[f"{mine}/attn/w{n}"] = [(f"{pre}.self_attn.in_proj_weight", (j * d, (j + 1) * d))]
            out[f"{mine}/attn/b{n}"] = [(f"{pre}.self_attn.in_proj_bias", (j * d, (j + 1) * d))]
        out[f"{mine}/attn/wo"] = [(f"{pre}.self_attn.out_proj.weight", None)]
        out[f"{mine}/attn/bo"] = [(f"{pre}.self_attn.out_proj.bias", None)]
        for n in ("norm1", "norm2"):
            out[f"{mine}/{n}/scale"] = [(f"{pre}.{n}.weight", None)]
            out[f"{mine}/{n}/bias"] = [(f"{pre}.{n}.bias", None)]
        for n, theirs in (("ffn1", "linear1"), ("ffn2", "linear2")):
            out[f"{mine}/{n}/w"] = [(f"{pre}.{theirs}.weight", None)]
            out[f"{mine}/{n}/b"] = [(f"{pre}.{theirs}.bias", None)]
    out["queries"] = [(f"task_pool.query.{t}", None) for t in tasks]
    out["heads/w"] = [(f"classifiers.{t}.weight", None) for t in tasks]
    out["heads/b"] = [(f"classifiers.{t}.bias", None) for t in tasks]
    return out
