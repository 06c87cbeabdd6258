"""What the benchmark needs to know of the PM family besides its reference:
the port's spec for a configuration and the FLOPs of a forward."""

from __future__ import annotations

from ..reference.pm import hparams, trunk_blocks
from .pmg import PORT


def port_spec(cfg: dict):
    """The port's ``models.pm.Spec`` for the configuration."""
    from importlib import import_module

    family = import_module(f"{PORT}.models").get_family("pm")
    return family.build_spec(cfg["tasks"], cfg["hparams"])


def forward_flops(cfg: dict, batch: int) -> float:
    """Multiply-adds of one forward, counted twice, over ``batch`` images:
    every 4 x 4 convolution of the trunk, and per task in the cheapest
    exact order (the port's): SE's two products (C x C/16 each), the
    attention logits and the attention-weighted pooling (HW x C each), and
    the pooled vector's class projection (C x K).  With the ablation flag
    a task is its mean's class projection.  Norms, activations, the SE
    mean and softmaxes are left out."""
    h, s, macs = hparams(cfg), cfg["img_size"], 0
    for cin, cout, stride, pad in trunk_blocks(cfg):
        s = (s + 2 * pad - 4) // stride + 1
        macs += s * s * cout * cin * 16
    c, n = cout, s * s
    ablate = bool(h["ablate_attention"])
    per_task = n * c if ablate else 2 * n * c
    if h["attn_use_se"] and not ablate:
        per_task += 2 * c * max(c // 16, 1)
    macs += len(cfg["tasks"]) * per_task + sum(len(v) for v in cfg["tasks"].values()) * c
    return 2.0 * macs * batch
