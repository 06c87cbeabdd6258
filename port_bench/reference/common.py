"""Plain PyTorch pieces shared by the references: the input transform, the
precision of a run, the masked multi-task loss and AdamW.

The references import nothing of the program.  They compute in float32 with
TF32 off; ``Precision`` also gives the lower precisions that the controls
use (TF32 for a float32 configuration, per-tensor scaled fp8 for a bf16 one).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
IGNORE = -100
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def normalize(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC frames -> float32 NCHW, ``(x / 255 - mean) / std``: the
    reference toolkit's ToTensor and Normalize."""
    x = x_u8.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn under one scale for the whole tensor
    (its largest magnitude maps to 448), back in float32."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Precision:
    """How the reference computes: ``"float32"`` (TF32 off), ``"tf32"``
    (float32 with TF32 on in cuBLAS and cuDNN) or ``"fp8"`` (every operand
    of a convolution or a matrix product rounded to per-tensor scaled fp8,
    the sums in float32).  ``q`` applies the operand rounding."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8(t) if self.name == "fp8" else t

    @contextlib.contextmanager
    def flags(self):
        """TF32 on for ``"tf32"``, off otherwise, restored afterwards."""
        keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def masked_loss(logits: Dict[str, torch.Tensor], labels: torch.Tensor,
                tasks: List[str]) -> torch.Tensor:
    """Mean over the tasks that have a label in the batch of each task's
    mean cross entropy over its labelled images (label != -100)."""
    losses = []
    for i, name in enumerate(tasks):
        y = labels[:, i]
        valid = y != IGNORE
        if bool(valid.any()):
            losses.append(torch.nn.functional.cross_entropy(logits[name][valid], y[valid].long()))
    return torch.stack(losses).mean()


def probs(logits: Dict[str, torch.Tensor], tasks: List[str], kmax: int) -> torch.Tensor:
    """[B, T, kmax] float32: each task's softmax, zero past its classes."""
    b = logits[tasks[0]].shape[0]
    out = torch.zeros((b, len(tasks), kmax), device=logits[tasks[0]].device)
    for i, name in enumerate(tasks):
        k = logits[name].shape[1]
        out[:, i, :k] = torch.softmax(logits[name].float(), dim=-1)
    return out


class AdamW:
    """AdamW as the recipe states it (optax's ``adamw``): betas (0.9,
    0.999), eps 1e-8 added to the bias-corrected root, decoupled weight
    decay on every trained tensor."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 3e-4,
                 weight_decay: float = 1e-4, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            update = (m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr * update)
            p.grad = None


def leaf_norm(parts: List[torch.Tensor]) -> float:
    """The 2-norm of the elements of ``parts`` together, in float64."""
    return math.sqrt(sum(float(t.double().square().sum()) for t in parts))
