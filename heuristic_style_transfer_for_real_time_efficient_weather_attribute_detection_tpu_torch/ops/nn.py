"""Basic functional NN ops: conv, linear, leaky ReLU, SE channel attention,
torch's default initializers, and the bf16 cast of a param tree.

Layout at the boundary is the JAX package's: NHWC activations, HWIO conv
kernels, ``[in, out]`` linear weights.

bf16 follows the JAX package's rule (its ``preferred_element_type``): a
product of bf16 operands sums in float32, the bias is added in float32,
and the result is rounded once to bf16.  On the CPU the operands are
upcast first (the product of two bf16 values is exact in float32); on the
card cuBLAS and cuDNN take them as they are and sum in float32.  A bf16
``linear`` is one cuBLAS call, which adds the bias in float32 before its
one rounding, where cuBLAS may not reduce split-K sums in bf16
(``config.enable_parity_precision``); otherwise it takes a float32 result
and adds and rounds after.  cuDNN rounds a convolution before the bias
add (a second rounding).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from .preprocess import s2d_pack


def _uniform(g: torch.Generator, shape: Sequence[int], bound: float) -> torch.Tensor:
    return (torch.rand(tuple(shape), generator=g, dtype=torch.float32) * 2.0 - 1.0) * bound


def init_conv(
    g: torch.Generator, kh: int, kw: int, cin: int, cout: int, bias: bool = False
) -> Dict[str, torch.Tensor]:
    """HWIO conv params with torch's default init: kaiming-uniform with
    a = sqrt(5), i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in)), and the bias
    from the same range."""
    bound = 1.0 / math.sqrt(cin * kh * kw)
    p = {"w": _uniform(g, (kh, kw, cin, cout), bound)}
    if bias:
        p["b"] = _uniform(g, (cout,), bound)
    return p


def init_linear(g: torch.Generator, cin: int, cout: int, bias: bool = True) -> Dict[str, torch.Tensor]:
    """``[in, out]`` linear params with torch's default init."""
    bound = 1.0 / math.sqrt(cin)
    p = {"w": _uniform(g, (cin, cout), bound)}
    if bias:
        p["b"] = _uniform(g, (cout,), bound)
    return p


def init_se(g: torch.Generator, c: int) -> Dict[str, Dict]:
    """Bias-free Squeeze-and-Excitation params (PMG's): ``fc1`` [c, c/16]
    and ``fc2`` [c/16, c]."""
    hid = max(1, c // 16)
    return {"fc1": init_linear(g, c, hid, bias=False), "fc2": init_linear(g, hid, c, bias=False)}


def init_batch_norm(c: int) -> Dict[str, torch.Tensor]:
    """Identity affine, zero mean and unit variance."""
    return {"scale": torch.ones(c), "bias": torch.zeros(c), "mean": torch.zeros(c),
            "var": torch.ones(c)}


def init_norm(c: int, kind: str) -> Dict[str, torch.Tensor]:
    """Identity affine; batch norm adds zero mean and unit variance."""
    if kind == "batch":
        return init_batch_norm(c)
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


class _MatmulBf16F32(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=torch.float32)`` on bf16 operands, which
    has no derivative formula of its own: the backward products sum in
    float32 (float32 operands) and round once to the operands' type."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        da = torch.mm(dy, b.float().t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = torch.mm(a.float().t(), dy).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` [..., K] x [K, N], or batched [N, M, K] x [N, K, P], summed
    in float32 with a float32 result, whatever the operands' float types
    (JAX's ``preferred_element_type``).  bf16 operands on a CUDA card go to
    cuBLAS as they are, with a float32 output (a 2-D b under autograd
    through :class:`_MatmulBf16F32`); elsewhere they are upcast, which is
    exact."""
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16 and b.ndim == 3 and not grad:
        return torch.bmm(a, b, out_dtype=torch.float32)
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16 and b.ndim == 2:
        a2 = a.reshape(-1, a.shape[-1])
        if grad:
            y = _MatmulBf16F32.apply(a2, b)
        else:
            y = torch.mm(a2, b, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def conv2d_nchw(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int, padding: int
) -> torch.Tensor:
    """``F.conv2d`` on NCHW x OIHW with the bf16 rule.  On the card cuDNN
    sums in float32 and rounds to bf16 itself, and the bias (bf16, as in
    the run copy) is added to that rounded sum and rounded again."""
    if x.dtype != torch.bfloat16 or x.is_cuda:
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    y = F.conv2d(x.float(), w.float(), stride=stride, padding=padding)
    return (y if b is None else y + b.float()[:, None, None]).to(x.dtype)


def conv2d(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    stride: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC, symmetric integer padding.

    A non-overlapping convolution (kernel == stride, pad 0; a 1x1 conv is
    the k = 1 case) is a space-to-depth reshape and one matmul over the
    packed channels, in NHWC as it stands; others go to ``F.conv2d``.
    """
    kh, kw, cin, cout = p["w"].shape
    if kh == kw == stride and padding == 0:
        return linear(s2d_pack(x, kh), {"w": p["w"].reshape(kh * kw * cin, cout), "b": p.get("b")})
    y = conv2d_nchw(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1), p.get("b"),
                    stride, padding)
    return y.permute(0, 2, 3, 1)


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x: [..., in] @ w[in, out] + b[out]; bf16 x: the bf16 rule."""
    w, b = p["w"], p.get("b")
    if x.dtype == torch.bfloat16:
        if (x.is_cuda and w.dtype == x.dtype and (b is None or b.dtype == x.dtype)
                and not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction):
            # one cuBLAS call: float32 sums, the bias added in float32, one rounding
            if b is None:
                return torch.matmul(x, w)
            y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        y = matmul_f32(x, w)
        return (y if b is None else y + b.float()).to(x.dtype)
    y = torch.matmul(x, w)
    return y if b is None else y + b


def cast_tree(tree: Any, dtype: Optional[torch.dtype]) -> Any:
    """A param tree with every floating leaf cast to ``dtype`` (batch-norm
    running statistics and queries included), the others (int8) as they
    are; ``None`` returns the tree unchanged.  float32 on a tree with bf16
    leaves is what JAX's dtype promotion does to a float32 activation
    meeting a bf16 weight (exact)."""
    if dtype is None:
        return tree
    if isinstance(tree, Mapping):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope)


def se_block(x: torch.Tensor, p: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Squeeze-and-Excitation channel attention, NHWC:
    ``x * sigmoid(fc2(relu(fc1(mean_hw(x)))))``."""
    s = x.mean(dim=(1, 2))
    s = torch.relu(linear(s, p["fc1"]))
    s = torch.sigmoid(linear(s, p["fc2"]))
    return x * s[:, None, None, :]
