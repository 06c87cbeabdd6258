"""Attention ops (eval mode): torch-compatible MHA, the pre-norm transformer
encoder, the stacked per-task pooling and heads of PMG, and RTM's per-task
query attention.

Per-task computations are stacked over a task axis T into one batched
product, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .nn import linear
from .norms import layer_norm


def multi_head_attention(
    x: torch.Tensor, p: Dict[str, torch.Tensor], num_heads: int
) -> torch.Tensor:
    """Self-attention matching ``torch.nn.MultiheadAttention`` (batch_first).

    x: [B, N, D]; wq/wk/wv/wo: [D, D] input-major, bq/bk/bv/bo: [D].
    q is scaled by 1/sqrt(head_dim) before the score product.
    """
    b, n, d = x.shape
    h = num_heads
    hd = d // h

    def split(y):  # [B, N, D] -> [B, h, N, hd]
        return y.reshape(b, n, h, hd).transpose(1, 2)

    q = split(torch.matmul(x, p["wq"]) + p["bq"])
    k = split(torch.matmul(x, p["wk"]) + p["bk"])
    v = split(torch.matmul(x, p["wv"]) + p["bv"])
    q = q * (1.0 / math.sqrt(hd))
    w = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k), dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", w, v)
    o = o.transpose(1, 2).reshape(b, n, d)
    return torch.matmul(o, p["wo"]) + p["bo"]


def transformer_encoder(
    x: torch.Tensor, layers: List[Dict], num_heads: int
) -> torch.Tensor:
    """Pre-norm transformer encoder stack, ReLU FFN, no final norm
    (``TransformerEncoderLayer(norm_first=True)`` in eval mode)."""
    for p in layers:
        x = x + multi_head_attention(layer_norm(x, p["norm1"]), p["attn"], num_heads)
        h = torch.relu(linear(layer_norm(x, p["norm2"]), p["ffn1"]))
        x = x + linear(h, p["ffn2"])
    return x


def task_query_pool(tokens: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """PMG task-conditioned pooling, stacked over tasks.

    tokens: [B, N, D]; queries: [T, D].  scores_t = <tokens, q_t> softmaxed
    over N (no 1/sqrt(d) scaling); pooled_t = sum_n w_n token_n -> [B, T, D].
    """
    w = torch.softmax(torch.einsum("bnd,td->btn", tokens, queries), dim=-1)
    return torch.einsum("btn,bnd->btd", w, tokens)


def rtm_task_attention(tokens: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """RTM per-task query attention over spatial tokens, stacked over tasks.

    tokens: [B, N, C]; ``proj_w`` [T, C, d], ``q`` [T, d], ``out_w`` [T, d, C].
    Per task: Tp = tokens @ proj; attn = softmax(q.Tp^T / sqrt(d));
    out = (attn @ Tp) @ out_w.  Computed in the JAX package's reassociated
    order: ``pq = proj_w @ q`` first, then the scores and the pooling in
    C-space, then ``proj_w``, then ``out_w``.  Returns [B, T, C].
    """
    d = p["q"].shape[-1]
    pq = torch.einsum("tcd,td->tc", p["proj_w"], p["q"])
    w = torch.softmax(torch.einsum("bnc,tc->btn", tokens, pq) * (1.0 / math.sqrt(d)), dim=-1)
    pooled = torch.einsum("btn,bnc->btc", w, tokens)
    h = torch.einsum("btc,tcd->btd", pooled, p["proj_w"])
    return torch.einsum("btd,tdc->btc", h, p["out_w"])


def stacked_task_heads(pooled: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-task linear classifiers as one batched product.

    pooled: [B, T, D]; p: {"w": [T, D, Kmax], "b": [T, Kmax]}, columns beyond
    a task's class count zero-padded -> [B, T, Kmax].
    """
    return torch.einsum("btd,tdk->btk", pooled, p["w"]) + p["b"]
