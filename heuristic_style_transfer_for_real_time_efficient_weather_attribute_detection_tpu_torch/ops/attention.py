"""Attention ops: torch-compatible MHA, the pre-norm transformer encoder
(with train-mode dropout), the stacked per-task pooling and heads of PMG,
and RTM's per-task query attention.

Per-task computations are stacked over a task axis T into one batched
product, as in the JAX package.

bf16 activations and weights follow the JAX package's types: every product
sums in float32 (``ops.nn.matmul_f32``; einsums on upcast operands), a
float32 operand meeting a bf16 one promotes it, and only the attention
output, the FFN's ``linear`` layers, the pooled tokens and the task
embeddings are rounded back to the activations' type.  For float32 inputs
the upcasts are no-ops.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .nn import linear, matmul_f32
from .norms import layer_norm


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shard=None) -> torch.Tensor:
    """Inverted dropout (torch semantics: kept units scaled by 1/keep), the
    mask drawn from ``generator`` on x's device.  Identity when there is no
    generator or the rate is 0 (eval mode).  With a ``shard``
    (``parallel.mesh.RowShard``: x holds rows of a global batch) the mask is
    drawn for the global batch and x takes its own rows of it, so a sharded
    step drops what the unsharded step drops."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if shard is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        u = shard.rows(torch.rand((shard.total,) + tuple(x.shape[1:]), generator=generator,
                                  device=x.device), x.shape[0])
    m = u < keep
    return torch.where(m, x / keep, 0.0).to(x.dtype)


def multi_head_attention(
    x: torch.Tensor, p: Dict[str, torch.Tensor], num_heads: int, dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None, shard=None,
) -> torch.Tensor:
    """Self-attention matching ``torch.nn.MultiheadAttention`` (batch_first).

    x: [B, N, D]; wq/wk/wv/wo: [D, D] input-major, bq/bk/bv/bo: [D].
    q is scaled by 1/sqrt(head_dim) before the score product.
    ``dropout_rate``/``generator``: dropout on the attention probabilities
    (train mode; ``shard``: see :func:`dropout`).
    """
    b, n, d = x.shape
    h = num_heads
    hd = d // h

    def split(y):  # [B, N, D] -> [B, h, N, hd]
        return y.reshape(b, n, h, hd).transpose(1, 2)

    q = split(matmul_f32(x, p["wq"]) + p["bq"].float())
    k = split(matmul_f32(x, p["wk"]) + p["bk"].float())
    v = split(matmul_f32(x, p["wv"]) + p["bv"].float())
    q = q * (1.0 / math.sqrt(hd))
    w = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k), dim=-1)
    w = dropout(w, dropout_rate, generator, shard)
    o = torch.einsum("bhqk,bhkd->bhqd", w, v)
    o = o.transpose(1, 2).reshape(b, n, d)
    return (torch.matmul(o, p["wo"].float()) + p["bo"].float()).to(x.dtype)


def transformer_encoder(
    x: torch.Tensor, layers: List[Dict], num_heads: int, dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None, shard=None,
) -> torch.Tensor:
    """Pre-norm transformer encoder stack, ReLU FFN, no final norm
    (``TransformerEncoderLayer(norm_first=True)``).  With a generator and a
    rate above 0, train mode's four dropout sites per layer (attention
    probabilities, attention output, FFN inner, FFN output), drawn in that
    order (for the global batch with a ``shard``); without, eval mode."""
    for p in layers:
        a = multi_head_attention(layer_norm(x, p["norm1"]), p["attn"], num_heads, dropout_rate,
                                 generator, shard)
        x = x + dropout(a, dropout_rate, generator, shard)
        h = dropout(torch.relu(linear(layer_norm(x, p["norm2"]), p["ffn1"])), dropout_rate,
                    generator, shard)
        x = x + dropout(linear(h, p["ffn2"]), dropout_rate, generator, shard)
    return x


def task_query_pool(tokens: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """PMG task-conditioned pooling, stacked over tasks.

    tokens: [B, N, D]; queries: [T, D].  scores_t = <tokens, q_t> softmaxed
    over N (no 1/sqrt(d) scaling); pooled_t = sum_n w_n token_n -> [B, T, D].
    """
    t32 = tokens.float()
    w = torch.softmax(torch.einsum("bnd,td->btn", t32, queries.float()), dim=-1)
    return torch.einsum("btn,bnd->btd", w, t32).to(tokens.dtype)


def rtm_task_attention(tokens: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """RTM per-task query attention over spatial tokens, stacked over tasks.

    tokens: [B, N, C]; ``proj_w`` [T, C, d], ``q`` [T, d], ``out_w`` [T, d, C].
    Per task: Tp = tokens @ proj; attn = softmax(q.Tp^T / sqrt(d));
    out = (attn @ Tp) @ out_w.  Computed in the JAX package's reassociated
    order: ``pq = proj_w @ q`` first, then the scores and the pooling in
    C-space, then ``proj_w``, then ``out_w``.  Returns [B, T, C].
    """
    d = p["q"].shape[-1]
    t32, proj_w = tokens.float(), p["proj_w"].float()
    pq = torch.einsum("tcd,td->tc", proj_w, p["q"].float())
    w = torch.softmax(torch.einsum("bnc,tc->btn", t32, pq) * (1.0 / math.sqrt(d)), dim=-1)
    pooled = torch.einsum("btn,bnc->btc", w, t32)
    h = torch.einsum("btc,tcd->btd", pooled, proj_w)
    return torch.einsum("btd,tdc->btc", h, p["out_w"].float()).to(tokens.dtype)


def stacked_task_heads(pooled: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-task linear classifiers as one batched product.

    pooled: [B, T, D]; p: {"w": [T, D, Kmax], "b": [T, Kmax]}, columns beyond
    a task's class count zero-padded -> float32 [B, T, Kmax].
    """
    return torch.einsum("btd,tdk->btk", pooled.float(), p["w"].float()) + p["b"].float()
