"""RTM, the "ResNet-Truncated-Multitask" model.

Truncated ResNet-50 (first ``truncate_after_layer`` children) -> spatial
tokens [B, HW, C] -> per-task query-attention head -> per-task MLP
classifier; the ablation (``use_attention=False``) classifies the GAP
embedding.  Per-task heads and classifiers are stacked over a task axis and
zero-padded to Kmax, as in the JAX package, whose param tree this module
shares leaf for leaf (``engine.checkpoint.params_from_jax``).

Headline configuration: ``build_spec(tasks, {})`` on the 12-task registry,
i.e. the whole trunk through ``layer4`` (C = 2048, 7x7 tokens at 224 px),
attention with d = C, no hidden MLP layers.

``apply`` runs a bf16 param tree in bf16 as the JAX package does: the
trunk and the task embeddings in bf16, the MLPs' products summed in
float32 and the logits float32.  ``fold_stream_weights(dtype=bf16)`` gives
the camera path's bf16 fold, on which ``apply_stream`` runs the same way.

The camera path runs :func:`apply_stream` on a :func:`fold_stream_weights`
tree.  With ``quantize_fold=True`` the fold's [T, C, C] product and any
``mlp_q8`` layers go through the ``dequant_matvec`` kernel
(``ops/cuda_kernels.py``) on the card, its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import TaskSpec
from ..ops import cuda_kernels
from ..ops.attention import rtm_task_attention
from ..ops.nn import cast_tree, conv2d_nchw, init_linear, matmul_f32
from . import resnet

DEFAULTS = dict(
    truncate_layer=10,  # clamps to all 8 children
    use_attention=True,
    attn_token_dim=None,
    cls_hidden_dims=(),
    cls_num_layers=0,
)


@dataclasses.dataclass(frozen=True)
class Spec:
    tasks: TaskSpec
    truncate_after_layer: int = 10
    use_attention: bool = True
    attn_token_dim: Optional[int] = None
    cls_hidden_dims: Tuple[int, ...] = ()
    cls_num_layers: int = 0

    @property
    def num_features(self) -> int:
        return resnet.stage_out_channels(self.truncate_after_layer)

    @property
    def token_dim(self) -> int:
        return self.attn_token_dim or self.num_features

    @property
    def mlp_dims(self) -> Tuple[int, ...]:
        # C -> hidden_dims[:cls_num_layers] -> n_cls
        return (self.num_features,) + tuple(self.cls_hidden_dims[: self.cls_num_layers])


def build_spec(tasks: Mapping[str, Any], hparams: Dict[str, Any]) -> Spec:
    """hparams dict (+ reference defaults) -> Spec."""
    h = {**DEFAULTS, **{k: v for k, v in (hparams or {}).items() if k in DEFAULTS}}
    return Spec(
        tasks=TaskSpec.from_tasks(tasks),
        truncate_after_layer=int(h["truncate_layer"]),
        use_attention=bool(h["use_attention"]),
        attn_token_dim=None if h["attn_token_dim"] is None else int(h["attn_token_dim"]),
        cls_hidden_dims=tuple(int(d) for d in (h["cls_hidden_dims"] or ())),
        cls_num_layers=int(h["cls_num_layers"]),
    )


def init(g: torch.Generator, spec: Spec) -> Dict[str, Any]:
    """Random params (CPU float32) with torch's default init, drawn from the
    generator ``g``; the query vectors are standard normal."""
    t = spec.tasks
    nt, kmax = len(t), t.max_classes
    c, d = spec.num_features, spec.token_dim
    params: Dict[str, Any] = {"backbone": resnet.init(g)}
    if spec.use_attention:
        proj_w, out_w, qs = [], [], []
        for _ in range(nt):
            proj_w.append(init_linear(g, c, d, bias=False)["w"])
            out_w.append(init_linear(g, d, c, bias=False)["w"])
            qs.append(torch.randn(d, generator=g))
        params["attn"] = {"proj_w": torch.stack(proj_w), "q": torch.stack(qs),
                          "out_w": torch.stack(out_w)}
    dims = spec.mlp_dims
    mlp: List[Dict[str, torch.Tensor]] = []
    for li in range(len(dims) - 1):
        layers = [init_linear(g, dims[li], dims[li + 1]) for _ in range(nt)]
        mlp.append({"w": torch.stack([p["w"] for p in layers]),
                    "b": torch.stack([p["b"] for p in layers])})
    fw = torch.zeros((nt, dims[-1], kmax))
    fb = torch.zeros((nt, kmax))
    for i in range(nt):
        p = init_linear(g, dims[-1], t.num_classes[i])
        fw[i, :, : t.num_classes[i]] = p["w"]
        fb[i, : t.num_classes[i]] = p["b"]
    params["mlp"] = mlp
    params["final"] = {"w": fw, "b": fb}
    return params


def _classify(params: Dict[str, Any], h: torch.Tensor) -> torch.Tensor:
    """Stacked per-task MLP. h: [B, T, C] -> logits [B, T, Kmax].

    Takes ``mlp`` layers (float32 or bf16: the products of bf16 weights are
    exact in float32 and summed there) or the camera fold's weight-only int8
    ``mlp_q8`` layers, whose product is the ``dequant_matvec`` kernel on the
    card (its plain version on the CPU) with h cast to the scales' type,
    then the bias in float32 and the ReLU."""
    if "mlp_q8" in params:
        for lp in params["mlp_q8"]:
            x = h.to(lp["scale"].dtype).contiguous()
            h = torch.relu(cuda_kernels.dequant_matvec(x, lp["w8"], lp["scale"]) + lp["b"].float())
    else:
        for lp in params["mlp"]:
            h = torch.relu(torch.einsum("btc,tcd->btd", h.float(), lp["w"].float())
                           + lp["b"].float())
    final = params["final"]
    return torch.einsum("btc,tck->btk", h.float(), final["w"].float()) + final["b"].float()


def head_apply(
    params: Dict[str, Any],
    feats: torch.Tensor,
    spec: Spec,
    capture: Sequence[str] = (),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Attention heads + MLPs from NHWC backbone features (Grad-CAM entry)."""
    b, h, w, c = feats.shape
    aux: Dict[str, torch.Tensor] = {}
    if spec.use_attention:
        emb = rtm_task_attention(feats.reshape(b, h * w, c), params["attn"])
    else:
        # the params' tasks: a task-sharded tree's own
        emb = feats.mean(dim=(1, 2))[:, None, :].expand(b, params["final"]["w"].shape[0], c)
    if "task_embeddings" in capture:
        aux["task_embeddings"] = emb
    return _classify(params, emb), aux


def pack_stem_weights(w7: torch.Tensor) -> torch.Tensor:
    """ResNet stem conv [7,7,C,64] -> [4,4,4C,64] for k=2 space-to-depth
    input (channel order ky*2C + kx*C + c).

    Exact: pad the kernel to 8x8 with a zero top row and left column, so the
    7-tap stride-2 window at odd offset 2o-3 becomes an 8-tap window at even
    offset 2o-4 = packed taps o-2..o+1, stride 1, pad (2, 1).
    """
    kh, kw, cin, cout = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"ResNet stem conv expected, got a {kh}x{kw} kernel")
    w8 = w7.new_zeros((8, 8, cin, cout))
    w8[1:, 1:] = w7
    return w8.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * cin, cout)


def _q8(w: torch.Tensor, dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight-only int8 with per-(task, output-column) symmetric scales for a
    stacked [T, C, D] weight, in the JAX package's order of operations: the
    scales and ``w / scale`` in float32, the scales then stored at
    ``dtype``; ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=1)  # [T, D]
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None, :]), -127, 127)
    return q.to(torch.int8).contiguous(), scale.to(dtype)


def fold_stream_weights(
    params: Dict[str, Any], spec: Spec, dtype: torch.dtype = torch.float32,
    quantize_fold: bool = False, pack_stem: bool = True,
) -> Dict[str, Any]:
    """Derived weights for the batch-1 camera path.

    - ``attn_pq = proj_w @ q`` [T, C], input-independent, computed once,
      float32 at every ``dtype`` (the scores stay float32);
    - ``attn_fold = proj_w @ out_w`` [T, C, C]: the two per-frame weight
      reads ``(pooled @ proj_w) @ out_w`` associate into one; summed in
      float32 and stored at ``dtype``;
    - ``quantize_fold=True`` stores the fold weight-only int8 with
      per-(task, output-column) scales (``attn_fold_q8``,
      ``attn_fold_scale``) and the hidden MLP layers likewise (``mlp_q8``,
      their biases at ``dtype``); the scales are computed in float32 and
      stored at ``dtype``;
    - ``pack_stem`` adds the stem conv repacked for k=2 space-to-depth
      input (``stem_w``, at ``dtype``).

    ``backbone``, ``mlp`` and ``final`` are cast to ``dtype``, as the JAX
    package's fold does.  The fold is a floating-point reassociation of
    :func:`apply`; the tests bound its drift.
    """
    if not spec.use_attention:
        raise ValueError("fold_stream_weights requires use_attention=True")
    attn = params["attn"]
    pq = torch.einsum("tcd,td->tc", attn["proj_w"], attn["q"])
    fold = torch.bmm(attn["proj_w"], attn["out_w"])
    out: Dict[str, Any] = {
        "backbone": cast_tree(params["backbone"], dtype),
        "attn_pq": pq,
        "mlp": cast_tree(params["mlp"], dtype),
        "final": cast_tree(params["final"], dtype),
    }
    if quantize_fold:
        out["attn_fold_q8"], out["attn_fold_scale"] = _q8(fold, dtype)
        out["mlp_q8"] = []
        for lp in params["mlp"]:
            w8, s = _q8(lp["w"], dtype)
            out["mlp_q8"].append({"w8": w8, "scale": s, "b": lp["b"].to(dtype)})
        del out["mlp"]
    else:
        out["attn_fold"] = fold.to(dtype)
    if pack_stem:
        out["stem_w"] = pack_stem_weights(params["backbone"]["conv1"]["w"]).to(dtype)
    return out


def apply_stream(folded: Dict[str, Any], x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """Camera forward on a :func:`fold_stream_weights` tree -> logits [B, T, Kmax].

    Same math as :func:`apply` with the attention head's three stacked
    weight contractions collapsed to one.  With packed stem weights
    (``stem_w``), ``x`` is normalized NHWC [B, H, W, 3] (packed here) or
    already k=2 space-to-depth packed [B, H/2, W/2, 12].

    On a bf16 fold (``x`` normalized in bf16) it computes what the JAX
    package's bf16 ``apply_stream`` does: the packed stem and the trunk in
    bf16 (float32 sums), the scores and the attention pooling in float32,
    and the fold product on the pooled vector rounded to bf16, summed in
    float32: on the int8 fold through ``dequant_matvec``'s bf16 mode, each
    weight dequantized to bf16 first.
    """
    if "stem_w" in folded:
        if x.shape[-1] == 3:
            b, h, w_, c = x.shape
            x = (x.reshape(b, h // 2, 2, w_ // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
                 .reshape(b, h // 2, w_ // 2, 4 * c))
        # contiguous NCHW, as the trunk's other entry makes it: a
        # channels-last view here would carry cuDNN channels-last through
        # every later convolution, with a layout conversion at each
        a = conv2d_nchw(F.pad(resnet._nchw(x), (2, 1, 2, 1)), folded["stem_w"].permute(3, 2, 0, 1),
                        None, 1, 0)
        n = max(1, min(spec.truncate_after_layer, len(resnet.CHILDREN)))
        feats = resnet._apply_children(folded["backbone"], a, resnet.CHILDREN[1:n])
        b, c, h, w = feats.shape
        tokens = feats.permute(0, 2, 3, 1).reshape(b, h * w, c)
    else:
        feats = resnet.apply_truncated(folded["backbone"], x, spec.truncate_after_layer)
        b, h, w, c = feats.shape
        tokens = feats.reshape(b, h * w, c)
    tokens = tokens.float()
    scores = torch.einsum("bnc,tc->btn", tokens, folded["attn_pq"]) * (1.0 / math.sqrt(spec.token_dim))
    pooled = torch.einsum("btn,bnc->btc", torch.softmax(scores, dim=-1), tokens)
    if "attn_fold_q8" in folded:
        scale = folded["attn_fold_scale"]
        emb = cuda_kernels.dequant_matvec(pooled.to(scale.dtype).contiguous(),
                                          folded["attn_fold_q8"], scale)
    elif folded["attn_fold"].dtype == torch.float32:
        emb = torch.einsum("btc,tce->bte", pooled, folded["attn_fold"])
    else:
        w = folded["attn_fold"]
        emb = matmul_f32(pooled.to(w.dtype).transpose(0, 1), w).transpose(0, 1)
    return _classify(folded, emb)


def apply_train(
    params: Dict[str, Any], x: torch.Tensor, spec: Spec,
    generator: Optional[torch.Generator] = None, dropout_rate: float = 0.0, shard=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Train-mode forward: the backbone's batch norms on batch statistics,
    with new running statistics (the global batch's with a ``shard``, as in
    ``pmg.apply_train``).  RTM has no dropout sites, so ``generator`` and
    ``dropout_rate`` are unused.  Returns (stacked logits, {"backbone":
    backbone params with new running statistics})."""
    del generator, dropout_rate
    feats, new_backbone = resnet.apply_truncated_train(params["backbone"], x,
                                                       spec.truncate_after_layer, shard)
    logits, _ = head_apply(params, feats, spec)
    return logits, {"backbone": new_backbone}


def apply(
    params: Dict[str, Any],
    x: torch.Tensor,
    spec: Spec,
    capture: Sequence[str] = (),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward: normalized NHWC images -> (stacked logits [B,T,Kmax], aux).

    ``capture``: "features" (truncated-backbone output, NHWC),
    "shared_embedding" (GAP [B, C]), "task_embeddings" ([B, T, C]).
    """
    aux: Dict[str, torch.Tensor] = {}
    feats = resnet.apply_truncated(params["backbone"], x, spec.truncate_after_layer)
    if "features" in capture:
        aux["features"] = feats
    b, h, w, c = feats.shape
    shared = feats.mean(dim=(1, 2))
    if "shared_embedding" in capture:
        aux["shared_embedding"] = shared
    if spec.use_attention:
        emb = rtm_task_attention(feats.reshape(b, h * w, c), params["attn"])
    else:
        emb = shared[:, None, :].expand(b, len(spec.tasks), c)
    if "task_embeddings" in capture:
        aux["task_embeddings"] = emb
    return _classify(params, emb), aux
