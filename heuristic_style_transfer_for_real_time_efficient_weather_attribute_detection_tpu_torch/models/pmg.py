"""PMG, the "PatchGAN-Multitask-Gram" model (~2.4M params shipped).

Non-overlapping conv trunk (k4 s4 p0, doubling from ``ndf``, then a 1x1
block) -> optional SE -> 1x1 ``chan_proj`` to ``gram_channels`` -> split into
``patch_div^2`` patches (replicate pad) -> per-patch Gram -> flattened
tokens -> ``token_proj`` -> pre-norm transformer -> per-task query pooling
-> per-task linear heads.

Shipped config: ndf 32, patch_size 64, patch_div 3, gram_channels 96,
d_model 192, 2 layers, 4 heads, batch norm; 224 px input -> 14x14 features
-> 15x15 pad -> 9 patches of 5x5 -> 9 Gram tokens of 9216 values.

Params are a nested dict of tensors with the JAX package's tree layout
(HWIO convs, [in, out] linears, heads stacked over tasks), so one tree maps
leaf for leaf onto the other (``engine.checkpoint.params_from_jax``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..config import TaskSpec
from ..ops import cuda_kernels
from ..ops.attention import stacked_task_heads, task_query_pool, transformer_encoder
from ..ops.gram import patch_gram_tokens
from ..ops.nn import conv2d, leaky_relu, linear, se_block
from ..ops.norms import apply_norm, batch_norm_affine
from ..ops.preprocess import packed_affine, s2d_unpack
from .trunk import apply_trunk, trunk_plan

DEFAULTS = dict(
    ndf=64,
    patch_size=70,
    patch_div=4,
    gram_channels=64,
    d_model=256,
    transformer_layers=1,
    transformer_heads=4,
    use_token_attention=True,
    use_channel_attention=False,
    norm="batch",
)


@dataclasses.dataclass(frozen=True)
class Spec:
    tasks: TaskSpec
    ndf: int = 64
    norm: str = "batch"
    patch_size: int = 70
    patch_div: int = 4
    gram_channels: int = 64
    d_model: int = 256
    transformer_layers: int = 1
    transformer_heads: int = 4
    use_token_attention: bool = True
    use_channel_attention: bool = False
    input_nc: int = 3

    @property
    def plan(self):
        # k=s=4, p=0; final block is 1x1 s1 p0.
        return trunk_plan(
            self.ndf, self.patch_size, 4, 4, 0, 1, 0, in_nc=self.input_nc
        )

    @property
    def trunk_channels(self) -> int:
        return self.plan[-1].cout

    @property
    def has_transformer(self) -> bool:
        return self.use_token_attention and self.transformer_layers > 0

    @property
    def token_dim_in(self) -> int:
        return self.gram_channels * self.gram_channels


def build_spec(tasks: Mapping[str, Any], hparams: Dict[str, Any]) -> Spec:
    """hparams dict (+ reference defaults) -> Spec."""
    h = {**DEFAULTS, **{k: v for k, v in (hparams or {}).items() if k in DEFAULTS}}
    return Spec(
        tasks=TaskSpec.from_tasks(tasks),
        ndf=int(h["ndf"]),
        norm=str(h["norm"]),
        patch_size=int(h["patch_size"]),
        patch_div=int(h["patch_div"]),
        gram_channels=int(h["gram_channels"]),
        d_model=int(h["d_model"]),
        transformer_layers=int(h["transformer_layers"]),
        transformer_heads=int(h["transformer_heads"]),
        use_token_attention=bool(h["use_token_attention"]),
        use_channel_attention=bool(h["use_channel_attention"]),
    )


def apply(
    params: Dict[str, Any],
    x: torch.Tensor,
    spec: Spec,
    capture: Sequence[str] = (),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward: normalized NHWC images -> (stacked logits [B,T,Kmax], aux).

    ``capture`` may request "features" (trunk output), "tokens"
    (post-transformer) and "pooled" (per-task embeddings).
    """
    aux: Dict[str, torch.Tensor] = {}
    feats = apply_trunk(params["trunk"], x, spec.plan, spec.norm)
    if "features" in capture:
        aux["features"] = feats
    logits, head_aux = head_apply(params, feats, spec, capture)
    aux.update(head_aux)
    return logits, aux


def head_apply(
    params: Dict[str, Any],
    feats: torch.Tensor,
    spec: Spec,
    capture: Sequence[str] = (),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Everything after the trunk: SE -> chan_proj -> Gram -> transformer ->
    task pooling -> heads."""
    aux: Dict[str, torch.Tensor] = {}
    h = se_block(feats, params["se"]) if spec.use_channel_attention else feats
    z = conv2d(h, params["chan_proj"])
    tokens = linear(patch_gram_tokens(z.contiguous(), spec.patch_div), params["token_proj"])
    if spec.has_transformer:
        tokens = transformer_encoder(tokens, params["transformer"], spec.transformer_heads)
    if "tokens" in capture:
        aux["tokens"] = tokens
    pooled = task_query_pool(tokens, params["queries"])
    if "pooled" in capture:
        aux["pooled"] = pooled
    return stacked_task_heads(pooled, params["heads"]), aux


def head_from_gram_tokens(
    params: Dict[str, Any], gram_tokens: torch.Tensor, spec: Spec
) -> torch.Tensor:
    """Raw per-patch Gram tokens [B, Np, gc*gc] -> stacked logits."""
    tokens = linear(gram_tokens, params["token_proj"])
    if spec.has_transformer:
        tokens = transformer_encoder(tokens, params["transformer"], spec.transformer_heads)
    return stacked_task_heads(task_query_pool(tokens, params["queries"]), params["heads"])


def supports_packed_input(spec: Spec) -> bool:
    """True when the first trunk block is non-overlapping (kernel == stride,
    pad 0), so the uint8 stem path (``apply_packed``) is exact."""
    b0 = spec.plan[0]
    return b0.kernel == b0.stride and b0.pad == 0


def fold_stem(params: Dict[str, Any], spec: Spec) -> Dict[str, torch.Tensor]:
    """The first trunk block as the stem kernel's operands.

    The uint8 normalize affine is folded into the weight and a bias,
    ``(u8*scale - shift) @ W == u8 @ (scale*W) + (b - shift@W)``.  For batch
    norm the inference affine joins the bias into the kernel's scale/shift
    and the kernel applies the LeakyReLU; for instance or group norm the
    kernel's affine is the identity plus the bias, and the norm and LeakyReLU
    follow the kernel.  Returns {"w": [k*k*cin, cout], "scale", "shift": [cout]}.
    """
    if not supports_packed_input(spec):
        raise ValueError("the first trunk block overlaps; use apply on normalized input")
    b0 = spec.plan[0]
    p0 = params["trunk"][0]
    w0 = p0["conv"]["w"].reshape(-1, b0.cout)
    scale, shift = (torch.as_tensor(a, device=w0.device) for a in packed_affine(b0.kernel))
    bf = -(shift @ w0)
    if p0["conv"].get("b") is not None:
        bf = bf + p0["conv"]["b"]
    if spec.norm == "batch":
        s, t = batch_norm_affine(p0["norm"])
        t = bf * s + t
    else:
        s, t = torch.ones_like(bf), bf
    return {
        "w": (scale[:, None] * w0).contiguous(),
        "scale": s.contiguous(),
        "shift": t.contiguous(),
    }


def packed_trunk_features(
    params: Dict[str, Any],
    x8: torch.Tensor,
    spec: Spec,
    stem: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Trunk forward from uint8 -> feature map [B, h, w, C].

    ``x8`` is raw uint8 NHWC [B, H, W, 3] or space-to-depth packed
    [B, H/k, W/k, k*k*3] (unpacked here, on x8's device).  The first block
    runs in the stem kernel on ``stem``, the operands from
    :func:`fold_stem` (folded here when not given; a caller that runs many
    batches folds once, as the fold's host-to-device constants would
    otherwise synchronize every batch).
    """
    if stem is None:
        stem = fold_stem(params, spec)
    b0 = spec.plan[0]
    k = b0.kernel
    if x8.shape[-1] == k * k * b0.cin and k > 1:
        x8 = s2d_unpack(x8, k)
    batch_norm = spec.norm == "batch"
    y = cuda_kernels.stem(x8, stem["w"], stem["scale"], stem["shift"], k, leaky=batch_norm)
    if not batch_norm:
        y = leaky_relu(apply_norm(y, params["trunk"][0]["norm"], spec.norm), 0.2)
    for pp, bk in zip(params["trunk"][1:], spec.plan[1:]):
        y = conv2d(y, pp["conv"], stride=bk.stride, padding=bk.pad)
        y = leaky_relu(apply_norm(y, pp["norm"], spec.norm), 0.2)
    return y


def apply_packed(
    params: Dict[str, Any],
    x8: torch.Tensor,
    spec: Spec,
    capture: Sequence[str] = (),
    stem: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward from uint8 images (raw or packed) through the stem kernel;
    the same math as ``apply`` after ``normalize_uint8``.  ``stem``: see
    :func:`packed_trunk_features`."""
    y = packed_trunk_features(params, x8, spec, stem)
    aux: Dict[str, torch.Tensor] = {}
    if "features" in capture:
        aux["features"] = y
    logits, head_aux = head_apply(params, y, spec, capture)
    aux.update(head_aux)
    return logits, aux
