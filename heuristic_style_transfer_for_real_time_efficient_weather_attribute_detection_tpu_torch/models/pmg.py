"""PMG, the "PatchGAN-Multitask-Gram" model (~2.4M params shipped).

Non-overlapping conv trunk (k4 s4 p0, doubling from ``ndf``, then a 1x1
block) -> optional SE -> 1x1 ``chan_proj`` to ``gram_channels`` -> split into
``patch_div^2`` patches (replicate pad) -> per-patch Gram -> flattened
tokens -> ``token_proj`` -> pre-norm transformer -> per-task query pooling
-> per-task linear heads.  The camera path's fused trunk+Gram kernel
re-enters at ``head_from_gram_tokens``, on a compressed
``fold_head_weights`` tree or the full one.

Shipped config: ndf 32, patch_size 64, patch_div 3, gram_channels 96,
d_model 192, 2 layers, 4 heads, batch norm; 224 px input -> 14x14 features
-> 15x15 pad -> 9 patches of 5x5 -> 9 Gram tokens of 9216 values.

Params are a nested dict of tensors with the JAX package's tree layout
(HWIO convs, [in, out] linears, heads stacked over tasks), so one tree maps
leaf for leaf onto the other (``engine.checkpoint.params_from_jax``).

On a bf16 param tree (``ops.nn.cast_tree``) the forward runs in bf16 as
the JAX package's does: from uint8 the first block (stem, batch norm,
LeakyReLU) runs in the stem kernel's bf16 mode (K2), the Gram is rounded
to bf16 and ``token_proj`` runs in the ``gram_proj`` kernel (K5) on the
card, their plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..config import TaskSpec
from ..ops import cuda_kernels
from ..ops.attention import stacked_task_heads, task_query_pool, transformer_encoder
from ..ops.gram import patch_gram_tokens
from ..ops.nn import cast_tree, conv2d, init_conv, init_linear, init_se, leaky_relu, linear, se_block
from ..ops.norms import apply_norm, batch_norm_affine
from ..ops.preprocess import packed_affine, s2d_unpack
from ..utils.reporting import count
from .trunk import apply_trunk, apply_trunk_train, init_trunk, trunk_plan

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


def init(g: torch.Generator, spec: Spec) -> Dict[str, Any]:
    """Random params (CPU float32) drawn from the generator ``g``, in the
    JAX package's tree: bias-free trunk convolutions, ``chan_proj``,
    ``token_proj``, standard-normal ``queries``, a bias-free ``se`` when the
    spec uses channel attention, transformer layers with zero attention
    biases, identity norms and an FFN of ``2 * d_model``, and the task heads
    stacked and zero-padded to Kmax."""
    t = spec.tasks
    d = spec.d_model
    params: Dict[str, Any] = {
        "trunk": init_trunk(g, spec.plan, spec.norm, conv_bias=False),
        "chan_proj": init_conv(g, 1, 1, spec.trunk_channels, spec.gram_channels),
        "token_proj": init_linear(g, spec.token_dim_in, d),
        "queries": torch.randn(len(t), d, generator=g),
    }
    if spec.use_channel_attention:
        params["se"] = init_se(g, spec.trunk_channels)
    if spec.has_transformer:
        layers = []
        for _ in range(spec.transformer_layers):
            attn = {n: init_linear(g, d, d, bias=False)["w"] for n in ("wq", "wk", "wv")}
            attn.update({n: torch.zeros(d) for n in ("bq", "bk", "bv")})
            attn.update(wo=init_linear(g, d, d, bias=False)["w"], bo=torch.zeros(d))
            layers.append({
                "attn": attn,
                "norm1": {"scale": torch.ones(d), "bias": torch.zeros(d)},
                "norm2": {"scale": torch.ones(d), "bias": torch.zeros(d)},
                "ffn1": init_linear(g, d, 2 * d),
                "ffn2": init_linear(g, 2 * d, d),
            })
        params["transformer"] = layers
    kmax = t.max_classes
    hw = torch.zeros(len(t), d, kmax)
    hb = torch.zeros(len(t), kmax)
    for i, k in enumerate(t.num_classes):
        p = init_linear(g, d, k)
        hw[i, :, :k], hb[i, :k] = p["w"], p["b"]
    params["heads"] = {"w": hw, "b": hb}
    return params


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
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    shard=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Everything after the trunk: SE -> chan_proj -> Gram -> transformer ->
    task pooling -> heads.  ``dropout_rate``/``generator`` turn on the
    transformer's train-mode dropout (``apply_train``; ``shard``: see
    ``ops.attention.dropout``).  The task count is the params' (a
    task-sharded tree gives its own tasks' logits).  The Gram (K1) and
    the bf16 ``token_proj`` (K5) are operators with registered gradients,
    so autograd runs through both."""
    aux: Dict[str, torch.Tensor] = {}
    h = se_block(feats, params["se"]) if spec.use_channel_attention else feats
    z = conv2d(h, params["chan_proj"])
    grams = patch_gram_tokens(z.contiguous(), spec.patch_div)
    tp = params["token_proj"]
    if grams.dtype == torch.bfloat16:
        # bf16 x bf16 summed in float32, the bias added in float32, one rounding
        tokens = cuda_kernels.gram_proj(grams, tp["w"].contiguous(), tp["b"].float(), grams.dtype)
    else:
        tokens = linear(grams, tp)
    if spec.has_transformer:
        tokens = transformer_encoder(tokens, params["transformer"], spec.transformer_heads,
                                     dropout_rate, generator, shard)
    if "tokens" in capture:
        aux["tokens"] = tokens
    pooled = task_query_pool(tokens, params["queries"])
    if "pooled" in capture:
        aux["pooled"] = pooled
    return stacked_task_heads(pooled, params["heads"]), aux


def head_from_gram_tokens(
    params: Dict[str, Any], gram_tokens: torch.Tensor, spec: Spec
) -> torch.Tensor:
    """Raw per-patch Gram tokens [B, Np, gc*gc] -> stacked logits.

    Re-entry point after the fused trunk+Gram kernel.  Takes the full param
    tree or a :func:`fold_head_weights` tree.  As in the JAX package, the
    float32 tokens meet the bf16 weights upcast to float32 (dtype
    promotion), and a weight-only int8 ``token_proj`` (``w8`` key) is
    dequantized in float32: ``float(w8) * scale``.
    """
    tp = params["token_proj"]
    if "w8" in tp:
        w = tp["w8"].to(torch.float32) * tp["scale"]
        tokens = torch.matmul(gram_tokens, w) + tp["b"]
    else:
        tokens = linear(gram_tokens, cast_tree(tp, torch.float32))
    if spec.has_transformer:
        tokens = transformer_encoder(
            tokens, cast_tree(params["transformer"], torch.float32), spec.transformer_heads
        )
    return stacked_task_heads(task_query_pool(tokens, params["queries"]), params["heads"])


def fold_head_weights(
    params: Dict[str, Any], spec: Spec, variant: str = "bf16"
) -> Dict[str, Any]:
    """Compressed head weights for the batch-1 camera path.

    - ``"bf16"``: ``token_proj`` and the transformer's matrix weights stored
      bfloat16; biases, norms, queries and heads stay float32.
    - ``"q8"``: ``token_proj`` stored weight-only int8 with symmetric
      per-output-column scales (``w8``, ``scale``); transformer as in
      ``"bf16"``.

    The rounding is the JAX package's, leaf for leaf: round half to even
    for both the bf16 cast and the int8 quantization.  The compressed
    matrices come out contiguous, as the fused head kernel takes them.
    """
    if variant not in ("bf16", "q8"):
        raise ValueError(f"unknown head fold variant {variant!r}")
    out: Dict[str, Any] = {"queries": params["queries"], "heads": params["heads"]}
    tp = params["token_proj"]
    if variant == "q8":
        w = tp["w"].to(torch.float32)
        amax = w.abs().amax(dim=0)  # per output column
        scale = torch.clamp(amax, min=1e-12) / 127.0
        out["token_proj"] = {
            "w8": torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8).contiguous(),
            "scale": scale,
            "b": tp["b"],
        }
    else:
        out["token_proj"] = {"w": tp["w"].to(torch.bfloat16).contiguous(), "b": tp["b"]}
    if spec.has_transformer:

        def bf(t):
            return t.to(torch.bfloat16).contiguous()

        out["transformer"] = [
            {
                "attn": {
                    **{n: bf(lp["attn"][n]) for n in ("wq", "wk", "wv", "wo")},
                    **{n: lp["attn"][n] for n in ("bq", "bk", "bv", "bo")},
                },
                "norm1": lp["norm1"],
                "norm2": lp["norm2"],
                "ffn1": {"w": bf(lp["ffn1"]["w"]), "b": lp["ffn1"]["b"]},
                "ffn2": {"w": bf(lp["ffn2"]["w"]), "b": lp["ffn2"]["b"]},
            }
            for lp in params["transformer"]
        ]
    return out


def apply_train(
    params: Dict[str, Any],
    x: torch.Tensor,
    spec: Spec,
    generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.1,
    shard=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Train-mode forward on normalized NHWC images: batch norm on batch
    statistics, and the reference transformer's dropout (rate 0.1) drawn
    from ``generator`` when one is given (None: no dropout).  Returns
    (stacked logits, {"trunk": trunk params with new running statistics});
    the train step takes only the statistics from it.  ``shard`` (the
    sharded train step's ``parallel.mesh.RowShard``: x holds this rank's
    rows of the global batch) takes the batch norms' statistics and the
    dropout masks over the global batch."""
    feats, new_trunk = apply_trunk_train(params["trunk"], x, spec.plan, spec.norm, shard=shard)
    logits, _ = head_apply(params, feats, spec, dropout_rate=dropout_rate, generator=generator,
                           shard=shard)
    return logits, {"trunk": new_trunk}


def supports_packed_input(spec: Spec) -> bool:
    """True when the first trunk block is non-overlapping (kernel == stride,
    pad 0), so the uint8 stem path (``apply_packed``) is exact."""
    b0 = spec.plan[0]
    return b0.kernel == b0.stride and b0.pad == 0


def _stem_fuses_norm(spec: Spec) -> bool:
    """The stem kernel applies batch norm and the LeakyReLU itself: in a
    float32 run folded into its scale and shift, in a bf16 run in bf16
    after rounding the sum.  Other norms follow the kernel."""
    return spec.norm == "batch"


def fold_stem(
    params: Dict[str, Any], spec: Spec, dtype: torch.dtype = torch.float32
) -> Dict[str, Optional[torch.Tensor]]:
    """The first trunk block as the stem kernel's operands.

    The uint8 normalize affine is folded into the weight and a bias,
    ``(u8*scale - shift) @ W == u8 @ (scale*W) + (b - shift@W)``.  As in the
    JAX package, the folded weight is rounded to the conv weight's own type
    (bf16 on a bf16 tree) and held in float32 for the kernel; the bias
    stays float32.

    - float32 run: {"w", "scale", "shift"}.  For batch norm the inference
      affine joins the bias into the kernel's scale/shift and the kernel
      applies the LeakyReLU; otherwise scale is 1 and shift the bias, and
      the norm and LeakyReLU follow the kernel.
    - bf16 run (a bf16 tree): {"w", "bias", "scale", "shift"}: for batch
      norm, scale and shift are the bf16 affine that
      ``norms.batch_norm_affine`` gives on the bf16 params, computed once
      here with the same operations on the params' device, and the kernel
      applies them and the LeakyReLU to its bf16 sum; otherwise both are
      None and the norm and LeakyReLU follow the kernel.
    """
    if not supports_packed_input(spec):
        raise ValueError("the first trunk block overlaps; use apply on normalized input")
    b0 = spec.plan[0]
    p0 = params["trunk"][0]
    w0 = p0["conv"]["w"].reshape(-1, b0.cout)
    w0f = w0.float()
    scale, shift = (torch.as_tensor(a, device=w0.device) for a in packed_affine(b0.kernel))
    bf = -(shift @ w0f)
    if p0["conv"].get("b") is not None:
        bf = bf + p0["conv"]["b"].float()
    wf = (scale[:, None] * w0f).to(w0.dtype).float().contiguous()
    fused = _stem_fuses_norm(spec)
    if dtype == torch.float32:
        if fused:
            s, t = batch_norm_affine(p0["norm"])
            t = bf * s + t
        else:
            s, t = torch.ones_like(bf), bf
        return {"w": wf, "scale": s.contiguous(), "shift": t.contiguous()}
    s = t = None
    if fused:
        s, t = (v.contiguous() for v in batch_norm_affine(p0["norm"]))
    return {"w": wf, "bias": bf.contiguous(), "scale": s, "shift": t}


def packed_trunk_features(
    params: Dict[str, Any],
    x8: torch.Tensor,
    spec: Spec,
    stem: Optional[Dict[str, Optional[torch.Tensor]]] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Trunk forward from uint8 -> feature map [B, h, w, C] of ``dtype``.

    ``x8`` is raw uint8 NHWC [B, H, W, 3] or space-to-depth packed
    [B, H/k, W/k, k*k*3] (unpacked here, on x8's device).  The first block
    runs in the stem kernel on ``stem``, the operands from
    :func:`fold_stem` (folded here when not given; a caller that runs many
    batches folds once, as the fold's host-to-device constants would
    otherwise synchronize every batch).  In bf16 the kernel writes its sum
    rounded to bf16 and, for batch norm, the norm and LeakyReLU in bf16 on
    the bf16 params, as the JAX package's activation chain computes them.
    """
    if stem is None:
        stem = fold_stem(params, spec, dtype)
    b0 = spec.plan[0]
    k = b0.kernel
    if x8.shape[-1] == k * k * b0.cin and k > 1:
        x8 = s2d_unpack(x8, k)
    fused = _stem_fuses_norm(spec)
    y = cuda_kernels.stem(x8, stem["w"], stem["scale"], stem["shift"], k, leaky=fused,
                          out_dtype=dtype, bias=stem.get("bias"))
    if not fused:
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
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward from uint8 images (raw or packed) through the stem kernel;
    the same math as ``apply`` after ``normalize_uint8``.  ``stem`` and
    ``dtype`` (the run's type; bf16 wants a bf16 param tree): see
    :func:`packed_trunk_features`."""
    y = packed_trunk_features(params, x8, spec, stem, dtype)
    aux: Dict[str, torch.Tensor] = {}
    if "features" in capture:
        aux["features"] = y
    logits, head_aux = head_apply(params, y, spec, capture)
    aux.update(head_aux)
    return logits, aux


def trunk_features(params: Dict[str, Any], x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """Trunk-only forward on normalized NHWC images (the style-transfer tap)."""
    return apply_trunk(params["trunk"], x, spec.plan, spec.norm)


def count_params(params) -> int:
    return count(params)
