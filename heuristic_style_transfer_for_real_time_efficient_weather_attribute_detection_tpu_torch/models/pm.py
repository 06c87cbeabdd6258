"""PM, the "PatchGAN-Multitask" model: a strided-conv trunk and per-task
spatial-attention heads.

Per-task head:
  x   = SE(feat)                 (if attn_use_se and not ablate_attention)
  a   = Conv1x1(x) -> [N,1,H,W]  attention logits
  A   = softmax(a/tau) over HW   (or normalized sigmoid)
  M   = Conv1x1_cls(x)           [N,K,H,W]
  out = sum_hw(M*A) / (sum_hw(A)+1e-6)

As in the JAX package, the SE scaling, the 1x1 convolutions and the
attention-weighted pooling are linear in the channels, so they are
reassociated into three einsums stacked over the task axis and no
[B, T, H, W, C] tensor exists:

  a_t[b,hw]    = <feat[b,hw,:], se_t[b,:] * wa_t> + ba_t
  pool_t[b,c]  = sum_hw A_t[b,hw] * feat[b,hw,c]
  out_t[b,k]   = <pool_t[b,:] * se_t[b,:], wc_t[:,k]> / den_t

The params share the JAX package's tree leaf for leaf.  A bf16 tree runs
the trunk in bf16; the heads' products sum in float32 and their outputs
(logits, attention, embeddings) are float32, as JAX's types make them.
PM runs no hand-written kernel.  ``apply`` times the trunk and the heads as
the ``pm.trunk`` and ``pm.heads`` spans of the port's tracer (off unless
it records).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..config import TaskSpec
from ..ops.nn import init_conv, init_linear
from ..utils import trace
from .trunk import apply_trunk, apply_trunk_train, init_trunk, trunk_plan

DEFAULTS = dict(
    ndf=64,
    norm="instance",
    patch_size=70,
    attn_tau=0.7,
    attn_use_se=True,
    attn_softmax_spatial=True,
    ablate_attention=False,
)


@dataclasses.dataclass(frozen=True)
class Spec:
    tasks: TaskSpec
    ndf: int = 64
    norm: str = "instance"
    patch_size: int = 70
    attn_tau: float = 0.7
    attn_use_se: bool = True
    attn_softmax_spatial: bool = True
    ablate_attention: bool = False
    input_nc: int = 3

    @property
    def plan(self):
        # k=4, s=2, p=1; final block k4 s1 p1.
        return trunk_plan(self.ndf, self.patch_size, 4, 2, 1, 4, 1, in_nc=self.input_nc)

    @property
    def trunk_channels(self) -> int:
        return self.plan[-1].cout


def build_spec(tasks: Mapping[str, Any], hparams: Dict[str, Any]) -> Spec:
    """hparams dict (+ reference defaults) -> Spec."""
    h = {**DEFAULTS, **{k: v for k, v in (hparams or {}).items() if k in DEFAULTS}}
    return Spec(
        tasks=TaskSpec.from_tasks(tasks),
        ndf=int(h["ndf"]),
        norm=str(h["norm"]),
        patch_size=int(h["patch_size"]),
        attn_tau=float(h["attn_tau"]),
        attn_use_se=bool(h["attn_use_se"]),
        attn_softmax_spatial=bool(h["attn_softmax_spatial"]),
        ablate_attention=bool(h["ablate_attention"]),
    )


def init(g: torch.Generator, spec: Spec) -> Dict[str, Any]:
    """Random params (CPU float32) with torch's default init, drawn from the
    generator ``g``: biased trunk convolutions, biased SE linears and
    attention convolution, bias-free class convolutions zero-padded to Kmax."""
    t = spec.tasks
    c = spec.trunk_channels
    nt, kmax = len(t), t.max_classes
    params: Dict[str, Any] = {"trunk": init_trunk(g, spec.plan, spec.norm, conv_bias=True)}
    hid = max(c // 16, 1)
    heads = {
        "se1_w": torch.zeros(nt, c, hid), "se1_b": torch.zeros(nt, hid),
        "se2_w": torch.zeros(nt, hid, c), "se2_b": torch.zeros(nt, c),
        "attn_w": torch.zeros(nt, c), "attn_b": torch.zeros(nt),
        "cls_w": torch.zeros(nt, c, kmax),
    }
    for i in range(nt):
        p1, p2 = init_linear(g, c, hid), init_linear(g, hid, c)
        heads["se1_w"][i], heads["se1_b"][i] = p1["w"], p1["b"]
        heads["se2_w"][i], heads["se2_b"][i] = p2["w"], p2["b"]
        pa = init_conv(g, 1, 1, c, 1, bias=True)
        heads["attn_w"][i], heads["attn_b"][i] = pa["w"][0, 0, :, 0], pa["b"][0]
        heads["cls_w"][i, :, : t.num_classes[i]] = init_conv(g, 1, 1, c, t.num_classes[i])["w"][0, 0]
    params["heads"] = heads
    return params


def _head_outputs(
    params: Dict[str, Any], feats: torch.Tensor, spec: Spec
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All task heads at once.  feats: [B,H,W,C] -> (logits [B,T,Kmax],
    attention [B,T,H,W])."""
    hp = {k: v.float() for k, v in params["heads"].items()}
    b, h, w, c = feats.shape
    nt = hp["attn_w"].shape[0]  # the params' tasks: a task-sharded tree's own
    f32 = feats.float()

    if spec.attn_use_se and not spec.ablate_attention:
        s = feats.mean(dim=(1, 2)).float()  # [B, C]
        z = torch.relu(torch.einsum("bc,tch->bth", s, hp["se1_w"]) + hp["se1_b"])
        se = torch.sigmoid(torch.einsum("bth,thc->btc", z, hp["se2_w"]) + hp["se2_b"])
    else:
        se = torch.ones((b, nt, c), dtype=torch.float32, device=feats.device)

    if spec.ablate_attention:
        # uniform attention is global average pooling; SE is bypassed
        attn = torch.full((b, nt, h, w), 1.0 / (h * w), dtype=feats.dtype, device=feats.device)
        pooled = feats.mean(dim=(1, 2)).float()
        return torch.einsum("bc,tck->btk", pooled, hp["cls_w"]), attn

    # attention logits <feat, se_t * wa_t> + ba_t, stacked over tasks
    gate_a = se * hp["attn_w"][None]
    a = torch.einsum("bhwc,btc->bthw", f32, gate_a) + hp["attn_b"][None, :, None, None]
    a = a.reshape(b, nt, h * w)
    if spec.attn_softmax_spatial:
        attn = torch.softmax(a / spec.attn_tau, dim=-1)
        den = attn.sum(dim=-1) + 1e-6  # 1 + 1e-6, kept for parity
    else:
        attn = torch.sigmoid(a)
        attn = attn / (attn.sum(dim=-1, keepdim=True) + 1e-6)
        den = attn.sum(dim=-1) + 1e-6

    # attention-weighted pooling, then the SE gate, then the class projection
    fpool = torch.einsum("btn,bnc->btc", attn, f32.reshape(b, h * w, c))
    logits = torch.einsum("btc,tck->btk", fpool * se, hp["cls_w"]) / den[..., None]
    return logits, attn.reshape(b, nt, h, w)


def head_apply(
    params: Dict[str, Any],
    feats: torch.Tensor,
    spec: Spec,
    capture: Sequence[str] = (),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Task heads from trunk features (the Grad-CAM entry)."""
    logits, attn = _head_outputs(params, feats, spec)
    return logits, ({"attn": attn} if "attn" in capture else {})


def apply(
    params: Dict[str, Any],
    x: torch.Tensor,
    spec: Spec,
    capture: Sequence[str] = (),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward: normalized NHWC images -> (stacked logits [B,T,Kmax], aux).

    ``capture``: "features" (trunk output), "attn" (per-task spatial
    attention [B,T,H,W]), "task_embeddings" (attention-weighted embeddings
    ``sum(F*A)/sum(A)`` [B,T,C]), "shared_embedding" (GAP of the trunk
    features [B,C]).
    """
    aux: Dict[str, torch.Tensor] = {}
    with trace.span("pm.trunk", device=x.device):
        feats = apply_trunk(params["trunk"], x, spec.plan, spec.norm)
    if "features" in capture:
        aux["features"] = feats
    if "shared_embedding" in capture:
        aux["shared_embedding"] = feats.mean(dim=(1, 2))
    with trace.span("pm.heads", device=x.device):
        logits, attn = _head_outputs(params, feats, spec)
    if "attn" in capture:
        aux["attn"] = attn
    if "task_embeddings" in capture:
        b, h, w, c = feats.shape
        a = attn.reshape(b, len(spec.tasks), h * w).float()
        num = torch.einsum("btn,bnc->btc", a, feats.reshape(b, h * w, c).float())
        aux["task_embeddings"] = num / (a.sum(dim=-1, keepdim=True) + 1e-6)
    return logits, aux


def apply_train(
    params: Dict[str, Any], x: torch.Tensor, spec: Spec,
    generator: Optional[torch.Generator] = None, dropout_rate: float = 0.0, shard=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Train-mode forward: batch norm (``spec.norm == "batch"``) on batch
    statistics with new running statistics (the global batch's with a
    ``shard``, as in ``pmg.apply_train``); instance norm trains as it
    evaluates, and the heads have no norm.  PM has no dropout sites, so
    ``generator`` and ``dropout_rate`` are unused.  Returns (stacked logits,
    {"trunk": trunk params with new running statistics})."""
    del generator, dropout_rate
    feats, new_trunk = apply_trunk_train(params["trunk"], x, spec.plan, spec.norm, shard=shard)
    logits, _ = _head_outputs(params, feats, spec)
    return logits, {"trunk": new_trunk}
