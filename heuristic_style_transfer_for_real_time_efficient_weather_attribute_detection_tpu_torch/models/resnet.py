"""ResNet-50 backbone of the RTM family (torchvision stage structure).

The RTM family truncates a torchvision ResNet-50 after N top-level children
(conv1, bn1, relu, maxpool, layer1..layer4); inference batch norm uses the
running statistics, the train-mode forward (``apply_truncated_train``)
batch statistics.  Param tree, as in the JAX package:

  {"conv1": {"w"}, "bn1": {...}, "layer1": [block, ...], ..., "layer4": [...]}
  block = {"conv1", "bn1", "conv2", "bn2", "conv3", "bn3",
           optional "downsample": {"conv", "bn"}}

The public functions take and return NHWC, with HWIO conv weights.  Inside,
the trunk runs NCHW through ``F.conv2d``: the activation is permuted once at
the trunk's entry and once at its exit.  Each norm, with the residual sum
and the ReLU that follow it, is one call, 49 a full-depth forward (the
downsample branch's norm rides in its block's last call): in inference mode
``cuda_kernels.bn_epilogue`` (its kernel on the card, its plain version on
the CPU), in train mode ``cuda_kernels.bn_train`` (two steps forward and
two backward on the contiguous NCHW conv output: its kernels on the card,
their plain versions on the CPU).  The private ``_apply_block``, ``_apply_block_train``
and ``_apply_children`` work on NCHW.  Compare with the float32 reference only
with TF32 off (``config.enable_parity_precision``): cuDNN's float32
convolutions default to TF32.  A bf16 tree runs in bf16 under the JAX
package's rule (``ops.nn.conv2d_nchw``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..ops import cuda_kernels
from ..ops.nn import conv2d_nchw, init_batch_norm, init_conv

# (num_blocks, planes) per stage; expansion 4 (ResNet-50).
STAGES: Tuple[Tuple[int, int], ...] = ((3, 64), (4, 128), (6, 256), (3, 512))
EXPANSION = 4

# Top-level "children" in torchvision order (avgpool/fc already dropped).
CHILDREN = ("conv1", "bn1", "relu", "maxpool", "layer1", "layer2", "layer3", "layer4")


def stage_out_channels(truncate_after_layer: int) -> int:
    """Output channels after truncating to the first N children (clamped to [1, 8])."""
    n = max(1, min(truncate_after_layer, len(CHILDREN)))
    c = 3
    for child in CHILDREN[:n]:
        if child == "conv1":
            c = 64
        elif child.startswith("layer"):
            c = STAGES[int(child[-1]) - 1][1] * EXPANSION
    return c


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """Torch ``MaxPool2d(3, stride=2, padding=1)`` on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def _init_block(g: torch.Generator, cin: int, planes: int, stride: int) -> Dict[str, Any]:
    cout = planes * EXPANSION
    block = {
        "conv1": init_conv(g, 1, 1, cin, planes),
        "bn1": init_batch_norm(planes),
        "conv2": init_conv(g, 3, 3, planes, planes),
        "bn2": init_batch_norm(planes),
        "conv3": init_conv(g, 1, 1, planes, cout),
        "bn3": init_batch_norm(cout),
    }
    if stride != 1 or cin != cout:
        block["downsample"] = {"conv": init_conv(g, 1, 1, cin, cout), "bn": init_batch_norm(cout)}
    return block


def init(g: torch.Generator) -> Dict[str, Any]:
    """Random ResNet-50 params (CPU float32) with torch's default init,
    drawn from the generator ``g``."""
    params: Dict[str, Any] = {"conv1": init_conv(g, 7, 7, 3, 64), "bn1": init_batch_norm(64)}
    cin = 64
    for si, (nblocks, planes) in enumerate(STAGES):
        blocks: List[Dict[str, Any]] = []
        for bi in range(nblocks):
            blocks.append(_init_block(g, cin, planes, 1 if (si == 0 or bi > 0) else 2))
            cin = planes * EXPANSION
        params[f"layer{si + 1}"] = blocks
    return params


def _conv(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int = 1, padding: int = 0):
    """NCHW activation x HWIO weight -> NCHW."""
    return conv2d_nchw(x, p["w"].permute(3, 2, 0, 1), p.get("b"), stride, padding)


def _apply_block(p: Dict[str, Any], x: torch.Tensor, stride: int) -> torch.Tensor:
    """One bottleneck block, NCHW."""
    h = cuda_kernels.bn_epilogue(_conv(x, p["conv1"]), p["bn1"])
    h = cuda_kernels.bn_epilogue(_conv(h, p["conv2"], stride=stride, padding=1), p["bn2"])
    h = _conv(h, p["conv3"])
    if "downsample" in p:
        ds = p["downsample"]
        return cuda_kernels.bn_epilogue(h, p["bn3"], other=_conv(x, ds["conv"], stride=stride),
                                        p_other=ds["bn"])
    return cuda_kernels.bn_epilogue(h, p["bn3"], other=x)


def _apply_children(params: Dict[str, Any], x: torch.Tensor, children: Tuple[str, ...]) -> torch.Tensor:
    """Run the named top-level children on an NCHW activation."""
    for i, child in enumerate(children):
        if child == "conv1":
            x = _conv(x, params["conv1"], stride=2, padding=3)
        elif child == "bn1":
            x = cuda_kernels.bn_epilogue(x, params["bn1"], relu=children[i + 1:i + 2] == ("relu",))
        elif child == "relu":
            if children[i - 1:i] != ("bn1",):  # else bn1's pass applied it
                x = torch.relu(x)
        elif child == "maxpool":
            x = F.max_pool2d(x, 3, 2, 1)
        else:
            si = int(child[-1]) - 1
            for bi, bp in enumerate(params[child]):
                x = _apply_block(bp, x, 1 if (si == 0 or bi > 0) else 2)
    return x


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def apply_truncated(params: Dict[str, Any], x: torch.Tensor, truncate_after_layer: int) -> torch.Tensor:
    """Run the first ``truncate_after_layer`` children (clamped to [1, 8]), NHWC."""
    n = max(1, min(truncate_after_layer, len(CHILDREN)))
    return _nhwc(_apply_children(params, _nchw(x), CHILDREN[:n]))


def stem_conv(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """conv1 output only (pre-bn, pre-relu), NHWC: the activation the
    reference's RTM Grad-CAM hooks."""
    return _nhwc(_conv(_nchw(x), params["conv1"], stride=2, padding=3))


def apply_truncated_from_stem(
    params: Dict[str, Any], a: torch.Tensor, truncate_after_layer: int
) -> torch.Tensor:
    """Continue from ``stem_conv`` activations (NHWC) through the remaining
    truncated children."""
    n = max(1, min(truncate_after_layer, len(CHILDREN)))
    return _nhwc(_apply_children(params, _nchw(a), CHILDREN[1:n]))


# ---------------------------------------------------------------------------
# Train mode: batch statistics and running-statistic updates
# ---------------------------------------------------------------------------


def _apply_block_train(p: Dict[str, Any], x: torch.Tensor, stride: int, shard=None):
    """One bottleneck block in train mode, NCHW -> (y, block params with new
    running statistics): three ``cuda_kernels.bn_train`` calls, the last
    with the identity or, in a downsample block, with the downsample
    convolution's output under its own norm."""
    new_p = dict(p)
    h, new_p["bn1"], _ = cuda_kernels.bn_train(_conv(x, p["conv1"]), p["bn1"], shard=shard)
    h, new_p["bn2"], _ = cuda_kernels.bn_train(_conv(h, p["conv2"], stride=stride, padding=1),
                                               p["bn2"], shard=shard)
    h = _conv(h, p["conv3"])
    if "downsample" in p:
        ds = p["downsample"]
        y, new_p["bn3"], ds_bn = cuda_kernels.bn_train(
            h, p["bn3"], other=_conv(x, ds["conv"], stride=stride), p_other=ds["bn"], shard=shard)
        new_p["downsample"] = {"conv": ds["conv"], "bn": ds_bn}
        return y, new_p
    y, new_p["bn3"], _ = cuda_kernels.bn_train(h, p["bn3"], other=x, shard=shard)
    return y, new_p


def apply_truncated_train(
    params: Dict[str, Any], x: torch.Tensor, truncate_after_layer: int, shard=None
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Train-mode truncated forward, NHWC -> (features, params with new
    batch-norm running statistics; the weights are the same tensors).  Each
    norm site is one ``cuda_kernels.bn_train`` call (the stem's norm with
    its ReLU); with a ``shard`` every norm takes the global batch's
    statistics."""
    n = max(1, min(truncate_after_layer, len(CHILDREN)))
    children = CHILDREN[:n]
    new_params = dict(params)
    x = _nchw(x)
    for i, child in enumerate(children):
        if child == "conv1":
            x = _conv(x, params["conv1"], stride=2, padding=3)
        elif child == "bn1":
            x, new_params["bn1"], _ = cuda_kernels.bn_train(
                x, params["bn1"], relu=children[i + 1:i + 2] == ("relu",), shard=shard)
        elif child == "relu":
            pass  # bn1's call applied it
        elif child == "maxpool":
            x = F.max_pool2d(x, 3, 2, 1)
        else:
            si = int(child[-1]) - 1
            blocks = []
            for bi, bp in enumerate(params[child]):
                x, nb = _apply_block_train(bp, x, 1 if (si == 0 or bi > 0) else 2, shard)
                blocks.append(nb)
            new_params[child] = blocks
    return _nhwc(x), new_params
