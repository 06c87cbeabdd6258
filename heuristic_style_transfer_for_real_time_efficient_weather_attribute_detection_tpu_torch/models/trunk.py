"""PatchGAN-style conv trunk.

Starting at ``ndf`` filters, add Conv(k, s, p) -> Norm -> LeakyReLU(0.2)
blocks, doubling the filters, while the receptive-field counter (starting
at ``patch_size``, divided by the stride each block) stays > 4 and the
current filter count is <= 512; then one final stride-1 block.

Each block's norm and LeakyReLU is one call of :func:`norm_leaky`: an
instance norm is one call of ``cuda_kernels.instance_norm_leaky`` (its
kernel, ``csrc/instance_norm_leaky.cu``, on the card; its plain version on
the CPU); batch and group norms are the plain chain.  Each call is a
``trunk.norm`` span of the port's tracer, off unless the tracer records.
The train-mode trunk keeps the plain chain.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from ..ops import cuda_kernels
from ..ops.nn import conv2d, init_conv, init_norm, leaky_relu
from ..ops.norms import apply_norm, train_batch_norm
from ..utils import trace


class ConvBlock(NamedTuple):
    cin: int
    cout: int
    kernel: int
    stride: int
    pad: int


def trunk_plan(
    ndf: int,
    patch_size: int,
    kernel: int,
    stride: int,
    pad: int,
    final_kernel: int,
    final_pad: int,
    in_nc: int = 3,
) -> Tuple[ConvBlock, ...]:
    """Static layer plan for the doubling trunk + its final s1 block."""
    blocks: List[ConvBlock] = []
    cin, nf, rf = in_nc, ndf, float(patch_size)
    while rf > 4 and nf <= 512:
        blocks.append(ConvBlock(cin, nf, kernel, stride, pad))
        cin, nf, rf = nf, nf * 2, rf / stride
    blocks.append(ConvBlock(cin, nf, final_kernel, 1, final_pad))
    return tuple(blocks)


def init_trunk(
    g: torch.Generator, plan: Tuple[ConvBlock, ...], norm: str, conv_bias: bool
) -> List[Dict]:
    """Random trunk params drawn from ``g``, one {conv, norm} per planned block."""
    return [
        {"conv": init_conv(g, b.kernel, b.kernel, b.cin, b.cout, bias=conv_bias),
         "norm": init_norm(b.cout, norm)}
        for b in plan
    ]


def norm_leaky(x: torch.Tensor, p: Dict[str, torch.Tensor], norm: str,
               inplace: bool = False) -> torch.Tensor:
    """One block's norm of kind ``norm`` and LeakyReLU(0.2) on its conv
    output x.  ``inplace`` lets the kernel write over x where no gradient
    is recorded: pass it only for a conv output that nothing else reads."""
    with trace.span("trunk.norm", device=x.device):
        if norm == "instance":
            return cuda_kernels.instance_norm_leaky(x, p, 0.2, inplace=inplace)
        return leaky_relu(apply_norm(x, p, norm), 0.2)


def apply_trunk(
    params: List[Dict], x: torch.Tensor, plan: Tuple[ConvBlock, ...], norm: str
) -> torch.Tensor:
    """NHWC conv trunk: (Conv -> Norm -> LeakyReLU(0.2)) per planned block."""
    for p, b in zip(params, plan):
        x = norm_leaky(conv2d(x, p["conv"], stride=b.stride, padding=b.pad), p["norm"], norm,
                       inplace=True)
    return x


def apply_trunk_from_last_conv(
    params: List[Dict], last_conv_out: torch.Tensor, plan: Tuple[ConvBlock, ...], norm: str
) -> torch.Tensor:
    """Finish the trunk from the last block's raw conv output (before its
    norm and LeakyReLU), the activation the reference's Grad-CAM hooks; the
    caller's tensor is left as it is."""
    del plan
    return norm_leaky(last_conv_out, params[-1]["norm"], norm)


def trunk_last_conv(
    params: List[Dict], x: torch.Tensor, plan: Tuple[ConvBlock, ...], norm: str
) -> torch.Tensor:
    """The trunk up to and including the last block's convolution: its
    pre-norm output, the Grad-CAM target."""
    for p, b in zip(params[:-1], plan[:-1]):
        x = norm_leaky(conv2d(x, p["conv"], stride=b.stride, padding=b.pad), p["norm"], norm,
                       inplace=True)
    return conv2d(x, params[-1]["conv"], stride=plan[-1].stride, padding=plan[-1].pad)


def apply_trunk_train(
    params: List[Dict],
    x: torch.Tensor,
    plan: Tuple[ConvBlock, ...],
    norm: str,
    momentum: float = 0.1,
    shard=None,
) -> Tuple[torch.Tensor, List[Dict]]:
    """Train-mode trunk -> (features, trunk params with new running
    statistics).  Batch norm uses batch statistics and moves the running
    ones (momentum 0.1, unbiased variance), over the global batch with a
    ``shard`` (``norms.batch_norm_train``); instance and group norms keep
    no statistics, so train equals eval for them."""
    new_params: List[Dict] = []
    for p, b in zip(params, plan):
        x = conv2d(x, p["conv"], stride=b.stride, padding=b.pad)
        if norm == "batch":
            x, new_norm = train_batch_norm(x, p["norm"], shard, momentum)
        else:
            x = apply_norm(x, p["norm"], norm)
            new_norm = p["norm"]
        x = leaky_relu(x, 0.2)
        new_params.append({"conv": p["conv"], "norm": new_norm})
    return x, new_params
