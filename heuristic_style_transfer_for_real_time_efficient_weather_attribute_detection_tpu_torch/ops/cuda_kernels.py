"""Hand-written CUDA kernels of the port, their plain PyTorch versions, and
their launch counts.

Counterpart of the JAX package's ``ops/pallas_kernels.py``:

- ``patch_gram`` (``csrc/patch_gram.cu``) replaces ``patch_gram_tokens_pallas``,
  in float32 and in bf16;
- ``stem`` (``csrc/stem.cu``) replaces ``fused_stem``;
- ``fused_trunk_gram`` (``csrc/trunk_gram.cu``) replaces ``fused_trunk_gram``,
  the camera path's trunk + Gram on a ``fold_trunk_gram_weights`` fold;
- ``fused_head`` (``csrc/head.cu``) replaces ``fused_head``, the camera
  path's head on a ``models.pmg.fold_head_weights`` tree;
- ``dequant_matvec`` (``csrc/int8_matvec.cu``) replaces ``int8_pallas``
  (``tools/exp_rtm_int8_stream.py:77``), the RTM camera path's per-task
  int8 fold product and ``mlp_q8`` layers, in float32 and in bf16;
- ``gram_proj`` (``csrc/gram_proj.cu``) replaces ``make_proj_kernel.proj``
  (``tools/exp_pmg_projkernel.py:65``), the bf16 token projection of the
  PMG batch path read from the row-major Gram;
- ``tsne_repulsion`` (``csrc/tsne_repulsion.cu``) replaces no TPU kernel: the
  JAX package runs scikit-learn's t-SNE on the host, and this kernel sums
  the t-SNE's all-pairs repulsion on the card (``utils/tsne.py``);
- ``hdbscan_core_distances`` and ``hdbscan_prim_mst`` (``csrc/hdbscan.cu``)
  replace no TPU kernel either: the JAX package runs scikit-learn's HDBSCAN
  on the host, and these compute its core distances and its Prim's minimum
  spanning tree on the card, in float64, bit for bit scikit-learn's
  (``utils/hdbscan.py``);
- ``bn_epilogue`` (``csrc/bn_epilogue.cu``) replaces no TPU kernel either:
  XLA fuses the ResNet trunk's inference batch norm, residual sum and ReLU
  into each convolution's output, and this kernel is those eager passes as
  one, bit for bit (``models/resnet.py``);
- ``instance_norm_leaky`` (``csrc/instance_norm_leaky.cu``) replaces no TPU
  kernel either: XLA fuses the PM trunk's instance norm and LeakyReLU into
  each convolution's output, and this kernel is the eager chain's passes as
  one (``models/trunk.py``);
- ``bn_train`` (``csrc/bn_train.cu``) replaces no TPU kernel either: XLA
  fuses the ResNet trunk's train-mode batch norm, residual sum and ReLU,
  and their gradients, around each convolution, and these four kernels are
  each site's eager passes as two forward (statistics, apply) and two
  backward (the gradient's sums, the gradients) (``models/resnet.py``);
  its operator's CPU implementation runs the same steps, each as its plain
  version.

The sources are compiled for ``sm_90a`` by ``nvcc`` at first use, one
process per source started together, and linked into one shared library
under ``csrc/_build/`` (named by a hash of sources and flags, so a changed
source rebuilds).  The library has a plain C interface loaded with ctypes.

Each wrapper takes its plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel on the current stream or raises: a
missing ``nvcc``, a failed build or a refused launch is an error, never a
fallback.  ``LAUNCHES`` counts kernel launches per wrapper.

K1, K2 and K5, the kernels of the batch path, the RTM trunk's
``bn_epilogue`` and ``bn_train`` and the PM trunk's ``instance_norm_leaky``
are registered kernels: :func:`_register` makes each an operator
(``torch.library.custom_op`` in the ``wadt_torch`` namespace, e.g.
``torch.ops.wadt_torch.patch_gram``) and gives its wrapper one call rule.
Eager on the card the wrapper launches the kernel itself; a CPU tensor or a
traced call goes through the operator, whose CPU implementation is the
plain version and whose fake implementation gives the output's shape and
type to ``torch.export``, so an exported program carries the operators by
name and launches the kernels when it runs.  Importing this module
registers them.  All but K2 also carry gradients (``patch_gram_backward``,
``gram_proj_backward``, ``bn_epilogue_backward``,
``instance_norm_leaky_backward``: plain PyTorch, as the JAX package
differentiates them by XLA autodiff outside its kernels; ``bn_train``'s
backward is two kernels of its own), so the training path and Grad-CAM run
their forwards through the kernels and autograd through them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import IMAGENET_MEAN, IMAGENET_STD
from .attention import stacked_task_heads, task_query_pool, transformer_encoder
from .gram import split_patches
from .nn import cast_tree, leaky_relu
from .norms import EPS, batch_norm_affine, instance_norm, train_batch_norm
from .preprocess import s2d_pack

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(_CSRC, "_build")
_SOURCES = ("patch_gram.cu", "stem.cu", "trunk_gram.cu", "head.cu", "int8_matvec.cu",
            "gram_proj.cu", "tsne_repulsion.cu", "hdbscan.cu", "bn_epilogue.cu",
            "instance_norm_leaky.cu", "bn_train.cu")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_HEAD_CHUNK_ROWS = 256  # token_proj rows per block of csrc/head.cu's first launch

LAUNCHES: Dict[str, int] = {
    "patch_gram": 0, "stem": 0, "fused_trunk_gram": 0, "fused_head": 0, "dequant_matvec": 0,
    "gram_proj": 0, "tsne_repulsion": 0, "hdbscan_core": 0, "hdbscan_mst": 0, "bn_epilogue": 0,
    "instance_norm_leaky": 0, "bn_train": 0, "bn_train_backward": 0,
}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
            "kernels cannot be built"
        )
    return path


def _run_all(cmds, what: str) -> str:
    """Run the commands in parallel; raise with the compiler output if any fails."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError(f"{what} failed:\n" + "\n".join(failed))
    return "".join(logs)


def build(verbose: bool = False) -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library.

    ``verbose`` prints the compiler's report (registers, shared memory and
    spills of each kernel) when this call compiles.
    """
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        for src in _SOURCES:
            with open(os.path.join(_CSRC, src), "rb") as f:
                digest.update(f.read())
        so_path = os.path.join(_BUILD, f"libwadt_kernels_{digest.hexdigest()[:16]}.so")
        if not os.path.isfile(so_path):
            nvcc = _nvcc()
            os.makedirs(_BUILD, exist_ok=True)
            tmp = tempfile.mkdtemp(dir=_BUILD)
            try:
                objs = [os.path.join(tmp, src + ".o") for src in _SOURCES]
                log = _run_all(
                    [[nvcc, *_NVCC_FLAGS, "-c", os.path.join(_CSRC, src), "-o", obj]
                     for src, obj in zip(_SOURCES, objs)],
                    "nvcc compile",
                )
                tmp_so = os.path.join(tmp, "lib.so")
                _run_all([[nvcc, "-shared", *objs, "-o", tmp_so]], "nvcc link")
                os.replace(tmp_so, so_path)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            if verbose:
                print(log)
        lib = ctypes.CDLL(so_path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.wadt_patch_gram_f32, lib.wadt_patch_gram_bf16):
            fn.argtypes = [ptr, ptr] + [i32] * 8 + [ptr]
            fn.restype = i32
        lib.wadt_stem_u8.argtypes = [ptr] * 6 + [i32] * 13 + [ptr]
        lib.wadt_stem_u8.restype = i32
        lib.wadt_trunk_gram_u8.argtypes = [ptr] * 3 + [i32] * 12 + [ptr]
        lib.wadt_trunk_gram_u8.restype = i32
        ints = ctypes.POINTER(i32)
        lib.wadt_fused_head.argtypes = [
            ptr, ptr, i32, ptr, ptr, ptr, ptr, i32, ints, ints, ints, i32, i32,
            i32, ptr, ptr, ptr, ptr, i32, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.wadt_fused_head.restype = i32
        for fn in (lib.wadt_dequant_matvec, lib.wadt_dequant_matvec_bf16):
            fn.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
            fn.restype = i32
        lib.wadt_gram_proj_bf16.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.wadt_gram_proj_bf16.restype = i32
        lib.wadt_tsne_repulsion.argtypes = [ptr] * 3 + [i32, ptr]
        lib.wadt_tsne_repulsion.restype = i32
        lib.wadt_hdbscan_core.argtypes = [ptr] + [i32] * 4 + [ptr, ptr]
        lib.wadt_hdbscan_core.restype = i32
        lib.wadt_hdbscan_mst.argtypes = [ptr, i32, ptr, i32, i32] + [ptr] * 4 + [i32, ptr, ptr, ptr]
        lib.wadt_hdbscan_mst.restype = i32
        lib.wadt_bn_epilogue.argtypes = [ptr] * 11 + [ctypes.c_longlong] + [i32] * 6 + [ptr]
        lib.wadt_bn_epilogue.restype = i32
        lib.wadt_instance_norm_leaky.argtypes = [ptr] * 6 + [i32] * 3 + [ctypes.c_float, i32, ptr]
        lib.wadt_instance_norm_leaky.restype = i32
        lib.wadt_bn_train_stats.argtypes = [ptr, ptr] + [i32] * 5 + [ptr]
        lib.wadt_bn_train_stats.restype = i32
        f64 = ctypes.c_double
        lib.wadt_bn_train_apply.argtypes = [ptr] * 17 + [i32] * 4 + [f64] + [i32] * 4 + [ptr]
        lib.wadt_bn_train_apply.restype = i32
        lib.wadt_bn_train_grad_stats.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.wadt_bn_train_grad_stats.restype = i32
        lib.wadt_bn_train_grad_apply.argtypes = [ptr] * 12 + [i32] * 4 + [f64] + [i32] * 4 + [ptr]
        lib.wadt_bn_train_grad_apply.restype = i32
        _lib = lib
        return lib


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device,
                shape: Optional[Sequence[int]] = None):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(kernel: str, fn, device: torch.device, *args, count: bool = True) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed") from torch.cuda.CudaError(err)
    if count:
        LAUNCHES[kernel] += 1


def _require_cpu_or_cuda(x: torch.Tensor, kernel: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{kernel}: tensors on {x.device.type} are not supported "
            "(CUDA runs the kernel, the CPU its plain version)"
        )


def _eager(x: torch.Tensor) -> bool:
    """No trace records the call, so a registered kernel's call may skip
    its operator: x a plain tensor (no fake or functional subclass, as a
    trace makes), no dispatch mode active (``make_fx``) and no compiler
    tracing."""
    return (type(x) is torch.Tensor and not torch._C._len_torch_dispatch_stack()
            and not torch.compiler.is_compiling())


def _records_grad(args: tuple) -> bool:
    """Whether autograd records a gradient through any tensor of ``args``."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in args)


def _register(name: str, launch, plain, fake, setup=None, backward=None):
    """Register the operator ``wadt_torch::<name>`` and return the one call
    its wrapper makes, ``call(*args)`` with the operator's arguments.

    The operator runs ``launch`` on CUDA tensors and ``plain`` on CPU ones;
    ``fake`` gives its output's shape and type to a trace, and ``setup``
    and ``backward`` (both or neither) its gradient.  The call rule, the
    same for every registered kernel: an eager call (:func:`_eager`) on a
    CUDA tensor runs ``launch`` itself or, where autograd records a
    gradient (:func:`_records_grad`) and the kernel has a backward, an
    autograd function of ``launch`` with the same ``setup`` and
    ``backward``; a CPU tensor, a traced call (``torch.export``,
    ``make_fx``, the compiler) and a gradient through a kernel without a
    backward go through the operator, so an exported program carries it by
    name.  Skipping the operator saves its dispatch, 30–55 µs of host time
    a call on the card, and the import of ``torch._dynamo`` that its first
    call makes, seconds of set-up.  ``call(..., launcher=f)`` runs ``f`` in
    place of ``launch`` on the eager path that records no gradient (the
    instance norm's write over its input)."""
    op = torch.library.custom_op(f"wadt_torch::{name}", launch, mutates_args=(),
                                 device_types="cuda")
    op.register_kernel("cpu", plain)
    op.register_fake(fake)
    overload = getattr(torch.ops.wadt_torch, name).default
    with_grad = overload
    if backward is not None:
        op.register_autograd(backward, setup_context=setup)
        with_grad = type(f"_{name}_grad", (torch.autograd.Function,), {
            "forward": staticmethod(launch), "setup_context": staticmethod(setup),
            "backward": staticmethod(backward)}).apply

    def call(*args, launcher=launch):
        x = args[0]
        _require_cpu_or_cuda(x, name)
        if x.is_cuda and _eager(x):
            return with_grad(*args) if _records_grad(args) else launcher(*args)
        return overload(*args)

    return call


# ---------------------------------------------------------------------------
# K1: per-patch Gram tokens
# ---------------------------------------------------------------------------


def patch_gram_plain(x: torch.Tensor, div: int) -> torch.Tensor:
    """Plain PyTorch per-patch Gram: NHWC [B,H,W,C] -> [B, div*div, C*C] of
    x's dtype, summed in float32 (float64 for float64 x)."""
    patches, area = split_patches(x, div)
    b, np_, _, c = patches.shape
    p = patches.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    g = torch.einsum("bpnc,bpnd->bpcd", p, p) * (1.0 / float(area))
    return g.reshape(b, np_, c * c).to(x.dtype)


class PatchGramPlan(NamedTuple):
    """Launch plan of ``csrc/patch_gram.cu``: ``units`` = B * div^2 * ``bands``
    (image, patch, band of ``band`` whole output rows), walked by ``grid``
    persistent blocks (block k takes units k, k + grid, ...); a stage stages
    up to ``kc`` pixels of a patch (``chunks`` stages a unit), each pixel a
    row of ``ld`` elements, into one of two input slots, a stage ahead;
    ``n_tiles`` float32 6 x 6 thread tiles (bf16: 16 x 16 warp tiles) a
    unit; ``smem`` bytes of shared memory a block."""

    ph: int
    pw: int
    kc: int
    chunks: int
    band: int
    bands: int
    units: int
    grid: int
    ld: int
    n_tiles: int
    smem: int


_PG_THREADS = 256  # csrc/patch_gram.cu kThreads: 8 warps
_PG_TILE = 6  # float32: a thread's output tile edge
_PG_WARP_TILES = 8 * 4  # bf16: 16 x 16 tiles a unit may have (8 warps x kWarpTiles)
_SM_SMEM = 228 * 1024  # shared memory of one SM; each block also reserves 1 KB
_PG_BLOCKS_PER_SM = {False: 2, True: 3}  # csrc/patch_gram.cu __launch_bounds__, float32 / bf16


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _patch_gram_layout(c: int, kc: int, band: int, bf16: bool) -> Tuple[int, int, int]:
    """(ld, n_tiles, smem) of csrc/patch_gram.cu ``layout``."""
    es = 2 if bf16 else 4
    ld = _up(c, 16) + 8 if bf16 else _up(c, 12)
    if bf16:
        g = _up(c, 16) // 16
        n_tiles = g * (g + 1) // 2 if band >= c else (_up(band, 16) // 16) * g
    else:
        n = -(-c // _PG_TILE)
        n_tiles = n * (n + 1) // 2 if band >= c else (band // _PG_TILE) * n
    smem = 2 * kc * ld * es + 2 * _up(band * c * es, 16) + (2 * _up(4 * c, 16) if bf16 else 0)
    return ld, n_tiles, smem


@functools.lru_cache(maxsize=64)
def patch_gram_plan(b: int, h: int, w: int, c: int, div: int, sms: int,
                    bf16: bool = False) -> PatchGramPlan:
    """The launch plan of K1 for x [b, h, w, c] and a div x div grid on a
    card of ``sms`` SMs: one band of all C rows where its tiles fit the
    block (the upper triangle of float32 6 x 6 tiles in 256 threads, or of
    bf16 16 x 16 tiles, four a warp), else bands of whole tile rows; the widest
    stage of 64, 32 or 16 pixels (no wider than the patch) whose shared
    memory fits 227 KB; as many blocks an SM as fit, up to the kernel's
    launch bounds (two in float32, three in bf16), never more blocks than
    units.  (At the main shape, [256, 14, 14, 96] div 3 on 132 SMs: 2,304
    units of one 32-pixel stage, 264 blocks in float32 and 396 in bf16.)
    Raises ValueError for a C too wide for the kernel."""
    ph, pw = -(-h // div), -(-w // div)
    area = ph * pw
    if bf16:
        groups = _up(c, 16) // 16
        rows = (_PG_WARP_TILES // groups) * 16
        band = c if groups * (groups + 1) // 2 <= _PG_WARP_TILES else rows
    else:
        n = -(-c // _PG_TILE)
        rows = (_PG_THREADS // n) * _PG_TILE
        band = c if n * (n + 1) // 2 <= _PG_THREADS else rows
    if band == 0:
        raise ValueError(f"patch_gram: C = {c} is too wide for the kernel")
    bands = -(-c // band)
    for kc in (64, 32, 16):
        if kc > 16 and kc // 2 >= _up(area, 16):
            continue
        ld, n_tiles, smem = _patch_gram_layout(c, kc, band, bf16)
        if smem <= _SMEM_MAX:
            break
    else:
        raise ValueError(f"patch_gram: C = {c} needs {smem} bytes of shared memory a block; "
                         f"the limit is {_SMEM_MAX}")
    units = b * div * div * bands
    per_sm = next(n for n in range(_PG_BLOCKS_PER_SM[bf16], 0, -1)
                  if n * (smem + 1024) <= _SM_SMEM or n == 1)
    return PatchGramPlan(ph, pw, kc, -(-area // kc), band, bands, units,
                         min(units, per_sm * sms), ld, n_tiles, smem)


def patch_gram_tiles(c: int, bf16: bool = False) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
    """(edge, tiles): the output tiles of one band of all C rows, on and
    above the diagonal, in the order ``csrc/patch_gram.cu`` hands them out.
    float32: 6 x 6 thread tiles, thread q the q-th, diagonal d = tj - ti
    after diagonal; bf16: 16 x 16 warp tiles, tile q to warp q % 8, row by
    row.  Each tile is written as it is and, off the diagonal, transposed."""
    edge = 16 if bf16 else _PG_TILE
    n = -(-c // edge)
    if bf16:
        return edge, tuple((i, j) for i in range(n) for j in range(i, n))
    return edge, tuple((i, i + d) for d in range(n) for i in range(n - d))


def patch_gram(x: torch.Tensor, div: int) -> torch.Tensor:
    """Replicate-pad, split into div*div row-major patches, per-patch
    ``P^T P / area`` summed in float32 -> [B, div*div, C*C] of x's dtype
    (bf16: rounded once, to nearest even).

    The registered kernel ``wadt_torch::patch_gram`` (:func:`_register`'s
    rule).  CPU tensor: the plain version.  CUDA tensor: the ``patch_gram``
    kernel on :func:`patch_gram_plan`'s persistent grid, float32 or bf16
    NHWC contiguous only.
    """
    return _patch_gram(x, div)


def _patch_gram_launch(x: torch.Tensor, div: int) -> torch.Tensor:
    """K1 on a CUDA tensor, the CUDA implementation of ``wadt_torch::patch_gram``."""
    if x.ndim != 4 or div < 1:
        raise ValueError(f"patch_gram: expected NHWC and div >= 1, got {tuple(x.shape)}, {div}")
    dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    _check_cuda("patch_gram x", x, dtype, x.device)
    b, h, w, c = x.shape
    out = torch.empty((b, div * div, c * c), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = patch_gram_plan(b, h, w, c, div, _sm_count(x.device), dtype == torch.bfloat16)
    lib = build()
    fn = lib.wadt_patch_gram_bf16 if dtype == torch.bfloat16 else lib.wadt_patch_gram_f32
    _launch("patch_gram", fn, x.device, x.data_ptr(), out.data_ptr(), b, h, w, c, div, plan.kc,
            plan.band, plan.grid)
    return out


def _patch_gram_fake(x: torch.Tensor, div: int) -> torch.Tensor:
    b, _, _, c = x.shape
    return x.new_empty((b, div * div, c * c))


def patch_gram_backward(x: torch.Tensor, div: int, dg: torch.Tensor) -> torch.Tensor:
    """The gradient of ``patch_gram`` at x for the output gradient dg
    [B, div*div, C*C]: per patch ``dP = P (dG + dG^T) / area``, then the
    adjoint of ``split_patches`` (patches back into the padded map, and the
    replicate pad's rows and columns added into the last real row and
    column).  Plain products: the sums are float32 (float64 for float64 x),
    rounded once to x's dtype.  On the card the forward stays the kernel;
    the JAX package computes this backward by XLA autodiff outside any
    Pallas kernel, so it has no kernel either."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    patches, area = split_patches(x.to(acc), div)
    b, np_, _, c = patches.shape
    d = dg.to(acc).reshape(b, np_, c, c)
    dp = torch.matmul(patches, d + d.transpose(-1, -2)) * (1.0 / float(area))
    _, h, w, _ = x.shape
    hp, wp = h + (-h) % div, w + (-w) % div
    dx = (dp.reshape(b, div, div, hp // div, wp // div, c).permute(0, 1, 3, 2, 4, 5)
          .reshape(b, hp, wp, c))
    if hp > h:
        dx = torch.cat([dx[:, : h - 1], dx[:, h - 1:].sum(1, keepdim=True)], 1)
    if wp > w:
        dx = torch.cat([dx[:, :, : w - 1], dx[:, :, w - 1:].sum(2, keepdim=True)], 2)
    return dx.to(x.dtype)


def _patch_gram_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(inputs[0])
    ctx.div = inputs[1]


def _patch_gram_grad(ctx, dg):
    (x,) = ctx.saved_tensors
    return patch_gram_backward(x, ctx.div, dg), None


_patch_gram = _register("patch_gram", _patch_gram_launch, patch_gram_plain, _patch_gram_fake,
                        _patch_gram_setup, _patch_gram_grad)


# ---------------------------------------------------------------------------
# K2: uint8 stem (normalize folded into the weight, k=s p0 conv, affine, LReLU)
# ---------------------------------------------------------------------------


def stem_plain(
    x8: torch.Tensor, w2d: torch.Tensor, scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], k: int, leaky: bool = True,
    out_dtype: torch.dtype = torch.float32, bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch stem: space-to-depth pack, one GEMM, affine, LeakyReLU.

    bf16 (``out_dtype``): the float32 GEMM plus ``bias`` rounded to bf16,
    then ``y * scale + shift`` and the LeakyReLU as bf16 operations (each
    rounds once), the norm left out where ``scale`` is None."""
    u = s2d_pack(x8, k).to(torch.float32)
    if out_dtype == torch.bfloat16:
        y = (torch.matmul(u, w2d) + bias).to(torch.bfloat16)
        if scale is not None:
            y = y * scale + shift
    else:
        y = torch.matmul(u, w2d) * scale + shift
    return leaky_relu(y, 0.2) if leaky else y


class StemPlan(NamedTuple):
    """Launch plan of ``csrc/stem.cu``: tiles of ``rows`` whole output rows
    (``tiles`` of them over the B * H/k rows), walked by ``grid`` persistent
    blocks (block k takes tiles k, k + grid, ...) through a ring of
    ``stages`` input slots of ``stage_bytes``; ``chunks`` 32-channel
    chunks; ``bulk``: each output row's
    input run arrives by one ``cp.async.bulk`` (else the producer warp
    copies its bytes: the plain path); ``tma``: whole 16-pixel m-tiles
    leave by tensor stores from shared memory (else, and for a tile's last
    partial m-tile, straight from the fragments); ``smem`` bytes a block."""

    rows: int
    tiles: int
    stages: int
    grid: int
    chunks: int
    bulk: bool
    tma: bool
    stage_bytes: int
    smem: int

    @property
    def path(self) -> str:
        return f"{'bulk' if self.bulk else 'plain'} loads, {'tensor' if self.tma else 'direct'} stores"


_STEM_BLOCKS_PER_SM = 3  # csrc/stem.cu __launch_bounds__
_STEM_STAGES = 3  # slots of the input ring (3 beat 4 and 2 at the main shape)
_STEM_CONSUMERS = 4  # consumer warps a block, each with
_STEM_OUT_BUFS = 4  # output buffers of 16 pixels x 32 channels
_STEM_K_STEPS = 3  # csrc/stem.cu kKS: 16-deep k-steps, 4 words of 4 bytes each
_STEM_MAX_COUT = 128  # four consumer warps of 32 channels
_STEM_TILES_PER_BLOCK = 8  # fewer tiles a block leave a long tail


def _stem_words(k: int, cin: int) -> Tuple[int, int]:
    """(words a pixel's input row, words a pixel): 4-byte words of k*cin bytes."""
    wpr = -(-(k * cin) // 4)
    return wpr, k * wpr


def _stem_chunks(cout: int) -> int:
    n = -(-cout // 32)
    return 1 if n <= 1 else 2 if n <= 2 else 4


def _stem_layout(w: int, cin: int, k: int, rows: int, stages: int, chunks: int,
                 bf16: bool) -> Tuple[int, int]:
    """(stage_bytes, smem) of csrc/stem.cu ``layout``."""
    stage = _up(rows * k * w * cin + 16, 128)
    out = _up(stages * stage, 1024) + _STEM_CONSUMERS * _STEM_OUT_BUFS * 16 * 32 * (2 if bf16 else 4)
    table = out + 3 * chunks * 32 * 4
    return stage, _up(table + 4 * rows * (w // k), 16) + 16 * stages + 1024


@functools.lru_cache(maxsize=64)
def stem_plan(b: int, h: int, w: int, cin: int, k: int, cout: int, sms: int,
              aligned: bool = True, bf16: bool = False) -> StemPlan:
    """The launch plan of K2 for uint8 x [b, h, w, cin], a k x k stride-k
    stem to ``cout`` channels (float32 or ``bf16`` out), on a card of
    ``sms`` SMs: of the tile heights (4, 2 or 1 output rows) and rings (3
    or 2 slots) whose shared memory lets the most blocks share an SM (at
    most three), the most rows that still give each block of a full grid
    at least 8 tiles, else one row, each with the most slots that fit; as
    many blocks as fit, never more than the tiles.  The bulk path needs x
    16-byte aligned (``aligned``) and k*w*cin and h*w*cin multiples of 16;
    the tensor stores need cout 32, 64 or 128.  (Main shape, [256, 224,
    224, 3] -> 32 on 132 SMs: 3,584 tiles of 4 rows, 3 slots, 396 blocks;
    batch 1: 56 tiles of one row on 56 SMs.)  Raises ValueError for a stem
    the kernel does not take."""
    if _stem_words(k, cin)[1] > 4 * _STEM_K_STEPS or cout > _STEM_MAX_COUT or cout < 1:
        raise ValueError(
            f"stem: the kernel takes at most {4 * _STEM_K_STEPS} 4-byte words of input a pixel "
            f"(k*ceil(k*cin/4)) and 1 to {_STEM_MAX_COUT} channels; got k={k}, cin={cin}, "
            f"cout={cout}"
        )
    nrows = b * (h // k)
    chunks = _stem_chunks(cout)
    bulk = aligned and (k * w * cin) % 16 == 0 and (h * w * cin) % 16 == 0

    def per_sm(smem: int) -> int:
        return next(n for n in range(_STEM_BLOCKS_PER_SM, 0, -1) if n * (smem + 1024) <= _SM_SMEM or n == 1)

    fits = []  # (blocks an SM, rows, stages): each rows' most stages that fit the most blocks
    for r in (4, 2, 1):
        shapes = [(st, _stem_layout(w, cin, k, r, st, chunks, bf16)[1]) for st in (_STEM_STAGES, 2)]
        shapes = [(per_sm(sm), st) for st, sm in shapes if sm <= _SMEM_MAX]
        if shapes:
            n, st = max(shapes)
            fits.append((n, r, st))
    if not fits:
        raise ValueError(f"stem: an output row's input ({k * w * cin} bytes) does not fit "
                         f"the kernel's shared memory")
    most = max(n for n, _, _ in fits)
    fits = [(r, st) for n, r, st in fits if n == most]
    full = most * sms * _STEM_TILES_PER_BLOCK
    rows, stages = next(((r, st) for r, st in fits if -(-nrows // r) >= full), fits[-1])
    stage_bytes, smem = _stem_layout(w, cin, k, rows, stages, chunks, bf16)
    tiles = -(-nrows // rows)
    return StemPlan(rows, tiles, stages, min(tiles, most * sms), chunks, bulk, cout == 32 * chunks,
                    stage_bytes, smem)


def stem_k_order(k: int, cin: int) -> Tuple[Tuple[int, int, int], ...]:
    """The stem kernel's K order, for each k index of its mma k-steps (16 a
    step): (dy, j, row), the byte that the kernel reads at dy * W*cin + j
    under a pixel's first staged byte, and the row of ``w2d`` that it meets
    (dy * k*cin + j), or -1 for a zero row.  A pixel's input is k rows of
    k*cin bytes cut into 4-byte words; word 4s + t of k-step s (t = lane %
    4) feeds the A fragment's columns 2t, 2t+1 (its bytes 0, 1) and 2t+8,
    2t+9 (bytes 2, 3).  A byte past k*cin in a row's last word, and every
    byte of a word past the pixel's last (read at dy = 0), meets a zero row."""
    span = k * cin
    wpr, words = _stem_words(k, cin)
    order = []
    for kk in range(16 * _STEM_K_STEPS):
        s, r = divmod(kk, 16)
        wi = 4 * s + (r % 8) // 2
        byte = r % 2 + (2 if r >= 8 else 0)
        if wi >= words:
            order.append((0, byte, -1))
            continue
        dy, jw = divmod(wi, wpr)
        j = 4 * jw + byte
        order.append((dy, j, dy * span + j if j < span else -1))
    return tuple(order)


def stem_weight_split(w2d: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The stem kernel's split of a float32 weight into bf16 parts, hi =
    bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid), each difference
    exact in float32; the three sum to w exactly (8 + 8 + 8 significant
    bits).  The bf16 mode's weight is bf16-valued: it takes hi alone."""
    out, rest = [], w2d.to(torch.float32)
    for _ in range(3):
        p = rest.to(torch.bfloat16)
        out.append(p)
        rest = rest - p.to(torch.float32)
    return tuple(out)


def stem(
    x8: torch.Tensor, w2d: torch.Tensor, scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], k: int, leaky: bool = True,
    out_dtype: torch.dtype = torch.float32, bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """uint8 NHWC [B,H,W,cin] -> [B,H/k,W/k,cout] of ``out_dtype``.

    float32: ``act(scale * (s2d(x) @ w2d) + shift)``, act = LeakyReLU(0.2)
    if ``leaky``; ``bias`` None.  bf16 (the bf16 batch path): ``y0 =
    bf16(s2d(x) @ w2d + bias)``, then, where ``scale`` and ``shift`` (bf16,
    the batch norm's affine) are given, ``bf16(bf16(y0 * scale) + shift)``,
    then the LeakyReLU in bf16: each step rounds once, as the chain of
    PyTorch bf16 operations does.  ``w2d`` is the kernel == stride == k
    conv weight as float32 [k*k*cin, cout] in (dy, dx, ci) row order, with
    the normalize folded in (bf16-valued in bf16: the kernel takes it as
    bf16).  The registered kernel ``wadt_torch::stem`` (:func:`_register`'s
    rule), with no gradient.  CPU tensor: the plain version.  CUDA tensor:
    the ``stem`` kernel on :func:`stem_plan`'s plan.
    """
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stem: out_dtype must be float32 or bfloat16, got {out_dtype}")
    bf16 = out_dtype == torch.bfloat16
    if bf16 and (bias is None or (scale is None) != (shift is None)):
        raise ValueError("stem: bf16 takes a bias, and scale and shift both or neither")
    if not bf16 and (bias is not None or scale is None or shift is None):
        raise ValueError("stem: float32 takes scale and shift and no bias")
    return _stem(x8, w2d, scale, shift, k, leaky, bf16, bias)


def _stem_launch(
    x8: torch.Tensor, w2d: torch.Tensor, scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], k: int, leaky: bool, bf16: bool, bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """K2 on CUDA tensors, the CUDA implementation of ``wadt_torch::stem``."""
    out_dtype = torch.bfloat16 if bf16 else torch.float32
    if x8.ndim != 4:
        raise ValueError(f"stem: expected uint8 NHWC, got {tuple(x8.shape)}")
    b, h, w, cin = x8.shape
    cout = w2d.shape[-1]
    dev = x8.device
    if w2d.shape != (k * k * cin, cout):
        raise ValueError(f"stem: weight {tuple(w2d.shape)} does not fit k={k}, cin={cin}")
    if h < k or w < k:
        raise ValueError(f"stem: image {h}x{w} is smaller than the kernel {k}")
    _check_cuda("stem x", x8, torch.uint8, dev)
    _check_cuda("stem w", w2d, torch.float32, dev)
    vec_dtype = torch.bfloat16 if bf16 else torch.float32
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None:
            _check_cuda(f"stem {name}", t, vec_dtype, dev, (cout,))
    if bias is not None:
        _check_cuda("stem bias", bias, torch.float32, dev, (cout,))
    out = torch.empty((b, h // k, w // k, cout), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    plan = stem_plan(b, h, w, cin, k, cout, _sm_count(dev), x8.data_ptr() % 16 == 0, bf16)
    mode = 0 if not bf16 else 2 if scale is not None else 1
    lib = build()
    _launch("stem", lib.wadt_stem_u8, dev, x8.data_ptr(), w2d.data_ptr(),
            None if scale is None else scale.data_ptr(), None if shift is None else shift.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), b, h, w, cin, k, cout, mode,
            int(leaky), plan.rows, plan.stages, plan.grid, int(plan.bulk), int(plan.tma))
    return out


def _stem_cpu(x8, w2d, scale, shift, k, leaky, bf16, bias):
    return stem_plain(x8, w2d, scale, shift, k, leaky,
                      torch.bfloat16 if bf16 else torch.float32, bias)


def _stem_fake(x8, w2d, scale, shift, k, leaky, bf16, bias):
    b, h, w, _ = x8.shape
    return x8.new_empty((b, h // k, w // k, w2d.shape[-1]),
                        dtype=torch.bfloat16 if bf16 else torch.float32)


_stem = _register("stem", _stem_launch, _stem_cpu, _stem_fake)


# ---------------------------------------------------------------------------
# K3: fused trunk + Gram (the camera path's trunk)
# ---------------------------------------------------------------------------


def supports_fused_trunk_gram(spec) -> bool:
    """True for trunk plans of exactly [k=s pad0, k=s pad0, 1x1] (the shipped
    PMG shape) with no SE block."""
    plan = spec.plan
    if len(plan) != 3:
        return False
    b0, b1, b2 = plan
    return (
        b0.kernel == b0.stride and b0.pad == 0 and b0.kernel > 1
        and b1.kernel == b1.stride and b1.pad == 0 and b1.kernel > 1
        and b2.kernel == 1 and b2.stride == 1 and b2.pad == 0
        and not spec.use_channel_attention
    )


def fold_trunk_gram_weights(params: Dict[str, Any], spec) -> Tuple[torch.Tensor, ...]:
    """Fold the normalize and the inference batch norms into the GEMM chain.

    Returns (W0bd, B0, W2, B2, W3, B3, Wcp, Bcp), the JAX package's eight
    arrays bit for bit: bf16 weights, float32 biases, on the params' device.
    W0bd is conv1 as a block-diagonal [K*K*cin, k2*k2*c0] matrix (K = k1*k2)
    in the K-granular space-to-depth channel order.  Raises ValueError for
    another plan and NotImplementedError for a norm other than batch.
    """
    if not supports_fused_trunk_gram(spec):
        raise ValueError(
            "the fused trunk kernel needs a [k=s p0, k=s p0, 1x1] trunk plan without SE"
        )
    b0, b1, b2 = spec.plan
    k1, k2 = b0.kernel, b1.kernel
    K = k1 * k2

    def host(t) -> np.ndarray:
        return t.detach().cpu().numpy()

    def bn_affine(norm):
        if spec.norm == "batch":
            inv = host(norm["scale"]) / np.sqrt(host(norm["var"]) + 1e-5)
            return (inv.astype(np.float32),
                    (host(norm["bias"]) - host(norm["mean"]) * inv).astype(np.float32))
        raise NotImplementedError(
            "fused trunk kernel folds inference BatchNorm only; instance-norm "
            "trunks need per-image statistics (use the packed path)"
        )

    p0, p1, p2 = params["trunk"]
    device = p0["conv"]["w"].device
    w0 = host(p0["conv"]["w"]).astype(np.float32)  # (k1,k1,cin,cout0)
    nscale = 1.0 / (255.0 * np.asarray(IMAGENET_STD, np.float32))
    nshift = np.asarray(IMAGENET_MEAN, np.float32) / np.asarray(IMAGENET_STD, np.float32)
    s0, sh0 = bn_affine(p0["norm"])
    w0n = (w0 * nscale[None, None, :, None]) * s0[None, None, None, :]
    bias0 = -np.einsum("hwio,i->o", w0, nshift) * s0 + sh0
    if p0["conv"].get("b") is not None:
        bias0 = bias0 + host(p0["conv"]["b"]) * s0
    cin, c0 = b0.cin, b0.cout
    W0bd = np.zeros((K * K * cin, k2 * k2 * c0), np.float32)
    for u in range(k2):
        for v in range(k2):
            col = (u * k2 + v) * c0
            for dy in range(k1):
                for dx in range(k1):
                    row = ((k1 * u + dy) * K + (k1 * v + dx)) * cin
                    W0bd[row:row + cin, col:col + c0] = w0n[dy, dx]
    B0 = np.tile(bias0, k2 * k2)

    s1, sh1 = bn_affine(p1["norm"])
    W2 = host(p1["conv"]["w"]).astype(np.float32).reshape(k2 * k2 * c0, b1.cout) * s1[None, :]
    B2 = sh1.copy()
    if p1["conv"].get("b") is not None:
        B2 = B2 + host(p1["conv"]["b"]) * s1

    s2, sh2 = bn_affine(p2["norm"])
    W3 = host(p2["conv"]["w"]).astype(np.float32)[0, 0] * s2[None, :]
    B3 = sh2.copy()
    if p2["conv"].get("b") is not None:
        B3 = B3 + host(p2["conv"]["b"]) * s2

    cp = params["chan_proj"]
    Wcp = host(cp["w"]).astype(np.float32)[0, 0]
    Bcp = (host(cp["b"]).astype(np.float32) if cp.get("b") is not None
           else np.zeros(Wcp.shape[1], np.float32))

    def bf16(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).to(device)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return (bf16(W0bd), f32(B0), bf16(W2), f32(B2), bf16(W3), f32(B3), bf16(Wcp), f32(Bcp))


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def fused_trunk_gram_plain(x8: torch.Tensor, weights, spec) -> torch.Tensor:
    """Plain PyTorch trunk + Gram: K-granular space-to-depth pack (the TPU
    kernel's input layout), the four GEMMs with bf16 operands and float32
    sums, each operand rounded to bf16 where the TPU kernel casts, replicate
    pad, float32 per-patch Gram."""
    w0, b0, w2, b2, w3, b3, wcp, bcp = weights
    z16 = s2d_pack(x8, spec.plan[0].kernel * spec.plan[1].kernel)
    a = _bf16_round(leaky_relu(torch.matmul(z16.to(torch.float32), w0.float()) + b0))
    b = _bf16_round(leaky_relu(torch.matmul(a, w2.float()) + b2))
    c = _bf16_round(leaky_relu(torch.matmul(b, w3.float()) + b3))
    z = torch.matmul(c, wcp.float()) + bcp
    return patch_gram_plain(z, spec.patch_div)


class TrunkGramPlan(NamedTuple):
    """Launch plan of ``csrc/trunk_gram.cu`` for one spec and frame size:
    one cluster of ``cluster`` blocks per (image, patch) of the ``ph`` x
    ``pw`` patches on the ``hf`` x ``wf`` final grid; block r computes the
    patch's pixels [pix[r], pix[r+1]) (row-major, replicate-padded pixels
    included) through the four GEMMs and the Gram's rows [rows[r],
    rows[r+1]).  ``widths``: the GEMM widths padded to 16 (conv1's depth
    k1*k1*cin, c0, c1, c2, gc); ``seg``: byte offsets of the four GEMMs'
    weights (each followed by its float32 bias) in the packed weight buffer,
    its size last; ``smem`` bytes of shared memory a block."""

    hf: int
    wf: int
    ph: int
    pw: int
    cluster: int
    pix: Tuple[int, ...]
    rows: Tuple[int, ...]
    widths: Tuple[int, ...]
    seg: Tuple[int, ...]
    smem: int


_TRUNK_MAX_CLUSTER = 8  # the portable cluster size


def _trunk_dims(spec):
    b0, b1, b2 = spec.plan
    return b0.kernel, b1.kernel, b0.cin, b0.cout, b1.cout, b2.cout, spec.gram_channels


def trunk_gram_plan(spec, h: int, w: int) -> TrunkGramPlan:
    """The launch plan of K3 for ``spec`` on h x w frames: the fewest blocks
    (at most 8) that give each block the fewest of a patch's pixels, in
    even contiguous shares, and even shares of the Gram's rows.  (Shipped
    spec at 224 px: 5 x 5 patches, clusters of 7 blocks of 3-4 pixels.)
    Raises ValueError where a block's shared memory would pass 227 KB."""
    if not supports_fused_trunk_gram(spec):
        raise ValueError(
            "the fused trunk kernel needs a [k=s p0, k=s p0, 1x1] trunk plan without SE"
        )
    k1, k2, cin, c0, c1, c2, gc = _trunk_dims(spec)
    K, div = k1 * k2, spec.patch_div
    hf, wf = h // K, w // K
    ph, pw = -(-hf // div), -(-wf // div)
    area = ph * pw
    most = -(-area // _TRUNK_MAX_CLUSTER)  # the fewest pixels a block can have
    cluster = -(-area // most)
    pix = tuple(r * area // cluster for r in range(cluster + 1))
    rows = tuple(r * gc // cluster for r in range(cluster + 1))
    kd0p, c0p, c1p, c2p, gcp = (_up(v, 16) for v in (k1 * k1 * cin, c0, c1, c2, gc))
    cells = k2 * k2
    seg = [0]
    for r, c in ((kd0p, c0p), (cells * c0p, c1p), (c1p, c2p), (c2p, gcp)):
        seg.append(seg[-1] + r * (c + 8) * 2 + c * 4)
    mpix = -(-area // cluster)
    m1, m2 = _up(mpix * cells, 16), _up(mpix, 16)
    smem = (seg[-1] + m1 * (kd0p + 8) * 2 + m2 * (cells * c0p + 8) * 2 + m2 * (c1p + 8) * 2
            + m2 * (c2p + 8) * 2 + area * gcp * 4 + 4 * 8 + _up(K * cin * 4, 16))
    if smem > _SMEM_MAX:
        raise ValueError(f"fused_trunk_gram: the spec needs {smem} bytes of shared memory a block; "
                         f"the limit is {_SMEM_MAX}")
    return TrunkGramPlan(hf, wf, ph, pw, cluster, pix, rows, (kd0p, c0p, c1p, c2p, gcp),
                         tuple(seg), smem)


def pack_trunk_gram_weights(weights, spec) -> torch.Tensor:
    """A :func:`fold_trunk_gram_weights` fold in ``csrc/trunk_gram.cu``'s
    shared-memory layout, as one uint8 tensor on the fold's device: for
    conv1 (the dense (0, 0) block of W0bd), conv2, the 1x1 conv and
    ``chan_proj`` in turn, the bf16 weight [rows, cols + 8] and then the
    float32 bias [cols], every width padded to 16 with zeros (conv2's rows
    per sub-cell)."""
    w0bd, b0, w2, b2, w3, b3, wcp, bcp = weights
    k1, k2, cin, c0, c1, c2, gc = _trunk_dims(spec)
    K, cells = k1 * k2, k2 * k2
    kd0p, c0p, c1p, c2p, gcp = (_up(v, 16) for v in (k1 * k1 * cin, c0, c1, c2, gc))
    # row (dy*k1 + dx)*cin + ci of conv1's block is row (dy*K + dx)*cin + ci of W0bd
    idx = torch.tensor([(dy * K + dx) * cin + ci for dy in range(k1) for dx in range(k1)
                        for ci in range(cin)], device=w0bd.device)
    pieces = []
    for w, b, rows, cols in ((w0bd[idx, :c0], b0[:c0], kd0p, c0p),
                             (w2.reshape(cells, c0, c1), b2, cells * c0p, c1p),
                             (w3, b3, c1p, c2p), (wcp, bcp, c2p, gcp)):
        wp = torch.zeros((rows, cols + 8), dtype=torch.bfloat16, device=w.device)
        if w.ndim == 3:  # conv2: each sub-cell's c0 rows at a multiple of c0p
            wp.view(cells, c0p, cols + 8)[:, :c0, :c1] = w
        else:
            wp[:w.shape[0], :w.shape[1]] = w
        bp = torch.zeros(cols, dtype=torch.float32, device=w.device)
        bp[:b.shape[0]] = b
        pieces += [wp.reshape(-1).view(torch.uint8), bp.view(torch.uint8)]
    return torch.cat(pieces)


_trunk_cache: Dict[int, Tuple[Any, Tuple, torch.Tensor]] = {}
_TRUNK_CACHE_SIZE = 8


def _trunk_gram_buffer(weights, spec, dev: torch.device) -> torch.Tensor:
    """The fold's checked, packed weight buffer: built once per fold object
    and kept while the fold's tensors keep their storage (a fold whose
    tensors are replaced is checked and packed again)."""
    key = (tuple(t.data_ptr() for t in weights), _trunk_dims(spec), dev)
    hit = _trunk_cache.get(id(weights))
    if hit is not None and hit[0] is weights and hit[1] == key:
        return hit[2]
    k1, k2, cin, c0, c1, c2, gc = _trunk_dims(spec)
    K = k1 * k2
    shapes = (
        (K * K * cin, k2 * k2 * c0), (k2 * k2 * c0,), (k2 * k2 * c0, c1), (c1,),
        (c1, c2), (c2,), (c2, gc), (gc,),
    )
    if len(weights) != len(shapes):
        raise ValueError(f"fused_trunk_gram: expected 8 folded arrays, got {len(weights)}")
    for i, (t, shape) in enumerate(zip(weights, shapes)):
        _check_cuda(f"fused_trunk_gram weight {i}", t,
                    torch.bfloat16 if i % 2 == 0 else torch.float32, dev, shape)
    buf = pack_trunk_gram_weights(weights, spec)
    if len(_trunk_cache) >= _TRUNK_CACHE_SIZE:
        _trunk_cache.pop(next(iter(_trunk_cache)))
    _trunk_cache[id(weights)] = (weights, key, buf)
    return buf


def fused_trunk_gram(x8: torch.Tensor, weights, spec) -> torch.Tensor:
    """Raw uint8 NHWC images [B, H, W, cin] -> per-patch Gram tokens
    [B, div*div, gc*gc] through the whole trunk and ``chan_proj``, on a
    :func:`fold_trunk_gram_weights` fold.  Rows and columns beyond a multiple
    of K = k1*k2 are ignored, as the strided convolutions ignore them.

    CPU tensor: the plain version.  CUDA tensor: the ``fused_trunk_gram``
    kernel, which reads the raw frame (no space-to-depth copy), one cluster
    of :func:`trunk_gram_plan`'s blocks per patch, on the fold packed once
    by :func:`pack_trunk_gram_weights`.
    """
    if x8.device.type == "cpu":
        return fused_trunk_gram_plain(x8, weights, spec)
    _require_cpu_or_cuda(x8, "fused_trunk_gram")
    if not supports_fused_trunk_gram(spec):
        raise ValueError(
            "the fused trunk kernel needs a [k=s pad0, k=s pad0, 1x1] trunk plan without SE"
        )
    k1, k2, cin, c0, c1, c2, gc = _trunk_dims(spec)
    K = k1 * k2
    if x8.ndim != 4:
        raise ValueError(f"fused_trunk_gram: expected uint8 NHWC, got {tuple(x8.shape)}")
    dev = x8.device
    _check_cuda("fused_trunk_gram x", x8, torch.uint8, dev)
    b, h, w, c = x8.shape
    if c != cin or h < K or w < K:
        raise ValueError(
            f"fused_trunk_gram: image {tuple(x8.shape)} does not fit cin={cin}, K={K}"
        )
    plan = trunk_gram_plan(spec, h, w)
    buf = _trunk_gram_buffer(weights, spec, dev)
    div = spec.patch_div
    out = torch.empty((b, div * div, gc * gc), dtype=torch.float32, device=dev)
    lib = build()
    _launch("fused_trunk_gram", lib.wadt_trunk_gram_u8, dev, x8.data_ptr(), buf.data_ptr(),
            out.data_ptr(), b, h, w, cin, k1, k2, c0, c1, c2, gc, div, plan.cluster)
    return out


# ---------------------------------------------------------------------------
# K4: fused head (the camera path's head)
# ---------------------------------------------------------------------------

# The kernel's per-layer float32 vectors and the matrices whose column shares
# it packs, each in its packed order (csrc/head.cu `Vec`: the d-wide vectors,
# then FFN1's bias).
_LAYER_VECS = (
    ("norm1", "scale"), ("norm1", "bias"), ("attn", "bq"), ("attn", "bk"), ("attn", "bv"),
    ("attn", "bo"), ("norm2", "scale"), ("norm2", "bias"), ("ffn2", "b"), ("ffn1", "b"),
)
_LAYER_MATRICES = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                   ("ffn1", "w"), ("ffn2", "w"))
_MAX_HEAD_LAYERS = 8  # csrc/head.cu kMaxLayers
_HEAD_CLUSTERS = (8, 16)  # launch 2's cluster sizes, the first whose shares fit
_SMEM_MAX = 227 * 1024  # shared memory a block may use
_HEAD_CACHE_SIZE = 8


class HeadSharePlan(NamedTuple):
    """Column shares of ``csrc/head.cu``'s launch 2: block r of a cluster
    owns the d-wide columns [bd[r], bd[r+1]) of Wq, Wk, Wv, Wo and FFN2, and
    the FFN-wide columns [bf[r], bf[r+1]) of FFN1; its packed shares of
    every layer start at element off[r] of the packed buffer (off[-1]: the
    buffer's size).  ``w_cap`` bf16 elements of weights, ``t_cap`` tasks and
    ``smem`` bytes of shared memory a block."""

    cluster: int
    bd: Tuple[int, ...]
    bf: Tuple[int, ...]
    off: Tuple[int, ...]
    w_cap: int
    t_cap: int
    smem: int


def _shares(n: int, parts: int) -> Tuple[int, ...]:
    """Bounds of ``parts`` shares of n columns, each a multiple of 8, as even
    as they come (empty shares when n / 8 < parts)."""
    units = n // 8
    return tuple(8 * (units * r // parts) for r in range(parts + 1))


def _up16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _head_smem(w_cap, t_cap, n_layers, np_, d, ff, heads, kmax) -> int:
    """Bytes of launch 2's shared memory (csrc/head.cu ``head_smem``)."""
    rows = -(-np_ // 16) * 16
    return (_up16(2 * w_cap) + 4 * n_layers * (9 * d + ff) + _up16(4 * t_cap * d)
            + _up16(4 * t_cap * d * kmax) + _up16(4 * np_ * d)
            + max(3 * _up16(4 * np_ * (d + 4)), 2 * _up16(2 * rows * (ff + 8)))
            + 2 * _up16(2 * rows * (d + 8))
            + _up16(4 * heads * np_ * np_) + _up16(4 * t_cap * np_) + _up16(4 * t_cap * d)
            + 8 * (_MAX_HEAD_LAYERS + 1))


def head_share_plan(np_: int, d: int, ff: int, heads: int, n_layers: int, ntask: int, kmax: int,
                    cluster: Optional[int] = None) -> HeadSharePlan:
    """The column shares of the fused head's launch 2 on the first cluster
    size of (8, 16) (or ``cluster``) whose per-block shared memory fits in
    227 KB; raises ValueError naming the limit when none does."""
    if n_layers == 0:
        ff, heads = 0, 1
    need = None
    for cs in (cluster,) if cluster else _HEAD_CLUSTERS:
        bd = _shares(d, cs)
        bf = _shares(ff, cs)
        regions = [n_layers * (4 * d * (bd[r + 1] - bd[r]) + d * (bf[r + 1] - bf[r])
                               + ff * (bd[r + 1] - bd[r])) for r in range(cs)]
        off = tuple(int(v) for v in np.concatenate([[0], np.cumsum(regions)]))
        t_cap = -(-ntask // cs)
        smem = _head_smem(max(regions), t_cap, n_layers, np_, d, ff, heads, kmax)
        if smem <= _SMEM_MAX:
            return HeadSharePlan(cs, bd, bf, off, max(regions), t_cap, smem)
        need = smem
    raise ValueError(
        f"fused_head: d={d}, ffn={ff}, {n_layers} layers need {need} bytes of shared memory a "
        f"block even on clusters of {cluster or _HEAD_CLUSTERS[-1]}; the limit is {_SMEM_MAX}"
    )


def pack_head_shares(layers, plan: HeadSharePlan) -> torch.Tensor:
    """Every block's column shares of every layer matrix, packed for
    launch 2: block by block, layer by layer, Wq Wk Wv Wo FFN1 FFN2, each
    share [in, cols] row-major -> one flat bf16 tensor of ``plan.off[-1]``
    elements (8 zeros when there is nothing to pack)."""
    pieces = []
    for r in range(plan.cluster):
        cols = {"d": slice(plan.bd[r], plan.bd[r + 1]), "f": slice(plan.bf[r], plan.bf[r + 1])}
        for lp in layers:
            for grp, leaf in _LAYER_MATRICES:
                sl = cols["f" if grp == "ffn1" else "d"]
                pieces.append(lp[grp][leaf][:, sl].reshape(-1))
    if not pieces or plan.off[-1] == 0:
        dev = layers[0]["attn"]["wq"].device if layers else "cpu"
        return torch.zeros(8, dtype=torch.bfloat16, device=dev)
    return torch.cat(pieces).contiguous()


def fused_head_plain(tokens: torch.Tensor, folded: Dict[str, Any], spec) -> torch.Tensor:
    """Plain PyTorch fused head: ``token_proj`` on bf16 tokens (int8 fold:
    ``bf16(bf16(w8) * bf16(scale))``), float32 sums, then the layers of the
    fold, task-query pooling and the stacked heads."""
    tp = folded["token_proj"]
    if "w8" in tp:
        w = _bf16_round(tp["w8"].to(torch.float32) * _bf16_round(tp["scale"]))
    else:
        w = tp["w"].float()
    x = torch.matmul(_bf16_round(tokens), w) + tp["b"]
    layers = folded.get("transformer", ())
    if layers:
        x = transformer_encoder(x, cast_tree(layers, torch.float32), spec.transformer_heads)
    return stacked_task_heads(task_query_pool(x, folded["queries"]), folded["heads"])


def _head_leaves(folded: Dict[str, Any]):
    """Every tensor the fused head reads, in a fixed order."""
    tp = folded["token_proj"]
    leaves = [tp[k] for k in ("w8", "scale", "w", "b") if k in tp]
    for lp in folded.get("transformer", ()):
        leaves += [lp[g][k] for g, k in _LAYER_VECS + _LAYER_MATRICES]
    return leaves + [folded["queries"], folded["heads"]["w"], folded["heads"]["b"]]


_head_cache: Dict[int, Tuple[Any, Tuple, Dict[str, Any]]] = {}


def _head_state(folded: Dict[str, Any], spec, npatch: int, dev: torch.device,
                cluster: Optional[int]) -> Dict[str, Any]:
    """The fold's checked launch state: its plan, packed shares and pointer
    tables.  Built once per fold object and kept while the fold's tensors
    keep their storage; a fold whose tensors are replaced is checked again.
    (The fold is read as immutable: its shares are copied once.)"""
    key = (tuple(t.data_ptr() for t in _head_leaves(folded)), spec.transformer_heads, npatch,
           dev, cluster)
    hit = _head_cache.get(id(folded))
    if hit is not None and hit[0] is folded and hit[1] == key:
        return hit[2]
    tp = folded["token_proj"]
    q8 = "w8" in tp
    w = tp["w8"] if q8 else tp["w"]
    din, d = w.shape
    _check_cuda("fused_head token_proj", w, torch.int8 if q8 else torch.bfloat16, dev, (din, d))
    scale = None
    if q8:
        scale = tp["scale"]
        _check_cuda("fused_head token_proj scale", scale, torch.float32, dev, (d,))
    _check_cuda("fused_head token_proj bias", tp["b"], torch.float32, dev, (d,))
    layers = folded.get("transformer", ())
    if len(layers) > _MAX_HEAD_LAYERS:
        raise ValueError(f"fused_head: at most {_MAX_HEAD_LAYERS} layers, got {len(layers)}")
    ff = layers[0]["ffn1"]["w"].shape[-1] if layers else 0
    heads = spec.transformer_heads
    if d % 8 or (layers and (d % 16 or d > 256 or ff % 16 or d % heads or (d // heads) % 4)):
        raise ValueError(
            f"fused_head: the kernel takes model widths up to 256, model and FFN widths that "
            f"are multiples of 16 and heads of a multiple of 4 wide (without layers: d a "
            f"multiple of 8); got d={d}, ffn={ff}, {heads} heads"
        )
    shapes = {("ffn1", "w"): (d, ff), ("ffn1", "b"): (ff,), ("ffn2", "w"): (ff, d)}
    for li, lp in enumerate(layers):
        for grp, leaf in _LAYER_VECS + _LAYER_MATRICES:
            t = lp[grp][leaf]
            matrix = leaf.startswith("w")
            shape = shapes.get((grp, leaf), (d, d) if matrix else (d,))
            _check_cuda(f"fused_head layer {li} {grp}.{leaf}", t,
                        torch.bfloat16 if matrix else torch.float32, dev, shape)
    vecs = (torch.stack([torch.cat([lp[g][k] for g, k in _LAYER_VECS]) for lp in layers])
            if layers else torch.zeros(4, dtype=torch.float32, device=dev))
    queries, hw, hb = folded["queries"], folded["heads"]["w"], folded["heads"]["b"]
    ntask, kmax = hb.shape
    _check_cuda("fused_head queries", queries, torch.float32, dev, (ntask, d))
    _check_cuda("fused_head heads w", hw, torch.float32, dev, (ntask, d, kmax))
    _check_cuda("fused_head heads b", hb, torch.float32, dev, (ntask, kmax))
    if queries.data_ptr() % 16 or hw.data_ptr() % 16:
        raise ValueError("fused_head: queries and head weights must be 16-byte aligned")
    plan = head_share_plan(npatch, d, ff, heads, len(layers), ntask, kmax, cluster)
    ints = ctypes.c_int * (plan.cluster + 1)
    state = {
        "q8": q8, "w": w, "scale": scale, "b": tp["b"], "d": d, "din": din, "ff": ff,
        "heads": heads, "ntask": ntask, "kmax": kmax, "n_layers": len(layers), "plan": plan,
        "packed": pack_head_shares(layers, plan), "queries": queries, "hw": hw, "hb": hb,
        "vecs": vecs.contiguous(),
        "bd": ints(*plan.bd), "bf": ints(*plan.bf), "off": ints(*plan.off),
    }
    if len(_head_cache) >= _HEAD_CACHE_SIZE:
        _head_cache.pop(next(iter(_head_cache)))
    _head_cache[id(folded)] = (folded, key, state)
    return state


def fused_head(tokens: torch.Tensor, folded: Dict[str, Any], spec) -> torch.Tensor:
    """Gram tokens [B, Np, gc*gc] + a ``fold_head_weights`` tree (bf16 or
    q8) -> stacked logits [B, T, Kmax]: ``token_proj``, the fold's
    transformer layers, task-query pooling and the heads.

    CPU tensor: the plain version.  CUDA tensor: the ``fused_head`` kernel
    (two launches, counted as one call; the second one cluster of 8 or 16
    blocks per image on :func:`head_share_plan`'s column shares).
    """
    if tokens.device.type == "cpu":
        return fused_head_plain(tokens, folded, spec)
    return _fused_head_launch(tokens, folded, spec)


def _fused_head_launch(tokens: torch.Tensor, folded: Dict[str, Any], spec, stages: int = 3,
                       cluster: Optional[int] = None, out: Optional[torch.Tensor] = None,
                       partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fused_head``'s launches on a CUDA tensor: ``stages`` 1 runs launch 1
    only (into ``partial``), 2 launch 2 only (from ``partial``), 3 both;
    ``cluster`` forces launch 2's cluster size.  Only the full call counts
    as a launch."""
    _require_cpu_or_cuda(tokens, "fused_head")
    if tokens.ndim != 3:
        raise ValueError(f"fused_head: expected tokens [B, Np, D], got {tuple(tokens.shape)}")
    dev = tokens.device
    b, npatch, din = tokens.shape
    st = _head_state(folded, spec, npatch, dev, cluster)
    _check_cuda("fused_head tokens", tokens, torch.float32, dev, (b, npatch, st["din"]))
    chunks = -(-din // _HEAD_CHUNK_ROWS)
    if partial is None:
        partial = torch.empty((chunks, b * npatch, st["d"]), dtype=torch.float32, device=dev)
    if out is None:
        out = torch.empty((b, st["ntask"], st["kmax"]), dtype=torch.float32, device=dev)
    plan = st["plan"]
    lib = build()
    _launch("fused_head", lib.wadt_fused_head, dev, tokens.data_ptr(), st["w"].data_ptr(),
            int(st["q8"]), st["scale"].data_ptr() if st["q8"] else None, st["b"].data_ptr(),
            st["packed"].data_ptr(), st["vecs"].data_ptr(), st["n_layers"], st["bd"], st["bf"],
            st["off"], plan.cluster, plan.w_cap, plan.t_cap, st["queries"].data_ptr(),
            st["hw"].data_ptr(), st["hb"].data_ptr(), partial.data_ptr(), chunks, out.data_ptr(),
            b, npatch, din, st["d"], st["ff"], st["heads"], st["ntask"], st["kmax"], stages,
            count=stages == 3)
    return out


# ---------------------------------------------------------------------------
# K6: per-task weight-only int8 matvec (the RTM camera path's fold product)
# ---------------------------------------------------------------------------


def dequant_matvec_plain(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch per-task int8 product.  float32 mode:
    ``(x[:, t] @ float(w8[t])) * scale[t]``.  bf16 mode (bf16 x and scale):
    ``x[:, t] @ bf16(w8[t] * scale[t])``, each weight dequantized to bf16
    and the exact products summed in float32."""
    if x.dtype == torch.bfloat16:
        w = (w8.to(torch.bfloat16) * scale[:, None, :]).float()
        return torch.einsum("btc,tcd->btd", x.float(), w)
    return torch.einsum("btc,tcd->btd", x, w8.to(torch.float32)) * scale


class DequantMatvecPlan(NamedTuple):
    """Launch plan of ``csrc/int8_matvec.cu``: one block per (tile of
    ``tile_cols`` output columns, task, group of ``group`` batch rows); a
    ring of ``stages`` shared-memory stages of ``rows_per_stage`` rows of
    the tile (0 stages: the byte-wise path); ``smem`` bytes of shared
    memory a block (the ring, x's rows zero-padded to ``k_steps`` whole
    stages, the per-warp column sums)."""

    tile_cols: int
    rows_per_stage: int
    group: int
    stages: int
    k_steps: int
    grid: Tuple[int, int, int]
    smem: int

    @property
    def vec16(self) -> bool:
        return self.stages > 0


DEQUANT_TILE_COLS, DEQUANT_STAGE_ROWS = 64, 64  # 256 threads: 64 row lanes x 4 of 16 columns
DEQUANT_STAGES = 4  # the ring's depth: 3 stages of 4 KB in flight a block
DEQUANT_MAX_SMEM = 227 * 1024


def dequant_matvec_plan(b: int, t: int, c: int, d: int, aligned: bool = True) -> DequantMatvecPlan:
    """The launch plan of K6 for x [b, t, c] and w8 [t, c, d] (``aligned``:
    w8 is 16-byte aligned): a block per 64 output columns of a task and a
    group of 1 batch row (b = 1) or 4; the ring of 16-byte ``cp.async``
    copies when d % 16 == 0 and w8 is aligned, else the byte-wise path.
    (At the camera shape, b 1, t 12, c = d 2048: 32 x 12 x 1 = 384 blocks,
    4 stages of 4 KB, 26,624 bytes of shared memory.)"""
    group = 1 if b == 1 else 4
    k_steps = -(-c // DEQUANT_STAGE_ROWS)
    stages = DEQUANT_STAGES if d % 16 == 0 and aligned else 0
    smem = (stages * DEQUANT_STAGE_ROWS * DEQUANT_TILE_COLS
            + 4 * (group * k_steps * DEQUANT_STAGE_ROWS + 8 * DEQUANT_TILE_COLS))  # 8 warps' sums
    grid = (-(-d // DEQUANT_TILE_COLS), t, -(-b // group))
    if smem > DEQUANT_MAX_SMEM or t > 65535 or grid[2] > 65535:
        raise ValueError(f"dequant_matvec: [B, T, C, D] = [{b}, {t}, {c}, {d}] is beyond the kernel's "
                         f"limits ({smem} bytes of shared memory, grid {grid})")
    return DequantMatvecPlan(DEQUANT_TILE_COLS, DEQUANT_STAGE_ROWS, group, stages, k_steps, grid, smem)


def dequant_matvec(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-task weight-only int8 product, y float32 [B, T, D], summed in float32:

    - float32 mode: x float32 [B, T, C], w8 int8 [T, C, D], scale float32
      [T, D] -> ``(x[:, t] @ w8[t]) * scale[t]``;
    - bf16 mode: x bf16 [B, T, C], w8 int8 [T, C, D], scale bf16 [T, D] ->
      ``x[:, t] @ bf16(w8[t] * scale[t])``, each weight dequantized to bf16
      first, as the JAX package's bf16 camera path computes it.

    Replaces ``int8_pallas`` (``tools/exp_rtm_int8_stream.py:77``, body
    ``_dequant_matvec_kernel``).  On this card it is bound by reading w8
    once: 50.3 MB at the RTM camera shape (T 12, C = D 2048), ~15 us at
    3.35 TB/s, in either mode.  The kernel dequantizes without the
    conversion unit (a PRMT of each byte under the exponent of 2^23 and one
    FADD; in bf16 mode one bf16x2 multiply by the column scales, rounded
    once) and keeps a ring of 16-byte ``cp.async`` copies in flight while
    it does the math, on :func:`dequant_matvec_plan`'s launch plan.  CPU
    tensor: the plain version.  CUDA tensor: the ``dequant_matvec`` kernel,
    contiguous tensors only; x and scale of one type.
    """
    if x.device.type == "cpu":
        return dequant_matvec_plain(x, w8, scale)
    _require_cpu_or_cuda(x, "dequant_matvec")
    if x.ndim != 3 or w8.ndim != 3:
        raise ValueError(
            f"dequant_matvec: expected x [B, T, C] and w8 [T, C, D], got "
            f"{tuple(x.shape)} and {tuple(w8.shape)}"
        )
    b, t, c = x.shape
    d = w8.shape[-1]
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    _check_cuda("dequant_matvec x", x, dtype, dev)
    _check_cuda("dequant_matvec w8", w8, torch.int8, dev, (t, c, d))
    _check_cuda("dequant_matvec scale", scale, dtype, dev, (t, d))
    out = torch.empty((b, t, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    plan = dequant_matvec_plan(b, t, c, d, w8.data_ptr() % 16 == 0)
    lib = build()
    fn = lib.wadt_dequant_matvec_bf16 if bf16 else lib.wadt_dequant_matvec
    _launch("dequant_matvec", fn, dev, x.data_ptr(), w8.data_ptr(), scale.data_ptr(),
            out.data_ptr(), b, t, c, d, plan.group, plan.stages, plan.smem)
    return out


# ---------------------------------------------------------------------------
# K5: bf16 token projection from the row-major Gram (the bf16 batch path)
# ---------------------------------------------------------------------------


def gram_proj_plain(g: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch token projection: ``float(g) @ float(w) + b`` in float32
    (the products of bf16 values are exact in float32), then one cast to
    ``out_dtype``."""
    return (torch.matmul(g.float(), w.float()) + b.float()).to(out_dtype)


class GramProjPlan(NamedTuple):
    """Launch plan of ``csrc/gram_proj.cu``: output tiles of 128 rows by
    ``tile_n`` columns, K cut into ``splits`` slices of whole 64-deep
    tiles, one cluster of ``splits`` blocks per output tile."""

    tile_n: int
    m_tiles: int
    n_tiles: int
    k_tiles: int
    splits: int
    one_wave: bool  # every cluster is resident at once (see gram_proj_plan)

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.splits, self.m_tiles, self.n_tiles)

    @property
    def cluster(self) -> Tuple[int, int, int]:
        return (self.splits, 1, 1)

    def k_slice(self, s: int) -> Tuple[int, int]:
        """[first, end) 64-deep tiles of K slice ``s``, as the kernel cuts them."""
        base, rem = divmod(self.k_tiles, self.splits)
        first = s * base + min(s, rem)
        return first, first + base + (1 if s < rem else 0)


_GRAM_PROJ_WIDTHS = (64, 128, 192, 256)  # the kernel's compile-time tile widths
GRAM_PROJ_TILE_M, _GRAM_PROJ_BK = 128, 64  # its tile height and K step
_GRAM_PROJ_MAX_SPLITS = 8  # the portable cluster size
_GPC_SMS = 16  # a cluster runs inside one GPC; the H100 SXM has 8 of about 16 SMs


def _one_wave(tiles: int, splits: int, sms: int) -> bool:
    """Whether ``tiles`` clusters of ``splits`` blocks (one block per SM) are
    all resident at once: at most one block per SM, and clusters counted
    per GPC, ``16 // splits`` in each of ``sms // 16``."""
    return tiles * splits <= sms and tiles <= (sms // _GPC_SMS) * (_GPC_SMS // splits)


@functools.lru_cache(maxsize=64)
def gram_proj_plan(m: int, n: int, k: int, sms: int) -> GramProjPlan:
    """The launch plan of K5 for G [m, k] x W [k, n] on a card of ``sms`` SMs:
    the narrowest tile width that holds n (256-wide tiles beyond), and the
    most K slices (at most 8, at most one per 64-deep tile) whose clusters
    are all resident at once.  (At the main shape, [2304, 9216] x [9216,
    192] on 132 SMs: 18 tiles, 5 slices, 90 blocks.)"""
    tile_n = next((t for t in _GRAM_PROJ_WIDTHS if t >= n), _GRAM_PROJ_WIDTHS[-1])
    m_tiles, n_tiles = -(-m // GRAM_PROJ_TILE_M), -(-n // tile_n)
    k_tiles = -(-k // _GRAM_PROJ_BK)
    tiles = m_tiles * n_tiles
    splits = next((s for s in range(min(_GRAM_PROJ_MAX_SPLITS, k_tiles), 0, -1)
                   if _one_wave(tiles, s, sms)), 1)
    return GramProjPlan(tile_n, m_tiles, n_tiles, k_tiles, splits, _one_wave(tiles, splits, sms))


def gram_proj(g: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gram tokens g bf16 [B, Np, C*C] (the row-major per-patch Gram,
    flattened), ``token_proj`` w bf16 [C*C, N] in its own order, bias b
    float32 [N] -> [B, Np, N] = ``g @ w + b``, summed in float32, written as
    float32 or rounded once to bf16 (``out_dtype``).

    Replaces ``make_proj_kernel.proj`` (``tools/exp_pmg_projkernel.py:65``),
    which took w transposed to d-major; the Gram is symmetric, so the two
    are the same product.  The registered kernel ``wadt_torch::gram_proj``
    (:func:`_register`'s rule).  CPU tensor: the plain version.  CUDA
    tensor: the ``gram_proj`` kernel on :func:`gram_proj_plan`'s launch
    plan, contiguous tensors with K and N multiples of 8 and g, w and b
    16-byte aligned only (every spec's C*C and d_model are).
    """
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gram_proj: out_dtype must be float32 or bfloat16, got {out_dtype}")
    return _gram_proj(g, w, b, out_dtype == torch.bfloat16)


def _gram_proj_launch(g: torch.Tensor, w: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """K5 on CUDA tensors, the CUDA implementation of ``wadt_torch::gram_proj``."""
    out_dtype = torch.bfloat16 if bf16 else torch.float32
    if g.ndim != 3 or w.ndim != 2:
        raise ValueError(
            f"gram_proj: expected g [B, Np, K] and w [K, N], got {tuple(g.shape)} and "
            f"{tuple(w.shape)}"
        )
    bsz, npatch, k = g.shape
    n = w.shape[-1]
    dev = g.device
    _check_cuda("gram_proj g", g, torch.bfloat16, dev)
    _check_cuda("gram_proj w", w, torch.bfloat16, dev, (k, n))
    _check_cuda("gram_proj b", b, torch.float32, dev, (n,))
    if k % 8 or n % 8 or g.data_ptr() % 16 or w.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(
            f"gram_proj: K = {k} and N = {n} must be multiples of 8, and g, w and b 16-byte aligned"
        )
    out = torch.empty((bsz, npatch, n), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    plan = gram_proj_plan(bsz * npatch, n, k, _sm_count(dev))
    lib = build()
    _launch("gram_proj", lib.wadt_gram_proj_bf16, dev, g.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), bsz * npatch, n, k, plan.tile_n,
            plan.splits)
    return out


def _gram_proj_cpu(g, w, b, bf16):
    return gram_proj_plain(g, w, b, torch.bfloat16 if bf16 else torch.float32)


def _gram_proj_fake(g, w, b, bf16):
    return g.new_empty((*g.shape[:-1], w.shape[-1]),
                       dtype=torch.bfloat16 if bf16 else torch.float32)


def gram_proj_backward(g: torch.Tensor, w: torch.Tensor, b_dtype: torch.dtype,
                       dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of ``gram_proj`` for the output gradient dy [B, Np, N]:
    ``dG = dY W^T``, ``dW = sum G^T dY`` and ``db = sum dY`` over the B*Np
    rows.  Plain products with float32 sums, each rounded once to its
    input's dtype (g, w, and b's ``b_dtype``); the forward stays the kernel
    on the card."""
    dy32 = dy.float().reshape(-1, dy.shape[-1])
    dg = torch.matmul(dy32, w.float().t()).to(g.dtype).reshape(g.shape)
    dw = torch.matmul(g.float().reshape(-1, g.shape[-1]).t(), dy32).to(w.dtype)
    return dg, dw, dy32.sum(0).to(b_dtype)


def _gram_proj_setup(ctx, inputs, output) -> None:
    g, w, b, _ = inputs
    ctx.save_for_backward(g, w)
    ctx.b_dtype = b.dtype


def _gram_proj_grad(ctx, dy):
    g, w = ctx.saved_tensors
    return (*gram_proj_backward(g, w, ctx.b_dtype, dy), None)


_gram_proj = _register("gram_proj", _gram_proj_launch, _gram_proj_cpu, _gram_proj_fake,
                       _gram_proj_setup, _gram_proj_grad)


# ---------------------------------------------------------------------------
# The ResNet trunk's inference batch-norm epilogue (no TPU counterpart)
# ---------------------------------------------------------------------------

_NORM_KEYS = ("scale", "bias", "mean", "var")


def _bn_plain(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    scale, shift = batch_norm_affine(p)
    return x * scale[:, None, None] + shift[:, None, None]


def bn_epilogue_plain(x: torch.Tensor, p: Dict[str, torch.Tensor], relu: bool = True,
                      other: Optional[torch.Tensor] = None,
                      p_other: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Plain PyTorch inference batch norm on NCHW x (the norm ``p``'s
    running statistics, ``norms.batch_norm_affine``), plus ``other`` (the
    residual identity) or, with ``p_other``, plus ``other`` under its own
    norm (the downsample branch), then the ReLU if ``relu``: each step one
    eager PyTorch operation, rounded to x's type."""
    if p_other is not None and other is None:
        raise ValueError("bn_epilogue: a second norm needs the tensor it normalizes")
    y = _bn_plain(x, p)
    if other is not None:
        y = y + (other if p_other is None else _bn_plain(other, p_other))
    return torch.relu(y) if relu else y


def _epilogue_fits(x: torch.Tensor, other: Optional[torch.Tensor], vecs) -> bool:
    """x contiguous NCHW float32 or bf16; ``other`` and every vector of
    ``vecs`` ([C], contiguous), where not None, of x's type and device."""
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.bfloat16) or x.ndim != 4 or not x.is_contiguous():
        return False
    if other is not None and (other.dtype != dt or other.device != dev or other.shape != x.shape
                              or not other.is_contiguous()):
        return False
    c = x.shape[1]
    return all(v.dtype == dt and v.device == dev and v.ndim == 1 and v.shape[0] == c
               and v.is_contiguous() for v in vecs if v is not None)


def bn_epilogue(x: torch.Tensor, p: Dict[str, torch.Tensor], relu: bool = True,
                other: Optional[torch.Tensor] = None,
                p_other: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """:func:`bn_epilogue_plain` in one pass: ``relu?(bn(x) [+ other |
    + bn_other(other)])``, bit for bit, with the plain chain's gradients.

    Replaces no TPU kernel: the JAX package leaves these passes after each
    convolution of the ResNet trunk to XLA's fusion.  The registered kernel
    ``wadt_torch::bn_epilogue`` (:func:`_register`'s rule).  CPU tensor: the
    plain version.  CUDA tensor: the ``bn_epilogue`` kernel
    (``csrc/bn_epilogue.cu``), which computes the norm's affine per channel
    itself, on contiguous NCHW float32 or bf16 tensors with ``other`` and
    every norm vector of x's type (others raise); autograd differentiates
    it by :func:`bn_epilogue_backward`.  Eager on the card the operator's
    dispatch would cost a ResNet-50 forward ~1 ms of host time over its 49
    calls (10–15 ms more where autograd records them).
    """
    second = (None,) * 4 if p_other is None else tuple(p_other[k] for k in _NORM_KEYS)
    return _bn_epilogue(x, p["scale"], p["bias"], p["mean"], p["var"], other, *second, relu)


def _bn_epilogue_launch(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
    var: torch.Tensor, other: Optional[torch.Tensor], scale2: Optional[torch.Tensor],
    bias2: Optional[torch.Tensor], mean2: Optional[torch.Tensor], var2: Optional[torch.Tensor],
    relu: bool,
) -> torch.Tensor:
    """The kernel on CUDA tensors, the CUDA implementation of
    ``wadt_torch::bn_epilogue``."""
    second = (scale2, bias2, mean2, var2)
    given = sum(t is not None for t in second)
    if given not in (0, 4) or (given and other is None):
        raise ValueError("bn_epilogue: a second norm takes all four vectors and the tensor it "
                         "normalizes")
    mode = 0 if other is None else 2 if given else 1
    if not (x.is_cuda and _epilogue_fits(x, other, (scale, bias, mean, var, *second))):
        raise ValueError(
            "bn_epilogue: the kernel takes contiguous NCHW float32 or bf16 CUDA tensors, with "
            "other and the norm vectors [C] of x's type and device"
        )
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    b, c, h, w = x.shape
    ptrs = [None if t is None else t.data_ptr() for t in (x, other, scale, bias, mean, var, *second)]
    _launch("bn_epilogue", build().wadt_bn_epilogue, x.device, *ptrs, out.data_ptr(),
            out.numel(), c, h * w, mode, int(relu), int(x.dtype == torch.bfloat16),
            _sm_count(x.device))
    return out


def _bn_epilogue_cpu(x, scale, bias, mean, var, other, scale2, bias2, mean2, var2, relu):
    p_other = None if scale2 is None else dict(zip(_NORM_KEYS, (scale2, bias2, mean2, var2)))
    return bn_epilogue_plain(x, dict(zip(_NORM_KEYS, (scale, bias, mean, var))), relu, other,
                             p_other)


def _bn_epilogue_fake(x, scale, bias, mean, var, other, scale2, bias2, mean2, var2, relu):
    return x.new_empty(x.shape)


def _bn_backward(g: torch.Tensor, t: torch.Tensor, vecs: Sequence[torch.Tensor],
                 needs: Sequence[bool]) -> list:
    """The gradients of ``_bn_plain(t, vecs)`` for its output's gradient g:
    t's, then each norm vector's (None where ``needs`` says none is
    needed), as autograd gives them through the eager chain: g times the
    rounded affine, and the affine's own steps differentiated by autograd."""
    if not any(needs[1:]):  # the activation's alone (Grad-CAM): no graph to record
        inv = batch_norm_affine(dict(zip(_NORM_KEYS, vecs)))[0]
        return [g * inv[:, None, None] if needs[0] else None, None, None, None, None]
    with torch.enable_grad():
        leaves = [v.detach().requires_grad_(n) for v, n in zip(vecs, needs[1:])]
        inv, shift = batch_norm_affine(dict(zip(_NORM_KEYS, leaves)))
    grads = [g * inv.detach()[:, None, None] if needs[0] else None, None, None, None, None]
    wanted = [i for i, n in enumerate(needs[1:]) if n]
    if wanted:
        dvecs = torch.autograd.grad((inv, shift), [leaves[i] for i in wanted],
                                    ((g * t).sum((0, 2, 3)), g.sum((0, 2, 3))))
        for i, d in zip(wanted, dvecs):
            grads[1 + i] = d
    return grads


def bn_epilogue_backward(dy: torch.Tensor, x: torch.Tensor, other: Optional[torch.Tensor],
                         out: torch.Tensor, vecs: Sequence[Optional[torch.Tensor]], relu: bool,
                         needs: Sequence[bool]) -> tuple:
    """The gradients of ``bn_epilogue`` for the output gradient dy, in the
    operator's argument order (x, p's four vectors, other, p_other's four,
    relu), bit for bit autograd's through :func:`bn_epilogue_plain`: the
    ReLU's mask from the output, then each normed input's gradient, the
    identity's the masked gradient itself.  Plain PyTorch; the forward
    stays the kernel on the card."""
    g = torch.ops.aten.threshold_backward(dy, out, 0) if relu else dy
    grads = _bn_backward(g, x, vecs[:4], needs[:5])
    if vecs[4] is None:
        return (*grads, g if needs[5] else None, None, None, None, None, None)
    return (*grads, *_bn_backward(g, other, vecs[4:], needs[5:10]), None)


def _bn_epilogue_setup(ctx, inputs, output) -> None:
    x, scale, bias, mean, var, other, scale2, bias2, mean2, var2, relu = inputs
    ctx.save_for_backward(x, other, output, scale, bias, mean, var, scale2, bias2, mean2, var2)
    ctx.relu = relu


def _bn_epilogue_grad(ctx, dy):
    x, other, out, *vecs = ctx.saved_tensors
    return bn_epilogue_backward(dy, x, other, out, vecs, ctx.relu, ctx.needs_input_grad)


_bn_epilogue = _register("bn_epilogue", _bn_epilogue_launch, _bn_epilogue_cpu, _bn_epilogue_fake,
                         _bn_epilogue_setup, _bn_epilogue_grad)


# ---------------------------------------------------------------------------
# The PM trunk's instance norm and LeakyReLU (no TPU counterpart)
# ---------------------------------------------------------------------------


def instance_norm_leaky_plain(x: torch.Tensor, p: Dict[str, torch.Tensor],
                              slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch ``leaky_relu(instance_norm(x, p), slope)`` on NHWC x,
    each step one eager operation rounded to x's type."""
    return leaky_relu(instance_norm(x, p), slope)


def _inl_fits(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> bool:
    """x a contiguous NHWC float32 or bf16 tensor (the channels-last memory
    the trunk's convolutions return), scale and bias contiguous [C] of x's
    type and device."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.ndim != 4 or not x.is_contiguous():
        return False
    c = x.shape[3]
    return all(v.dtype == x.dtype and v.device == x.device and v.ndim == 1 and v.shape[0] == c
               and v.is_contiguous() for v in (scale, bias))


def instance_norm_leaky(x: torch.Tensor, p: Dict[str, torch.Tensor], slope: float = 0.2,
                        inplace: bool = False) -> torch.Tensor:
    """:func:`instance_norm_leaky_plain` in one pass, with the plain
    chain's gradients (the instance norm's closed form).

    Replaces no TPU kernel: the JAX package leaves each PM trunk block's
    norm and LeakyReLU to XLA's fusion.  The registered kernel
    ``wadt_torch::instance_norm_leaky`` (:func:`_register`'s rule).  CPU
    tensor: the plain version.  CUDA tensor: the ``instance_norm_leaky``
    kernel (``csrc/instance_norm_leaky.cu``) on a contiguous NHWC float32 or
    bf16 x (channels-last memory, as the trunk's convolutions return it)
    with ``p``'s scale and bias [C] of its type (others raise); float32
    statistics and arithmetic, one rounding.  ``inplace`` writes the result
    over x on the eager card path that records no gradient (the trunk's
    conv outputs, which nothing else reads); elsewhere it is out of place.
    """
    return _instance_norm_leaky(x, p["scale"], p["bias"], slope,
                                launcher=_inl_over if inplace else _inl_launch)


def _inl_into(y: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              slope: float) -> torch.Tensor:
    """The kernel on CUDA tensors, its result into y (x itself or a new
    tensor of x's layout) -> y.  It leaves the kernel's statistics outputs
    unset: the backward recomputes them (:func:`instance_norm_stats`)."""
    if not (x.is_cuda and _inl_fits(x, scale, bias)):
        raise ValueError(
            "instance_norm_leaky: the kernel takes a contiguous NHWC float32 or bf16 CUDA tensor, "
            "with scale and bias [C] of its type and device"
        )
    if x.numel() == 0:
        return y
    n, h, w, c = x.shape
    _launch("instance_norm_leaky", build().wadt_instance_norm_leaky, x.device, x.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), y.data_ptr(), None, None, n, h * w, c, float(slope),
            int(x.dtype == torch.bfloat16))
    return y


def _inl_launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                slope: float) -> torch.Tensor:
    """The kernel out of place, the CUDA implementation of
    ``wadt_torch::instance_norm_leaky``."""
    return _inl_into(torch.empty_like(x), x, scale, bias, slope)


def _inl_over(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              slope: float) -> torch.Tensor:
    """The kernel written over x (``instance_norm_leaky(..., inplace=True)``)."""
    return _inl_into(x, x, scale, bias, slope)


def _inl_cpu(x, scale, bias, slope):
    return instance_norm_leaky_plain(x, {"scale": scale, "bias": bias}, slope)


def _inl_fake(x, scale, bias, slope):
    return x.new_empty(x.shape)


def instance_norm_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (mean, 1/sqrt(var + eps)) of NHWC x over H, W, each [N, C]:
    the statistics the kernel normalises by, in float32 (float64 for
    float64 x)."""
    xa = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    var = xa.var(dim=(1, 2), correction=0)
    return xa.mean(dim=(1, 2)), torch.reciprocal(torch.sqrt(var + EPS))


def instance_norm_leaky_backward(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                                 rstd: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                 slope: float, needs: Sequence[bool]) -> tuple:
    """The gradients of ``instance_norm_leaky`` for the output gradient dy,
    as (x's, scale's, bias's, None for the slope), each None where
    ``needs`` says none is needed: the LeakyReLU's mask from the sign of the
    normalised value (the output's, for a positive slope), then the
    instance norm's closed form over each (image, channel)'s H x W values.
    Plain PyTorch in the type of x's statistics ``mean`` and ``rstd``
    [N, C] (:func:`instance_norm_stats`); the forward stays the kernel on
    the card."""
    acc = mean.dtype
    mu, rs = mean[:, None, None, :], rstd[:, None, None, :]
    sc, bi = scale.to(acc), bias.to(acc)
    xhat = (x.to(acc) - mu) * rs
    g = dy.to(acc)
    g = torch.where(xhat * sc + bi >= 0, g, g * slope)
    dx = dscale = dbias = None
    if needs[0]:
        gx = g * sc
        dx = (rs * (gx - gx.mean(dim=(1, 2), keepdim=True)
                    - xhat * (gx * xhat).mean(dim=(1, 2), keepdim=True))).to(x.dtype)
    if needs[1]:
        dscale = (g * xhat).sum(dim=(0, 1, 2)).to(scale.dtype)
    if needs[2]:
        dbias = g.sum(dim=(0, 1, 2)).to(bias.dtype)
    return dx, dscale, dbias, None


def _inl_setup(ctx, inputs, output) -> None:
    x, scale, bias, slope = inputs
    ctx.save_for_backward(x, scale, bias)
    ctx.slope = slope


def _inl_grad(ctx, dy):
    x, scale, bias = ctx.saved_tensors
    return instance_norm_leaky_backward(dy, x, *instance_norm_stats(x), scale, bias, ctx.slope,
                                        ctx.needs_input_grad)


_instance_norm_leaky = _register("instance_norm_leaky", _inl_launch, _inl_cpu, _inl_fake,
                                 _inl_setup, _inl_grad)


# ---------------------------------------------------------------------------
# The ResNet trunk's train-mode batch norm (no TPU counterpart)
# ---------------------------------------------------------------------------

_BN_TRAIN_RUN = 16384  # values of one channel a block of csrc/bn_train.cu's reductions sums
_BN_MOMENTUM = 0.1  # norms.update_running_stats' momentum, csrc/bn_train.cu's kMomentum


def bn_train_splits(n: int, hw: int) -> int:
    """Runs of at most ~16 K values that ``csrc/bn_train.cu``'s reductions
    cut each channel's n * hw values into, one block a (channel, run): at
    batch 128, 98 runs for the stem's 112x112 planes, one for layer4's 7x7."""
    return max(1, -(-n * hw // _BN_TRAIN_RUN))


def _bn_count(x: torch.Tensor, shard=None) -> int:
    """Values each channel of NCHW x reduces: N*H*W, the global batch's
    with a ``shard`` (``norms._count``)."""
    return x.shape[2] * x.shape[3] * (x.shape[0] if shard is None else shard.total)


def _chain_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], shard=None):
    """``norms.train_batch_norm`` of NCHW x on its NHWC view (the output
    keeps x's memory, so y comes back contiguous NCHW) -> (y, new p)."""
    y, new_p = train_batch_norm(x.permute(0, 2, 3, 1), p, shard)
    return y.permute(0, 3, 1, 2), new_p


def bn_train_plain(x: torch.Tensor, p: Dict[str, torch.Tensor], relu: bool = True,
                   other: Optional[torch.Tensor] = None,
                   p_other: Optional[Dict[str, torch.Tensor]] = None, shard=None):
    """Plain PyTorch train-mode batch norm of NCHW x on batch statistics
    (the global batch's with a ``shard``), plus ``other`` (the residual
    identity) or, with ``p_other``, plus ``other`` under its own train-mode
    norm (the downsample branch), then the ReLU if ``relu`` -> (y, p with
    new running statistics, p_other with new ones or None).  The eager
    chain that :func:`bn_train` replaced, each step one PyTorch operation:
    ``norms.train_batch_norm`` on the NHWC view, the sum, ``torch.relu``;
    the reference the tests and ``chip_smoke.py`` hold it to."""
    if p_other is not None and other is None:
        raise ValueError("bn_train: a second norm needs the tensor it normalizes")
    y, new_p = _chain_norm(x, p, shard)
    new_o = None
    if other is not None:
        if p_other is not None:
            other, new_o = _chain_norm(other, p_other, shard)
        y = y + other
    return (torch.relu(y) if relu else y), new_p, new_o


def bn_train(x: torch.Tensor, p: Dict[str, torch.Tensor], relu: bool = True,
             other: Optional[torch.Tensor] = None,
             p_other: Optional[Dict[str, torch.Tensor]] = None, shard=None):
    """:func:`bn_train_plain`, forward and backward, as two steps each way
    -> (y, p with new running statistics, p_other's or None).

    Replaces no TPU kernel: the JAX package leaves each train-mode norm of
    the ResNet trunk, and what follows it, to XLA's fusion.  One route on
    both devices: the statistics' sums, then one pass for y, the batch
    statistics and the new running ones; backward the gradient's sums, then
    one pass for the gradients (:func:`_bn_train_forward`,
    :func:`_bn_train_grads`).  Each step is its kernel in
    ``csrc/bn_train.cu`` on a CUDA tensor and its plain version
    (``bn_train_*_plain``) on a CPU one.  The kernels take contiguous NCHW
    float32 or bf16 tensors with ``other`` and the norms' scale and bias of
    x's type and running statistics [C] of float32 or x's type (others
    raise).  Without a ``shard`` it is the registered kernel
    ``wadt_torch::bn_train`` (:func:`_register`'s rule).  With a ``shard``
    (``parallel.mesh.RowShard``) the statistics and the gradient's sums are
    the global batch's: ``shard.all_reduce`` runs between each pair of
    steps (:class:`_BnTrainSplit`).  The new running statistics carry no
    gradient and keep their params' type.
    """
    _require_cpu_or_cuda(x, "bn_train")
    if p_other is not None and other is None:
        raise ValueError("bn_train: a second norm needs the tensor it normalizes")
    second = (None,) * 4 if p_other is None else tuple(p_other[k] for k in _NORM_KEYS)
    args = (x, *(p[k] for k in _NORM_KEYS), other, *second, relu)
    y, _, run = _bn_train(*args) if shard is None else _BnTrainSplit.apply(shard, *args)
    run = run.detach()

    def moved(q, i):
        return {**q, "mean": run[i].to(q["mean"].dtype), "var": run[i + 1].to(q["var"].dtype)}

    return y, moved(p, 0), None if p_other is None else moved(p_other, 2)


def _bn_train_fits(x: torch.Tensor, other: Optional[torch.Tensor], vecs, running) -> bool:
    """:func:`_epilogue_fits` for x, ``other`` and the scales and biases;
    each running statistic [C] of float32 or x's type on x's device."""
    c = x.shape[1] if x.ndim == 4 else -1
    return _epilogue_fits(x, other, vecs) and all(
        r.dtype in (torch.float32, x.dtype) and r.device == x.device and r.ndim == 1
        and r.shape[0] == c for r in running if r is not None)


# -- the four steps: each the kernel on CUDA tensors, its plain version on CPU ones


def bn_train_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """The statistics step: (sum x, sum x^2) per channel of NCHW x in
    float64 -> [1, C, 2] (one run a channel)."""
    xd = x.double()
    return torch.stack([xd.sum((0, 2, 3)), xd.square().sum((0, 2, 3))], -1)[None]


def _bn_stats(x: torch.Tensor) -> torch.Tensor:
    """The statistics step's sums [runs, C, 2] (:func:`bn_train_splits` runs
    on the card)."""
    if not x.is_cuda:
        return bn_train_stats_plain(x)
    n, c, h, w = x.shape
    splits = bn_train_splits(n, h * w)
    part = torch.empty((splits, c, 2), dtype=torch.float64, device=x.device)
    _launch("bn_train", build().wadt_bn_train_stats, x.device, x.data_ptr(), part.data_ptr(), n, c,
            h * w, splits, int(x.dtype == torch.bfloat16))
    return part


def _bn_affine_plain(part: torch.Tensor, scale: torch.Tensor, count: int):
    """(mean, variance, rstd, inv = scale * rstd) [C] in float32 from the
    statistics' sums, as the apply kernel derives them: float64 moments,
    rounded once, then each float32 step rounded."""
    s = part.sum(0)
    mean = s[:, 0] / count
    var = s[:, 1] / count - mean.square()
    m, v = mean.float(), torch.where(var < 0, 0.0, var).float()
    rstd = torch.reciprocal(torch.sqrt(v + EPS))
    return m, v, rstd, scale.float() * rstd


def _chw(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def bn_train_apply_plain(x: torch.Tensor, other: Optional[torch.Tensor], parts, norms, relu: bool,
                         count: int):
    """The apply step: ``norms`` (scale, bias, running mean, running
    variance) of x and, in a second entry, of ``other``; ``parts`` their
    statistics' sums -> (y of x's type, [2k, C] float32 batch mean and
    variance of each norm, [2k, C] float32 new running mean and variance of
    each), in float32 with one rounding to x's type at the end."""
    keep = float(np.float32(1.0) - np.float32(_BN_MOMENTUM))
    bessel = float(np.float32(count / max(count - 1, 1)))
    zs, stats, run = [], [], []
    for t, part, (scale, bias, rmean, rvar) in zip((x, other), parts, norms):
        m, v, _, inv = _bn_affine_plain(part, scale, count)
        zs.append((t.float() - _chw(m)) * _chw(inv) + _chw(bias.float()))
        stats += [m, v]
        run += [keep * rmean.float() + _BN_MOMENTUM * m,
                keep * rvar.float() + _BN_MOMENTUM * (v * bessel)]
    y = zs[0]
    if other is not None:
        y = y + (zs[1] if len(zs) == 2 else other.float())
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), torch.stack(stats), torch.stack(run)


def _bn_apply(x, other, parts, norms, relu, count):
    if not x.is_cuda:
        return bn_train_apply_plain(x, other, parts, norms, relu, count)
    n, c, h, w = x.shape
    k = len(norms)
    y = torch.empty_like(x)
    stats = torch.empty((2 * k, c), dtype=torch.float32, device=x.device)
    run = torch.empty((2 * k, c), dtype=torch.float32, device=x.device)
    ptrs, keep = [], []  # keep: the float32 running statistics, alive until the launch
    for i in range(2):
        if i < k:
            scale, bias, rmean, rvar = norms[i]
            rm, rv = rmean.float().contiguous(), rvar.float().contiguous()
            keep += [rm, rv]
            ptrs += [parts[i].data_ptr(), scale.data_ptr(), bias.data_ptr(), rm.data_ptr(),
                     rv.data_ptr(), stats[2 * i].data_ptr(), run[2 * i].data_ptr()]
        else:
            ptrs += [None] * 7
    mode = 0 if other is None else 2 if k == 2 else 1
    _launch("bn_train", build().wadt_bn_train_apply, x.device, x.data_ptr(),
            None if other is None else other.data_ptr(), *ptrs, y.data_ptr(), n, c, h * w,
            parts[0].shape[0], float(count), mode, int(relu),
            int(x.dtype == torch.bfloat16), _sm_count(x.device))
    return y, stats, run


def _masked(dy: torch.Tensor, y: torch.Tensor, relu: bool) -> torch.Tensor:
    """The gradient past the ReLU in float32: ``threshold_backward`` on the output."""
    g = dy.float()
    return torch.where(y <= 0, 0.0, g) if relu else g


def bn_train_grad_stats_plain(dy, y, x, other, stats, relu: bool) -> torch.Tensor:
    """The gradient's sums: (sum g, sum g (x - mean)) per channel, and sum
    g (other - mean2) with a second norm's ``other``, in float64 from
    float32 products -> [1, C, 2 or 3]."""
    g = _masked(dy, y, relu)
    cols = [g, g * (x.float() - _chw(stats[0]))]
    if other is not None:
        cols.append(g * (other.float() - _chw(stats[2])))
    return torch.stack([t.double().sum((0, 2, 3)) for t in cols], -1)[None]


def _bn_grad_stats(dy, y, x, other, stats, relu):
    if not x.is_cuda:
        return bn_train_grad_stats_plain(dy, y, x, other, stats, relu)
    n, c, h, w = x.shape
    splits = bn_train_splits(n, h * w)
    part = torch.empty((splits, c, 2 if other is None else 3), dtype=torch.float64, device=x.device)
    _launch("bn_train_backward", build().wadt_bn_train_grad_stats, x.device, dy.data_ptr(),
            y.data_ptr(), x.data_ptr(), None if other is None else other.data_ptr(),
            stats.data_ptr(), part.data_ptr(), n, c, h * w, splits, int(relu),
            int(x.dtype == torch.bfloat16))
    return part


def bn_train_grad_apply_plain(dy, y, x, other, stats, scales, glob, local, relu: bool, count: int,
                              mode: int):
    """The gradients: dx, then ``other``'s (mode 1, an identity: the masked
    gradient itself; mode 2, a second norm's input: its own dx) or None,
    then each norm's (dscale, dbias) from the ``local`` sums; dx and
    other's from the ``glob`` sums (the global batch's), in float32 with one
    rounding to x's type."""
    g = _masked(dy, y, relu)
    gs, ls = glob.sum(0), local.sum(0)

    def one(t, m, v, scale, col):
        rstd = torch.reciprocal(torch.sqrt(v + EPS))
        inv = scale.float() * rstd
        beta = (-inv.double() * rstd * rstd * gs[:, col] / count).float()
        delta = (-inv.double() * gs[:, 0] / count).float()
        dt = _chw(beta) * (t.float() - _chw(m)) + (_chw(inv) * g + _chw(delta))
        return (dt.to(x.dtype), (ls[:, col] * rstd.double()).float().to(scale.dtype),
                ls[:, 0].float().to(scale.dtype))

    dx, dscale, dbias = one(x, stats[0], stats[1], scales[0], 1)
    if mode == 2:
        dother, dscale2, dbias2 = one(other, stats[2], stats[3], scales[1], 2)
        return dx, dscale, dbias, dother, dscale2, dbias2
    return dx, dscale, dbias, (g.to(x.dtype) if mode == 1 else None), None, None


def _bn_grad_apply(dy, y, x, other, stats, scales, glob, local, relu, count, mode):
    if not x.is_cuda:
        return bn_train_grad_apply_plain(dy, y, x, other, stats, scales, glob, local, relu, count,
                                         mode)
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    dother = None if mode == 0 else torch.empty_like(x)
    dvec = torch.empty((4 if mode == 2 else 2, c), dtype=x.dtype, device=x.device)
    _launch("bn_train_backward", build().wadt_bn_train_grad_apply, x.device, dy.data_ptr(),
            y.data_ptr(), x.data_ptr(), None if mode != 2 else other.data_ptr(), stats.data_ptr(),
            scales[0].data_ptr(), None if mode != 2 else scales[1].data_ptr(), glob.data_ptr(),
            local.data_ptr(), dx.data_ptr(), None if dother is None else dother.data_ptr(),
            dvec.data_ptr(), n, c, h * w, glob.shape[0], float(count), mode, int(relu),
            int(x.dtype == torch.bfloat16), _sm_count(x.device))
    if mode == 2:
        return dx, dvec[0], dvec[1], dother, dvec[2], dvec[3]
    return dx, dvec[0], dvec[1], dother, None, None


# -- the route: statistics, [all-reduce], apply; backward sums, [all-reduce], gradients


def _bn_train_forward(x, scale, bias, rmean, rvar, other, scale2, bias2, rmean2, rvar2, relu,
                      shard=None):
    """The statistics step, the sums all-reduced over ``shard``'s data group
    where given, then the apply step -> (y, [2k, C] float32 batch mean and
    variance, then the second norm's; [2k, C] float32 new running mean and
    variance, then the second norm's)."""
    second = (scale2, bias2, rmean2, rvar2)
    given = sum(t is not None for t in second)
    if given not in (0, 4) or (given and other is None):
        raise ValueError("bn_train: a second norm takes all four vectors and the tensor it "
                         "normalizes")
    if x.is_cuda and not _bn_train_fits(x, other, (scale, bias, scale2, bias2),
                                        (rmean, rvar, rmean2, rvar2)):
        raise ValueError(
            "bn_train: the kernels take contiguous NCHW float32 or bf16 CUDA tensors, with other, "
            "scale and bias [C] of x's type and device and running statistics [C] of float32 or "
            "x's type"
        )
    parts = [_bn_stats(x)] + ([_bn_stats(other)] if given else [])
    if shard is not None:
        parts = [shard.all_reduce(t) for t in parts]
    norms = [(scale, bias, rmean, rvar)] + ([second] if given else [])
    return _bn_apply(x, other, parts, norms, relu, _bn_count(x, shard))


def _bn_train_grads(dy, x, y, other, stats, scale, scale2, relu, count, shard=None):
    """The backward: the gradient's sums, all-reduced over ``shard``'s data
    group where given (dx reads the global sums, dscale and dbias this
    rank's), then the gradients -> (dx, dscale, dbias, other's gradient,
    dscale2, dbias2)."""
    mode = 0 if other is None else 2 if scale2 is not None else 1
    dy = dy.contiguous()
    local = _bn_grad_stats(dy, y, x, other if mode == 2 else None, stats, relu)
    glob = local if shard is None else shard.all_reduce(local)
    return _bn_grad_apply(dy, y, x, other, stats, (scale, scale2), glob, local, relu, count, mode)


# the operator's arguments that carry a gradient, in _bn_train_grads' order
_BN_TRAIN_GRAD_ARGS = (0, 1, 2, 5, 6, 7)


def _bn_train_setup(ctx, inputs, output) -> None:
    x, scale, _, _, _, other, scale2, _, _, _, relu = inputs
    y, stats, run = output
    ctx.mark_non_differentiable(stats, run)
    ctx.save_for_backward(x, other, y, stats, scale, scale2)
    ctx.relu = relu
    ctx.count = _bn_count(x)


def _bn_train_slots(ctx, dy, needs, shard=None) -> tuple:
    """The gradients in the operator's argument order, None where ``needs``
    says none is needed."""
    x, other, y, stats, scale, scale2 = ctx.saved_tensors
    grads = _bn_train_grads(dy, x, y, other, stats, scale, scale2, ctx.relu, ctx.count, shard)
    out = [None] * len(needs)
    for i, g in zip(_BN_TRAIN_GRAD_ARGS, grads):
        out[i] = g if needs[i] else None
    return tuple(out)


def _bn_train_grad(ctx, dy, _dstats, _drun):
    return _bn_train_slots(ctx, dy, ctx.needs_input_grad)


def _bn_train_launch(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, rmean: torch.Tensor,
    rvar: torch.Tensor, other: Optional[torch.Tensor], scale2: Optional[torch.Tensor],
    bias2: Optional[torch.Tensor], rmean2: Optional[torch.Tensor], rvar2: Optional[torch.Tensor],
    relu: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``wadt_torch::bn_train`` on CUDA and CPU tensors alike:
    :func:`_bn_train_forward` -> (y, batch statistics, new running statistics)."""
    return _bn_train_forward(x, scale, bias, rmean, rvar, other, scale2, bias2, rmean2, rvar2,
                             relu)


def _bn_train_fake(x, scale, bias, rmean, rvar, other, scale2, bias2, rmean2, rvar2, relu):
    rows = (2 if scale2 is None else 4, x.shape[1])
    return (x.new_empty(x.shape), x.new_empty(rows, dtype=torch.float32),
            x.new_empty(rows, dtype=torch.float32))


_bn_train = _register("bn_train", _bn_train_launch, _bn_train_launch, _bn_train_fake,
                      _bn_train_setup, _bn_train_grad)


class _BnTrainSplit(torch.autograd.Function):
    """The route with a mesh: the operator's forward and backward with
    ``shard.all_reduce`` between the sums and the pass that reads them (an
    operator cannot carry the mesh)."""

    @staticmethod
    def forward(shard, *args):
        return _bn_train_forward(*args, shard=shard)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _bn_train_setup(ctx, inputs[1:], output)
        ctx.shard = inputs[0]
        ctx.count = _bn_count(inputs[1], inputs[0])

    @staticmethod
    def backward(ctx, dy, _dstats, _drun):
        return (None, *_bn_train_slots(ctx, dy, ctx.needs_input_grad[1:], ctx.shard))


# ---------------------------------------------------------------------------
# The t-SNE's all-pairs repulsion (no TPU counterpart)
# ---------------------------------------------------------------------------

_REPULSION_CHUNK = 1 << 24  # elements of one [rows, N] block of the plain version


def tsne_repulsion_plain(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch all-pairs repulsion in y's floating type, over row
    chunks of [rows, N] (no [N, N] tensor): ``rep_i = sum_{j != i}
    q_ij^2 (y_i - y_j)`` and ``z_i = sum_{j != i} q_ij``, q_ij = 1 / (1 +
    |y_i - y_j|^2), j = i left out by index."""
    n = y.shape[0]
    rep = torch.empty_like(y)
    z = torch.empty(n, dtype=y.dtype, device=y.device)
    rows = max(1, _REPULSION_CHUNK // max(n, 1))
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        dx = y[lo:hi, 0, None] - y[None, :, 0]
        dy = y[lo:hi, 1, None] - y[None, :, 1]
        q = 1.0 / (1.0 + dx.square() + dy.square())
        r = torch.arange(hi - lo, device=y.device)
        q[r, r + lo] = 0.0
        z[lo:hi] = q.sum(1)
        q.square_()
        rep[lo:hi, 0] = (q * dx).sum(1)
        rep[lo:hi, 1] = (q * dy).sum(1)
    return rep, z


def tsne_repulsion(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The t-SNE's all-pairs repulsion of the layout y [N, 2] -> (rep [N, 2],
    z_rows [N]): ``rep_i = sum_{j != i} q_ij^2 (y_i - y_j)``, ``z_i =
    sum_{j != i} q_ij``, q_ij = 1 / (1 + |y_i - y_j|^2); the caller sums
    z_rows in float64 for the normalization Z.

    Replaces no TPU kernel (the JAX package's t-SNE is scikit-learn's, on
    the host, whose Barnes-Hut method approximates this sum).  On this card
    it is bound by operations: N^2 pairs of 12 float32 FLOPs and one MUFU
    reciprocal, ~1.03 ms at N = 65,536.  The kernel gives each row one
    thread, stages the points in shared-memory tiles of 128 and adds each
    tile's float32 sums to the row's totals with Kahan compensation.  CPU
    tensor: the plain version, in y's floating type.  CUDA tensor: the
    ``tsne_repulsion`` kernel, float32 only.
    """
    if y.device.type == "cpu":
        return tsne_repulsion_plain(y)
    _require_cpu_or_cuda(y, "tsne_repulsion")
    if y.ndim != 2 or y.shape[1] != 2:
        raise ValueError(f"tsne_repulsion: expected y [N, 2], got {tuple(y.shape)}")
    dev = y.device
    _check_cuda("tsne_repulsion y", y, torch.float32, dev)
    if y.data_ptr() % 8 != 0:
        raise ValueError("tsne_repulsion: y must be 8-byte aligned")
    n = y.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"tsne_repulsion: N = {n} is beyond the kernel's int indices")
    rep = torch.empty_like(y)
    z = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return rep, z
    _launch("tsne_repulsion", build().wadt_tsne_repulsion, dev, y.data_ptr(), rep.data_ptr(),
            z.data_ptr(), n)
    return rep, z


# ---------------------------------------------------------------------------
# HDBSCAN's core distances and Prim's MST (no TPU counterpart)
# ---------------------------------------------------------------------------

_HDBSCAN_CHUNK = 1 << 25  # elements of one [rows, N] block of the plain core distances
HDBSCAN_FAST_K = 32  # largest k of csrc/hdbscan.cu's insertion path; above it, its radix select
HDBSCAN_MST_MAX_DIMS = 16384  # the MST kernel keeps x_cur in shared memory
HDBSCAN_MST_THREADS = 256  # threads of a block of csrc/hdbscan.cu's MST kernel
HDBSCAN_MST_BLOCKS_PER_SM = 2  # the MST kernel's grid, at most: ~2 x 132 partials to reduce a step


def _add_squares(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """acc += (a - b) * (a - b): a subtraction, a product and a sum, each
    rounded on its own (no ``addcmul`` or ``pow``), as scikit-learn sums a
    squared distance."""
    t = a - b
    acc += t * t


def _sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """float64 square root, correctly rounded as IEEE 754 asks and as the C
    library's ``sqrt`` under scikit-learn gives it: ``torch.sqrt`` on the
    card; numpy's on the CPU, where torch's vectorized float64 square root
    is one ulp off on ~0.7 % of values."""
    if t.device.type == "cpu":
        return torch.from_numpy(np.sqrt(t.numpy()))
    return t.sqrt()


def hdbscan_core_distances_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch core distances in float64 on x's device: each point's
    k-th smallest euclidean distance to the N points of x [N, D], itself at
    0 included.  Row chunks of [rows, N] squared distances, summed one
    coordinate at a time: no [N, N] tensor."""
    x = x.double()
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.float64, device=x.device)
    rows = max(1, _HDBSCAN_CHUNK // max(n, 1))
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        d2 = torch.zeros((hi - lo, n), dtype=torch.float64, device=x.device)
        for c in range(x.shape[1]):
            _add_squares(d2, x[lo:hi, c, None], x[None, :, c])
        out[lo:hi] = torch.kthvalue(d2, k, dim=1).values
    return _sqrt_rn(out)


def hdbscan_prim_mst_plain(x: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Prim's MST of the mutual reachability graph in float64
    on x's device, one row of distances a step (no [N, N] tensor) ->
    [N - 1, 3] rows of (node in the tree, node added, weight), in the order
    scikit-learn's ``mst_from_data_matrix`` adds them.  The node indices
    stay tensors: no step waits for the device.  A step's squared
    differences are taken for all D coordinates at once and then summed one
    coordinate at a time, each operation rounded on its own."""
    xt = x.double().t().contiguous()
    core = core.double()
    n, dev = x.shape[0], x.device
    in_tree = torch.zeros(n, dtype=torch.bool, device=dev)
    min_reach = torch.full((n,), float("inf"), dtype=torch.float64, device=dev)
    source = torch.ones(n, dtype=torch.long, device=dev)
    order = torch.empty(n - 1, dtype=torch.long, device=dev)
    cur = torch.zeros(1, dtype=torch.long, device=dev)
    for i in range(n - 1):
        in_tree.index_fill_(0, cur, True)
        sq = xt.index_select(1, cur) - xt
        sq *= sq
        d2 = sq[0]
        for c in range(1, xt.shape[0]):
            d2 += sq[c]
        mrd = torch.maximum(torch.maximum(core.index_select(0, cur), core), _sqrt_rn(d2))
        better = ~in_tree & (mrd < min_reach)
        min_reach = torch.where(better, mrd, min_reach)
        source = torch.where(better, cur, source)
        cur = torch.argmin(torch.where(in_tree, float("inf"), min_reach)).view(1)  # the first of equals
        order[i:i + 1] = cur
    # a node's source and min_reach stay as they were when it joined the tree
    return torch.stack((source[order].double(), order.double(), min_reach[order]), 1)


def _hdbscan_points(x: torch.Tensor, what: str) -> Tuple[int, int]:
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: expected float32 or float64 points [N, D], got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, d = x.shape
    if n >= 2 ** 31 or n * d >= 2 ** 40:
        raise ValueError(f"{what}: {n} points of {d} dimensions are beyond the kernel's indices")
    return n, d


def hdbscan_core_distances(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each point's core distance -> [N] float64: its k-th smallest
    euclidean distance to the N points of x [N, D] (float32 or float64),
    itself at 0 included; ``NearestNeighbors(n_neighbors=k).kneighbors(x)``'s
    last column, bit for bit.  1 <= k <= N.

    Replaces no TPU kernel (the JAX package's HDBSCAN is scikit-learn's, on
    the host).  On this card it is bound by operations: 3 N^2 D float64
    operations, none of them fused.  The kernel (``csrc/hdbscan.cu``) gives
    each row one thread over tiles staged in shared memory, keeps the K
    smallest squared distances (K 8 for k <= 8, else 32) for k <=
    ``HDBSCAN_FAST_K`` and radix-selects the k-th on their bits above.  CPU
    tensor: the plain version.  CUDA tensor: the ``hdbscan_core`` kernel.
    """
    n = x.shape[0] if x.ndim else 0
    if not 1 <= k <= n:
        raise ValueError(f"hdbscan_core_distances: k must be in [1, N = {n}], got {k}")
    if x.device.type == "cpu":
        return hdbscan_core_distances_plain(x, k)
    _require_cpu_or_cuda(x, "hdbscan_core")
    n, d = _hdbscan_points(x, "hdbscan_core_distances")
    dev = x.device
    xt = x.t().contiguous()
    out = torch.empty(n, dtype=torch.float64, device=dev)
    _launch("hdbscan_core", build().wadt_hdbscan_core, dev, xt.data_ptr(),
            int(x.dtype == torch.float64), n, d, k, out.data_ptr())
    return out


def hdbscan_prim_mst(x: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """Prim's MST of the mutual reachability graph ``max(core_i, core_j,
    d_ij)`` of x [N, D] (float32 or float64, N >= 2) and its core distances
    (float64 [N]) -> [N - 1, 3] float64 rows of (node in the tree, node
    added, weight), grown from node 0 in the order scikit-learn's
    ``mst_from_data_matrix`` adds them, ties to the lowest index: its edges
    bit for bit.

    Replaces no TPU kernel.  On this card it is bound by its N - 1
    dependent steps, each a global arg-min.  The kernel
    (``csrc/hdbscan.cu``) is one cooperative launch for the whole tree with
    one grid barrier a step; min_reach, source and in_tree stay on the
    card.  CPU tensor: the plain version.  CUDA tensor: the ``hdbscan_mst``
    kernel (D up to ``HDBSCAN_MST_MAX_DIMS``).
    """
    if x.device.type == "cpu":
        return hdbscan_prim_mst_plain(x, core)
    _require_cpu_or_cuda(x, "hdbscan_mst")
    n, d = _hdbscan_points(x, "hdbscan_prim_mst")
    if n < 2:
        raise ValueError(f"hdbscan_prim_mst: needs at least 2 points, got {n}")
    if d > HDBSCAN_MST_MAX_DIMS:
        raise ValueError(f"hdbscan_prim_mst: D = {d} is beyond the kernel's {HDBSCAN_MST_MAX_DIMS}")
    dev = x.device
    _check_cuda("hdbscan_prim_mst core", core, torch.float64, dev, (n,))
    xt = x.t().contiguous()
    max_blocks = HDBSCAN_MST_BLOCKS_PER_SM * _sm_count(dev)
    min_reach = torch.empty(n, dtype=torch.float64, device=dev)
    source = torch.empty(n, dtype=torch.int32, device=dev)
    in_tree = torch.empty(n, dtype=torch.uint8, device=dev)
    partials = torch.empty(2 * max_blocks * 16, dtype=torch.uint8, device=dev)
    bar = torch.empty(2, dtype=torch.int32, device=dev)
    edges = torch.empty((n - 1, 3), dtype=torch.float64, device=dev)
    _launch("hdbscan_mst", build().wadt_hdbscan_mst, dev, xt.data_ptr(),
            int(x.dtype == torch.float64), core.data_ptr(), n, d, min_reach.data_ptr(),
            source.data_ptr(), in_tree.data_ptr(), partials.data_ptr(), max_blocks,
            bar.data_ptr(), edges.data_ptr())
    return edges


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
