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
  int8 fold product and ``mlp_q8`` layers;
- ``gram_proj`` (``csrc/gram_proj.cu``) replaces ``make_proj_kernel.proj``
  (``tools/exp_pmg_projkernel.py:65``), the bf16 token projection of the
  PMG batch path read from the row-major Gram.

The sources are compiled for ``sm_90a`` by ``nvcc`` at first use, one
process per source started together, and linked into one shared library
under ``csrc/_build/`` (named by a hash of sources and flags, so a changed
source rebuilds).  The library has a plain C interface loaded with ctypes.

Each wrapper takes its plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel on the current stream or raises: a
missing ``nvcc``, a failed build or a refused launch is an error, never a
fallback.  ``LAUNCHES`` counts kernel launches per wrapper.
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
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import IMAGENET_MEAN, IMAGENET_STD
from .attention import stacked_task_heads, task_query_pool, transformer_encoder
from .gram import split_patches
from .nn import cast_tree, leaky_relu
from .preprocess import s2d_pack

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(_CSRC, "_build")
_SOURCES = ("patch_gram.cu", "stem.cu", "trunk_gram.cu", "head.cu", "int8_matvec.cu",
            "gram_proj.cu")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_HEAD_CHUNK_ROWS = 256  # token_proj rows per block of csrc/head.cu's first launch
_GRAM_PROJ_BLOCKS_PER_SM = 8  # csrc/gram_proj.cu splits K until about this many blocks
_GRAM_PROJ_TILE = 64  # its output tile edge and K step

LAUNCHES: Dict[str, int] = {
    "patch_gram": 0, "stem": 0, "fused_trunk_gram": 0, "fused_head": 0, "dequant_matvec": 0,
    "gram_proj": 0,
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
            fn.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr]
            fn.restype = i32
        lib.wadt_stem_u8_f32.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr
        ]
        lib.wadt_stem_u8_f32.restype = i32
        lib.wadt_trunk_gram_u8.argtypes = [ptr] * 10 + [i32] * 11 + [ptr]
        lib.wadt_trunk_gram_u8.restype = i32
        lib.wadt_fused_head.argtypes = [
            ptr, ptr, i32, ptr, ptr, ctypes.POINTER(ptr), i32, ptr, ptr, ptr, ptr, i32,
            ptr, i32, i32, i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.wadt_fused_head.restype = i32
        lib.wadt_dequant_matvec.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.wadt_dequant_matvec.restype = i32
        lib.wadt_gram_proj_bf16.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        lib.wadt_gram_proj_bf16.restype = i32
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


def _launch(kernel: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed") from torch.cuda.CudaError(err)
    LAUNCHES[kernel] += 1


def _require_cuda(x: torch.Tensor, kernel: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"{kernel}: tensors on {x.device.type} are not supported "
            "(CUDA runs the kernel, the CPU its plain version)"
        )


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


def patch_gram(x: torch.Tensor, div: int) -> torch.Tensor:
    """Replicate-pad, split into div*div row-major patches, per-patch
    ``P^T P / area`` summed in float32 -> [B, div*div, C*C] of x's dtype
    (bf16: rounded once, to nearest even).

    CPU tensor: the plain version.  CUDA tensor: the ``patch_gram`` kernel,
    float32 or bf16 NHWC contiguous only.
    """
    if x.device.type == "cpu":
        return patch_gram_plain(x, div)
    _require_cuda(x, "patch_gram")
    if x.ndim != 4 or div < 1:
        raise ValueError(f"patch_gram: expected NHWC and div >= 1, got {tuple(x.shape)}, {div}")
    dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    _check_cuda("patch_gram x", x, dtype, x.device)
    b, h, w, c = x.shape
    out = torch.empty((b, div * div, c * c), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build()
    fn = lib.wadt_patch_gram_bf16 if dtype == torch.bfloat16 else lib.wadt_patch_gram_f32
    _launch("patch_gram", fn, x.device, x.data_ptr(), out.data_ptr(), b, h, w, c, div)
    return out


# ---------------------------------------------------------------------------
# K2: uint8 stem (normalize folded into the weight, k=s p0 conv, affine, LReLU)
# ---------------------------------------------------------------------------


def stem_plain(
    x8: torch.Tensor, w2d: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
    k: int, leaky: bool = True,
) -> torch.Tensor:
    """Plain PyTorch stem: space-to-depth pack, one GEMM, affine, LeakyReLU."""
    u = s2d_pack(x8, k).to(torch.float32)
    y = torch.matmul(u, w2d) * scale + shift
    return leaky_relu(y, 0.2) if leaky else y


def stem(
    x8: torch.Tensor, w2d: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
    k: int, leaky: bool = True,
) -> torch.Tensor:
    """uint8 NHWC [B,H,W,cin] -> float32 [B,H/k,W/k,cout]:
    ``act(scale * (s2d(x) @ w2d) + shift)``, act = LeakyReLU(0.2) if ``leaky``.

    ``w2d`` is the kernel == stride == k conv weight as [k*k*cin, cout] in
    (dy, dx, ci) row order, with the normalize already folded in.
    CPU tensor: the plain version.  CUDA tensor: the ``stem`` kernel.
    """
    if x8.device.type == "cpu":
        return stem_plain(x8, w2d, scale, shift, k, leaky)
    _require_cuda(x8, "stem")
    if x8.ndim != 4:
        raise ValueError(f"stem: expected uint8 NHWC, got {tuple(x8.shape)}")
    b, h, w, cin = x8.shape
    cout = w2d.shape[-1]
    if w2d.shape != (k * k * cin, cout) or scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError(
            f"stem: weight {tuple(w2d.shape)}, scale {tuple(scale.shape)}, shift "
            f"{tuple(shift.shape)} do not fit k={k}, cin={cin}"
        )
    if h < k or w < k:
        raise ValueError(f"stem: image {h}x{w} is smaller than the kernel {k}")
    _check_cuda("stem x", x8, torch.uint8, x8.device)
    for name, t in (("w", w2d), ("scale", scale), ("shift", shift)):
        _check_cuda(f"stem {name}", t, torch.float32, x8.device)
    out = torch.empty((b, h // k, w // k, cout), dtype=torch.float32, device=x8.device)
    if out.numel() == 0:
        return out
    lib = build()
    _launch("stem", lib.wadt_stem_u8_f32, x8.device,
            x8.data_ptr(), w2d.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), b, h, w, cin, k, cout, int(leaky))
    return out


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


def fused_trunk_gram(x8: torch.Tensor, weights, spec) -> torch.Tensor:
    """Raw uint8 NHWC images [B, H, W, cin] -> per-patch Gram tokens
    [B, div*div, gc*gc] through the whole trunk and ``chan_proj``, on a
    :func:`fold_trunk_gram_weights` fold.  Rows and columns beyond a multiple
    of K = k1*k2 are ignored, as the strided convolutions ignore them.

    CPU tensor: the plain version.  CUDA tensor: the ``fused_trunk_gram``
    kernel, which reads the raw frame (no space-to-depth copy).
    """
    if x8.device.type == "cpu":
        return fused_trunk_gram_plain(x8, weights, spec)
    _require_cuda(x8, "fused_trunk_gram")
    if not supports_fused_trunk_gram(spec):
        raise ValueError(
            "the fused trunk kernel needs a [k=s p0, k=s p0, 1x1] trunk plan without SE"
        )
    b0, b1, b2 = spec.plan
    k1, k2, cin = b0.kernel, b1.kernel, b0.cin
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
    c0, c1, c2, gc = b0.cout, b1.cout, b2.cout, spec.gram_channels
    shapes = (
        (K * K * cin, k2 * k2 * c0), (k2 * k2 * c0,), (k2 * k2 * c0, c1), (c1,),
        (c1, c2), (c2,), (c2, gc), (gc,),
    )
    if len(weights) != len(shapes):
        raise ValueError(f"fused_trunk_gram: expected 8 folded arrays, got {len(weights)}")
    for i, (t, shape) in enumerate(zip(weights, shapes)):
        _check_cuda(f"fused_trunk_gram weight {i}", t,
                    torch.bfloat16 if i % 2 == 0 else torch.float32, dev, shape)
    div = spec.patch_div
    out = torch.empty((b, div * div, gc * gc), dtype=torch.float32, device=dev)
    lib = build()
    _launch("fused_trunk_gram", lib.wadt_trunk_gram_u8, dev, x8.data_ptr(),
            *(t.data_ptr() for t in weights), out.data_ptr(),
            b, h, w, cin, k1, k2, c0, c1, c2, gc, div)
    return out


# ---------------------------------------------------------------------------
# K4: fused head (the camera path's head)
# ---------------------------------------------------------------------------

# The kernel's per-layer weights, in the order of its pointer table.
_LAYER_LEAVES = (
    ("norm1", "scale"), ("norm1", "bias"), ("attn", "wq"), ("attn", "bq"),
    ("attn", "wk"), ("attn", "bk"), ("attn", "wv"), ("attn", "bv"),
    ("attn", "wo"), ("attn", "bo"), ("norm2", "scale"), ("norm2", "bias"),
    ("ffn1", "w"), ("ffn1", "b"), ("ffn2", "w"), ("ffn2", "b"),
)
_MAX_HEAD_LAYERS = 8  # csrc/head.cu kMaxLayers


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


def fused_head(tokens: torch.Tensor, folded: Dict[str, Any], spec) -> torch.Tensor:
    """Gram tokens [B, Np, gc*gc] + a ``fold_head_weights`` tree (bf16 or
    q8) -> stacked logits [B, T, Kmax]: ``token_proj``, the fold's
    transformer layers, task-query pooling and the heads.

    CPU tensor: the plain version.  CUDA tensor: the ``fused_head`` kernel
    (two launches, counted as one call).
    """
    if tokens.device.type == "cpu":
        return fused_head_plain(tokens, folded, spec)
    _require_cuda(tokens, "fused_head")
    if tokens.ndim != 3:
        raise ValueError(f"fused_head: expected tokens [B, Np, D], got {tuple(tokens.shape)}")
    dev = tokens.device
    _check_cuda("fused_head tokens", tokens, torch.float32, dev)
    b, npatch, din = tokens.shape
    tp = folded["token_proj"]
    q8 = "w8" in tp
    w = tp["w8"] if q8 else tp["w"]
    d = w.shape[-1]
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
    if layers and (d % heads or d % 16 or ff % 16):
        raise ValueError(
            f"fused_head: the kernel takes model and FFN widths that are multiples of 16 "
            f"and divide into the heads; got d={d}, ffn={ff}, {heads} heads"
        )
    ffn_shapes = {("ffn1", "w"): (d, ff), ("ffn1", "b"): (ff,), ("ffn2", "w"): (ff, d)}
    ptrs = []
    for li, lp in enumerate(layers):
        for grp, leaf in _LAYER_LEAVES:
            t = lp[grp][leaf]
            matrix = leaf.startswith("w")
            shape = ffn_shapes.get((grp, leaf), (d, d) if matrix else (d,))
            dtype = torch.bfloat16 if matrix else torch.float32
            _check_cuda(f"fused_head layer {li} {grp}.{leaf}", t, dtype, dev, shape)
            ptrs.append(t.data_ptr())
    queries, hw, hb = folded["queries"], folded["heads"]["w"], folded["heads"]["b"]
    ntask, kmax = hb.shape
    _check_cuda("fused_head queries", queries, torch.float32, dev, (ntask, d))
    _check_cuda("fused_head heads w", hw, torch.float32, dev, (ntask, d, kmax))
    _check_cuda("fused_head heads b", hb, torch.float32, dev, (ntask, kmax))
    chunks = -(-din // _HEAD_CHUNK_ROWS)
    partial = torch.empty((chunks, b * npatch, d), dtype=torch.float32, device=dev)
    out = torch.empty((b, ntask, kmax), dtype=torch.float32, device=dev)
    table = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    lib = build()
    _launch("fused_head", lib.wadt_fused_head, dev, tokens.data_ptr(), w.data_ptr(), int(q8),
            scale.data_ptr() if q8 else None, tp["b"].data_ptr(), table, len(layers),
            queries.data_ptr(), hw.data_ptr(), hb.data_ptr(), partial.data_ptr(), chunks,
            out.data_ptr(), b, npatch, din, d, ff, heads, ntask, kmax)
    return out


# ---------------------------------------------------------------------------
# K6: per-task weight-only int8 matvec (the RTM camera path's fold product)
# ---------------------------------------------------------------------------


def dequant_matvec_plain(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch per-task int8 product: ``(x[:, t] @ float(w8[t])) * scale[t]``."""
    return torch.einsum("btc,tcd->btd", x, w8.to(torch.float32)) * scale


def dequant_matvec(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x float32 [B, T, C], w8 int8 [T, C, D], scale float32 [T, D] ->
    y float32 [B, T, D] = ``(x[:, t] @ w8[t]) * scale[t]``, summed in float32.

    Replaces ``int8_pallas`` (``tools/exp_rtm_int8_stream.py:77``, body
    ``_dequant_matvec_kernel``).  On this card it is bound by reading w8
    once: 50.3 MB at the RTM camera shape (T 12, C = D 2048), ~15 us at
    3.35 TB/s.  CPU tensor: the plain version.  CUDA tensor: the
    ``dequant_matvec`` kernel, contiguous tensors only.
    """
    if x.device.type == "cpu":
        return dequant_matvec_plain(x, w8, scale)
    _require_cuda(x, "dequant_matvec")
    if x.ndim != 3 or w8.ndim != 3:
        raise ValueError(
            f"dequant_matvec: expected x [B, T, C] and w8 [T, C, D], got "
            f"{tuple(x.shape)} and {tuple(w8.shape)}"
        )
    b, t, c = x.shape
    d = w8.shape[-1]
    dev = x.device
    _check_cuda("dequant_matvec x", x, torch.float32, dev)
    _check_cuda("dequant_matvec w8", w8, torch.int8, dev, (t, c, d))
    _check_cuda("dequant_matvec scale", scale, torch.float32, dev, (t, d))
    out = torch.empty((b, t, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build()
    _launch("dequant_matvec", lib.wadt_dequant_matvec, dev, x.data_ptr(), w8.data_ptr(),
            scale.data_ptr(), out.data_ptr(), b, t, c, d)
    return out


# ---------------------------------------------------------------------------
# K5: bf16 token projection from the row-major Gram (the bf16 batch path)
# ---------------------------------------------------------------------------


def gram_proj_plain(g: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch token projection: ``float(g) @ float(w) + b`` in float32
    (the products of bf16 values are exact in float32)."""
    return torch.matmul(g.float(), w.float()) + b.float()


def gram_proj(g: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gram tokens g bf16 [B, Np, C*C] (the row-major per-patch Gram,
    flattened), ``token_proj`` w bf16 [C*C, N] in its own order, bias b
    float32 [N] -> float32 [B, Np, N] = ``g @ w + b``, summed in float32.

    Replaces ``make_proj_kernel.proj`` (``tools/exp_pmg_projkernel.py:65``),
    which took w transposed to d-major; the Gram is symmetric, so the two
    are the same product.  CPU tensor: the plain version.  CUDA tensor: the
    ``gram_proj`` kernel, contiguous tensors with K and N multiples of 8
    and g and w 16-byte aligned only (every spec's C*C and d_model are);
    K is split into slices (float32 scratch, a second launch adds them)
    until there are about eight blocks per SM.
    """
    if g.device.type == "cpu":
        return gram_proj_plain(g, w, b)
    _require_cuda(g, "gram_proj")
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
    if k % 8 or n % 8 or g.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(
            f"gram_proj: K = {k} and N = {n} must be multiples of 8, and g and w 16-byte aligned"
        )
    out = torch.empty((bsz, npatch, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    m, t = bsz * npatch, _GRAM_PROJ_TILE
    tiles = -(-m // t) * -(-n // t)
    splits = max(1, min(-(-_GRAM_PROJ_BLOCKS_PER_SM * _sm_count(dev) // tiles), k // (8 * t)))
    part = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else None
    lib = build()
    _launch("gram_proj", lib.wadt_gram_proj_bf16, dev, g.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(), m, n, k, splits)
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
