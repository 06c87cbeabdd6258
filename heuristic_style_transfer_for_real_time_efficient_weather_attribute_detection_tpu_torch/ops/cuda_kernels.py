"""Hand-written CUDA kernels of the port, their plain PyTorch versions, and
their launch counts.

Counterpart of the JAX package's ``ops/pallas_kernels.py``:

- ``patch_gram`` (``csrc/patch_gram.cu``) replaces ``patch_gram_tokens_pallas``;
- ``stem`` (``csrc/stem.cu``) replaces ``fused_stem``.

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
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

import torch

from .gram import split_patches
from .nn import leaky_relu
from .preprocess import s2d_pack

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(_CSRC, "_build")
_SOURCES = ("patch_gram.cu", "stem.cu")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {"patch_gram": 0, "stem": 0}

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
        lib.wadt_patch_gram_f32.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.wadt_patch_gram_f32.restype = i32
        lib.wadt_stem_u8_f32.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr
        ]
        lib.wadt_stem_u8_f32.restype = i32
        _lib = lib
        return lib


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
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
    """Plain PyTorch per-patch Gram: NHWC [B,H,W,C] -> [B, div*div, C*C]."""
    patches, area = split_patches(x, div)
    b, np_, _, c = patches.shape
    g = torch.einsum("bpnc,bpnd->bpcd", patches, patches) * (1.0 / float(area))
    return g.reshape(b, np_, c * c)


def patch_gram(x: torch.Tensor, div: int) -> torch.Tensor:
    """Replicate-pad, split into div*div row-major patches, per-patch
    ``P^T P / area`` in float32 -> [B, div*div, C*C].

    CPU tensor: the plain version.  CUDA tensor: the ``patch_gram`` kernel,
    float32 NHWC contiguous only.
    """
    if x.device.type == "cpu":
        return patch_gram_plain(x, div)
    _require_cuda(x, "patch_gram")
    if x.ndim != 4 or div < 1:
        raise ValueError(f"patch_gram: expected NHWC and div >= 1, got {tuple(x.shape)}, {div}")
    _check_cuda("patch_gram x", x, torch.float32, x.device)
    b, h, w, c = x.shape
    out = torch.empty((b, div * div, c * c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = build()
    _launch("patch_gram", lib.wadt_patch_gram_f32, x.device,
            x.data_ptr(), out.data_ptr(), b, h, w, c, div)
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
