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
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

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
        lib.wadt_dequant_matvec.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.wadt_dequant_matvec.restype = i32
        lib.wadt_gram_proj_bf16.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
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


def _launch(kernel: str, fn, device: torch.device, *args, count: bool = True) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed") from torch.cuda.CudaError(err)
    if count:
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

    CPU tensor: the plain version.  CUDA tensor: the ``patch_gram`` kernel on
    :func:`patch_gram_plan`'s persistent grid, float32 or bf16 NHWC
    contiguous only.
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
    plan = patch_gram_plan(b, h, w, c, div, _sm_count(x.device), dtype == torch.bfloat16)
    lib = build()
    fn = lib.wadt_patch_gram_bf16 if dtype == torch.bfloat16 else lib.wadt_patch_gram_f32
    _launch("patch_gram", fn, x.device, x.data_ptr(), out.data_ptr(), b, h, w, c, div, plan.kc,
            plan.band, plan.grid)
    return out


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
    bf16).  CPU tensor: the plain version.  CUDA tensor: the ``stem``
    kernel on :func:`stem_plan`'s plan.
    """
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stem: out_dtype must be float32 or bfloat16, got {out_dtype}")
    bf16 = out_dtype == torch.bfloat16
    if bf16 and (bias is None or (scale is None) != (shift is None)):
        raise ValueError("stem: bf16 takes a bias, and scale and shift both or neither")
    if not bf16 and (bias is not None or scale is None or shift is None):
        raise ValueError("stem: float32 takes scale and shift and no bias")
    if x8.device.type == "cpu":
        return stem_plain(x8, w2d, scale, shift, k, leaky, out_dtype, bias)
    _require_cuda(x8, "stem")
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
    _require_cuda(x8, "fused_trunk_gram")
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
    _require_cuda(tokens, "fused_head")
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
    are the same product.  CPU tensor: the plain version.  CUDA tensor: the
    ``gram_proj`` kernel on :func:`gram_proj_plan`'s launch plan, contiguous
    tensors with K and N multiples of 8 and g, w and b 16-byte aligned only
    (every spec's C*C and d_model are).
    """
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gram_proj: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if g.device.type == "cpu":
        return gram_proj_plain(g, w, b, out_dtype)
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


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
