#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of the repository:

    python3 chip_smoke.py [--profile]

Phases, each of which raises on failure:

1. print the card's name and power limit (nvidia-smi), build the six CUDA
   kernels from ``<port>/csrc`` (nvcc, sm_90a, one process per source);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and on ragged shapes that take their other code paths
   (K2: float32 at 2e-4, two calls bit-identical, the bf16 mode to limits
   (a) and (b) of PERF.md section 2, with the load and store paths each
   call took);
3. golden fixture: the shipped PMG checkpoint's logits on the fixture input
   match the frozen reference logits at 2e-4;
4. main path: ``Engine.run`` at batch 256 on 600 seeded uint8 224-px frames
   with launch counts reset just before; both kernels must have launched,
   probabilities sum to 1, the first 8 frames' logits match the port's CPU
   path, and ``prob_threshold=0.99`` gives all Unknown;
5. times (CUDA events; card name and power limit beside them): each kernel,
   its plain version and one PyTorch library call that computes the same
   function, beside the least time the card could take (K1: ``torch.baddbmm``
   on the split patches, with ``torch.bmm`` and the ``split_patches`` copy
   they need timed apart; the archived K1 in turns where ``_archive/``
   holds it); K2 in both modes beside its two bounds, the host time of one
   wrapper call, ``torch.addmm`` on the packed operand in float32 and in
   bf16, and where ``_archive/`` holds the previous K2 as ``stem_v1.cu``, the archived
   K2 in turns with the new one and the old bf16 stem block (archived K2,
   cast, batch norm, LeakyReLU) in turns with the bf16 mode; the engine's
   images per second end to end and on device-resident batches.
   ``--profile`` adds K2's stage cut in both modes and a ``torch.profiler``
   table of device time by kernel over a few device-resident steps;
6. the camera path's kernels against their plain versions on the card: the
   fused trunk + Gram at the shipped shapes (batch 1 and 8) and on a ragged
   spec, the fused head for the bf16 and q8 folds (batch 1 and 8), for a
   spec without transformer and for narrow layers (d 64, FFN 128, 2 heads;
   batch 1 and 8, clusters of 8 and 16), each called twice: bit-identical;
7. the golden-fixture walk of the fused head variants on the card: argmax
   agrees on decisive samples, drift <= HEAD_FOLD_MAX_DRIFT;
8. camera path: ``StreamPredictor`` with its default routes on the shipped
   checkpoint over 64 seeded frames, launch counts reset just before; both
   camera kernels must have launched, the probabilities follow the Kalman
   recursion and match the port's CPU path on 8 frames; the packed route
   runs at batch 1 through the stem and Gram kernels;
9. camera times: both camera kernels at batch 1 beside their bounds and
   plain versions, the fused head's two launches apart (and, where the
   gitignored ``_archive/`` holds the previous kernel sources, the previous
   fused trunk + Gram and fused head in turns with the new ones), and
   per-frame latency of three
   routes: device time per
   step back to back, one step's device span on an idle card and the host
   time to enqueue it, and host wall time per frame from ``submit`` to the
   probabilities on the host; at the end of the run, after every host
   timing, device kernels and kernel time per step (``torch.profiler``).
   ``--profile`` adds each route's table of device time by kernel, and the
   head kernel's time with its fold cut to its first 0, 1, ... layers;
10. the RTM int8 kernel (K6, ``dequant_matvec``) against its plain version
    on the card, at the camera path's full-width shape and on the fixtures'
    ragged shapes, within 1e-4 x max|y|;
11. the three RTM golden fixtures on the card: logits of the loaded
    engine's params at 2e-4, and the ``apply_stream`` walk on the float32
    and int8 folds (argmax agrees on every fixture; drift printed);
12. RTM batch inference at full width (ResNet-50 through ``layer4``,
    C = d = 2048, the 12-task registry, seeded random weights):
    ``Engine.run`` at batch 128 over 384 frames, probabilities sum to 1,
    logits match the port's CPU path on 2 frames; device step time and
    end-to-end images per second.  ``--profile`` adds the step's table of
    device time by kernel;
13. the RTM camera path at full width: the default ``folded_q8`` route over
    64 frames with the Kalman filter on, launch counts reset just before;
    K6 must launch once per frame, and the probabilities match the port's
    CPU path on 8 frames (the fold is built once, on the card, and reused
    there).  Per route (``generic``, ``folded``, ``folded_q8``) the latency
    of phase 9, and its device kernels per step at the end of the run; K6
    at batch 1 with L2 out of play beside its bound, its plain version, a
    ``torch.bmm`` yardstick and ``torch._weight_int8pack_mm`` where this
    torch has it;
14. the bf16 path's kernels on the card at its shapes: K1 in bf16 against
    its plain version at batch 256 and on two ragged shapes (atol 0, rtol
    2^-8; two calls bit-identical), with its time, bound and yardsticks
    (and the archived K1 in turns); K2's bf16 mode on the engine's own
    fold to limits (a) and (b); the bf16 ``linear`` (one
    cuBLAS call) within one bf16 ulp of the float32 product plus bias
    rounded; the bf16 token projection kernel (K5, ``gram_proj``) against
    its plain version at batch 256 of the shipped spec (the Gram from K1
    in bf16; two calls bit-identical; bf16 output within one bf16 ulp) and
    on six shapes that take every tile width, ragged M and K tails, within
    1e-4 x max|y|; its time with the Gram read from device memory (four
    rotating copies), its plain version's, ``torch.matmul`` of the same
    bf16 operands, its bound, the host time of one call, and the previous
    K5 in turns where ``_archive/`` holds it;
15. PMG bf16 batch: ``Engine(dtype=torch.bfloat16)`` on the shipped
    checkpoint at batch 256 over phase 4's 600 frames, launch counts reset
    just before; K5 and K1 must have launched.  Argmax agreement (at least
    99.5 % of (frame, task) pairs) and probability drift against phase 4's
    float32 run, the shipped fixture in
    bf16 (argmax on decisive samples, drift <= 0.05), device step time (in
    turns with float32), the host's enqueue time of one step, and
    end-to-end images per second beside the float32 engine's; where the
    gitignored ``_archive/parent/`` holds a parent commit's port, that
    port's PMG step and this tree's in turns, each in its own process;
16. PM: the five PM golden fixtures on the card at 2e-4, ``pm_small``'s
    attention (2e-4) and task embeddings (2e-3); the PM headline spec
    (``pm.build_spec`` on the 12-task registry: ndf 64, patch 70, instance
    norm, SE; seeded ``pm.init`` weights) at batch 256 in float32 and bf16:
    logits against the port's CPU path on 2 frames, device step time and
    images per second;
17. RTM bf16 batch at phase 12's width and batch: argmax agreement and
    probability drift against the float32 run, device step time and images
    per second.

``--profile`` also prints, for phases 15-17, each step's device kernels,
kernel time and table of device time by kernel, and in phase 14 K1's bf16
time with its work cut stage by stage.  Host times come from runs
without ``--profile``: once a profiler session has run, the host's launch
cost stays higher for the rest of the process.

Output: one line per phase, then a ``{"kernels": [...]}`` JSON line, the
card's nvidia-smi line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, with no result line, when no CUDA card is available or the
port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, float32
# FLOP/s outside the tensor cores, and dense bf16 FLOP/s of the tensor
# cores.  A bound counts each operation at the peak of its operands' type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"
JAX_PKG = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu"
FIXTURES = os.path.join("tests", "fixtures")
BATCH = 256
N_FRAMES = 600
CAMERA_FRAMES = 64
LATENCY_FRAMES = 200
K3_TOL = 5e-3  # the JAX package's own bound for the fused trunk (tests/test_pallas.py:133)
K4_TOL = 1e-3
K6_TOL = 1e-4  # times max|y| of the plain version
RTM_BATCH = 128
RTM_FRAMES = 384
K5_TOL = 1e-4  # times max|y| of the plain version
BF16_FIXTURE_DRIFT = 0.05  # logit drift of a bf16 run on a golden fixture (utils/goldens.py)
BF16_PMG_AGREEMENT = 0.995  # share of (frame, task) pairs whose bf16 argmax is float32's (PERF.md 2)
PM_FRAMES = 512


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean device time of ``reps`` back-to-back
    calls, between CUDA events.  A sleep kernel queued first lets the host
    enqueue every call before the first event fires, so host launch cost
    stays outside the interval.  The sleep lasts at least 1.5 times the
    host's measured enqueue time of ``reps`` calls (cycles counted at 2 GHz,
    above the card's SM clock, so the sleep is never shorter)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = max(50_000_000, int(1.5 * enqueue_s * 2e9))
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def bound_ms(nbytes: float, flops: float, bf16_flops: float = 0.0):
    """Least time: bytes over HBM rate, or float32 and bf16 FLOPs over their peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOP_PER_S + bf16_flops / PEAK_BF16_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want, atol: float, rtol: float, what: str) -> float:
    import torch

    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {got.numel()} values outside "
            f"atol={atol} rtol={rtol}; max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


def random_pmg_params(spec, rng):
    """Seeded random PMG params of ``spec`` (float32 CPU tensors, the port's
    tree layout) with non-trivial batch-norm statistics."""
    import torch

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype("float32"))

    def lin(i, o):
        return {"w": t(i, o, scale=i ** -0.5), "b": t(o, scale=0.1)}

    def norm(c, stats=True):
        p = {"scale": t(c, scale=0.1) + 1.0, "bias": t(c, scale=0.1)}
        if stats:
            p.update(mean=t(c, scale=0.1), var=t(c).abs() + 0.5)
        return p

    gc, d = spec.gram_channels, spec.d_model
    params = {
        "trunk": [{"conv": {"w": t(b.kernel, b.kernel, b.cin, b.cout,
                                   scale=(b.kernel * b.kernel * b.cin) ** -0.5)},
                   "norm": norm(b.cout)} for b in spec.plan],
        "chan_proj": {"w": t(1, 1, spec.trunk_channels, gc, scale=spec.trunk_channels ** -0.5)},
        "token_proj": lin(gc * gc, d),
        "queries": t(len(spec.tasks), d, scale=d ** -0.5),
        "heads": {"w": t(len(spec.tasks), d, spec.tasks.max_classes, scale=d ** -0.5),
                  "b": t(len(spec.tasks), spec.tasks.max_classes, scale=0.1)},
    }
    if spec.has_transformer:
        params["transformer"] = [{
            "attn": {**{n: t(d, d, scale=d ** -0.5) for n in ("wq", "wk", "wv", "wo")},
                     **{n: t(d, scale=0.1) for n in ("bq", "bk", "bv", "bo")}},
            "norm1": norm(d, stats=False), "norm2": norm(d, stats=False),
            "ffn1": lin(d, 2 * d), "ffn2": lin(2 * d, d),
        } for _ in range(spec.transformer_layers)]
    return params


def tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def stem_path(x8, cout: int, bf16: bool = False) -> str:
    """The paths K2 takes on uint8 ``x8``: its plan's bulk or plain loads,
    tensor or direct stores."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    b, h, w, cin = x8.shape
    plan = ck.stem_plan(b, h, w, cin, 4, cout, ck._sm_count(x8.device), x8.data_ptr() % 16 == 0, bf16)
    return f"{plan.path} ({plan.rows} rows a tile, {plan.grid} blocks)"


def stem_bf16_check(x8, w, bias, s, t, what: str) -> dict:
    """K2's bf16 mode against the limits: (a) with the norm and LeakyReLU it
    equals the PyTorch bf16 chain applied to the kernel's own sum (no
    norm) bit for bit; (b) that sum is within one bf16 ulp of the plain
    version's rounding (2^-7 |want| + 2e-4), and at most 1 % of the outputs
    differ from it at all.  Returns the share that differ and the path."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, nn,
    )

    bf16 = torch.bfloat16
    y0 = ck.stem(x8, w, None, None, 4, leaky=False, out_dtype=bf16, bias=bias)
    y = ck.stem(x8, w, s, t, 4, leaky=True, out_dtype=bf16, bias=bias)
    torch.cuda.synchronize()
    if not torch.equal(y.view(torch.int16), nn.leaky_relu(y0 * s + t, 0.2).view(torch.int16)):
        raise AssertionError(f"stem bf16 {what}: the norm and LeakyReLU differ from the bf16 chain")
    want = ck.stem_plain(x8, w, None, None, 4, leaky=False, out_dtype=bf16, bias=bias).float()
    max_err(y0.float(), want, 2e-4, 2 ** -7, f"stem bf16 {what} sum")
    share = float((y0.float() != want).float().mean())
    if share > 0.01:
        raise AssertionError(f"stem bf16 {what}: {share:.4%} of the sums round otherwise")
    full = ck.stem_plain(x8, w, s, t, 4, leaky=True, out_dtype=bf16, bias=bias).float()
    return {"what": what, "share": share, "path": stem_path(x8, w.shape[1], True),
            "err": float((y.float() - full).abs().max())}


ARCHIVE = "_archive"  # gitignored: earlier kernel versions kept for an A/B in one call
# archived source -> the C entry points it holds and their argument types
# (ctypes.c_void_p for pointers and the stream, c_int for sizes)
ARCHIVED = {
    "gram_proj_v2.cu": {"wadt_gram_proj_bf16": "PPPPPIIIIP"},
    "head_v2.cu": {"wadt_fused_head": "PPIPPTIPPPPIPIIIIIIIIP"},
    "patch_gram_v1.cu": {"wadt_patch_gram_f32": "PPIIIIIP", "wadt_patch_gram_bf16": "PPIIIIIP"},
    "stem_v1.cu": {"wadt_stem_u8_f32": "PPPPPIIIIIIIP"},
    "trunk_gram_v1.cu": {"wadt_trunk_gram_u8": "PPPPPPPPPPIIIIIIIIIIIP"},
}


PARENT = os.path.join(ARCHIVE, "parent")  # gitignored: a parent commit's port, for a whole-step A/B
# run in a process of its own from a checkout's root: that checkout's PMG
# batch step at batch 256 in float32 and bf16 (phase 15's timing), as JSON
STEP_AB = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
port.config.enable_parity_precision()
meta = json.load(open(os.path.join(cs.FIXTURES, "pmg_shipped.json")))
eng = port.load_engine("pmg", os.path.join(cs.FIXTURES, "pmg_shipped.pth"), meta["tasks"], meta["hparams"],
                       batch_size=cs.BATCH, device="cuda")
eng16 = executor.Engine("pmg", eng.spec, eng.params, batch_size=cs.BATCH, dtype=torch.bfloat16)
xb = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (cs.BATCH, 224, 224, 3), np.uint8)).cuda()
f32, b16 = cs.in_turns(lambda: eng.step(xb), lambda: eng16.step(xb), reps=1, rounds=10)
print(json.dumps([f32, b16]))
"""


def parent_step_ab(card: str) -> None:
    """Where the gitignored ``_archive/parent/`` holds a parent commit's port
    (``git archive <commit> <port> chip_smoke.py tests/fixtures/pmg_shipped.json
    tests/fixtures/pmg_shipped.pth``), the PMG batch step of the parent and
    of this tree in turns (parent, this, this, parent), each in a process of
    its own that builds its own kernels."""
    if not os.path.isdir(PARENT):
        return
    runs = []
    for root in (PARENT, ".", ".", PARENT):
        out = subprocess.run([sys.executable, "-c", STEP_AB], cwd=root, capture_output=True, text=True,
                             timeout=600, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    (p1, p2), (c1, c2), (c3, c4), (p3, p4) = runs
    print(f"[15] PMG batch step at batch {BATCH}, the parent's port ({PARENT}) against this tree in turns: "
          f"float32 {p1:.3f} / {p3:.3f} -> {c1:.3f} / {c3:.3f} ms, bf16 {p2:.3f} / {p4:.3f} -> "
          f"{c2:.3f} / {c4:.3f} ms | {card}")


def archived_kernels() -> dict:
    """The previous versions of the redesigned kernels that the gitignored
    ``_archive/`` holds (copies of earlier commits' sources, not committed:
    K5 and K4 as ``gram_proj_v2.cu`` and ``head_v2.cu``, K1 and K3 as
    ``patch_gram_v1.cu`` and ``trunk_gram_v1.cu``; each optional), built
    into one library of their own: entry point name -> ctypes function.
    Empty where the checkout has none of them."""
    import ctypes

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    srcs = [f for f in ARCHIVED if os.path.isfile(os.path.join(ARCHIVE, f))]
    if not srcs:
        return {}
    out = os.path.join(ARCHIVE, "build")
    os.makedirs(out, exist_ok=True)
    objs = [os.path.join(out, f + ".o") for f in srcs]
    nvcc = ck._nvcc()
    ck._run_all([[nvcc, *ck._NVCC_FLAGS, "-c", os.path.join(ARCHIVE, f), "-o", o]
                 for f, o in zip(srcs, objs)], "nvcc (archive)")
    so = os.path.join(out, "libarchived.so")
    ck._run_all([[nvcc, "-shared", *objs, "-o", so]], "nvcc link (archive)")
    lib = ctypes.CDLL(os.path.abspath(so))
    kinds = {"P": ctypes.c_void_p, "I": ctypes.c_int, "T": ctypes.POINTER(ctypes.c_void_p)}
    fns = {}
    for f in srcs:
        for name, sig in ARCHIVED[f].items():
            fn = getattr(lib, name)
            fn.argtypes = [kinds[c] for c in sig]
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def archived_call(fn, *args):
    """A function that runs an archived kernel on the current stream and
    raises if its launch fails."""
    import torch

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"archived kernel failed: {err}")

    return run


def archived_head_call(fused_head, tokens, fold, spec):
    """A function that runs the archived K4 (two launches) on ``tokens``."""
    import ctypes

    import torch

    tp, layers = fold["token_proj"], fold.get("transformer", ())
    q8 = "w8" in tp
    w = tp["w8"] if q8 else tp["w"]
    order = (("norm1", "scale"), ("norm1", "bias"), ("attn", "wq"), ("attn", "bq"), ("attn", "wk"),
             ("attn", "bk"), ("attn", "wv"), ("attn", "bv"), ("attn", "wo"), ("attn", "bo"),
             ("norm2", "scale"), ("norm2", "bias"), ("ffn1", "w"), ("ffn1", "b"), ("ffn2", "w"),
             ("ffn2", "b"))
    ptrs = [lp[g][k].data_ptr() for lp in layers for g, k in order]
    table = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    b, npatch, din = tokens.shape
    d = w.shape[1]
    ff = layers[0]["ffn1"]["w"].shape[1] if layers else 0
    ntask, kmax = fold["heads"]["b"].shape
    chunks = -(-din // 256)
    partial = torch.empty((chunks, b * npatch, d), dtype=torch.float32, device=tokens.device)
    out = torch.empty((b, ntask, kmax), dtype=torch.float32, device=tokens.device)

    def run():
        err = fused_head(
            tokens.data_ptr(), w.data_ptr(), int(q8), tp["scale"].data_ptr() if q8 else None,
            tp["b"].data_ptr(), table, len(layers), fold["queries"].data_ptr(),
            fold["heads"]["w"].data_ptr(), fold["heads"]["b"].data_ptr(), partial.data_ptr(), chunks,
            out.data_ptr(), b, npatch, din, d, ff, spec.transformer_heads, ntask, kmax,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"archived fused_head failed: {err}")
        return out

    return run


def route_latency(label: str, p, x1, frames, card: str) -> None:
    """Print one camera route's latency: device time of one step with all its
    launches queued behind a sleep, one step's device span on an idle card
    and the host time to enqueue it, and host wall time per frame from
    ``submit`` to the probabilities on the host."""
    import numpy as np
    import torch

    for f in frames[:10]:
        np.asarray(p.submit(f))
    step_ms = device_ms(lambda: p.step(x1), reps=1, rounds=20)
    walls, enqueues, spans, steps = [], [], [], []
    for i in range(LATENCY_FRAMES):
        t0 = time.perf_counter()
        handle = p.submit(frames[i % len(frames)])
        t1 = time.perf_counter()
        np.asarray(handle)
        walls.append(time.perf_counter() - t0)
        enqueues.append(t1 - t0)
        # one step alone on an idle card: its device span, launch gaps included
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        p.step(x1)
        steps.append(time.perf_counter() - t0)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    print(f"{label}: {step_ms * 1e3:.1f} us of device time per step (launches queued ahead), "
          f"{statistics.median(spans) * 1e3:.1f} us span of one step alone, enqueued by the host "
          f"in {statistics.median(steps) * 1e6:.1f} us; host wall per frame, submit to host "
          f"probs {statistics.median(walls) * 1e6:.1f} us, of which submit returns after "
          f"{statistics.median(enqueues) * 1e6:.1f} us (medians of {LATENCY_FRAMES}) | {card}")


def profile_step(label: str, fn, steps: int = 3) -> None:
    """Device kernels, kernel time per step and the table of device time by
    kernel of ``steps`` calls of ``fn`` (``torch.profiler``; ``--profile``
    only: host launch costs stay higher afterwards)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]
    print(f"{label}: {len(evs) / steps:.1f} device kernels per step, "
          f"{sum(e.time_range.elapsed_us() for e in evs) / steps:.1f} us of kernel time per step")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))


def kernels_per_step(routes, profile: bool) -> None:
    """Device kernels and kernel time per step of each (label, predictor,
    frame), from ``torch.profiler`` over 10 steps; ``profile`` adds the table
    of device time by kernel.  Run after every host timing: the host's
    launch cost stays higher once a profiler session has run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    for label, p, x1 in routes:
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                p.step(x1)
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]
        print(f"{label}: {len(evs) / 10:.1f} device kernels per step, "
              f"{sum(e.time_range.elapsed_us() for e in evs) / 10:.1f} us of kernel time per step")
        if profile:
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))


def camera_phases(profile: bool, card: str, spec, params, routes: list, old: dict) -> list:
    """Phases 6-9 (the camera path) on the shipped ``spec`` and ``params``
    (on the card); returns the camera kernels' entries of the kernels line
    and appends each timed route to ``routes``."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint, executor,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, kalman,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import goldens
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import stream

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(3)

    # -- 6. camera kernels against their plain versions, on the card --------
    trunk_w = ck.fold_trunk_gram_weights(params, spec)
    x8 = torch.from_numpy(rng.randint(0, 256, (8, 224, 224, 3), np.uint8)).to(dev)
    x1 = x8[:1]
    k3_err = 0.0
    for xb in (x1, x8):
        got = ck.fused_trunk_gram(xb, trunk_w, spec)
        torch.cuda.synchronize()
        k3_err = max(k3_err, max_err(got, ck.fused_trunk_gram_plain(xb, trunk_w, spec), K3_TOL,
                                     K3_TOL, f"fused_trunk_gram [{xb.shape[0]},224,224,3]"))
        if not torch.equal(ck.fused_trunk_gram(xb, trunk_w, spec), got):
            raise AssertionError(f"fused_trunk_gram batch {xb.shape[0]}: two calls differ")
    # ragged: a 7x7 final map, replicate-padded to 9x9 for div 3; 120 px
    # wide leaves 8 columns beyond a multiple of K = 16
    rag_spec = pmg.build_spec({"a": ["x", "y"]}, dict(
        ndf=16, patch_size=64, patch_div=3, gram_channels=32, d_model=64,
        transformer_layers=0, use_token_attention=False))
    rag_w = ck.fold_trunk_gram_weights(
        checkpoint.to_device(random_pmg_params(rag_spec, rng), dev), rag_spec)
    xr = torch.from_numpy(rng.randint(0, 256, (2, 112, 120, 3), np.uint8)).to(dev)
    got = ck.fused_trunk_gram(xr, rag_w, rag_spec)
    rag_err = max_err(got, ck.fused_trunk_gram_plain(xr, rag_w, rag_spec), K3_TOL, K3_TOL,
                      "fused_trunk_gram ragged [2,112,120,3]")
    if not torch.equal(ck.fused_trunk_gram(xr, rag_w, rag_spec), got):
        raise AssertionError("fused_trunk_gram ragged: two calls differ")
    torch.cuda.synchronize()
    print(f"[6] fused_trunk_gram vs plain: max abs err {k3_err:.3e} (batch 1 and 8), "
          f"{rag_err:.3e} (ragged), atol/rtol {K3_TOL}, two calls bit-identical; clusters of "
          f"{ck.trunk_gram_plan(spec, 224, 224).cluster} (shipped) and "
          f"{ck.trunk_gram_plan(rag_spec, 112, 120).cluster} (ragged) blocks a patch")

    tokens8 = ck.fused_trunk_gram_plain(x8, trunk_w, spec)
    tokens1 = tokens8[:1].contiguous()
    folds = {v: pmg.fold_head_weights(params, spec, v) for v in ("bf16", "q8")}
    nt_spec = pmg.build_spec(spec.tasks.as_dict(), dict(
        ndf=32, patch_size=64, patch_div=3, gram_channels=96, d_model=192,
        transformer_layers=0, use_token_attention=False))
    nt_fold = pmg.fold_head_weights(
        checkpoint.to_device(random_pmg_params(nt_spec, rng), dev), nt_spec, "q8")
    # narrow layers (d 64, FFN 128, 2 heads): 8 columns a block of 8, and on
    # a cluster of 16 half the blocks own no d-wide columns
    nw_spec = pmg.build_spec(spec.tasks.as_dict(), dict(
        ndf=16, patch_size=64, patch_div=3, gram_channels=32, d_model=64, transformer_layers=2,
        transformer_heads=2, use_token_attention=True))
    nw_fold = pmg.fold_head_weights(
        checkpoint.to_device(random_pmg_params(nw_spec, rng), dev), nw_spec, "bf16")
    nw8 = torch.from_numpy(rng.randn(8, 9, 32 * 32).astype(np.float32)).to(dev)
    k4_err = 0.0
    cases = [(f"{v} batch {tb.shape[0]}", tb, f, spec, None)
             for v, f in folds.items() for tb in (tokens1, tokens8)]
    cases.append(("q8 no transformer batch 8", tokens8, nt_fold, nt_spec, None))
    cases += [(f"narrow d 64 batch {tb.shape[0]} cluster {cl or 8}", tb, nw_fold, nw_spec, cl)
              for tb in (nw8[:1].contiguous(), nw8) for cl in (None, 16)]
    for what, tb, f, sp, cl in cases:
        got = ck._fused_head_launch(tb, f, sp, cluster=cl)
        torch.cuda.synchronize()
        want = ck.fused_head_plain(tb, f, sp)
        k4_err = max(k4_err, max_err(got, want, K4_TOL, K4_TOL, f"fused_head {what}"))
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError(f"fused_head {what}: argmax differs from the plain version")
        if not torch.equal(ck._fused_head_launch(tb, f, sp, cluster=cl), got):
            raise AssertionError(f"fused_head {what}: two calls on the same inputs differ")
    print(f"[6] fused_head vs plain: max abs err {k4_err:.3e} (bf16 and q8 folds at batch 1 "
          f"and 8, no-transformer spec, narrow d 64 spec on clusters of 8 and 16), atol/rtol "
          f"{K4_TOL}, argmax equal, two calls bit-identical")

    # -- 7. golden-fixture walk of the fused head, on the card ---------------
    rows = goldens.pmg_head_fold_fixture_parity(FIXTURES, ["fused_bf16", "fused_q8"], device=dev)
    for variant, rs in rows.items():
        for name, agree, drift in rs:
            if not agree or drift > goldens.HEAD_FOLD_MAX_DRIFT:
                raise AssertionError(f"{variant} on {name}: argmax agrees {agree}, drift {drift}")
        print(f"[7] golden walk {variant}: {len(rs)} fixtures, argmax agrees, max drift "
              f"{max(r[2] for r in rs):.3e} (limit {goldens.HEAD_FOLD_MAX_DRIFT})")

    # -- 8. camera path ---------------------------------------------------------
    cam = np.random.RandomState(4).randint(0, 256, (CAMERA_FRAMES, 224, 224, 3), np.uint8)
    pred = stream.StreamPredictor("pmg", spec, params, use_kalman=True)
    if (pred.route, pred.head_fold) != ("fused", "fused_bf16"):
        raise AssertionError(f"default camera route is {pred.route}/{pred.head_fold}")
    ck.reset_launches()
    handles = [pred.submit(f) for f in cam]
    probs = np.stack([np.asarray(h) for h in handles])
    torch.cuda.synchronize()
    cam_launches = dict(ck.LAUNCHES)
    for name in ("fused_trunk_gram", "fused_head"):
        if cam_launches[name] == 0:
            raise AssertionError(f"camera path never launched the {name} kernel")
    # the smoothed rows sum to what the Kalman recursion makes of a constant 1
    state, sums = kalman.init_state(1, 1), []
    for _ in range(CAMERA_FRAMES):
        state, m = kalman.filter_update(state, torch.ones(1, 1))
        sums.append(float(m))
    mask = executor.class_mask(spec.tasks)
    if (probs.shape != (CAMERA_FRAMES, len(spec.tasks), spec.tasks.max_classes)
            or not np.allclose(probs.sum(-1), np.asarray(sums)[:, None], atol=1e-5)
            or np.abs(probs[:, ~mask]).max() != 0):
        raise AssertionError("camera probability rows do not sum to 1 over the real classes")
    cpu_params = checkpoint.to_device(params, "cpu")
    cpu_pred = stream.StreamPredictor("pmg", spec, cpu_params, use_kalman=True, device="cpu")
    cam_err = max_err(torch.from_numpy(probs[:8]), torch.from_numpy(np.stack(
        [cpu_pred(f) for f in cam[:8]])), 1e-3, 1e-3, "camera probs vs the port's CPU path")
    packed = stream.StreamPredictor("pmg", spec, params, use_kalman=True, trunk_kernel="packed")
    ck.reset_launches()
    pk = np.stack([packed(f) for f in cam[:8]])
    torch.cuda.synchronize()
    packed_launches = dict(ck.LAUNCHES)
    for name in ("stem", "patch_gram"):
        if packed_launches[name] == 0:
            raise AssertionError(f"packed camera route never launched the {name} kernel")
    cpu_packed = stream.StreamPredictor("pmg", spec, cpu_params, use_kalman=True,
                                        trunk_kernel="packed", device="cpu")
    packed_err = max_err(torch.from_numpy(pk[:2]), torch.from_numpy(np.stack(
        [cpu_packed(f) for f in cam[:2]])), 2e-4, 2e-4, "packed camera probs vs the CPU path")
    print(f"[8] camera path fused+fused_bf16: {CAMERA_FRAMES} frames, launches {cam_launches}, "
          f"probs vs CPU max abs err {cam_err:.3e} (atol/rtol 1e-3); packed route: launches "
          f"{packed_launches}, vs CPU {packed_err:.3e} (2e-4)")

    # -- 9. camera times ---------------------------------------------------------
    b0, b1, b2 = spec.plan
    k1, k2, gc, div = b0.kernel, b1.kernel, spec.gram_channels, spec.patch_div
    hf = 224 // (k1 * k2)
    side = -(-hf // div)
    # weights the work needs: conv1's one diagonal block, not W0bd's zeros
    macs = (k2 * k2 * k1 * k1 * b0.cin * b0.cout + k2 * k2 * b0.cout * b1.cout
            + b1.cout * b2.cout + b2.cout * gc)
    weights = (k1 * k1 * b0.cin * b0.cout + k2 * k2 * b0.cout * b1.cout + b1.cout * b2.cout
               + b2.cout * gc)
    nbytes = x1.numel() + 2 * weights + 4 * (b0.cout + b1.cout + b2.cout + gc) + 4 * tokens1.numel()
    b_ms, b_by = bound_ms(nbytes, 2.0 * div * div * side * side * gc * gc,
                          bf16_flops=2.0 * hf * hf * macs)
    entries = [{
        "name": "fused_trunk_gram", "route": "cuda", "source": f"{PORT}/csrc/trunk_gram.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_kernels.py:309",
        "launches": cam_launches["fused_trunk_gram"], "max_abs_err": max(k3_err, rag_err),
        "ms": device_ms(lambda: ck.fused_trunk_gram(x1, trunk_w, spec)),
        "plain_ms": device_ms(lambda: ck.fused_trunk_gram_plain(x1, trunk_w, spec)),
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes a conv chain and a per-patch Gram
        "library_ms": None,
    }]
    if "wadt_trunk_gram_u8" in old:  # the archived K3 (one block per patch) in turns
        t_old = torch.empty_like(tokens1)
        old_ms, new_ms = in_turns(
            archived_call(old["wadt_trunk_gram_u8"], x1.data_ptr(), *(t.data_ptr() for t in trunk_w),
                          t_old.data_ptr(), 1, 224, 224, b0.cin, k1, k2, b0.cout, b1.cout, b2.cout, gc, div),
            lambda: ck.fused_trunk_gram(x1, trunk_w, spec))
        print(f"[9] fused_trunk_gram at batch 1 in turns: archived v1 {old_ms * 1e3:.1f} us, new "
              f"{new_ms * 1e3:.1f} us ({ck.trunk_gram_plan(spec, 224, 224).cluster} blocks a patch) | {card}")
    fb = folds["bf16"]
    d, npatch, din = spec.d_model, tokens1.shape[1], tokens1.shape[2]
    ff = fb["transformer"][0]["ffn1"]["w"].shape[1]
    ntask, kmax = fb["heads"]["b"].shape
    layer_flops = 2.0 * npatch * (4 * d * d + 2 * d * ff + 2 * npatch * d)
    head_flops = (spec.transformer_layers * layer_flops
                  + 2.0 * ntask * (2 * npatch * d + d * kmax))
    nbytes = 4 * tokens1.numel() + tree_nbytes(fb) + 4 * ntask * kmax
    b_ms, b_by = bound_ms(nbytes, head_flops, bf16_flops=2.0 * npatch * din * d)
    tok_bf16 = tokens1[0].to(torch.bfloat16)
    entries.append({
        "name": "fused_head", "route": "cuda", "source": f"{PORT}/csrc/head.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_kernels.py:477",
        "launches": cam_launches["fused_head"], "max_abs_err": k4_err,
        "ms": device_ms(lambda: ck.fused_head(tokens1, fb, spec)),
        "plain_ms": device_ms(lambda: ck.fused_head_plain(tokens1, fb, spec)),
        "bound_ms": b_ms, "bound_by": b_by,
        # partial yardstick: token_proj alone, bf16 [9, 9216] x [9216, 192];
        # leaves out the transformer, the pooling and the heads
        "library_ms": device_ms(lambda: torch.matmul(tok_bf16, fb["token_proj"]["w"])),
    })
    for k in entries:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.1f} us"
        print(f"[9] {k['name']} at batch 1: {k['ms'] * 1e3:.1f} us (bound {k['bound_ms'] * 1e3:.2f}"
              f" us by {k['bound_by']}), plain {k['plain_ms'] * 1e3:.1f} us, library {lib} | {card}")
    # launch 1 (token_proj partial sums) and launch 2 (the cluster) apart
    part = torch.empty((-(-din // 256), npatch, d), dtype=torch.float32, device=dev)
    out1 = torch.empty((1, ntask, kmax), dtype=torch.float32, device=dev)
    ck._fused_head_launch(tokens1, fb, spec, out=out1, partial=part)
    l1_ms = device_ms(lambda: ck._fused_head_launch(tokens1, fb, spec, stages=1, out=out1, partial=part))
    l2_ms = device_ms(lambda: ck._fused_head_launch(tokens1, fb, spec, stages=2, out=out1, partial=part))
    plan = ck.head_share_plan(npatch, d, ff, spec.transformer_heads, spec.transformer_layers, ntask, kmax)
    print(f"[9] fused_head at batch 1, launches apart: launch 1 {l1_ms * 1e3:.1f} us, launch 2 "
          f"{l2_ms * 1e3:.1f} us (clusters of {plan.cluster}, {plan.smem} bytes of shared memory a "
          f"block) | {card}")
    if "wadt_fused_head" in old:  # the archived K4 (launch 2 on one block per image) in turns
        old_ms, new_ms = in_turns(archived_head_call(old["wadt_fused_head"], tokens1, fb, spec),
                                  lambda: ck.fused_head(tokens1, fb, spec))
        print(f"[9] fused_head at batch 1 in turns: archived v2 {old_ms * 1e3:.1f} us, new "
              f"{new_ms * 1e3:.1f} us | {card}")
    if profile:  # the head kernel's time with the fold cut to its first n layers
        for n in range(len(fb["transformer"]) + 1):
            sub = dict(fb, transformer=fb["transformer"][:n])
            print(f"[9] fused_head with {n} of its layers: "
                  f"{device_ms(lambda: ck.fused_head(tokens1, sub, spec)) * 1e3:.1f} us | {card}")

    for trunk_kernel, head_fold in (("fused", "fused_bf16"), ("fused", "bf16"), ("packed", None)):
        kw = {"head_fold": head_fold} if head_fold else {}
        p = stream.StreamPredictor("pmg", spec, params, use_kalman=True,
                                   trunk_kernel=trunk_kernel, **kw)
        label = f"[9] camera step {trunk_kernel}+{head_fold}"
        route_latency(label, p, x1, cam, card)
        routes.append((label, p, x1))
    return entries


def random_rtm_params(spec, seed: int):
    """Seeded random RTM params of ``spec`` (float32 CPU tensors in the port's
    tree layout, drawn with numpy): He-scaled convolutions, non-trivial
    batch-norm statistics and a small scale on each residual branch's last
    norm, so that the 16 bottleneck blocks keep the activations finite."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import resnet

    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, shift=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale) + np.float32(shift)
        return torch.from_numpy(a)

    def conv(k, cin, cout):
        return {"w": t((k, k, cin, cout), (2.0 / (k * k * cin)) ** 0.5)}

    def bn(c, gain=1.0):
        return {"scale": t(c, 0.1 * gain, gain), "bias": t(c, 0.1), "mean": t(c, 0.1),
                "var": torch.from_numpy(rng.random(c, dtype=np.float32) + 0.5)}

    bb, cin = {"conv1": conv(7, 3, 64), "bn1": bn(64)}, 64
    for si, (nblocks, planes) in enumerate(resnet.STAGES):
        blocks, cout = [], planes * resnet.EXPANSION
        for bi in range(nblocks):
            blk = {"conv1": conv(1, cin, planes), "bn1": bn(planes),
                   "conv2": conv(3, planes, planes), "bn2": bn(planes),
                   "conv3": conv(1, planes, cout), "bn3": bn(cout, 0.2)}
            if bi == 0:
                blk["downsample"] = {"conv": conv(1, cin, cout), "bn": bn(cout)}
            blocks.append(blk)
            cin = cout
        bb[f"layer{si + 1}"] = blocks
    nt, kmax = len(spec.tasks), spec.tasks.max_classes
    c, d, dims = spec.num_features, spec.token_dim, spec.mlp_dims
    params = {"backbone": bb, "mlp": [
        {"w": t((nt, i, o), i ** -0.5), "b": t((nt, o), 0.1)} for i, o in zip(dims[:-1], dims[1:])]}
    if spec.use_attention:
        params["attn"] = {"proj_w": t((nt, c, d), c ** -0.5), "q": t((nt, d)),
                          "out_w": t((nt, d, c), d ** -0.5)}
    fw, fb = t((nt, dims[-1], kmax), dims[-1] ** -0.5), t((nt, kmax), 0.1)
    for i, k in enumerate(spec.tasks.num_classes):
        fw[i, :, k:] = 0.0
        fb[i, k:] = 0.0
    params["final"] = {"w": fw, "b": fb}
    return params


def rtm_phases(profile: bool, card: str, routes: list) -> tuple:
    """Phases 10-13 (the RTM family) at full width; returns K6's entry of
    the kernels line and phase 12's float32 run (spec, params, frames,
    results, wall time) for phase 17, and appends each timed camera route
    to ``routes``."""
    import itertools

    import numpy as np
    import torch

    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint, executor,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import rtm
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, kalman,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import goldens
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import stream

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(10)

    # -- 10. K6 against its plain version, on the card ----------------------
    def k6_case(b, t, c, d):
        x = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).to(dev)
        w8 = torch.from_numpy(rng.randint(-127, 128, (t, c, d)).astype(np.int8)).to(dev)
        scale = torch.from_numpy((rng.rand(t, d).astype(np.float32) + 0.5) * 1e-3).to(dev)
        return x, w8, scale

    k6_err = k6_rel = 0.0
    # full width at batch 1; the rtm_trunc5_attn fold (C 256) and its mlp_q8
    # layer (D 32); a shape that takes the byte-wise path and 4-row groups
    for shape in ((1, 12, 2048, 2048), (2, 3, 256, 256), (2, 3, 256, 32), (5, 3, 40, 24)):
        x, w8, scale = k6_case(*shape)
        got = ck.dequant_matvec(x, w8, scale)
        torch.cuda.synchronize()
        want = ck.dequant_matvec_plain(x, w8, scale)
        ymax = float(want.abs().max())
        err = max_err(got, want, K6_TOL * ymax, 0.0, f"dequant_matvec {list(shape)}")
        k6_err, k6_rel = max(k6_err, err), max(k6_rel, err / ymax)
    print(f"[10] dequant_matvec vs plain: max abs err {k6_err:.3e}, {k6_rel:.3e} x max|y|, at [B,T,C,D] = "
          f"[1,12,2048,2048], [2,3,256,256], [2,3,256,32], [5,3,40,24]; bound {K6_TOL} x max|y|")

    # -- 11. RTM golden fixtures on the card ------------------------------------
    fix_err = 0.0
    for name in ("rtm_trunc5_attn", "rtm_trunc5_default_dim", "rtm_trunc6_gap"):
        with open(os.path.join(FIXTURES, f"{name}.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(FIXTURES, f"{name}.npz"))
        eng = port.load_engine("rtm", os.path.join(FIXTURES, f"{name}.pth"), meta["tasks"],
                               meta["hparams"], batch_size=2, device="cuda")
        xf = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))).to(dev)
        with torch.inference_mode():
            logits, _ = rtm.apply(eng.params, xf, eng.spec)
        for i, task in enumerate(eng.spec.tasks.names):
            want = torch.from_numpy(data[f"logits/{task}"]).to(dev)
            fix_err = max(fix_err, max_err(logits[:, i, : want.shape[1]], want, 2e-4, 2e-4,
                                           f"{name} fixture / {task}"))
    print(f"[11] RTM golden logits on the card (3 fixtures): max abs err {fix_err:.3e}, atol/rtol 2e-4")
    for q8 in (False, True):
        rows = goldens.rtm_stream_fixture_parity(FIXTURES, quantize_fold=q8, device=dev)
        if len(rows) != 2 or not all(agree for _, agree, _ in rows):
            raise AssertionError(f"RTM golden walk, {'q8' if q8 else 'f32'} fold: {rows}")
        print(f"[11] RTM golden walk, {'q8' if q8 else 'f32'} fold, apply_stream on the card: "
              f"argmax agrees on {len(rows)} fixtures, drift "
              + ", ".join(f"{n} {d:.3e}" for n, _, d in rows))

    # -- 12. RTM batch inference at full width ---------------------------------
    spec = rtm.build_spec(config.load_tasks(config.default_tasks_path()), {})
    params = random_rtm_params(spec, seed=12)
    eng = executor.Engine("rtm", spec, params, batch_size=RTM_BATCH, device="cuda")
    frames = np.random.RandomState(13).randint(0, 256, (RTM_FRAMES, 224, 224, 3), np.uint8)
    ck.reset_launches()
    out = eng.run(frames, collect=("probs", "preds", "logits"))
    torch.cuda.synchronize()
    mask = executor.class_mask(spec.tasks)
    check_probs(out, RTM_FRAMES, spec, "RTM batch")
    want = executor.Engine("rtm", spec, params, batch_size=2, device="cpu").run(
        frames[:2], collect=("logits",))["logits"]
    scale = float(np.abs(want).max())
    batch_err = max_err(torch.from_numpy(out["logits"][:2]), torch.from_numpy(want),
                        1e-3 * scale, 1e-3, "RTM batch logits vs the port's CPU path")
    xb = torch.from_numpy(frames[:RTM_BATCH]).to(dev)
    step_ms = device_ms(lambda: eng.step(xb), reps=5, rounds=3)
    wall, walls = run_wall(eng, frames)
    print(f"[12] RTM batch (ResNet-50 through layer4, C 2048, 12 tasks, d 2048, seeded weights): "
          f"{RTM_FRAMES} frames at batch {RTM_BATCH}, logits vs CPU on 2 frames max abs err "
          f"{batch_err:.3e} (max |logit| {scale:.3f}; atol 1e-3 x max, rtol 1e-3), launches "
          f"{dict(ck.LAUNCHES)} (the batch path runs no hand-written kernel), "
          f"preds[0] {out['preds'][0].tolist()}")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                eng.step(xb)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    print(f"[12] RTM engine step on a device-resident batch of {RTM_BATCH}: {step_ms:.3f} ms = "
          f"{RTM_BATCH / step_ms * 1e3:,.0f} img/s (device); Engine.run end to end on {RTM_FRAMES} "
          f"host frames: {RTM_FRAMES / wall:,.0f} img/s (median of 3: "
          f"{[round(w, 4) for w in walls]} s) | {card}")
    del eng
    rtm_f32 = {"spec": spec, "params": params, "frames": frames, "out": out, "wall": wall}

    # -- 13. RTM camera path at full width -------------------------------------
    cam = np.random.RandomState(14).randint(0, 256, (CAMERA_FRAMES, 224, 224, 3), np.uint8)
    gparams = checkpoint.to_device(params, dev)
    pred = stream.StreamPredictor("rtm", spec, gparams, use_kalman=True)
    if pred.route != "folded_q8":
        raise AssertionError(f"default RTM camera route is {pred.route}")
    torch.cuda.synchronize()
    ck.reset_launches()
    handles = [pred.submit(f) for f in cam]
    probs = np.stack([np.asarray(h) for h in handles])
    torch.cuda.synchronize()
    cam_launches = dict(ck.LAUNCHES)
    if cam_launches["dequant_matvec"] != CAMERA_FRAMES:
        raise AssertionError(f"RTM camera path launched K6 {cam_launches['dequant_matvec']} "
                             f"times over {CAMERA_FRAMES} frames")
    state, sums = kalman.init_state(1, 1), []
    for _ in range(CAMERA_FRAMES):
        state, m = kalman.filter_update(state, torch.ones(1, 1))
        sums.append(float(m))
    if (probs.shape != (CAMERA_FRAMES, len(spec.tasks), spec.tasks.max_classes)
            or not np.allclose(probs.sum(-1), np.asarray(sums)[:, None], atol=1e-5)
            or np.abs(probs[:, ~mask]).max() != 0):
        raise AssertionError("RTM camera probability rows do not sum to 1 over the real classes")
    # the fold was built once, on the card; the CPU path reuses it
    cpu_pred = stream.StreamPredictor("rtm", spec, checkpoint.to_device(pred.params, "cpu"),
                                      use_kalman=True, trunk_kernel="folded_q8", device="cpu")
    cam_err = max_err(torch.from_numpy(probs[:8]), torch.from_numpy(np.stack(
        [cpu_pred(f) for f in cam[:8]])), 1e-3, 1e-3, "RTM camera probs vs the port's CPU path")
    del cpu_pred
    print(f"[13] RTM camera path folded_q8: {CAMERA_FRAMES} frames, launches {cam_launches}, "
          f"probs vs CPU on 8 frames max abs err {cam_err:.3e} (atol/rtol 1e-3)")

    x1 = torch.from_numpy(cam[:1]).to(dev)
    for route in ("generic", "folded", "folded_q8"):
        p = pred if route == "folded_q8" else stream.StreamPredictor(
            "rtm", spec, gparams, use_kalman=True, trunk_kernel=route)
        label = f"[13] RTM camera step {route}"
        route_latency(label, p, x1, cam, card)
        routes.append((label, p, x1))

    # K6 at batch 1, L2 out of play: the calls rotate through 4 copies of the
    # fold's weights (4 x 50.3 MB, four times the 50 MB L2), so each call
    # reads weights that 150 MB of other weights have passed since
    fold8, fscale = pred.params["attn_fold_q8"], pred.params["attn_fold_scale"]
    t, c, d = fold8.shape
    xq = torch.from_numpy(rng.randn(1, t, c).astype(np.float32)).to(dev)
    copies = [(fold8.clone(), fscale.clone()) for _ in range(4)]
    ring = itertools.cycle(copies)
    ring_plain = itertools.cycle(copies)
    k6_ms = device_ms(lambda: ck.dequant_matvec(xq, *next(ring)))
    plain_ms = device_ms(lambda: ck.dequant_matvec_plain(xq, *next(ring_plain)))
    # partial yardstick: one torch.bmm on the float32-dequantized fold, which
    # reads 4x the bytes (201 MB, four times the L2 on its own)
    deq = (fold8.float() * fscale[:, None, :]).contiguous()
    xt = xq[0][:, None, :].contiguous()
    lib_ms = device_ms(lambda: torch.bmm(xt, deq))
    del copies, deq
    try:  # PyTorch's int8 weight-only product, one call per task
        w_nk = [fold8[i].t().contiguous() for i in range(t)]

        def int8pack_all():
            for i in range(t):
                torch._weight_int8pack_mm(xq[0, i:i + 1], w_nk[i], fscale[i])

        int8pack_all()
        torch.cuda.synchronize()
        int8pack = f"{device_ms(int8pack_all) * 1e3:.1f} us for {t} calls (L2 warm)"
        del w_nk
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        int8pack = f"not available on this card's torch ({type(e).__name__}: {str(e).splitlines()[0][:120]})"
    nbytes = xq.numel() * 4 + fold8.numel() + fscale.numel() * 4 + t * d * 4
    b_ms, b_by = bound_ms(nbytes, 2.0 * t * c * d)
    print(f"[13] dequant_matvec at batch 1 [1,{t},{c}] x [{t},{c},{d}] int8, L2 out of play "
          f"(4 rotating weight copies): {k6_ms * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}), "
          f"plain {plain_ms * 1e3:.1f} us, torch.bmm on the float32-dequantized fold "
          f"{lib_ms * 1e3:.1f} us (partial yardstick, 4x the bytes); torch._weight_int8pack_mm: "
          f"{int8pack} | {card}")
    return {
        "name": "dequant_matvec", "route": "cuda", "source": f"{PORT}/csrc/int8_matvec.cu",
        "replaces": "tools/exp_rtm_int8_stream.py:77",
        "launches": cam_launches["dequant_matvec"], "max_abs_err": k6_err,
        "ms": k6_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    }, rtm_f32


def check_probs(out, n: int, spec, what: str) -> None:
    """Finite logits, and probability rows that sum to 1 over each task's
    real classes."""
    import numpy as np

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor

    mask = executor.class_mask(spec.tasks)
    probs = out["probs"]
    if (probs.shape != (n, len(spec.tasks), spec.tasks.max_classes)
            or not np.isfinite(out["logits"]).all()
            or not np.allclose(probs.sum(-1), 1.0, atol=1e-5) or np.abs(probs[:, ~mask]).max() != 0):
        raise AssertionError(f"{what}: probabilities are not finite rows summing to 1")


def agreement(a, b):
    """(share of (frame, task) pairs whose argmax agrees, max probability
    difference) between two runs' probabilities."""
    import numpy as np

    return float((a.argmax(-1) == b.argmax(-1)).mean()), float(np.abs(a - b).max())


def k1_yardsticks(z, div: int) -> dict:
    """Device times (ms) of K1's library yardsticks on NHWC ``z``: one
    ``torch.baddbmm`` of the split patches (P^T P times 1/area, the whole
    arithmetic), ``torch.bmm`` (P^T P), and the ``split_patches`` copy
    (replicate pad and split) that both need first."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import gram

    patches, area = gram.split_patches(z, div)
    p = patches.reshape(-1, area, z.shape[-1])
    pt = p.transpose(1, 2)
    out = torch.empty((p.shape[0], z.shape[-1], z.shape[-1]), dtype=z.dtype, device=z.device)
    return {
        "baddbmm": device_ms(lambda: torch.baddbmm(out, pt, p, beta=0, alpha=1.0 / area)),
        "bmm": device_ms(lambda: torch.bmm(pt, p)),
        "split": device_ms(lambda: gram.split_patches(z, div)),
    }


# csrc/patch_gram.cu's bf16 epilogue, cut stage by stage for --profile: each
# cut replaces these source lines (and keeps the cuts before it)
K1_CUTS = (
    ("the certificate's sequential recomputations",
     (("if (b0 + lane < total) {", "if (false) {"),)),
    ("the certificate",
     (("if (d & 0xffffu) redo |= 1u << (k * 8 + e);", ";"),
      ("if ((d >> 16) && j + 1 < C) redo |= 1u << (k * 8 + e + 1);", ";"))),
    ("the tensor-core products", (("const int ksteps = up(nn, 16) / 16;", "const int ksteps = 0;"),)),
)


def k1_bf16_cuts(z16, div: int, card: str) -> None:
    """``--profile``: K1 in bf16 on ``z16`` with its work cut stage by stage
    (each cut a copy of ``csrc/patch_gram.cu`` built into the gitignored
    ``csrc/_build/cuts/``; the outputs of a cut kernel are not checked):
    what the recomputations, the certificate and the products each cost."""
    import ctypes

    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    src = open(os.path.join(ck._CSRC, "patch_gram.cu")).read()
    out = os.path.join(ck._BUILD, "cuts")
    os.makedirs(out, exist_ok=True)
    nvcc = ck._nvcc()
    flags = [f for f in ck._NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmds, sos = [], []
    for n, (label, subs) in enumerate(K1_CUTS):
        for old, new in subs:
            if old not in src:
                raise AssertionError(f"K1 cut {label!r}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        cu, so = os.path.join(out, f"cut{n}.cu"), os.path.join(out, f"cut{n}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmds.append([nvcc, *flags, "-shared", cu, "-o", so])
        sos.append((label, so))
    ck._run_all(cmds, "nvcc (K1 cuts)")
    b, h, w, c = z16.shape
    plan = ck.patch_gram_plan(b, h, w, c, div, ck._sm_count(z16.device), True)
    g = torch.empty((b, div * div, c * c), dtype=torch.bfloat16, device=z16.device)
    times = [("whole", device_ms(lambda: ck.patch_gram(z16, div)))]
    for label, so in sos:
        fn = ctypes.CDLL(os.path.abspath(so)).wadt_patch_gram_bf16
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        times.append((f"without {label}", device_ms(archived_call(
            fn, z16.data_ptr(), g.data_ptr(), b, h, w, c, div, plan.kc, plan.band, plan.grid))))
    print("[14] patch_gram bf16 with its work cut stage by stage (each cut keeps the earlier ones): "
          + ", ".join(f"{label} {ms * 1e3:.1f} us" for label, ms in times) + f" | {card}")


# csrc/stem.cu cut stage by stage for --profile: each cut replaces these
# source lines (and keeps the cuts before it)
K2_CUTS = (
    ("the epilogue arithmetic", (
        ("out[h][j][0] = finish_bf16(a, acc[j][2 * h], acc[j][2 * h + 1], bias, sc, sh);",
         "out[h][j][0] = __float_as_uint(acc[j][2 * h]);"),
        ("const float2 y = finish_f32(a, acc[j][2 * h], acc[j][2 * h + 1], sc, sh);",
         "const float2 y = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);"))),
    ("the products", (("for (int ks = 0; ks < kKS; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {"),)),
    ("the stores", (("if (a.tma && m * 16 + 16 <= npx) {", "if (false) {"),
                    ("if (p >= npx) continue;", "continue;"))),
)


def k2_cuts(x8, wf, s, shift, wb, bias, s16, t16, card: str) -> None:
    """``--profile``: K2 in both modes at [256,224,224,3] -> 32 with its work
    cut stage by stage (each cut a copy of ``csrc/stem.cu`` built into the
    gitignored ``csrc/_build/cuts/``; the outputs of a cut kernel are not
    checked): whole; loads, products and stores; loads and stores only;
    loads only."""
    import ctypes

    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    src = open(os.path.join(ck._CSRC, "stem.cu")).read()
    out = os.path.join(ck._BUILD, "cuts")
    os.makedirs(out, exist_ok=True)
    nvcc = ck._nvcc()
    flags = [f for f in ck._NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmds, sos = [], []
    for n, (label, subs) in enumerate(K2_CUTS):
        for old, new in subs:
            if old not in src:
                raise AssertionError(f"K2 cut {label!r}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        cu, so = os.path.join(out, f"stem_cut{n}.cu"), os.path.join(out, f"stem_cut{n}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmds.append([nvcc, *flags, "-shared", cu, "-o", so])
        sos.append((label, so))
    ck._run_all(cmds, "nvcc (K2 cuts)")
    dev = x8.device
    b, h, w, cin = x8.shape
    lib = ck.build()
    for bf16 in (False, True):
        plan = ck.stem_plan(b, h, w, cin, 4, 32, ck._sm_count(dev), True, bf16)
        y = torch.empty((b, h // 4, w // 4, 32), dtype=torch.bfloat16 if bf16 else torch.float32, device=dev)
        ptrs = ((x8.data_ptr(), wb.data_ptr(), s16.data_ptr(), t16.data_ptr(), bias.data_ptr())
                if bf16 else (x8.data_ptr(), wf.data_ptr(), s.data_ptr(), shift.data_ptr(), None))
        rest = (b, h, w, cin, 4, 32, 2 if bf16 else 0, 1, plan.rows, plan.stages, plan.grid,
                int(plan.bulk), int(plan.tma))
        times = [("whole", device_ms(archived_call(lib.wadt_stem_u8, *ptrs, y.data_ptr(), *rest)))]
        for label, so in sos:
            fn = ctypes.CDLL(os.path.abspath(so)).wadt_stem_u8
            fn.argtypes = lib.wadt_stem_u8.argtypes
            fn.restype = ctypes.c_int
            times.append((f"without {label}", device_ms(archived_call(fn, *ptrs, y.data_ptr(), *rest))))
        print(f"[5] stem {'bf16' if bf16 else 'float32'} with its work cut stage by stage (each cut keeps "
              "the earlier ones): " + ", ".join(f"{label} {ms * 1e3:.1f} us" for label, ms in times)
              + f" | {card}")


def in_turns(fn_a, fn_b, **kw):
    """Device times of two functions measured in turns a, b, b, a; the
    median of each one's two."""
    a1 = device_ms(fn_a, **kw)
    b1 = device_ms(fn_b, **kw)
    b2 = device_ms(fn_b, **kw)
    a2 = device_ms(fn_a, **kw)
    return (a1 + a2) / 2, (b1 + b2) / 2


def run_wall(eng, frames):
    """(median, all) of 3 host-clock times of ``eng.run(frames)`` after a
    warm-up batch."""
    import torch

    eng.run(frames[: eng.batch_size])
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(frames)
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def pmg_bf16_phases(card: str, eng32, frames, out32, big, wall32: float, profile: bool,
                    old: dict) -> dict:
    """Phases 14-15: K5 against its plain version and timed, then the PMG
    bf16 batch path on the shipped checkpoint; returns the bf16 run's
    launch counts and K5's entry of the kernels line."""
    import itertools

    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, nn,
    )

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    spec = eng32.spec
    rng = np.random.RandomState(20)
    eng16 = executor.Engine("pmg", spec, eng32.params, batch_size=BATCH, dtype=bf16)

    # -- 14. K5 against its plain version, on the card ----------------------
    tp = eng16._run_params["token_proj"]
    w16, b32 = tp["w"], tp["b"].float()
    z16 = torch.from_numpy(rng.randn(BATCH, 14, 14, spec.gram_channels).astype(np.float32)).to(dev).to(bf16)
    g16 = ck.patch_gram(z16, spec.patch_div)  # the main path's bf16 Gram, [256, 9, 9216]
    torch.cuda.synchronize()
    # bf16 out: one rounding of float32 sums taken in another order, so the
    # two may differ by one bf16 ulp (2^-8 of the value) and by no more
    k1_err = max_err(g16.float(), ck.patch_gram_plain(z16, spec.patch_div).float(), 0.0, 2 ** -8,
                     f"patch_gram bf16 {list(z16.shape)} div {spec.patch_div}")
    # ragged: C % 8 != 0 takes scalar loads (C % 4 != 0 scalar stores too)
    k1_rag = 0.0
    for shape in ((2, 7, 5, 12), (2, 7, 5, 18)):
        zr = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev).to(bf16)
        k1_rag = max(k1_rag, max_err(ck.patch_gram(zr, 2).float(), ck.patch_gram_plain(zr, 2).float(),
                                     0.0, 2 ** -8, f"patch_gram bf16 {list(shape)} div 2"))
    if not torch.equal(ck.patch_gram(z16, spec.patch_div), g16):
        raise AssertionError("patch_gram bf16: two calls on the same inputs differ")
    k1_ms = device_ms(lambda: ck.patch_gram(z16, spec.patch_div))
    k1_bound, k1_by = bound_ms(2 * (z16.numel() + g16.numel()), 0.0,
                               bf16_flops=2.0 * BATCH * spec.patch_div ** 2 * 25 * spec.gram_channels ** 2)
    yard = k1_yardsticks(z16, spec.patch_div)
    print(f"[14] patch_gram in bf16 (bf16 in and out, float32 sums) vs plain: max abs err {k1_err:.3e} "
          f"at [{BATCH},14,14,{spec.gram_channels}] div {spec.patch_div}, {k1_rag:.3e} at [2,7,5,12] and "
          f"[2,7,5,18] div 2 (atol 0, rtol 2^-8), two calls bit-identical; {k1_ms * 1e3:.1f} us (bound "
          f"{k1_bound * 1e3:.1f} us by {k1_by}); yardsticks in bf16 on the split patches: torch.baddbmm "
          f"(P^T P / area) {yard['baddbmm'] * 1e3:.1f} us, torch.bmm {yard['bmm'] * 1e3:.1f} us; the "
          f"split_patches copy they need {yard['split'] * 1e3:.1f} us | {card}")
    if "wadt_patch_gram_bf16" in old:  # the archived K1 in bf16 (one block per patch) in turns
        g_old = torch.empty_like(g16)
        old_ms, new_ms = in_turns(
            archived_call(old["wadt_patch_gram_bf16"], z16.data_ptr(), g_old.data_ptr(), BATCH, 14, 14,
                          spec.gram_channels, spec.patch_div),
            lambda: ck.patch_gram(z16, spec.patch_div))
        print(f"[14] patch_gram bf16 in turns: archived v1 {old_ms * 1e3:.1f} us, new {new_ms * 1e3:.1f} us"
              f" | {card}")
    if profile:
        k1_bf16_cuts(z16, spec.patch_div, card)
    # K2 as the bf16 path runs it: the bf16 mode on the engine's own fold
    # (the bf16-rounded weight, the float32 bias, the batch norm's bf16
    # affine), limits (a) and (b) of phase 2
    x8 = torch.from_numpy(frames[:BATCH]).to(dev)
    st = eng16._stem
    k2 = stem_bf16_check(x8, st["w"], st["bias"], st["scale"], st["shift"], f"{list(x8.shape)} engine fold")
    print(f"[14] stem bf16 mode on the engine's fold at {list(x8.shape)} ({k2['path']}): the norm and "
          f"LeakyReLU equal the bf16 chain on the kernel's own sum bit for bit; the sum within one bf16 "
          f"ulp of the plain version's, {k2['share'] * 100:.4f} % of outputs differ (limit 1 %)")
    # bf16 linear (one cuBLAS call with the bias) at the path's shapes: the
    # float32 product plus bias, rounded once, within one bf16 ulp beyond
    # what float32 sums in another order may differ by (K * 2^-24 of the
    # sum of |terms|; it matters only where the terms cancel).  A bf16
    # reduction of partial sums would be off by ~2^-9 of them.
    lin_ulps = 0.0
    rp = eng16._run_params
    cases = [(rng.randn(BATCH, 14, 14, spec.trunk_channels),
              {"w": rp["chan_proj"]["w"].reshape(spec.trunk_channels, spec.gram_channels)})]
    for lp in rp.get("transformer", [])[:1]:
        cases += [(rng.randn(BATCH, spec.patch_div ** 2, spec.d_model), lp["ffn1"]),
                  (rng.randn(BATCH, spec.patch_div ** 2, 2 * spec.d_model), lp["ffn2"])]
    for xa, lp in cases:
        xl = torch.from_numpy(xa.astype(np.float32)).to(dev).to(bf16)
        want = torch.matmul(xl.float(), lp["w"].float())
        want = (want if lp.get("b") is None else want + lp["b"].float()).to(bf16).float()
        got = nn.linear(xl, lp).float()
        slack = xl.shape[-1] * 2.0 ** -24 * torch.matmul(xl.float().abs(), lp["w"].float().abs())
        mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
        ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
        ulps = float((((got - want).abs() - slack).clamp_min(0.0) / ulp).max())
        if ulps > 1.0:
            raise AssertionError(f"bf16 linear {list(xl.shape)} x {list(lp['w'].shape)}: {ulps} bf16 ulps off")
        lin_ulps = max(lin_ulps, ulps)
    print(f"[14] bf16 linear on the card (chan_proj, ffn1, ffn2 at batch {BATCH}) vs the float32 product "
          f"plus bias rounded once: at most {lin_ulps:.2f} bf16 ulp beyond the float32 order allowance "
          f"(bound 1)")
    y = ck.gram_proj(g16, w16, b32)
    torch.cuda.synchronize()
    want = ck.gram_proj_plain(g16, w16, b32)
    ymax = float(want.abs().max())
    k5_err = max_err(y, want, K5_TOL * ymax, 0.0, f"gram_proj {list(g16.shape)} x {list(w16.shape)}")
    k5_rel = k5_err / ymax
    if not torch.equal(ck.gram_proj(g16, w16, b32), y):
        raise AssertionError("gram_proj: two calls on the same inputs differ")
    # bf16 out, as the bf16 path calls it: the float32 sum plus bias rounded
    # once, within one bf16 ulp (2^-7 of the value) of the plain version's
    # rounding of its own float32 sum (K5_TOL x max|y| near zero)
    y16 = ck.gram_proj(g16, w16, b32, torch.bfloat16)
    torch.cuda.synchronize()
    k5_bf16 = max_err(y16.float(), ck.gram_proj_plain(g16, w16, b32, torch.bfloat16).float(),
                      K5_TOL * ymax, 2 ** -7, "gram_proj bf16 out")
    # every tile width (64: N 32, 40, 64; 128: N 72; 256: N 256 and two
    # 256-wide tiles for N 320), ragged M, and K tails (296, 264)
    for (bsz, npatch, k, n) in ((2, 9, 256, 32), (3, 16, 1024, 64), (2, 9, 296, 40),
                                (3, 7, 264, 72), (2, 9, 264, 256), (2, 9, 384, 320)):
        gr = torch.from_numpy(rng.randn(bsz, npatch, k).astype(np.float32)).to(dev).to(bf16)
        wr = torch.from_numpy(rng.randn(k, n).astype(np.float32) * k ** -0.5).to(dev).to(bf16)
        br = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
        got = ck.gram_proj(gr, wr, br)
        torch.cuda.synchronize()
        wr_want = ck.gram_proj_plain(gr, wr, br)
        rmax = float(wr_want.abs().max())
        err = max_err(got, wr_want, K5_TOL * rmax, 0.0, f"gram_proj ragged [{bsz},{npatch},{k}] x [{k},{n}]")
        k5_err, k5_rel = max(k5_err, err), max(k5_rel, err / rmax)
    print(f"[14] gram_proj vs plain: max abs err {k5_err:.3e}, {k5_rel:.3e} x max|y| (bound {K5_TOL} x "
          f"max|y|), at [M,K,N] = [{g16.shape[0] * g16.shape[1]},{g16.shape[2]},{w16.shape[1]}] "
          f"({ck.gram_proj_plan(g16.shape[0] * g16.shape[1], w16.shape[1], g16.shape[2], ck._sm_count(dev))}), "
          f"[18,256,32], [48,1024,64], [18,296,40], [21,264,72], [18,264,256], [18,384,320]; two calls "
          f"bit-identical; bf16 out {k5_bf16:.3e} (one bf16 ulp)")
    # timed with G read from device memory: 4 rotating copies, 170 MB, over
    # three times the 50 MB L2; W (3.5 MB) stays in L2 as it does between batches
    copies = [g16.clone() for _ in range(4)]
    rings = [itertools.cycle(copies) for _ in range(3)]
    k5_ms = device_ms(lambda: ck.gram_proj(next(rings[0]), w16, b32))
    plain_ms = device_ms(lambda: ck.gram_proj_plain(next(rings[1]), w16, b32))
    # yardstick: torch.matmul of the same bf16 operands (bf16 result, no bias)
    lib_ms = device_ms(lambda: torch.matmul(next(rings[2]), w16))
    m, k = g16.shape[0] * g16.shape[1], g16.shape[2]
    if "wadt_gram_proj_bf16" in old:  # the archived K5 (wmma, split K through device memory) in turns
        n = w16.shape[1]
        splits = 10
        part = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
        out_old = torch.empty((m, n), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ring_old = itertools.cycle(copies)
        old_ms, new_ms = in_turns(
            lambda: old["wadt_gram_proj_bf16"](next(ring_old).data_ptr(), w16.data_ptr(), b32.data_ptr(),
                                            out_old.data_ptr(), part.data_ptr(), m, n, k, splits, stream),
            lambda: ck.gram_proj(next(rings[0]), w16, b32))
        mm_ms = device_ms(lambda: torch.matmul(next(rings[2]), w16))
        print(f"[14] gram_proj in turns, G from device memory: archived v2 {old_ms * 1e3:.1f} us, new "
              f"{new_ms * 1e3:.1f} us; torch.matmul bf16 {mm_ms * 1e3:.1f} us | {card}")
    t0 = time.perf_counter()
    for _ in range(100):
        ck.gram_proj(g16, w16, b32)
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    del copies
    n = w16.shape[1]
    nbytes = 2 * g16.numel() + 2 * w16.numel() + 4 * n + 4 * m * n
    b_ms, b_by = bound_ms(nbytes, 0.0, bf16_flops=2.0 * m * k * n)
    print(f"[14] gram_proj at batch {BATCH} [{m},{k}] x [{k},{n}] bf16, G from device memory: "
          f"{k5_ms * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}), plain {plain_ms * 1e3:.1f} us, "
          f"torch.matmul bf16 {lib_ms * 1e3:.1f} us; host time of one wrapper call (tensor maps "
          f"encoded, launch enqueued) {host_us:.1f} us | {card}")

    # -- 15. PMG bf16 batch ----------------------------------------------------
    ck.reset_launches()
    out16 = eng16.run(frames, collect=("probs", "preds", "logits"))
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    for name in ("gram_proj", "patch_gram", "stem"):
        if launches[name] == 0:
            raise AssertionError(f"PMG bf16 path never launched the {name} kernel")
    check_probs(out16, len(frames), spec, "PMG bf16 batch")
    agree, drift = agreement(out16["probs"], out32["probs"])
    top2 = np.sort(out32["probs"], axis=-1)
    decisive = top2[..., -1] - top2[..., -2] > 0.1
    if (drift > 0.05 or agree < BF16_PMG_AGREEMENT
            or not (out16["probs"].argmax(-1) == out32["probs"].argmax(-1))[decisive].all()):
        raise AssertionError(f"PMG bf16 vs float32: drift {drift}, argmax agreement {agree}")
    with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(FIXTURES, "pmg_shipped.npz"))
    xf = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))).to(dev)
    with torch.inference_mode():
        logits, _ = pmg.apply(eng16._run_params, xf.to(bf16), spec)
    logits = logits.float().cpu().numpy()
    fix_drift, fix_agree = 0.0, True
    for i, task in enumerate(spec.tasks.names):
        ref = data[f"logits/{task}"]
        got = logits[:, i, : ref.shape[1]]
        fix_drift = max(fix_drift, float(np.abs(got - ref).max()))
        r2 = np.sort(ref, axis=-1)
        dec = r2[:, -1] - r2[:, -2] > 2 * BF16_FIXTURE_DRIFT
        fix_agree &= bool((got.argmax(-1) == ref.argmax(-1))[dec].all())
    if fix_drift > BF16_FIXTURE_DRIFT or not fix_agree:
        raise AssertionError(f"pmg_shipped in bf16: drift {fix_drift}, argmax agrees {fix_agree}")
    print(f"[15] PMG bf16 batch: {len(frames)} frames at batch {BATCH}, launches {launches}; vs the "
          f"float32 run argmax agrees on {agree:.4f} of (frame, task) pairs, max prob drift {drift:.3e}; "
          f"pmg_shipped fixture in bf16: max logit drift {fix_drift:.3e} (limit {BF16_FIXTURE_DRIFT}), "
          f"argmax agrees on decisive samples")
    xb = torch.from_numpy(frames[:BATCH]).to(dev)
    # one step at a time behind the sleep: ten queued bf16 steps (~190
    # launches each) fill the launch queue, and the host's pace leaks in
    step32, step16 = in_turns(lambda: eng32.step(xb), lambda: eng16.step(xb), reps=1, rounds=10)
    enqueue = {}
    for label, e in (("float32", eng32), ("bf16", eng16)):
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)
            t0 = time.perf_counter()
            e.step(xb)
            times.append(time.perf_counter() - t0)
        enqueue[label] = statistics.median(times)
    torch.cuda.synchronize()
    wall16, _ = run_wall(eng16, big)
    print(f"[15] engine step on a device-resident batch of {BATCH}, in turns: float32 {step32:.3f} ms "
          f"= {BATCH / step32 * 1e3:,.0f} img/s, bf16 {step16:.3f} ms = {BATCH / step16 * 1e3:,.0f} img/s "
          f"(device); host enqueue of one step: float32 {enqueue['float32'] * 1e3:.3f} ms, bf16 "
          f"{enqueue['bf16'] * 1e3:.3f} ms; Engine.run end to end on {len(big)} host frames: bf16 "
          f"{len(big) / wall16:,.0f} img/s, float32 (phase 5) {len(big) / wall32:,.0f} img/s | {card}")
    if profile:
        profile_step(f"[15] PMG float32 step at batch {BATCH}", lambda: eng32.step(xb), steps=5)
        profile_step(f"[15] PMG bf16 step at batch {BATCH}", lambda: eng16.step(xb), steps=5)
    del eng16
    return launches, {
        "name": "gram_proj", "route": "cuda", "source": f"{PORT}/csrc/gram_proj.cu",
        "replaces": "tools/exp_pmg_projkernel.py:65",
        "launches": launches["gram_proj"], "max_abs_err": k5_err,
        "ms": k5_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    }


def pm_phase(card: str, profile: bool) -> None:
    """Phase 16: the PM family on the card."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint, executor,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pm

    dev = torch.device("cuda", 0)
    fix_err = attn_err = emb_err = 0.0
    names = ("pm_ablate", "pm_batchnorm_sigmoid", "pm_deep_plan", "pm_no_se", "pm_small")
    for name in names:
        with open(os.path.join(FIXTURES, f"{name}.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(FIXTURES, f"{name}.npz"))
        spec = pm.build_spec(meta["tasks"], meta["hparams"])
        params = checkpoint.to_device(
            checkpoint.load_torch_checkpoint("pm", os.path.join(FIXTURES, f"{name}.pth"), spec), dev)
        xf = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))).to(dev)
        with torch.inference_mode():
            logits, aux = pm.apply(params, xf, spec, capture=("attn", "task_embeddings"))
        for i, task in enumerate(spec.tasks.names):
            want = torch.from_numpy(data[f"logits/{task}"]).to(dev)
            fix_err = max(fix_err, max_err(logits[:, i, : want.shape[1]], want, 2e-4, 2e-4,
                                           f"{name} fixture / {task}"))
            if name == "pm_small":
                attn_err = max(attn_err, max_err(aux["attn"][:, i], torch.from_numpy(
                    data[f"attn/{task}"][:, 0]).to(dev), 2e-4, 2e-4, f"pm_small attn / {task}"))
                emb_err = max(emb_err, max_err(aux["task_embeddings"][:, i], torch.from_numpy(
                    data[f"task_emb/{task}"]).to(dev), 2e-3, 2e-3, f"pm_small task_emb / {task}"))
    print(f"[16] PM golden logits on the card ({len(names)} fixtures): max abs err {fix_err:.3e} "
          f"(atol/rtol 2e-4); pm_small attention {attn_err:.3e} (2e-4), task embeddings "
          f"{emb_err:.3e} (2e-3)")

    spec = pm.build_spec(config.load_tasks(config.default_tasks_path()), {})
    params = pm.init(torch.Generator().manual_seed(16), spec)
    frames = np.random.RandomState(17).randint(0, 256, (PM_FRAMES, 224, 224, 3), np.uint8)
    xb = torch.from_numpy(frames[:BATCH]).to(dev)
    outs, engines = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        label = "bf16" if dtype == torch.bfloat16 else "float32"
        eng = executor.Engine("pm", spec, params, batch_size=BATCH, dtype=dtype)
        out = eng.run(frames, collect=("probs", "preds", "logits"))
        check_probs(out, PM_FRAMES, spec, f"PM headline {label}")
        want = executor.Engine("pm", spec, params, batch_size=2, dtype=dtype, device="cpu").run(
            frames[:2], collect=("logits",))["logits"]
        scale = float(np.abs(want).max())
        # float32: summation order only; bf16: roundings at other places
        # (cuDNN's bf16 output against the CPU's upcast convolution)
        tol = 1e-3 if dtype == torch.float32 else 5e-2
        err = max_err(torch.from_numpy(out["logits"][:2]), torch.from_numpy(want), tol * scale, tol,
                      f"PM headline {label} logits vs the port's CPU path")
        outs[label], engines[label] = out, eng
        print(f"[16] PM headline {label} (ndf 64, patch 70, instance norm, SE, trunk "
              f"{spec.trunk_channels} channels, 12 tasks, seeded weights): {PM_FRAMES} frames at batch "
              f"{BATCH}, logits vs CPU on 2 frames max abs err {err:.3e} (max |logit| {scale:.3f}; "
              f"atol {tol} x max, rtol {tol})")
    agree, drift = agreement(outs["bf16"]["probs"], outs["float32"]["probs"])
    step32, step16 = in_turns(lambda: engines["float32"].step(xb), lambda: engines["bf16"].step(xb),
                              reps=3, rounds=3)
    wall32, _ = run_wall(engines["float32"], frames)
    wall16, _ = run_wall(engines["bf16"], frames)
    print(f"[16] PM headline bf16 vs float32: argmax agrees on {agree:.4f} of (frame, task) pairs, max "
          f"prob drift {drift:.3e}; engine step at batch {BATCH} in turns: float32 {step32:.3f} ms = "
          f"{BATCH / step32 * 1e3:,.0f} img/s, bf16 {step16:.3f} ms = {BATCH / step16 * 1e3:,.0f} img/s "
          f"(device); Engine.run end to end on {PM_FRAMES} host frames: float32 "
          f"{PM_FRAMES / wall32:,.0f}, bf16 {PM_FRAMES / wall16:,.0f} img/s | {card}")
    if profile:
        for label in ("float32", "bf16"):
            profile_step(f"[16] PM headline {label} step at batch {BATCH}",
                         lambda: engines[label].step(xb))


def rtm_bf16_phase(card: str, f32: dict, profile: bool) -> None:
    """Phase 17: RTM batch inference in bf16 at phase 12's width and batch."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor

    dev = torch.device("cuda", 0)
    spec, params, frames = f32["spec"], f32["params"], f32["frames"]
    eng16 = executor.Engine("rtm", spec, params, batch_size=RTM_BATCH, dtype=torch.bfloat16)
    out16 = eng16.run(frames, collect=("probs", "preds", "logits"))
    check_probs(out16, RTM_FRAMES, spec, "RTM bf16 batch")
    agree, drift = agreement(out16["probs"], f32["out"]["probs"])
    eng32 = executor.Engine("rtm", spec, params, batch_size=RTM_BATCH)
    xb = torch.from_numpy(frames[:RTM_BATCH]).to(dev)
    step32, step16 = in_turns(lambda: eng32.step(xb), lambda: eng16.step(xb), reps=3, rounds=3)
    wall16, _ = run_wall(eng16, frames)
    print(f"[17] RTM bf16 batch (phase 12's width): {RTM_FRAMES} frames at batch {RTM_BATCH}; vs the "
          f"float32 run argmax agrees on {agree:.4f} of (frame, task) pairs, max prob drift {drift:.3e}; "
          f"engine step in turns: float32 {step32:.3f} ms = {RTM_BATCH / step32 * 1e3:,.0f} img/s, bf16 "
          f"{step16:.3f} ms = {RTM_BATCH / step16 * 1e3:,.0f} img/s (device); Engine.run end to end: "
          f"bf16 {RTM_FRAMES / wall16:,.0f} img/s, float32 (phase 12) {RTM_FRAMES / f32['wall']:,.0f} "
          f"img/s | {card}")
    if profile:
        profile_step(f"[17] RTM bf16 step at batch {RTM_BATCH}", lambda: eng16.step(xb))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel from torch.profiler")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    os.chdir(repo)
    sys.path.insert(0, repo)
    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, nn, norms, preprocess as pre,
    )

    port.config.enable_parity_precision()
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build(verbose=True)
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s")
    old = archived_kernels()
    print(f"[1] archived kernel versions for an A/B: {', '.join(sorted(old)) or 'none in this checkout'}")

    # -- 2. kernels against their plain versions, on the card -------------
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randn(BATCH, 14, 14, 96).astype(np.float32)).to(dev)
    g = ck.patch_gram(z, 3)
    torch.cuda.synchronize()
    gram_err = max_err(g, ck.patch_gram_plain(z, 3), 1e-5, 1e-5, "patch_gram [256,14,14,96] div 3")
    if not torch.equal(ck.patch_gram(z, 3), g):
        raise AssertionError("patch_gram: two calls on the same inputs differ")
    # ragged shapes: replicate pad, partial output tiles, and (C % 4 != 0)
    # the kernel's scalar load and store path
    rag_err = 0.0
    for shape, div in (((2, 7, 5, 16), 2), ((2, 7, 5, 18), 2)):
        zr = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
        rag_err = max(rag_err, max_err(ck.patch_gram(zr, div), ck.patch_gram_plain(zr, div),
                                       1e-5, 1e-5, f"patch_gram {list(shape)} div {div}"))
    torch.cuda.synchronize()
    print(f"[2] patch_gram vs plain: max abs err {gram_err:.3e} (main shape, two calls "
          f"bit-identical), {rag_err:.3e} (ragged), atol/rtol 1e-5")

    x8 = torch.from_numpy(rng.randint(0, 256, (BATCH, 224, 224, 3), np.uint8)).to(dev)
    conv_w = torch.from_numpy(rng.randn(4, 4, 3, 32).astype(np.float32) * 0.1).to(dev)
    bn = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in {
        "scale": rng.rand(32) + 0.5, "bias": rng.randn(32) * 0.1,
        "mean": rng.randn(32) * 0.1, "var": rng.rand(32) + 0.5}.items()}
    aff_s, aff_t = (torch.as_tensor(a, device=dev) for a in pre.packed_affine(4))
    w0 = conv_w.reshape(48, 32)
    wf = (aff_s[:, None] * w0).contiguous()
    s, t = norms.batch_norm_affine(bn)
    shift = (-(aff_t @ w0) * s + t).contiguous()
    y = ck.stem(x8, wf, s, shift, 4, leaky=True)
    torch.cuda.synchronize()
    stem_err = max_err(y, ck.stem_plain(x8, wf, s, shift, 4, leaky=True), 2e-4, 2e-4,
                       "stem [256,224,224,3] -> 32")
    if not torch.equal(ck.stem(x8, wf, s, shift, 4, leaky=True), y):
        raise AssertionError("stem: two calls on the same inputs differ")
    paths = [f"[256,224,224,3]->32 {stem_path(x8, 32)}"]
    # ragged shapes: 360-byte input runs (W*cin % 16 != 0: the plain path,
    # byte loads), and 12 channels (a partial n-tile, masked stores)
    rag_err = 0.0
    ragged = []
    for shape, cout in (((2, 30, 30, 3), 16), ((2, 32, 32, 3), 12)):
        xr = torch.from_numpy(rng.randint(0, 256, shape, np.uint8)).to(dev)
        wr = torch.from_numpy(rng.randn(48, cout).astype(np.float32) * 0.01).to(dev)
        sr, tr = (torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dev) for _ in range(2))
        rag_err = max(rag_err, max_err(
            ck.stem(xr, wr, sr, tr, 4, leaky=False), ck.stem_plain(xr, wr, sr, tr, 4, leaky=False),
            2e-4, 2e-4, f"stem {list(shape)} -> {cout}"))
        paths.append(f"{list(shape)}->{cout} {stem_path(xr, cout)}")
        ragged.append((xr, cout))
    torch.cuda.synchronize()
    print(f"[2] stem vs plain: max abs err {stem_err:.3e} (main shape, two calls bit-identical), "
          f"{rag_err:.3e} (ragged), atol/rtol 2e-4; paths: {'; '.join(paths)}")
    # bf16 mode on the same images: the bf16-rounded weight, the bias, the
    # batch norm's affine on bf16 params
    bn16 = {k: v.to(torch.bfloat16) for k, v in bn.items()}
    s16, t16 = (v.contiguous() for v in norms.batch_norm_affine(bn16))
    wb = wf.to(torch.bfloat16).float().contiguous()
    bias = (-(aff_t @ w0)).contiguous()
    checks = [stem_bf16_check(x8, wb, bias, s16, t16, "[256,224,224,3]->32")]
    for xr, cout in ragged:
        rr = np.random.RandomState(cout)
        wr = torch.from_numpy(rr.randn(48, cout).astype(np.float32) * 0.01).to(dev).to(torch.bfloat16).float()
        br = torch.from_numpy(rr.randn(cout).astype(np.float32)).to(dev)
        sr, tr = (torch.from_numpy(rr.rand(cout).astype(np.float32) + 0.5).to(dev).to(torch.bfloat16)
                  for _ in range(2))
        checks.append(stem_bf16_check(xr, wr, br, sr, tr, f"{list(xr.shape)}->{cout}"))
    print("[2] stem bf16 mode: (a) the norm and LeakyReLU equal the bf16 chain on the kernel's own "
          "sum bit for bit; (b) the sum within one bf16 ulp of the plain version's rounding "
          "(2^-7 |want| + 2e-4), share of outputs that differ at all (limit 1 %): "
          + "; ".join(f"{c['what']} {c['path']} {c['share'] * 100:.4f} %" for c in checks))

    # -- 3. golden fixture on the card --------------------------------------
    with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(FIXTURES, "pmg_shipped.npz"))
    eng = port.load_engine(
        "pmg", os.path.join(FIXTURES, "pmg_shipped.pth"), meta["tasks"],
        meta["hparams"], batch_size=BATCH, device="cuda",
    )
    spec = eng.spec
    xf = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))).to(dev)
    with torch.inference_mode():
        logits, _ = pmg.apply(eng.params, xf, spec)
    fix_err = 0.0
    for i, task in enumerate(spec.tasks.names):
        want = torch.from_numpy(data[f"logits/{task}"]).to(dev)
        fix_err = max(fix_err, max_err(logits[:, i, : want.shape[1]], want, 2e-4, 2e-4,
                                       f"pmg_shipped fixture / {task}"))
    print(f"[3] pmg_shipped golden logits on the card: max abs err {fix_err:.3e}, atol/rtol 2e-4")

    # -- 4. main path --------------------------------------------------------
    frames = np.random.RandomState(1).randint(0, 256, (N_FRAMES, 224, 224, 3), np.uint8)
    ck.reset_launches()
    out = eng.run(frames, collect=("probs", "preds", "logits"))
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    for name in ("patch_gram", "stem"):
        if launches[name] == 0:
            raise AssertionError(f"main path never launched the {name} kernel")
    probs, preds = out["probs"], out["preds"]
    if probs.shape != (N_FRAMES, len(spec.tasks), spec.tasks.max_classes):
        raise AssertionError(f"probs shape {probs.shape}")
    mask = executor.class_mask(spec.tasks)
    if not np.allclose(probs.sum(-1), 1.0, atol=1e-5) or np.abs(probs[:, ~mask]).max() != 0:
        raise AssertionError("probability rows do not sum to 1 over the real classes")
    cpu_eng = executor.Engine("pmg", spec, eng.params, batch_size=8, device="cpu")
    want = cpu_eng.run(frames[:8], collect=("logits",))["logits"]
    cpu_err = max_err(torch.from_numpy(out["logits"][:8]), torch.from_numpy(want), 2e-4, 2e-4,
                      "main path logits vs the port's CPU path")
    unknown = executor.Engine("pmg", spec, eng.params, batch_size=BATCH, prob_threshold=0.99,
                              device="cuda").run(frames[:BATCH])["preds"]
    if not (unknown == -1).all():
        raise AssertionError("prob_threshold=0.99 left some predictions known")
    print(f"[4] main path: {N_FRAMES} frames at batch {BATCH}, launches {launches}, "
          f"logits vs CPU max abs err {cpu_err:.3e}, preds[0] {preds[0].tolist()}")

    # -- 5. times -------------------------------------------------------------
    kernels = []
    nbytes = z.numel() * 4 + g.numel() * 4
    flops = 2.0 * BATCH * 9 * 25 * 96 * 96 + g.numel()
    b_ms, b_by = bound_ms(nbytes, flops)
    k1_yard = k1_yardsticks(z, 3)
    kernels.append({
        "name": "patch_gram", "route": "cuda", "source": f"{PORT}/csrc/patch_gram.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_kernels.py:68",
        "launches": launches["patch_gram"], "max_abs_err": gram_err,
        "ms": device_ms(lambda: ck.patch_gram(z, 3)),
        "plain_ms": device_ms(lambda: ck.patch_gram_plain(z, 3)),
        "bound_ms": b_ms, "bound_by": b_by,
        # torch.baddbmm (P^T P times 1/area) on the already split patches:
        # leaves out the replicate pad and the split, timed apart below
        "library_ms": k1_yard["baddbmm"],
    })
    nbytes = x8.numel() + wf.numel() * 4 + 2 * 32 * 4 + y.numel() * 4
    flops = 2.0 * y.numel() * 48 + 2.0 * y.numel()
    b_ms, b_by = bound_ms(nbytes, flops)
    a2d = pre.s2d_pack(x8, 4).reshape(-1, 48).float().contiguous()
    kernels.append({
        "name": "stem", "route": "cuda", "source": f"{PORT}/csrc/stem.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_kernels.py:118",
        "launches": launches["stem"], "max_abs_err": stem_err,
        "ms": device_ms(lambda: ck.stem(x8, wf, s, shift, 4, leaky=True)),
        "plain_ms": device_ms(lambda: ck.stem_plain(x8, wf, s, shift, 4, leaky=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        # torch.addmm on the packed float operand: leaves out the uint8 cast and
        # space-to-depth pack, the batch-norm scale and the LeakyReLU
        "library_ms": device_ms(lambda: torch.addmm(shift, a2d, wf)),
    })
    # K2's bf16 mode (the bf16 path's stem block): bf16 out, its products
    # bf16 x bf16 on the tensor cores; launches from the bf16 run (phase 15)
    y16 = ck.stem(x8, wb, s16, t16, 4, leaky=True, out_dtype=torch.bfloat16, bias=bias)
    b16_ms, b16_by = bound_ms(x8.numel() + wb.numel() * 4 + 32 * 8 + y16.numel() * 2, 0.0,
                              bf16_flops=2.0 * y16.numel() * 48)
    a2d16, wb16, bias16 = a2d.to(torch.bfloat16), wb.to(torch.bfloat16), bias.to(torch.bfloat16)
    stem16 = {
        "name": "stem_bf16", "route": "cuda", "source": f"{PORT}/csrc/stem.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_kernels.py:118",
        "launches": None, "max_abs_err": checks[0]["err"],  # against the plain bf16 chain
        "ms": device_ms(lambda: ck.stem(x8, wb, s16, t16, 4, leaky=True, out_dtype=torch.bfloat16,
                                        bias=bias)),
        "plain_ms": device_ms(lambda: ck.stem_plain(x8, wb, s16, t16, 4, leaky=True,
                                                    out_dtype=torch.bfloat16, bias=bias)),
        "bound_ms": b16_ms, "bound_by": b16_by,
        # torch.addmm of the packed operand cast to bf16 and the bf16 weight,
        # bf16 out: no cast or pack, no norm, no LeakyReLU
        "library_ms": device_ms(lambda: torch.addmm(bias16, a2d16, wb16)),
    }
    kernels.append(stem16)
    del a2d, a2d16
    t0 = time.perf_counter()
    for _ in range(100):
        ck.stem(x8, wf, s, shift, 4, leaky=True)
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    print(f"[5] stem host time of one wrapper call (checks, plan, tensor map encoded, launch "
          f"enqueued): {host_us:.1f} us | {card}")
    if "wadt_stem_u8_f32" in old:  # the archived K2 (CUDA cores, one block per 512 pixels) in turns
        y_old = torch.empty_like(y)
        old_ms, new_ms = in_turns(
            archived_call(old["wadt_stem_u8_f32"], x8.data_ptr(), wf.data_ptr(), s.data_ptr(),
                          shift.data_ptr(), y_old.data_ptr(), BATCH, 224, 224, 3, 4, 32, 1),
            lambda: ck.stem(x8, wf, s, shift, 4, leaky=True))
        print(f"[5] stem float32 in turns: archived v1 {old_ms * 1e3:.1f} us, new {new_ms * 1e3:.1f} us"
              f" | {card}")
        # the bf16 stem block before: archived K2 with the identity affine
        # plus the bias, the cast, batch_norm_infer on the bf16 params (its
        # affine recomputed), the LeakyReLU; after: the bf16 mode alone
        ones = torch.ones(32, device=dev)

        def old_block():
            old["wadt_stem_u8_f32"](x8.data_ptr(), wb.data_ptr(), ones.data_ptr(), bias.data_ptr(),
                                    y_old.data_ptr(), BATCH, 224, 224, 3, 4, 32, 0,
                                    torch.cuda.current_stream().cuda_stream)
            return nn.leaky_relu(norms.batch_norm_infer(y_old.to(torch.bfloat16), bn16), 0.2)

        old_ms, new_ms = in_turns(old_block, lambda: ck.stem(
            x8, wb, s16, t16, 4, leaky=True, out_dtype=torch.bfloat16, bias=bias))
        print(f"[5] bf16 stem block in turns: before (archived v1, cast, batch norm, LeakyReLU) "
              f"{old_ms * 1e3:.1f} us, now (the bf16 mode) {new_ms * 1e3:.1f} us | {card}")
        del y_old
    if args.profile:
        k2_cuts(x8, wf, s, shift, wb, bias, s16, t16, card)
    for k in kernels:
        print(f"[5] {k['name']}: {k['ms'] * 1e3:.1f} us (bound {k['bound_ms'] * 1e3:.2f} us by "
              f"{k['bound_by']}), plain {k['plain_ms'] * 1e3:.1f} us, library "
              f"{k['library_ms'] * 1e3:.1f} us | {card}")
    print(f"[5] patch_gram yardsticks in float32 on the split patches: torch.baddbmm (P^T P / area) "
          f"{k1_yard['baddbmm'] * 1e3:.1f} us, torch.bmm (P^T P) {k1_yard['bmm'] * 1e3:.1f} us; the "
          f"split_patches copy they need {k1_yard['split'] * 1e3:.1f} us | {card}")
    if "wadt_patch_gram_f32" in old:  # the archived K1 (one block per patch) in turns
        g_old = torch.empty_like(g)
        old_ms, new_ms = in_turns(
            archived_call(old["wadt_patch_gram_f32"], z.data_ptr(), g_old.data_ptr(), BATCH, 14, 14, 96, 3),
            lambda: ck.patch_gram(z, 3))
        print(f"[5] patch_gram float32 in turns: archived v1 {old_ms * 1e3:.1f} us, new {new_ms * 1e3:.1f} us"
              f" ({ck.patch_gram_plan(BATCH, 14, 14, 96, 3, ck._sm_count(dev))}) | {card}")

    xb = torch.from_numpy(frames[:BATCH]).to(dev)
    step_ms = device_ms(lambda: eng.step(xb), reps=10, rounds=3)
    print(f"[5] engine step on a device-resident batch of {BATCH}: {step_ms:.3f} ms "
          f"= {BATCH / step_ms * 1e3:,.0f} img/s (device) | {card}")
    h2d = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(frames[:BATCH]).to(dev)
        torch.cuda.synchronize()
        h2d.append(time.perf_counter() - t0)
    print(f"[5] host-to-device copy of one pageable uint8 batch ({frames[:BATCH].nbytes / 1e6:.1f} MB): "
          f"{statistics.median(h2d) * 1e3:.3f} ms (median of 5) | {card}")
    big = np.concatenate([frames] * 5)[: 10 * BATCH]
    wall5, walls = run_wall(eng, big)
    print(f"[5] Engine.run end to end, {len(big)} host uint8 frames at batch {BATCH}: "
          f"{len(big) / wall5:,.0f} img/s (median of 3: {[round(w, 4) for w in walls]} s) | {card}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                eng.step(xb)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))

    routes: list = []
    kernels += camera_phases(args.profile, card, eng.spec, eng.params, routes, old)
    k6, rtm_f32 = rtm_phases(args.profile, card, routes)
    kernels.append(k6)
    launches16, k5 = pmg_bf16_phases(card, eng, frames, out, big, wall5, args.profile, old)
    kernels.insert(4, k5)
    stem16["launches"] = launches16["stem"]
    parent_step_ab(card)
    del eng
    pm_phase(card, args.profile)
    rtm_bf16_phase(card, rtm_f32, args.profile)
    del rtm_f32
    kernels_per_step(routes, args.profile)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
