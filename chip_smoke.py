#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of the repository:

    python3 chip_smoke.py [--profile]

Phases, each of which raises on failure:

1. print the card's name and power limit (nvidia-smi), build the CUDA
   kernels from ``<port>/csrc`` (nvcc, sm_90a);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and on ragged shapes that take their other code paths;
3. golden fixture: the shipped PMG checkpoint's logits on the fixture input
   match the frozen reference logits at 2e-4;
4. main path: ``Engine.run`` at batch 256 on 600 seeded uint8 224-px frames
   with launch counts reset just before; both kernels must have launched,
   probabilities sum to 1, the first 8 frames' logits match the port's CPU
   path, and ``prob_threshold=0.99`` gives all Unknown;
5. times (CUDA events; card name and power limit beside them): each kernel,
   its plain version and one PyTorch library call that computes the same
   function, beside the least time the card could take; the engine's
   images per second end to end and on device-resident batches.
   ``--profile`` adds a ``torch.profiler`` table of device time by kernel
   over a few device-resident steps;
6. the camera path's kernels against their plain versions on the card: the
   fused trunk + Gram at the shipped shapes (batch 1 and 8) and on a ragged
   spec, the fused head for the bf16 and q8 folds (batch 1 and 8) and for a
   spec without transformer;
7. the golden-fixture walk of the fused head variants on the card: argmax
   agrees on decisive samples, drift <= HEAD_FOLD_MAX_DRIFT;
8. camera path: ``StreamPredictor`` with its default routes on the shipped
   checkpoint over 64 seeded frames, launch counts reset just before; both
   camera kernels must have launched, the probabilities follow the Kalman
   recursion and match the port's CPU path on 8 frames; the packed route
   runs at batch 1 through the stem and Gram kernels;
9. camera times: both camera kernels at batch 1 beside their bounds and
   plain versions, and per-frame latency of three routes: device time per
   step back to back, one step's device span on an idle card and the host
   time to enqueue it, and host wall time per frame from ``submit`` to the
   probabilities on the host.  ``--profile`` adds device kernels and kernel
   time per step of each route, and the head kernel's time with its fold
   cut to its first 0, 1, ... layers.

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
    stays outside the interval."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
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


def camera_phases(profile: bool, card: str, spec, params) -> list:
    """Phases 6-9 (the camera path) on the shipped ``spec`` and ``params``
    (on the card); returns the camera kernels' entries of the kernels line."""
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
    # ragged: a 7x7 final map, replicate-padded to 9x9 for div 3; 120 px
    # wide leaves 8 columns beyond a multiple of K = 16
    rag_spec = pmg.build_spec({"a": ["x", "y"]}, dict(
        ndf=16, patch_size=64, patch_div=3, gram_channels=32, d_model=64,
        transformer_layers=0, use_token_attention=False))
    rag_w = ck.fold_trunk_gram_weights(
        checkpoint.to_device(random_pmg_params(rag_spec, rng), dev), rag_spec)
    xr = torch.from_numpy(rng.randint(0, 256, (2, 112, 120, 3), np.uint8)).to(dev)
    rag_err = max_err(ck.fused_trunk_gram(xr, rag_w, rag_spec),
                      ck.fused_trunk_gram_plain(xr, rag_w, rag_spec), K3_TOL, K3_TOL,
                      "fused_trunk_gram ragged [2,112,120,3]")
    torch.cuda.synchronize()
    print(f"[6] fused_trunk_gram vs plain: max abs err {k3_err:.3e} (batch 1 and 8), "
          f"{rag_err:.3e} (ragged), atol/rtol {K3_TOL}")

    tokens8 = ck.fused_trunk_gram_plain(x8, trunk_w, spec)
    tokens1 = tokens8[:1].contiguous()
    folds = {v: pmg.fold_head_weights(params, spec, v) for v in ("bf16", "q8")}
    nt_spec = pmg.build_spec(spec.tasks.as_dict(), dict(
        ndf=32, patch_size=64, patch_div=3, gram_channels=96, d_model=192,
        transformer_layers=0, use_token_attention=False))
    nt_fold = pmg.fold_head_weights(
        checkpoint.to_device(random_pmg_params(nt_spec, rng), dev), nt_spec, "q8")
    k4_err = 0.0
    cases = [(f"{v} batch {tb.shape[0]}", tb, f, spec)
             for v, f in folds.items() for tb in (tokens1, tokens8)]
    cases.append(("q8 no transformer batch 8", tokens8, nt_fold, nt_spec))
    for what, tb, f, sp in cases:
        got = ck.fused_head(tb, f, sp)
        torch.cuda.synchronize()
        want = ck.fused_head_plain(tb, f, sp)
        k4_err = max(k4_err, max_err(got, want, K4_TOL, K4_TOL, f"fused_head {what}"))
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError(f"fused_head {what}: argmax differs from the plain version")
    print(f"[6] fused_head vs plain: max abs err {k4_err:.3e} (bf16 and q8 folds at batch 1 "
          f"and 8, no-transformer spec), atol/rtol {K4_TOL}, argmax equal")

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
    if profile:  # the head kernel's time with the fold cut to its first n layers
        for n in range(len(fb["transformer"]) + 1):
            sub = dict(fb, transformer=fb["transformer"][:n])
            print(f"[9] fused_head with {n} of its layers: "
                  f"{device_ms(lambda: ck.fused_head(tokens1, sub, spec)) * 1e3:.1f} us | {card}")

    for trunk_kernel, head_fold in (("fused", "fused_bf16"), ("fused", "bf16"), ("packed", None)):
        kw = {"head_fold": head_fold} if head_fold else {}
        p = stream.StreamPredictor("pmg", spec, params, use_kalman=True,
                                   trunk_kernel=trunk_kernel, **kw)
        step_ms = device_ms(lambda: p.step(x1))
        for f in cam[:10]:
            np.asarray(p.submit(f))
        walls, enqueues, spans, steps = [], [], [], []
        for i in range(LATENCY_FRAMES):
            t0 = time.perf_counter()
            handle = p.submit(cam[i % CAMERA_FRAMES])
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
        print(f"[9] camera step {trunk_kernel}+{head_fold}: {step_ms * 1e3:.1f} us of device "
              f"time per step (back to back), {statistics.median(spans) * 1e3:.1f} us span of "
              f"one step alone, enqueued by the host in {statistics.median(steps) * 1e6:.1f} us; "
              f"host wall per frame, submit to host probs {statistics.median(walls) * 1e6:.1f} "
              f"us, of which submit returns after {statistics.median(enqueues) * 1e6:.1f} us "
              f"(medians of {LATENCY_FRAMES}) | {card}")
        if profile:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as tprofile

            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    p.step(x1)
                torch.cuda.synchronize()
            evs = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]
            print(f"[9] profile {trunk_kernel}+{head_fold}: {len(evs) / 10:.1f} device kernels "
                  f"per step, {sum(e.time_range.elapsed_us() for e in evs) / 10:.1f} us of "
                  f"kernel time per step")
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))
    return entries


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
        cuda_kernels as ck, gram, norms, preprocess as pre,
    )

    port.config.enable_parity_precision()
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build(verbose=True)
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s")

    # -- 2. kernels against their plain versions, on the card -------------
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randn(BATCH, 14, 14, 96).astype(np.float32)).to(dev)
    g = ck.patch_gram(z, 3)
    torch.cuda.synchronize()
    gram_err = max_err(g, ck.patch_gram_plain(z, 3), 1e-5, 1e-5, "patch_gram [256,14,14,96] div 3")
    # ragged shapes: replicate pad, partial output tiles, and (C % 4 != 0)
    # the kernel's scalar load and store path
    rag_err = 0.0
    for shape, div in (((2, 7, 5, 16), 2), ((2, 7, 5, 18), 2)):
        zr = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
        rag_err = max(rag_err, max_err(ck.patch_gram(zr, div), ck.patch_gram_plain(zr, div),
                                       1e-5, 1e-5, f"patch_gram {list(shape)} div {div}"))
    torch.cuda.synchronize()
    print(f"[2] patch_gram vs plain: max abs err {gram_err:.3e} (main shape), "
          f"{rag_err:.3e} (ragged), atol/rtol 1e-5")

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
    # ragged shapes: the runtime-size loop (W*cin % 4 != 0), and a channel
    # count that is not a multiple of 16 (padded weights, scalar stores)
    rag_err = 0.0
    for shape, cout in (((2, 30, 30, 3), 16), ((2, 32, 32, 3), 12)):
        xr = torch.from_numpy(rng.randint(0, 256, shape, np.uint8)).to(dev)
        wr = torch.from_numpy(rng.randn(48, cout).astype(np.float32) * 0.01).to(dev)
        sr, tr = (torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dev) for _ in range(2))
        rag_err = max(rag_err, max_err(
            ck.stem(xr, wr, sr, tr, 4, leaky=False), ck.stem_plain(xr, wr, sr, tr, 4, leaky=False),
            2e-4, 2e-4, f"stem {list(shape)} -> {cout}"))
    torch.cuda.synchronize()
    print(f"[2] stem vs plain: max abs err {stem_err:.3e} (main shape), {rag_err:.3e} "
          f"(ragged), atol/rtol 2e-4")

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
    patches, area = gram.split_patches(z, 3)
    p3 = patches.reshape(-1, area, 96).contiguous()
    p3t = p3.transpose(1, 2)
    kernels.append({
        "name": "patch_gram", "route": "cuda", "source": f"{PORT}/csrc/patch_gram.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_kernels.py:68",
        "launches": launches["patch_gram"], "max_abs_err": gram_err,
        "ms": device_ms(lambda: ck.patch_gram(z, 3)),
        "plain_ms": device_ms(lambda: ck.patch_gram_plain(z, 3)),
        "bound_ms": b_ms, "bound_by": b_by,
        # torch.bmm on the already split patches: leaves out the pad/split and the 1/area scale
        "library_ms": device_ms(lambda: torch.bmm(p3t, p3)),
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
    for k in kernels:
        print(f"[5] {k['name']}: {k['ms'] * 1e3:.1f} us (bound {k['bound_ms'] * 1e3:.1f} us by "
              f"{k['bound_by']}), plain {k['plain_ms'] * 1e3:.1f} us, library "
              f"{k['library_ms'] * 1e3:.1f} us | {card}")

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
    eng.run(big[:BATCH])
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(big)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"[5] Engine.run end to end, {len(big)} host uint8 frames at batch {BATCH}: "
          f"{len(big) / wall:,.0f} img/s (median of 3: {[round(w, 4) for w in walls]} s) | {card}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                eng.step(xb)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))

    kernels += camera_phases(args.profile, card, eng.spec, eng.params)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
