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
   over a few device-resident steps.

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

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.  The kernels here run on CUDA
# cores in float32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"
JAX_PKG = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu"
FIXTURES = os.path.join("tests", "fixtures")
BATCH = 256
N_FRAMES = 600


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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
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
    for name, count in launches.items():
        if count == 0:
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

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
