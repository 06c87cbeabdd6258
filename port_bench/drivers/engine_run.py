"""Driver ``engine_run``: batch classification through the port's
``engine.executor.Engine.run``, as a folder run hands the engine its chunks.

Set-up draws the configuration's weights (or loads its checkpoint), loads
them into the port through ``engine.checkpoint.convert`` as a user loads a
checkpoint, builds the ``Engine`` at the traffic's batch and precision,
draws a pool of uint8 frames and makes the call's frames from it (the pool
repeated), and warms the engine up with one call.  Each call of the window
is ``Engine.run`` on those frames; every call's probabilities and
predictions are kept.

The check frees the engine, runs the plain reference once over the pool in
blocks of the batch, and holds every answer of every call to it: the
largest gap of a probability or of a prediction (``judge``).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import faults
from ..reference.common import Precision, normalize, probs
from ..weights import state as load_state
from ..yardstick import PEAK_FLOP_PER_S
from .train_step import PORT, frames

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the faults a batch-inference cell can have, planted under the timed path
FAULTS = {"half_batch": faults.half_batch_infer, "answer_altered": faults.answer_altered}


class Run:
    def __init__(self, ctx):
        from importlib import import_module

        ckpt = import_module(f"{PORT}.engine.checkpoint")
        executor = import_module(f"{PORT}.engine.executor")
        self.ctx, cfg, tr = ctx, ctx.cfg, ctx.traffic
        self.dev, self.batch = ctx.device, int(tr["batch"])
        if cfg.get("parity_precision"):
            import_module(f"{PORT}.config").enable_parity_precision()
        spec = ctx.family.port_spec(cfg)
        sd = load_state(cfg, ctx.root, ctx.seed, self.dev)
        params = ckpt.convert(cfg["family"], {k: v.cpu().numpy() for k, v in sd.items()}, spec)
        del sd
        self.engine = executor.Engine(cfg["family"], spec, params, batch_size=self.batch,
                                      prob_threshold=float(tr["prob_threshold"]),
                                      dtype=_DTYPES[tr["dtype"]], device=self.dev)
        del params
        self.pool = frames(int(tr["pool"]), cfg["img_size"], ctx.seed, self.dev)
        self.index = np.arange(int(tr["frames_per_call"])) % len(self.pool)
        self.frames = self.pool[self.index]
        self.outs = []
        self.attempted = self.failed = 0
        self.detail: dict = {}
        self._call()  # warm-up: the one shape the window uses
        self.outs.clear()

    def _call(self) -> None:
        with self.ctx.spans("run"):
            out = self.engine.run(self.frames, scan_chunk=self.ctx.traffic["scan_chunk"])
        self.outs.append((out["probs"], out["preds"]))

    def window(self, seconds: float) -> float:
        """Images of the calls completed in ``seconds``, over all the time."""
        calls, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._call()
            calls += 1
        rate = calls * len(self.frames) / (time.perf_counter() - t0)
        self.attempted += calls * len(self.frames)
        return rate

    def traced(self) -> Dict[str, int]:
        """The traced run's fixed work: ``traced_calls`` calls; a step is
        one batch."""
        n = int(self.ctx.traffic["traced_calls"])
        for _ in range(n):
            self._call()
        self.attempted += n * len(self.frames)
        return {"calls": n, "steps": n * -(-len(self.frames) // self.batch)}

    def annotate(self, tr) -> None:
        dtype = self.ctx.traffic["dtype"]
        tr.flops = self.ctx.family.forward_flops(self.ctx.cfg, self.batch) * tr.items["steps"]
        tr.peak_flop_per_s = PEAK_FLOP_PER_S[dtype]

    def check(self) -> Dict[str, float]:
        del self.engine
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers, self.failed = judge(self.ctx, self.index, self.outs,
                                     reference_probs(self.ctx, self.pool, Precision()))
        return numbers


def _pred_gap(w: np.ndarray, pred: np.ndarray, thr: float, kmax: np.ndarray) -> np.ndarray:
    """How far the reference's probabilities ``w`` [N, T, K] are from giving
    each predicted class ``pred`` [N, T] (-1: below the threshold): 0 where
    they give it; else half the gap between the reference's top probability
    and the predicted class's, the top's distance above the threshold, or
    the predicted class's distance below it; 1 for a class the task lacks.
    A program whose predictions follow its own probabilities never reads
    above its largest probability gap here."""
    top = w.max(-1)
    ref = np.where(top >= thr, w.argmax(-1), -1)
    valid = (pred >= -1) & (pred < kmax[None, :])
    pj = np.take_along_axis(w, np.clip(pred, 0, w.shape[-1] - 1)[..., None], -1)[..., 0]
    off = np.where(pred < 0, top - thr, np.where(ref < 0, thr - pj, (top - pj) / 2))
    return np.where(~valid, 1.0, np.where(pred == ref, 0.0, off))


def judge(ctx, index: np.ndarray, outs, want: np.ndarray):
    """(numbers, failed images): every call's answers ``outs`` (probs, preds
    of the frames ``index`` of the pool) against the reference's
    probabilities of the pool ``want`` [P, T, Kmax].  ``answer_gap`` is the
    largest of every probability's gap and every prediction's
    (``_pred_gap``), so it covers the masked softmax, the threshold and the
    argmax."""
    thr = float(ctx.traffic["prob_threshold"])
    kmax = np.array([len(v) for v in ctx.cfg["tasks"].values()])
    w = want[index]
    gap, failed = 0.0, 0
    for p, pred in outs:
        if p.shape != w.shape or pred.shape != w.shape[:2]:
            failed += len(w)
            continue
        ok = np.isfinite(p).all(axis=(1, 2))
        failed += int((~ok).sum())
        gap = max(gap, float(np.abs(p[ok] - w[ok]).max(initial=0.0)),
                  float(_pred_gap(w[ok], pred[ok], thr, kmax).max(initial=0.0)))
    return {"answer_gap": gap}, failed


def reference_probs(ctx, pool: np.ndarray, prec: Precision) -> np.ndarray:
    """The reference's probabilities [P, T, Kmax] of every pool frame,
    blocks of the traffic's batch at a time, from the same weights."""
    cfg, dev, bs = ctx.cfg, ctx.device, int(ctx.traffic["batch"])
    sd = load_state(cfg, ctx.root, ctx.seed, dev)
    tasks = list(cfg["tasks"])
    kmax = max(len(v) for v in cfg["tasks"].values())
    out = []
    with torch.no_grad(), prec.flags():
        for s in range(0, len(pool), bs):
            x = normalize(torch.from_numpy(pool[s:s + bs]).to(dev))
            out.append(probs(ctx.ref.forward(sd, x, cfg, prec), tasks, kmax).cpu().numpy())
    return np.concatenate(out)


def control(ctx, precision: str):
    """(numbers, detail): the numbers of the reference computed at
    ``precision`` put in the program's place, on the frames a run of this
    seed sends; no detail."""
    tr = ctx.traffic
    pool = frames(int(tr["pool"]), ctx.cfg["img_size"], ctx.seed, ctx.device)
    index = np.arange(int(tr["frames_per_call"])) % len(pool)
    low = reference_probs(ctx, pool, Precision(precision))[index]
    maxp = low.max(-1)
    pred = np.where(maxp >= float(tr["prob_threshold"]), low.argmax(-1), -1)
    return judge(ctx, index, [(low, pred)], reference_probs(ctx, pool, Precision()))[0], {}
