"""Faults planted under the timed path, to show that ``correct`` comes out
false when the program is wrong: each a context manager that patches the
port while it is open.  Each driver names the faults its cells can have in
its ``FAULTS``; the tests drive whole runs with them, and the calibration
reads each at a cell's own size."""

from __future__ import annotations

import contextlib
from importlib import import_module

import numpy as np

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"


@contextlib.contextmanager
def _patched(module: str, owner: str, name: str, make):
    obj = import_module(f"{PORT}.{module}")
    if owner:
        obj = getattr(obj, owner)
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _wrap_step(change):
    """Patch ``cached_train_step`` so the step it returns is ``change(step)``."""
    def make(orig):
        def cached(*a, **k):
            opt, init, step = orig(*a, **k)
            return opt, init, change(step)
        return cached
    return _patched("parallel.train", "", "cached_train_step", make)


@contextlib.contextmanager
def state_unchanged():
    """Train: neither the optimizer nor the running statistics move; the
    state leaves each step as it came."""
    def nothing(orig):
        return lambda *a, **k: None

    with _patched("parallel.train", "OptState", "update", nothing), \
            _patched("parallel.train", "", "_merge_stats", nothing):
        yield


def half_batch_train():
    """Train: the step sees the first half of each batch only, its mean
    taken over that half."""
    def change(step):
        def half(state, x, y):
            n = x.shape[0] // 2
            return step(state, x[:n], y[:n])
        return half
    return _wrap_step(change)


def loss_altered():
    """Train: the loss a step returns is 1 % off."""
    def change(step):
        def off(state, x, y):
            state, loss = step(state, x, y)
            return state, loss * 1.01
        return off
    return _wrap_step(change)


def half_batch_infer():
    """Inference: each batch's second half is replaced by its first half
    before the step, so half of its answers belong to other frames."""
    def make(orig):
        def step(self, images, labels=None):
            images = np.array(images)
            n = images.shape[0] // 2
            images[n: 2 * n] = images[:n]
            return orig(self, images, labels)
        return step
    return _patched("engine.executor", "Engine", "step", make)


def answer_altered():
    """Inference: the first frame of each batch gets its first task's
    probabilities rotated by one class where they are produced."""
    def make(orig):
        def outputs(self, *a, **k):
            out = orig(self, *a, **k)
            k0 = self.tasks.num_classes[0]
            p = out["probs"].clone()
            p[0, 0, :k0] = p[0, 0, :k0].roll(1)
            out["probs"] = p
            return out
        return outputs
    return _patched("engine.executor", "Engine", "_outputs", make)

