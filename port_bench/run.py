"""Run one cell of the port's benchmark and print its result line.

    python3 -m port_bench.run --workload rtm_resnet50.infer_bf16 --seed 7 --seconds 20 --trace 0

From the root of a checkout, on a machine with the CUDA cards the cell asks
for.  The cell's traffic names a driver (``drivers/<name>.py``), which sets
up the program under test
(``heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch``)
from the seed and the cell's files, drives its timed path for ``--seconds``
(or, with ``--trace 1``, a fixed amount of work, untraced and then under
the profiler), frees it and holds what it produced to the plain reference
under ``reference/``.  The window's rate is the value of the cell's
end-to-end metric besides ``setup_s``; a driver that measures more than
one returns them by name.
The last line of standard output is one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the last
key of that object.  Exit codes: 0 a result was printed (correct or not),
2 no such cell, 3 no card or too few, 4 JAX was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from importlib import import_module  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = frozenset({
    "jax", "jaxlib", "flax",
    "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu",
})


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds; set before torch is imported.
    The port's own nvcc builds already live in its ``csrc/_build/``."""
    cache = os.path.join(root, "port_bench", "_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"


def jax_loaded() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & JAX_NAMES)


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def window_metrics(cell, got) -> dict:
    """The window's readings by metric name: a driver's one rate goes to
    the cell's one end-to-end metric besides ``setup_s``."""
    if isinstance(got, dict):
        return got
    names = [m["name"] for m in cell.end_to_end if m["name"] != "setup_s"]
    if len(names) != 1:
        raise ValueError(f"{cell.name} reports {names}; its driver returned one rate")
    return {names[0]: got}


def context(root: str, cell, seed: int, device) -> types.SimpleNamespace:
    """What a driver reads: the cell's files, the seed, the device, the
    configuration family's module in ``families/`` and its reference."""
    from .trace import Spans

    fam = cell.config["family"]
    return types.SimpleNamespace(
        root=root, cell=cell.name, cfg=cell.config, traffic=cell.traffic, limits=cell.limits,
        seed=seed, device=device, spans=Spans(),
        family=import_module(f"{__package__}.families.{fam}"),
        ref=import_module(f"{__package__}.reference.{fam}"))


def execute(root: str, workload: str, seed: int, seconds: float, trace: bool,
            device=None, t0: float = T0) -> int:
    """One run; ``device=None`` looks for the cards the cell asks for, a
    given device (the tests' CPU) skips the look."""
    from . import cells
    from .trace import profile

    try:
        cell = cells.load(root, workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{workload} needs {cell.chips} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    ctx = context(root, cell, seed, device)
    run = cells.driver(cell).Run(ctx)
    setup_s = time.perf_counter() - t0
    metrics, extra = {}, {}
    if trace:
        tr = profile(run.traced, ctx.spans, device)
        run.annotate(tr)
        for m in cell.per_layer:
            v = cells.reader(root, m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra["busy_s"], extra["window_s"] = tr.busy_s, tr.window_s
        breakdown = tr.breakdown()
    else:
        rates = window_metrics(cell, run.window(seconds))
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else rates.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    numbers = run.check()
    bad = jax_loaded()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = (run.attempted > 0 and run.failed == 0
               and all(_finite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), **extra}
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cache_env(ROOT)
    return execute(ROOT, a.workload, a.seed, a.seconds, bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
