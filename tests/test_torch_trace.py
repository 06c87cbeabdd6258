"""The port's tracer (``utils/trace.py``) on the CPU: off it reads no clock
and opens nothing; under ``torch.profiler`` or ``recording()`` the Engine's
batches and the train step's phases record once each, tied by ids, and
stand in the profiler's events; readers see only the last session; a
session's cap holds; recording changes no result; and PM's forward records
its trunk, its heads and each trunk block's norm, which the benchmark's
``trunk_ms`` and ``norm_ms`` readers read."""

import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import (
    Engine,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import (
    pm,
    pmg,
    rtm,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import (
    train as ttrain,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import (
    trace,
)
from _torch_threads import one_torch_thread  # noqa: F401

TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
HPARAMS = {
    "pmg": dict(ndf=8, patch_size=16, patch_div=2, gram_channels=16, d_model=32,
                transformer_layers=1, transformer_heads=2, norm="batch"),
    "rtm": dict(truncate_layer=5, attn_token_dim=16),
}
MODULES = {"pmg": pmg, "rtm": rtm}
BS = 4
ENGINE_SPANS = ("engine.upload", "engine.forward", "engine.d2h")
TRAIN_SPANS = ("train.forward", "train.backward", "train.optimizer", "train.stats")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 64 px through four strided blocks and the final one: five norm sites
PM_HPARAMS = dict(ndf=8, patch_size=40)


def _spec_params(family):
    mod = MODULES[family]
    spec = mod.build_spec(TASKS, HPARAMS[family])
    params = mod.init(torch.Generator().manual_seed(0), spec)
    if family == "rtm":  # the truncated trunk runs layer1 only
        for stage in ("layer2", "layer3", "layer4"):
            del params["backbone"][stage]
    return spec, params


@pytest.fixture(scope="module")
def engines():
    return {f: Engine(f, *_spec_params(f), batch_size=BS, device="cpu") for f in MODULES}


def _frames(n, seed=3):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3), np.uint8)


def _step(family="pmg"):
    spec, params = _spec_params(family)
    _, step = ttrain.make_train_step(family, spec, dropout_rate=0.0, device="cpu")
    tp = ttrain.trainable_params(params, "cpu")
    return step, ttrain.TrainState(tp, ttrain.make_optimizer().init(tp), 0)


def _batch(seed=5, n=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 32, 32, 3).astype(np.float32)
    y = np.stack([rng.randint(0, 3, n), rng.randint(0, 2, n)], axis=1).astype(np.int32)
    return x, y


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_span_reads_no_clock_and_opens_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("touched while the tracer is off")

    assert not torch.autograd.profiler._is_profiler_enabled
    sessions = len(trace.TRACER.sessions)
    monkeypatch.setattr(time, "perf_counter_ns", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    for device in (None, torch.device("cuda"), torch.device("cpu")):
        cm = trace.span("engine.forward", device=device)
        assert cm is trace._NULL
        with cm as sid:
            assert sid is None
    trace.count("engine.rows", 3)
    assert len(trace.TRACER.sessions) == sessions


@pytest.mark.parametrize("family,scan", [("pmg", None), ("rtm", None), ("pmg", 2)])
def test_engine_run_records_each_batch_under_the_profiler(engines, family, scan):
    """10 frames at batch 4: three micro-batches (the last padded by 2), or
    with ``scan_chunk=2`` one stack of two and the tail alone."""
    eng = engines[family]
    with _cpu_profile() as prof:
        eng.run(_frames(10), scan_chunk=scan)
    recs = trace.records()
    batches = [r for r in recs if r.name == "engine.batch"]
    assert len(batches) == (2 if scan else 3)
    ids = [b.id for b in batches]
    assert all(b.parent is None for b in batches)
    for name in ENGINE_SPANS:
        kids = [r for r in recs if r.name == name]
        per = [sum(r.parent == i for r in kids) for i in ids]
        assert per == ([2, 1] if scan and name == "engine.forward" else [1] * len(ids)), name
    forwards = [r for r in recs if r.name == "engine.forward"]
    assert all(r.device_ms == r.host_ms > 0 for r in forwards)  # CPU: device time is host time
    waits = [r for r in recs if r.name == "engine.wait"]
    assert [w.link for w in waits] == ids and all(w.parent is None for w in waits)
    assert trace.counters() == {"engine.rows": 10, "engine.pad_rows": 2}
    names = {e.name for e in prof.events()}
    assert {"engine.batch", "engine.wait", *ENGINE_SPANS} <= names
    summ = trace.summary()
    assert summ["spans"]["engine.batch"]["count"] == len(ids)
    assert summ["spans"]["engine.batch"]["device_ms"] is None
    assert "engine.forward" in trace.format_summary(summ)


@pytest.mark.parametrize("family", ["pmg", "rtm"])
def test_train_step_records_its_phases_once_a_step(family):
    step, state = _step(family)
    x, y = _batch()
    with _cpu_profile() as prof:
        for _ in range(2):
            state, _ = step(state, x, y)
    recs = trace.records()
    steps = [r for r in recs if r.name == "train.step"]
    assert len(steps) == 2 and all(s.parent is None and s.device_ms > 0 for s in steps)
    for name in TRAIN_SPANS:
        assert [r.parent for r in recs if r.name == name] == [s.id for s in steps], name
    assert not [r for r in recs if r.name == "train.allreduce"]  # no mesh
    for s in steps:
        kids = [r for r in recs if r.parent == s.id]
        assert [r.name for r in kids] == list(TRAIN_SPANS)
        assert all(s.start_ns <= r.start_ns <= r.end_ns <= s.end_ns for r in kids)
    assert {"train.step", *TRAIN_SPANS} <= {e.name for e in prof.events()}
    assert trace.mean_device_ms("train.backward") > 0


def test_records_take_the_last_session_only(engines):
    eng = engines["pmg"]
    with trace.recording():
        eng.run(_frames(8))
    assert len([r for r in trace.records() if r.name == "engine.batch"]) == 2
    for n in (4, 12):  # two profiler sessions back to back, nothing between
        with _cpu_profile():
            eng.run(_frames(n))
    assert len([r for r in trace.records() if r.name == "engine.batch"]) == 3
    assert len([r for r in trace.records(-2) if r.name == "engine.batch"]) == 1
    assert trace.counters() == {"engine.rows": 12}
    with trace.recording():
        pass
    assert trace.records() == [] and trace.counters() == {}
    assert trace.mean_device_ms("engine.forward") is None


def test_the_cap_drops_and_counts():
    tr = trace.Tracer(cap=3, keep=2)
    with tr.recording():
        for i in range(5):
            with tr.span("s", link=i) as sid:
                assert (sid is None) == (i >= 3)
        tr.count("c", 2)
        tr.count("c")
    assert [r.link for r in tr.records()] == [0, 1, 2]
    assert tr.dropped() == 2 and tr.counters() == {"c": 3}
    for _ in range(3):
        with tr.recording():
            pass
    assert len(tr.sessions) == 2 and tr.dropped() == 0


def test_recording_changes_no_result(engines):
    for family, eng in engines.items():
        frames = _frames(10, seed=11)
        labels = np.random.RandomState(2).randint(0, 2, (10, 2)).astype(np.int32)
        off = eng.run(frames, labels, collect=("probs", "preds", "logits"))
        with trace.recording():
            on = eng.run(frames, labels, collect=("probs", "preds", "logits"))
        assert list(on) == list(off)
        for k in off:
            np.testing.assert_array_equal(on[k], off[k], err_msg=f"{family} {k}")
    x, y = _batch(seed=9)
    (step_a, a), (step_b, b) = _step(), _step()
    a, loss_a = step_a(a, x, y)
    with trace.recording():
        b, loss_b = step_b(b, x, y)
    assert torch.equal(loss_a, loss_b)
    la, lb = ttrain.leaf_dict(a.params), ttrain.leaf_dict(b.params)
    assert list(la) == list(lb) and all(torch.equal(la[k], lb[k]) for k in la)
    ta, tb = a.opt_state.tree(), b.opt_state.tree()
    for key in ("exp_avg", "exp_avg_sq"):
        assert all(torch.equal(ta[key][p], tb[key][p]) for p in ta[key])


def _pm_spec_params():
    spec = pm.build_spec(TASKS, PM_HPARAMS)
    return spec, pm.init(torch.Generator().manual_seed(0), spec)


def _pm_forward():
    spec, params = _pm_spec_params()
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        return pm.apply(params, x, spec)[0]


def test_pm_forward_records_trunk_heads_and_each_norm():
    assert len(pm.build_spec(TASKS, PM_HPARAMS).plan) == 5
    with trace.recording():
        _pm_forward()
    recs = trace.records()
    (tr,) = [r for r in recs if r.name == "pm.trunk"]
    (hd,) = [r for r in recs if r.name == "pm.heads"]
    norms = [r for r in recs if r.name == "trunk.norm"]
    assert len(norms) == 5 and all(r.parent == tr.id for r in norms)
    assert tr.parent is None and hd.parent is None and tr.end_ns <= hd.start_ns
    assert all(tr.start_ns <= r.start_ns <= r.end_ns <= tr.end_ns for r in norms)
    assert all(r.device_ms == r.host_ms > 0 for r in (tr, hd, *norms))  # CPU: host time
    assert trace.counters() == {}


def test_pm_forward_records_nothing_with_the_tracer_off(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("touched while the tracer is off")

    want = _pm_forward()
    sessions = len(trace.TRACER.sessions)
    monkeypatch.setattr(time, "perf_counter_ns", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert torch.equal(_pm_forward(), want)
    assert len(trace.TRACER.sessions) == sessions


@pytest.mark.parametrize("metric", ["trunk_ms.infer", "norm_ms.infer"])
def test_pm_span_readers(engines, metric):
    """The benchmark's readers: None on a session without PM's spans (a
    PMG engine run), the spans' device time a batch on one with them."""
    from port_bench import cells

    read = cells.reader(REPO, metric)
    with trace.recording():
        engines["pmg"].run(_frames(8))
    assert read(None) is None
    eng = Engine("pm", *_pm_spec_params(), batch_size=BS, device="cpu")
    frames = np.random.RandomState(4).randint(0, 256, (8, 64, 64, 3), np.uint8)
    with trace.recording():
        eng.run(frames)
    recs = trace.records()
    steps = [r for r in recs if r.name == "engine.forward"]
    if metric == "trunk_ms.infer":
        want = np.mean([r.device_ms for r in recs if r.name == "pm.trunk"])
    else:
        want = sum(r.device_ms for r in recs if r.name == "trunk.norm") / len(steps)
    assert len(steps) == 2 and read(None) == pytest.approx(want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device spans time CUDA events there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_spans_time_the_stream_on_the_card(cuda_device):
    """On the card a device span's time is its events' (the queued work,
    not the host's enqueue): a forward on the card records one per batch,
    and a long product reads longer on the device than on the host."""
    eng = Engine("pmg", *_spec_params("pmg"), batch_size=BS, device=cuda_device)
    a = torch.randn(4096, 4096, device=cuda_device)
    with trace.recording():
        eng.run(_frames(10))
        with trace.span("matmul", device=cuda_device):
            for _ in range(20):
                a = a @ a
                a = a / a.norm()
    recs = trace.records()
    assert len([r for r in recs if r.name == "engine.forward"]) == 3
    assert all(r.device_ms > 0 for r in recs if r.name == "engine.forward")
    (mm,) = [r for r in recs if r.name == "matmul"]
    assert mm.device_ms > mm.host_ms
