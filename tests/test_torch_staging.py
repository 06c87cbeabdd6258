"""The Engine's upload (``Engine._upload``, ``engine.wire.StagingRing``).

On the CPU: an engine on the CPU takes the direct path, with the same
results as an upload by ``torch.as_tensor`` of each batch and nothing
staged; the ring's byte layout puts each array at an aligned offset of its
own and reads it back unchanged.

On the card (``cuda``): host frames go through the pinned two-slot ring,
and every result equals, bit for bit, that of the same engine with the
ring taken out (the direct, pageable upload): ``run`` over calls of other
frames with tail batches, ``run_stream`` with ``scan_chunk`` 2,
``dispatch_scan``, a caller that overwrites its array as soon as
``dispatch`` returns, a batch size changed between runs; a CUDA tensor is
not staged; 50 calls grow neither the ring nor the device's memory.  This
file imports no JAX, so that the card's machine runs it:
``python -m pytest tests/test_torch_staging.py -q -m cuda --noconftest``.
"""

import contextlib

import numpy as np
import pytest
import torch

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.config import (
    IGNORE_INDEX,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import wire
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import (
    Engine,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import (
    pm,
    pmg,
    rtm,
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
    "pm": dict(ndf=8, patch_size=40),
}
MODULES = {"pmg": pmg, "rtm": rtm, "pm": pm}
SIZE = {"pmg": 32, "rtm": 32, "pm": 64}
BS = 4
KEYS = ("probs", "preds", "logits")


def _engine(family, device, batch_size=BS):
    mod = MODULES[family]
    spec = mod.build_spec(TASKS, HPARAMS[family])
    params = mod.init(torch.Generator().manual_seed(0), spec)
    if family == "rtm":  # the truncated trunk runs layer1 only
        for stage in ("layer2", "layer3", "layer4"):
            del params["backbone"][stage]
    return Engine(family, spec, params, batch_size=batch_size, device=device)


def _frames(n, seed, size=32):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), np.uint8)


def _labels(n, seed):
    y = np.random.RandomState(seed).randint(0, 2, (n, len(TASKS))).astype(np.int32)
    y[0, 0] = IGNORE_INDEX
    return y


def _direct(eng, frames, labels=None):
    """The upload before the ring, batch by batch: ``torch.as_tensor`` of the
    padded frames moved to the engine's device, then the engine's step."""
    out = {k: [] for k in KEYS}
    for s in range(0, len(frames), eng.batch_size):
        x, y = wire.pad_batch(frames[s:s + eng.batch_size], eng.batch_size,
                              None if labels is None else labels[s:s + eng.batch_size])
        x = torch.as_tensor(x).to(eng.device)
        y = (torch.full((eng.batch_size, len(TASKS)), IGNORE_INDEX, dtype=torch.int32, device=eng.device)
             if y is None else torch.as_tensor(y).to(eng.device))
        res = eng._step(x, y)
        n = min(eng.batch_size, len(frames) - s)
        for k in KEYS:
            out[k].append(res[k][:n].cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def _same(got, want, keys=KEYS):
    for k in keys:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


LAYOUTS = {
    "batch": lambda r: [r.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8),
                        r.randint(0, 3, (4, 2)).astype(np.int32)],
    "scan_stack": lambda r: [r.randint(0, 256, (2, 4, 7, 5, 3)).astype(np.uint8),
                             r.randint(0, 3, (2, 4, 12)).astype(np.int64)],
    "one_frame": lambda r: [r.randint(0, 256, (1, 3, 3, 3)).astype(np.uint8)],
    "strided_and_empty": lambda r: [r.randint(0, 256, (3, 5, 5, 3)).astype(np.uint8)[:, ::2],
                                    np.zeros((0, 2), np.int32),
                                    r.randint(0, 9, (5, 1)).astype(np.int16)],
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_layout_puts_each_array_apart_and_reads_it_back(case):
    """Each array at a 64-byte aligned offset of its own, the buffer just
    large enough; written through its byte view and read back unchanged,
    with its dtype and shape."""
    srcs = [torch.as_tensor(a) for a in LAYOUTS[case](np.random.RandomState(0))]
    offs, total = wire.layout(srcs)
    sizes = [s.numel() * s.element_size() for s in srcs]
    assert all(o % 64 == 0 for o in offs) and total % 64 == 0
    assert all(o + n <= nxt for o, n, nxt in zip(offs, sizes, offs[1:] + [total]))
    assert total - offs[-1] - sizes[-1] < 64
    buf = torch.full((total,), 255, dtype=torch.uint8)
    for s, o in zip(srcs, offs):
        wire.byte_view(buf, o, s).copy_(s)
    for s, o in zip(srcs, offs):
        back = wire.byte_view(buf, o, s)
        assert back.dtype == s.dtype and back.shape == s.shape and back.is_contiguous()
        assert torch.equal(back, s)


@pytest.mark.parametrize("family", list(MODULES))
@pytest.mark.parametrize("how", ["run", "labels", "scan2", "stream", "tensor"])
def test_cpu_engine_uploads_as_before(family, how):
    """On the CPU the engine stages nothing: its results equal the upload by
    ``torch.as_tensor`` bit for bit, and no ring exists or counts."""
    eng = _engine(family, "cpu")
    assert eng._ring is None
    frames = _frames(10, 3, SIZE[family])
    labels = _labels(10, 4) if how == "labels" else None
    with trace.recording():
        if how == "stream":
            batches = [(frames[s:s + BS], None) for s in range(0, 10, BS)]
            got, _ = eng.run_stream(batches, collect=KEYS, scan_chunk=2)
        elif how == "tensor":
            res = eng.step(torch.from_numpy(frames[:BS]))
            got = {k: res[k].numpy() for k in KEYS}
            frames = frames[:BS]
        else:
            got = eng.run(frames, labels, collect=KEYS, scan_chunk=2 if how == "scan2" else None)
    counters = trace.counters()
    assert "engine.staged" not in counters and "engine.stage_wait" not in counters
    assert not [r for r in trace.records() if r.name == "engine.stage"]
    _same(got, _direct(eng, frames, labels))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the staging ring pins host memory and copies on a CUDA stream")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def unstaged(eng):
    """The engine with its ring taken out: host frames go up as
    ``torch.as_tensor(frames).to(device)``, the upload before the ring."""
    ring, eng._ring = eng._ring, None
    try:
        yield eng
    finally:
        eng._ring = ring


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(MODULES))
def test_run_over_calls_equals_unstaged(cuda_device, family):
    """Three calls of other frames (two with tail batches, one with labels),
    each staged batch counted once, each stage span inside its upload."""
    eng = _engine(family, cuda_device)
    calls = [(_frames(n, seed, SIZE[family]), _labels(n, seed) if seed == 2 else None)
             for n, seed in ((10, 1), (12, 2), (7, 3))]
    for frames, labels in calls:
        keys = KEYS + (("loss_per_task", "count_per_task") if labels is not None else ())
        with trace.recording():
            got = eng.run(frames, labels, collect=KEYS)
        batches = -(-len(frames) // BS)
        assert trace.counters()["engine.staged"] == batches
        recs = trace.records()
        uploads = {r.id for r in recs if r.name == "engine.upload"}
        stages = [r for r in recs if r.name == "engine.stage"]
        assert len(stages) == batches and all(r.parent in uploads for r in stages)
        with unstaged(eng):
            want = eng.run(frames, labels, collect=KEYS)
        _same(got, want, keys)
        _same(got, _direct(eng, frames, labels))


@pytest.mark.cuda
def test_run_stream_scan2_equals_unstaged(cuda_device):
    eng = _engine("pmg", cuda_device)
    frames = _frames(18, 5)
    batches = [(frames[s:s + BS], None) for s in range(0, 18, BS)]
    with trace.recording():
        got, _ = eng.run_stream(batches, collect=KEYS, scan_chunk=2)
    assert trace.counters()["engine.staged"] == 3  # two stacks of two, then the tail
    with unstaged(eng):
        want, _ = eng.run_stream(batches, collect=KEYS, scan_chunk=2)
    _same(got, want)


@pytest.mark.cuda
def test_dispatch_scan_equals_unstaged(cuda_device):
    eng = _engine("pmg", cuda_device)
    stack = _frames(3 * BS, 6).reshape(3, BS, 32, 32, 3)
    labels = _labels(3 * BS, 7).reshape(3, BS, -1)
    got = eng.fetch(eng.dispatch_scan(stack, labels, collect=KEYS))
    with unstaged(eng):
        want = eng.fetch(eng.dispatch_scan(stack, labels, collect=KEYS))
    _same(got, want, KEYS + ("loss_per_task", "count_per_task"))


@pytest.mark.cuda
def test_cuda_tensor_input_is_not_staged(cuda_device):
    eng = _engine("pmg", cuda_device)
    frames = _frames(BS, 8)
    with trace.recording():
        on_card = eng.step(torch.from_numpy(frames).to(cuda_device))
    assert "engine.staged" not in trace.counters()
    with trace.recording():
        staged = eng.step(frames)
    assert trace.counters()["engine.staged"] == 1
    for k in KEYS:
        assert torch.equal(on_card[k], staged[k]), k


@pytest.mark.cuda
def test_overwriting_the_host_array_after_dispatch_changes_nothing(cuda_device):
    """The caller reuses one host buffer: it overwrites it with the next
    batch (or noise) as soon as ``dispatch`` returns, before any fetch."""
    eng = _engine("pmg", cuda_device)
    frames = _frames(6 * BS, 9)
    buf = np.empty((BS, 32, 32, 3), np.uint8)
    noise = np.random.RandomState(10)
    handles = []
    for s in range(0, len(frames), BS):
        buf[:] = frames[s:s + BS]
        handles.append(eng.dispatch(buf, collect=KEYS))
        buf[:] = noise.randint(0, 256, buf.shape, np.uint8)
    got = [eng.fetch(h) for h in handles]
    got = {k: np.concatenate([g[k] for g in got]) for k in KEYS}
    with unstaged(eng):
        want = eng.run(frames, collect=KEYS)
    _same(got, want)


@pytest.mark.cuda
def test_batch_size_change_mid_run_equals_unstaged(cuda_device):
    """A larger batch grows each slot once; a smaller one reuses it."""
    eng = _engine("pmg", cuda_device)
    frames = _frames(20, 11)
    for bs in (BS, 2 * BS, BS, 3):
        eng.batch_size = bs
        got = eng.run(frames, collect=KEYS)
        with unstaged(eng):
            want = eng.run(frames, collect=KEYS)
        _same(got, want)
    big = 2 * BS * 32 * 32 * 3
    assert all(s.host.numel() >= big and s.dev.numel() == s.host.numel() for s in eng._ring.slots)


@pytest.mark.cuda
def test_fifty_calls_grow_no_memory(cuda_device):
    """After the first call, 50 more keep every slot's pinned and device
    buffer and the device's allocated bytes."""
    eng = _engine("pmg", cuda_device)
    frames = _frames(3 * BS + 1, 12)
    first = eng.run(frames, collect=KEYS)
    torch.cuda.synchronize(cuda_device)
    bufs = [(s.host.data_ptr(), s.host.numel(), s.dev.data_ptr(), s.dev.numel()) for s in eng._ring.slots]
    held = torch.cuda.memory_allocated(cuda_device)
    for _ in range(50):
        out = eng.run(frames, collect=KEYS)
    torch.cuda.synchronize(cuda_device)
    assert [(s.host.data_ptr(), s.host.numel(), s.dev.data_ptr(), s.dev.numel())
            for s in eng._ring.slots] == bufs
    assert torch.cuda.memory_allocated(cuda_device) == held
    _same(out, first)
