"""The port's serving layer on the CPU: the micro-batcher (``AsyncBatcher``,
the cases of ``tests/test_serving.py``) and the HTTP front end
(``InferenceServer``, the cases of ``tests/test_serve.py``) over a live
engine and over an exported artifact, and ``/predict``'s JSON against the
JAX package's server on the same params.  Every wait has a timeout."""

import concurrent.futures
import io
import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque

import numpy as np
import pytest
import torch
from PIL import Image

import wadt  # noqa: F401
from wadt.engine.executor import Engine as JEngine
from wadt.models import pmg as jpmg
from wadt.workloads.serve import InferenceServer as JInferenceServer

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.checkpoint import (
    params_from_jax,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import Engine
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.serving import (
    AsyncBatcher,
    Overloaded,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads.serve import (
    InferenceServer,
)
from _torch_threads import one_torch_thread  # noqa: F401

TINY = dict(
    ndf=8, patch_size=16, patch_div=2, gram_channels=16, d_model=32,
    transformer_layers=1, transformer_heads=2, norm="batch",
)
TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}


def _engine(batch_size, seed=0):
    spec = pmg.build_spec(TASKS, TINY)
    return Engine("pmg", spec, pmg.init(torch.Generator().manual_seed(seed), spec),
                  batch_size=batch_size, device="cpu")


@pytest.fixture(scope="module")
def engine():
    return _engine(8)


# -- AsyncBatcher (tests/test_serving.py) --------------------------------------


def test_async_matches_direct(engine):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (5, 32, 32, 3), np.uint8)
    direct = engine.run(imgs, collect=("probs", "preds"))
    with AsyncBatcher(engine, max_wait_ms=5) as ab:
        futs = [ab.submit(imgs[i]) for i in range(5)]
        for i, f in enumerate(futs):
            res = f.result(timeout=60)
            np.testing.assert_allclose(res["probs"], direct["probs"][i], atol=1e-6)
            assert res["preds"].tolist() == direct["preds"][i].tolist()
        pct = ab.latency_percentiles()
    assert pct["n"] == 5 and pct["p50"] > 0


def test_async_concurrent_streams(engine):
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (24, 32, 32, 3), np.uint8)
    results = {}

    def stream(name, idx):
        results[name] = [ab.predict(imgs[i], timeout=60)["preds"] for i in idx]

    with AsyncBatcher(engine, max_wait_ms=2) as ab:
        threads = [threading.Thread(target=stream, args=(f"s{i}", range(i, 24, 4))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert len(results) == 4 and all(len(v) == 6 for v in results.values())
    want = engine.run(imgs)["preds"]
    for i in range(4):
        np.testing.assert_array_equal(np.stack(results[f"s{i}"]), want[i::4])


def test_async_shutdown_rejects(engine):
    ab = AsyncBatcher(engine)
    ab.close()
    with pytest.raises(RuntimeError):
        ab.submit(np.zeros((32, 32, 3), np.uint8))


def test_async_zero_wait_single_request_resolves(engine):
    """With max_wait_ms=0 a lone request does not wait for a second one."""
    with AsyncBatcher(engine, max_wait_ms=0.0) as ab:
        res = ab.predict(np.random.RandomState(0).randint(0, 256, (32, 32, 3), np.uint8), timeout=30)
        assert res["preds"].shape == (2,)


def test_latencies_bounded(engine):
    with AsyncBatcher(engine) as ab:
        assert isinstance(ab.latencies, deque) and ab.latencies.maxlen


class _StallEngine:
    """Engine stub whose dispatch blocks until released, to fill the
    admission queue deterministically."""

    batch_size = 1

    def __init__(self):
        self.release = threading.Event()

    def dispatch(self, images):
        self.release.wait(timeout=30)
        return images

    def fetch(self, handle):
        n = len(handle)
        return {"probs": np.full((n, 2, 3), 1 / 3, np.float32), "preds": np.zeros((n, 2), np.int32)}


def _wait_taken(ab):
    deadline = time.time() + 5
    while ab._queue.qsize() > 0 and time.time() < deadline:
        time.sleep(0.01)


def test_async_rejects_nonpositive_max_queue():
    """queue.Queue(maxsize=0) would mean unbounded: refused."""
    eng = _StallEngine()
    for bad in (0, -4):
        with pytest.raises(ValueError):
            AsyncBatcher(eng, max_batch=1, max_queue=bad)


def test_async_overload_raises():
    """With the dispatcher stalled, submits beyond max_queue raise
    Overloaded, and queued requests still resolve once the stall clears."""
    eng = _StallEngine()
    ab = AsyncBatcher(eng, max_batch=1, max_wait_ms=0.0, max_queue=2)
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        first = ab.submit(img)  # the dispatcher takes this one and stalls
        _wait_taken(ab)
        queued = [ab.submit(img) for _ in range(2)]  # fills max_queue
        with pytest.raises(Overloaded):
            ab.submit(img)
        eng.release.set()
        for f in [first, *queued]:
            assert f.result(timeout=30)["preds"].shape == (2,)
    finally:
        eng.release.set()
        ab.close()


def test_async_close_with_full_queue_still_terminates():
    """close() against a full queue drops the shutdown sentinel; the
    dispatcher's timed get re-checks the stop flag and ends once the
    backlog drains, serving the backlog on the way down."""
    eng = _StallEngine()
    ab = AsyncBatcher(eng, max_batch=1, max_wait_ms=0.0, max_queue=1)
    img = np.zeros((8, 8, 3), np.uint8)
    first = ab.submit(img)
    _wait_taken(ab)
    queued = ab.submit(img)  # fills max_queue=1: the sentinel put fails
    ab.close(timeout=0.2)  # returns with the dispatcher still stalled
    assert ab._thread.is_alive()
    eng.release.set()
    ab._thread.join(timeout=10)
    assert not ab._thread.is_alive()
    assert first.result(timeout=5)["preds"].shape == (2,)
    assert queued.result(timeout=5)["preds"].shape == (2,)


# -- HTTP front end (tests/test_serve.py) --------------------------------------


@pytest.fixture(scope="module")
def server(engine):
    srv = InferenceServer(engine, host="127.0.0.1", port=0, prob_threshold=0.0)
    srv.start()
    yield srv
    srv.stop()


def _url(server, path):
    return f"http://127.0.0.1:{server.port}{path}"


def _get(server, path):
    with urllib.request.urlopen(_url(server, path), timeout=60) as r:
        return r.status, json.loads(r.read())


def _post_image(server, data):
    req = urllib.request.Request(_url(server, "/predict"), data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _jpeg_bytes(seed=0, size=(100, 80)):
    img = Image.fromarray(np.random.RandomState(seed).randint(0, 256, (size[1], size[0], 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, "JPEG")
    return buf.getvalue()


def test_healthz(server):
    code, j = _get(server, "/healthz")
    assert code == 200 and j == {"status": "ok", "model": "pmg", "tasks": 2, "batch_size": 8}


def test_predict_schema(server):
    code, j = _post_image(server, _jpeg_bytes())
    assert code == 200
    pred = j["prediction"]
    assert set(pred) == {"A", "B"}
    assert set(pred["A"]) == {"predicted_class", "probability", "probs"}
    assert abs(sum(pred["A"]["probs"].values()) - 1.0) < 1e-4
    assert j["latency_ms"] > 0
    code, stats = _get(server, "/stats")
    assert stats["n"] >= 1


def test_predict_concurrent(server):
    results = []

    def one(i):
        results.append(_post_image(server, _jpeg_bytes(i))[0])

    ts = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert results == [200] * 8


def test_predict_bad_body(server):
    req = urllib.request.Request(_url(server, "/predict"), data=b"not-an-image", method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=60)
    assert exc.value.code == 400


def test_unknown_path(server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(_url(server, "/nope"), timeout=60)
    assert exc.value.code == 404


def test_oversize_body_rejected_413():
    """A body over max_body_bytes is refused before it is read."""
    srv = InferenceServer(_engine(4), host="127.0.0.1", port=0, prob_threshold=0.0,
                          max_body_bytes=1024).start()
    try:
        req = urllib.request.Request(_url(srv, "/predict"), data=b"x" * 4096, method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=60)
        assert exc.value.code == 413
        assert _get(srv, "/healthz")[0] == 200  # still healthy
    finally:
        srv.stop()


def test_result_timeout_504(server, monkeypatch):
    """A result that does not arrive within result_timeout_s maps to 504."""
    def never(*a, **k):
        raise concurrent.futures.TimeoutError()

    monkeypatch.setattr(server.batcher, "predict", never)
    req = urllib.request.Request(_url(server, "/predict"), data=_jpeg_bytes(), method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=60)
    assert exc.value.code == 504


def test_overload_503_with_retry_after(server, monkeypatch):
    """Queue-full backpressure surfaces as 503 with Retry-After."""
    def full(*a, **k):
        raise Overloaded("request queue full (test)")

    monkeypatch.setattr(server.batcher, "predict", full)
    req = urllib.request.Request(_url(server, "/predict"), data=_jpeg_bytes(), method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=60)
    assert exc.value.code == 503
    assert exc.value.headers.get("Retry-After") == "1"


@pytest.fixture(scope="module")
def exported_server(engine, tmp_path_factory):
    """A server running straight off an exported artifact (no Engine)."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.export import (
        ExportedPredictor,
        export_engine,
    )

    art = str(tmp_path_factory.mktemp("aot"))
    export_engine(engine, art)
    pred = ExportedPredictor(art, device="cpu")
    pred.warmup()
    srv = InferenceServer(pred, host="127.0.0.1", port=0, prob_threshold=0.0)
    srv.start()
    yield srv
    srv.stop()


def test_exported_artifact_serving(exported_server, engine):
    code, health = _get(exported_server, "/healthz")
    assert code == 200 and health["model"] == "pmg" and health["tasks"] == 2
    code, out = _post_image(exported_server, _jpeg_bytes(3))
    assert code == 200
    pred = out["prediction"]
    assert set(pred) == {"A", "B"}
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
        load_image_uint8,
    )

    want = engine.run(load_image_uint8(Image.open(io.BytesIO(_jpeg_bytes(3))))[None])["probs"][0]
    for ti, (t, classes) in enumerate(TASKS.items()):
        probs = pred[t]["probs"]
        assert list(probs) == classes
        np.testing.assert_allclose([probs[c] for c in classes], want[ti, : len(classes)], atol=1e-6)
        assert pred[t]["predicted_class"] in classes  # threshold 0: never Unknown


def test_exported_dispatch_rejects_labels(exported_server):
    with pytest.raises(ValueError, match="no label inputs"):
        exported_server.batcher.engine.dispatch(
            np.zeros((2, 224, 224, 3), np.uint8), labels=np.zeros((2, 2), np.int32))


def test_warmup_runs_before_traffic_and_skips_telemetry():
    """start() pushes one zero frame through the batcher and the engine
    before accepting traffic, and keeps it out of the latency telemetry."""
    srv = InferenceServer(_engine(4, seed=3), host="127.0.0.1", port=0)
    try:
        srv.start()
        assert srv.batcher.latency_percentiles() == {}
        status, stats = _get(srv, "/stats")
        assert status == 200 and stats.get("n", 0) == 0
    finally:
        srv.stop()


def test_stalled_dispatch_504_then_recovers():
    """A stalled dispatch maps to 504 for the waiting client without
    killing the server: once the stall clears, requests succeed again."""
    engine = _engine(4, seed=5)
    srv = InferenceServer(engine, host="127.0.0.1", port=0, prob_threshold=0.0, result_timeout_s=1.0)
    release = threading.Event()
    try:
        srv.start()
        orig = engine.dispatch
        stalled = []

        def wedged(*a, **k):
            if not stalled:  # only the first dispatch after the warmup stalls
                stalled.append(True)
                assert release.wait(timeout=30), "test stall never released"
            return orig(*a, **k)

        engine.dispatch = wedged
        req = urllib.request.Request(_url(srv, "/predict"), data=_jpeg_bytes(), method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 504
        release.set()
        status, out = _post_image(srv, _jpeg_bytes())
        assert status == 200 and set(out["prediction"]) == {"A", "B"}
    finally:
        release.set()
        srv.stop()


# -- against the JAX package's server --------------------------------------------


def test_predict_json_matches_jax_server():
    import jax

    jspec = jpmg.build_spec(TASKS, TINY)
    jparams = jpmg.init(jax.random.PRNGKey(0), jspec)
    jengine = JEngine("pmg", jspec, jparams, batch_size=4)
    engine = Engine("pmg", pmg.build_spec(TASKS, TINY), params_from_jax(jparams, jspec),
                    batch_size=4, device="cpu")
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(9).randint(0, 256, (96, 128, 3), np.uint8)).save(buf, "PNG")
    body = buf.getvalue()
    outs = []
    for server_cls, eng in ((JInferenceServer, jengine), (InferenceServer, engine)):
        srv = server_cls(eng, host="127.0.0.1", port=0, prob_threshold=0.4).start()
        try:
            outs.append(_post_image(srv, body))
        finally:
            srv.stop()
    (jcode, want), (code, got) = outs
    assert jcode == code == 200
    assert list(got) == list(want) == ["prediction", "latency_ms"]
    assert list(got["prediction"]) == list(want["prediction"])
    for t, w in want["prediction"].items():
        g = got["prediction"][t]
        assert list(g) == list(w) and list(g["probs"]) == list(w["probs"])
        assert g["predicted_class"] == w["predicted_class"], t
        assert abs(g["probability"] - w["probability"]) <= 1e-4
        for c, p in w["probs"].items():
            assert abs(g["probs"][c] - p) <= 1e-4, (t, c)
