"""The port's measured route selection (``…_torch/ops/kernel_select.py``):
with no record for the running device every ``"auto"`` keeps its fixed
rule, a record flips each reader (the PMG and RTM camera routes, PMG's
head fold, the engine's scan chunk), unknown ops and variants are refused,
the record lives in the port's package (never ``results/kernel_ab.json``),
and the committed record names only variants the code knows."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import REPO

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import (
    Engine,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import (
    pmg,
    rtm,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
    kernel_select as ks,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads.stream import (
    StreamPredictor,
)
from _torch_threads import one_torch_thread  # noqa: F401

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"
SMALL = dict(ndf=8, patch_size=64, patch_div=3, gram_channels=16, d_model=32,
             transformer_layers=1, transformer_heads=2, norm="batch")
TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}


@pytest.fixture(scope="module")
def pmg_model():
    spec = pmg.build_spec(TASKS, SMALL)
    return spec, pmg.init(torch.Generator().manual_seed(0), spec)


@pytest.fixture(scope="module")
def rtm_model():
    spec = rtm.build_spec(TASKS, dict(truncate_layer=5, attn_token_dim=16))
    params = rtm.init(torch.Generator().manual_seed(0), spec)
    for stage in ("layer2", "layer3", "layer4"):
        del params["backbone"][stage]
    return spec, params


@pytest.fixture
def record_at(tmp_path, monkeypatch):
    """The record moved to a temporary file, absent until written."""
    path = tmp_path / "kernel_ab.json"
    monkeypatch.setattr(ks, "RECORD_PATH", str(path))
    ks._table.cache_clear()
    yield path
    ks._table.cache_clear()


DEFAULTS = {"fused_trunk_gram": "fused", "pmg_head_fold": "fused_bf16",
            "rtm_stream_folded": "folded_q8",
            **{op: "standalone" for op in ks.VARIANTS if op.startswith("eval_scan_chunk_")}}


def _routes(pmg_model, rtm_model):
    p = StreamPredictor("pmg", *pmg_model, device="cpu")
    r = StreamPredictor("rtm", *rtm_model, device="cpu")
    chunks = {dt: Engine("pmg", *pmg_model, dtype=dt, device="cpu").resolve_scan_chunk("auto")
              for dt in (torch.float32, torch.bfloat16)}
    return p.route, p.head_fold, r.route, chunks


def _clear_win(op, win, backend="cpu", calls=2):
    """``calls`` recorded calls in which every round of ``win`` beat every
    round of the op's default, the other variants slower still -> the
    winner stored after the last."""
    for _ in range(calls):
        rounds = {v: [30.0, 31.0, 32.0] for v in ks.known_variants(op)}
        rounds[DEFAULTS[op]] = [20.0, 21.0, 22.0]
        rounds[win] = [10.0, 11.0, 12.0]
        got = ks.record(op, rounds, "test", DEFAULTS[op], backend=backend)
    return got


def test_no_record_keeps_the_fixed_rules(record_at, pmg_model, rtm_model):
    assert not record_at.exists()
    assert _routes(pmg_model, rtm_model) == (
        "fused", "fused_bf16", "folded_q8", {torch.float32: 1, torch.bfloat16: 1})


def test_a_record_for_another_card_changes_nothing_here(record_at, pmg_model, rtm_model):
    assert _clear_win("pmg_head_fold", "fused_q8", backend="NVIDIA H100 80GB HBM3") == "fused_q8"
    assert ks.backend_kind("cpu") == "cpu"
    assert _routes(pmg_model, rtm_model)[1] == "fused_bf16"


@pytest.mark.parametrize("op,win,want", [
    ("pmg_head_fold", "fused_q8", ("fused", "fused_q8", "folded_q8", 1, 1)),
    ("eval_scan_chunk_pmg_f32", "scan_k4", ("fused", "fused_bf16", "folded_q8", 4, 1)),
    ("eval_scan_chunk_pmg_f32", "scan_k8", ("fused", "fused_bf16", "folded_q8", 8, 1)),
    ("eval_scan_chunk_pmg_bf16", "scan_k8", ("fused", "fused_bf16", "folded_q8", 1, 8)),
])
def test_a_record_flips_its_reader(record_at, pmg_model, rtm_model, op, win, want):
    """A record for this device ("cpu" here) in which a kernel route beat
    the default clearly in two calls flips exactly its reader; explicit
    arguments still win over it."""
    assert _clear_win(op, win) == win
    p_route, p_fold, r_route, chunks = _routes(pmg_model, rtm_model)
    assert (p_route, p_fold, r_route, chunks[torch.float32], chunks[torch.bfloat16]) == want
    explicit = StreamPredictor("pmg", *pmg_model, trunk_kernel="fused", head_fold="f32",
                               device="cpu")
    assert (explicit.route, explicit.head_fold) == ("fused", "f32")
    assert Engine("pmg", *pmg_model, device="cpu").resolve_scan_chunk(2) == 2


@pytest.mark.parametrize("op,win", [
    ("fused_trunk_gram", "packed"),
    ("pmg_head_fold", "f32"),
    ("pmg_head_fold", "q8"),
    ("rtm_stream_folded", "folded"),
    ("rtm_stream_folded", "generic"),
])
def test_a_record_never_routes_to_a_library_call(record_at, pmg_model, rtm_model, op, win):
    """A route that runs library matmuls in place of the op's hand-written
    kernel (K4 for PMG's head, K6 for RTM's) is measured and recorded but
    never chosen, however clearly it wins; a hand-edited record naming it
    is refused."""
    assert _clear_win(op, win, calls=3) == DEFAULTS[op]
    assert _routes(pmg_model, rtm_model) == (
        "fused", "fused_bf16", "folded_q8", {torch.float32: 1, torch.bfloat16: 1})
    table = json.loads(record_at.read_text())
    table["cpu"][op]["winner"] = win
    record_at.write_text(json.dumps(table))
    ks._table.cache_clear()
    with pytest.raises(ValueError, match="library calls"):
        ks.winner(op, DEFAULTS[op], "cpu")


@pytest.mark.parametrize("calls,want", [
    ([[10, 11, 12]], "standalone"),  # one call is not enough
    ([[10, 11, 12], [10, 11, 21]], "standalone"),  # rounds overlap in one call
    ([[10, 11, 12], [10, 11, 12], [22, 23, 24]], "standalone"),  # the last call reverses
    ([[10, 11, 12], [15, 16, 19.9]], "scan_k4"),
])
def test_a_win_needs_every_round_ahead_in_two_calls(record_at, calls, want):
    """A variant replaces the default only when every one of its rounds beat
    every round of the default (rounds 20-22 here), in every recorded
    call and at least two."""
    op = "eval_scan_chunk_rtm_f32"
    for k4 in calls:
        got = ks.record(op, {"standalone": [20.0, 21.0, 22.0], "scan_k4": k4}, "test",
                        "standalone", backend="cpu")
    assert got == want == ks.winner(op, "standalone", "cpu")
    assert len(json.loads(record_at.read_text())["cpu"][op]["calls"]) == len(calls)
    # a call at another shape starts the op's calls anew
    ks.record(op, {"standalone": [20.0], "scan_k4": [10.0]}, "other shape", "standalone",
              backend="cpu")
    assert ks.winner(op, "standalone", "cpu") == "standalone"


def test_a_recorded_route_runs(record_at, pmg_model):
    _clear_win("pmg_head_fold", "fused_q8")
    pred = StreamPredictor("pmg", *pmg_model, device="cpu")
    assert pred.head_fold == "fused_q8"
    probs = pred(np.random.RandomState(0).randint(0, 256, (64, 64, 3), np.uint8))
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-6)


def test_unknown_ops_and_variants_are_refused(record_at):
    with pytest.raises(ValueError, match="unknown variants"):
        ks.record("fused_trunk_gram", {"pallas": [1.0], "fused": [2.0]}, "test", "fused")
    with pytest.raises(ValueError, match="not a selectable op"):
        ks.record("patch_gram_tokens", {"xla": [1.0]}, "test", "xla")
    with pytest.raises(ValueError, match="not a measured kernel route"):
        ks.record("rtm_stream_folded", {"generic": [1.0]}, "test", "folded_q8")
    with pytest.raises(ValueError, match="not a measured kernel route"):
        ks.record("rtm_stream_folded", {"generic": [1.0], "folded_q8": [2.0]}, "test", "generic")
    assert not record_at.exists()
    # a hand-edited record naming a variant the code does not know
    record_at.write_text(json.dumps({"cpu": {"pmg_head_fold": {"winner": "pallas_bf16"}}}))
    ks._table.cache_clear()
    with pytest.raises(ValueError, match="pallas_bf16"):
        ks.winner("pmg_head_fold", "fused_bf16", "cpu")


def test_record_is_the_ports_own(record_at):
    """The record's default place is inside the port's package; writing one
    leaves the JAX package's results/kernel_ab.json as it was."""
    default = os.path.join(REPO, PORT, "ops", "kernel_ab.json")
    assert os.path.samefile(os.path.dirname(default), os.path.dirname(ks.__file__))
    results = os.path.join(REPO, "results", "kernel_ab.json")
    before = hashlib.sha256(open(results, "rb").read()).hexdigest()
    _clear_win("eval_scan_chunk_rtm_f32", "scan_k8")
    assert hashlib.sha256(open(results, "rb").read()).hexdigest() == before
    saved = json.loads(record_at.read_text())
    assert saved["cpu"]["eval_scan_chunk_rtm_f32"]["winner"] == "scan_k8"
    assert ks.winner("eval_scan_chunk_rtm_f32", "x", "cpu") == "scan_k8"


def test_backend_kind(monkeypatch):
    assert ks.backend_kind("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ks.backend_kind() == "cpu"


def test_committed_record_names_known_variants():
    """The committed record (measured on the H100 by ``chip_smoke.py
    --record``, one call each time) holds every op the readers consult for
    PMG and RTM, each measured in at least two calls over every variant the
    code knows, and each winner the one :func:`decide` gives on those calls
    against the readers' default: a kernel route."""
    with open(os.path.join(os.path.dirname(ks.__file__), "kernel_ab.json")) as f:
        table = json.load(f)
    assert table and "cpu" not in table
    for card, ops in table.items():
        assert {"fused_trunk_gram", "pmg_head_fold", "rtm_stream_folded",
                "eval_scan_chunk_pmg_f32", "eval_scan_chunk_pmg_bf16",
                "eval_scan_chunk_rtm_f32", "eval_scan_chunk_rtm_bf16"} <= set(ops), card
        for op, entry in ops.items():
            assert entry["default"] == DEFAULTS[op], (card, op)
            assert len(entry["calls"]) >= ks.MIN_CALLS, (card, op)
            for call in entry["calls"]:
                assert set(call) == set(ks.known_variants(op)), (card, op)
            assert entry["winner"] == ks.decide(op, entry["calls"], entry["default"]), (card, op)
            assert entry["winner"] in ks.KERNEL_ROUTES[op], (card, op)
            assert entry["unit"] == "us" and entry["shape"]
