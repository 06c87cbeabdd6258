"""The port's evaluation path on the CPU against the JAX package's: the
data loader, ``Engine.run_stream``/``step_scan``, and the classifier,
benchmark, folder and watch-folder workloads on a tiny synthetic dataset
(``tools/make_synth_dataset``), with the JAX ``init`` params carried across
(``params_from_jax``).  The artifacts must have the same keys in the same
order, equal integers, class names and predictions, and floats within 1e-6
(the two engines' probabilities differ by float rounding)."""

import csv
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
from PIL import Image

from tests.conftest import REPO  # noqa: F401

import wadt  # noqa: F401
from wadt.data import BatchLoader as JLoader
from wadt.data import MultiTaskDataset as JDataset
from wadt.engine.executor import Engine as JEngine
from wadt.models import pm as jpm
from wadt.models import pmg as jpmg
from wadt.models import rtm as jrtm
from wadt.workloads import benchmark as jbench
from wadt.workloads import evaluate as jeval
from wadt.workloads import inference as jinf

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.data import (
    BatchLoader,
    MultiTaskDataset,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.checkpoint import (
    params_from_jax,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import Engine
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pm, pmg, rtm
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import (
    benchmark as tbench,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import (
    evaluate as teval,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import (
    inference as tinf,
)

from tools.make_synth_dataset import make as make_synth

TINY_HPARAMS = dict(
    ndf=8, patch_size=16, patch_div=2, gram_channels=16, d_model=32,
    transformer_layers=1, transformer_heads=2, norm="batch",
)
FAMILIES = {
    "pmg": (jpmg, pmg, TINY_HPARAMS, 0.0),
    "pm": (jpm, pm, dict(ndf=8, patch_size=16), 0.5),
    "rtm": (jrtm, rtm, dict(truncate_layer=5, use_attention=False), 0.5),
}
FLOAT_TOL = 1e-6


def assert_same(want, got, path="", atol=FLOAT_TOL):
    """Equal structure, key order, types and values; floats within atol."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(want), list(got))
        for k in want:
            assert_same(want[k], got[k], f"{path}/{k}", atol)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (path, want, got)
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"{path}[{i}]", atol)
    elif isinstance(want, float):
        assert isinstance(got, float), (path, want, got)
        assert (np.isnan(want) and np.isnan(got)) or abs(want - got) <= atol, (path, want, got)
    else:
        assert type(got) is type(want) and got == want, (path, want, got)


def load_json(path, root):
    """A JSON artifact with its own output directory replaced by "<out>"."""
    with open(path) as f:
        return json.loads(f.read().replace(str(root), "<out>"))


def csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def assert_roc_csvs_equal(want_dir, got_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in (n for n in names if n.endswith(".csv")):
        want, got = csv_rows(os.path.join(want_dir, name)), csv_rows(os.path.join(got_dir, name))
        assert len(got) == len(want) and got[0] == want[0], name
        for w, g in zip(want[1:], got[1:]):
            assert g[:2] == w[:2], (name, w, g)
            np.testing.assert_allclose(np.float64(g[2:]), np.float64(w[2:]), atol=FLOAT_TOL)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synth(str(tmp_path_factory.mktemp("synth")), n_per_class=3, size=96)


@pytest.fixture(scope="module")
def tasks(synth):
    with open(os.path.join(synth, "tasks.json")) as f:
        return json.load(f)


def _ds(synth, cls):
    return cls(os.path.join(synth, "dataset.json"), os.path.join(synth, "tasks.json"))


def _engines(family, tasks, seed=0):
    jmod, tmod, hparams, threshold = FAMILIES[family]
    import jax

    jspec = jmod.build_spec(tasks, hparams)
    jparams = jmod.init(jax.random.PRNGKey(seed), jspec)
    spec = tmod.build_spec(tasks, hparams)
    jeng = JEngine(family, jspec, jparams, batch_size=4, prob_threshold=threshold)
    eng = Engine(family, spec, params_from_jax(jparams, spec), batch_size=4,
                 prob_threshold=threshold, device="cpu")
    return jeng, eng


@pytest.fixture(scope="module")
def engines(tasks):
    return _engines("pmg", tasks)


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


# -- evaluate ------------------------------------------------------------------


@pytest.mark.parametrize("family", ["pmg", "pm", "rtm"])
def test_evaluate_matches_jax(synth, tasks, engines, family, tmp_path):
    jeng, eng = engines if family == "pmg" else _engines(family, tasks, seed=1)
    jloss, jmetrics, jf1, jtimes = jeval.evaluate(
        jeng, JLoader(_ds(synth, JDataset), batch_size=4, num_workers=2), str(tmp_path / "j"),
        measure_time=True)
    loss, metrics, f1, times = teval.evaluate(
        eng, BatchLoader(_ds(synth, MultiTaskDataset), batch_size=4, num_workers=2),
        str(tmp_path / "t"), measure_time=True)
    assert abs(loss - jloss) <= FLOAT_TOL and abs(f1 - jf1) <= FLOAT_TOL
    assert len(times) == len(jtimes) == 3
    want = load_json(tmp_path / "j" / "metrics_test.json", tmp_path / "j")
    got = load_json(tmp_path / "t" / "metrics_test.json", tmp_path / "t")
    assert_same(want, got)
    assert_same(json.loads(json.dumps(jmetrics)), json.loads(json.dumps(metrics).replace(
        str(tmp_path / "t"), str(tmp_path / "j"))))
    assert_roc_csvs_equal(tmp_path / "j" / "roc", tmp_path / "t" / "roc")
    assert csv_rows(tmp_path / "t" / "metrics_test_summary.csv")[0] == csv_rows(
        tmp_path / "j" / "metrics_test_summary.csv")[0]
    produced = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == produced
    if family != "pmg":
        assert "test_metrics.json" in produced and "times_test.json" in produced
        assert_same(json.load(open(tmp_path / "j" / "test_metrics.json")),
                    json.load(open(tmp_path / "t" / "test_metrics.json")))
    # the predictions behind the metrics, frame by frame
    frames = np.stack([_ds(synth, MultiTaskDataset).load(i)[0] for i in range(12)])
    np.testing.assert_array_equal(eng.run(frames)["preds"], np.asarray(jeng.run(frames)["preds"]))


def _port_rtm(tasks, **kw):
    spec = rtm.build_spec(tasks, FAMILIES["rtm"][2])
    return Engine("rtm", spec, rtm.init(torch.Generator().manual_seed(0), spec), batch_size=4,
                  device="cpu", **kw)


def test_evaluate_all_unknown_family_artifacts(synth, tasks, tmp_path):
    """prob_threshold above 1 makes every prediction Unknown: the family
    artifact holds a zero k x k matrix and 0.0 scalars, the unified one []."""
    eng = _port_rtm(tasks, prob_threshold=1.1)
    teval.evaluate(eng, BatchLoader(_ds(synth, MultiTaskDataset), batch_size=4), str(tmp_path))
    fam = json.load(open(tmp_path / "test_metrics.json"))
    uni = json.load(open(tmp_path / "metrics_test.json"))
    t0 = eng.tasks.names[0]
    k0 = eng.tasks.num_classes[0]
    assert fam[t0]["accuracy"] == 0.0
    assert fam[t0]["confusion_matrix"] == [[0.0] * k0 for _ in range(k0)]
    assert uni["tasks"][t0]["confusion_matrix"] == []
    assert set(fam["average"]) == {"accuracy", "precision", "recall", "f1_score"}


def test_evaluate_scan_chunk_is_bit_identical(synth, engine, tmp_path):
    """scan_chunk=2 sends two full batches through one step_scan: the same
    loss, metrics and files byte for byte; measure_time turns it off."""
    def run(name, **kw):
        return teval.evaluate(engine, BatchLoader(_ds(synth, MultiTaskDataset), batch_size=4),
                              str(tmp_path / name), **kw)

    loss_pb, metrics_pb, f1_pb, _ = run("pb")
    loss_sc, metrics_sc, f1_sc, _ = run("sc", scan_chunk=2)
    assert (loss_sc, f1_sc) == (loss_pb, f1_pb)
    for m in list(metrics_pb.values()) + list(metrics_sc.values()):
        m.pop("roc_png")
    assert metrics_sc == metrics_pb
    assert (load_json(tmp_path / "sc" / "metrics_test.json", tmp_path / "sc")
            == load_json(tmp_path / "pb" / "metrics_test.json", tmp_path / "pb"))
    for name in os.listdir(tmp_path / "pb" / "roc"):
        if name.endswith(".csv"):
            assert (open(tmp_path / "sc" / "roc" / name, "rb").read()
                    == open(tmp_path / "pb" / "roc" / name, "rb").read())
    _, _, _, times = run("mt", measure_time=True, scan_chunk=2)
    assert len(times) == 3


def test_evaluate_loader_batch_larger_than_engine(synth, engine, tmp_path):
    loader = BatchLoader(_ds(synth, MultiTaskDataset), batch_size=4 * engine.batch_size)
    avg_loss, metrics, _, _ = teval.evaluate(engine, loader, str(tmp_path))
    assert np.isfinite(avg_loss) and set(metrics) == set(engine.tasks.names)


def test_evaluate_profile_writes_a_trace(synth, engine, tmp_path):
    teval.evaluate(engine, BatchLoader(_ds(synth, MultiTaskDataset), batch_size=4),
                   str(tmp_path), profile=True)
    trace = tmp_path / "profile" / "trace.json"
    assert trace.exists() and json.load(open(trace))["traceEvents"]
    spans = json.load(open(tmp_path / "profile" / "spans.json"))  # the program's spans
    assert spans["spans"]["engine.batch"]["count"] >= 3
    assert spans["spans"]["engine.forward"]["device_ms"] > 0
    assert spans["counters"]["engine.rows"] >= 3 * engine.batch_size


@pytest.mark.parametrize("family", ["pmg", "rtm"])
def test_evaluate_save_test_images(synth, tasks, engine, family, tmp_path):
    """PMG writes PIL-annotated copies, RTM the auto-layout bar (cv2), each
    grouped by the first task's ground truth."""
    eng = engine if family == "pmg" else _port_rtm(tasks)
    teval.evaluate(eng, BatchLoader(_ds(synth, MultiTaskDataset), batch_size=4),
                   str(tmp_path), save_test_images=True, show_gt_labels=family == "pmg")
    pngs = [os.path.relpath(os.path.join(r, f), tmp_path / "test_images")
            for r, _, fs in os.walk(tmp_path / "test_images") for f in fs if f.endswith(".png")]
    assert len(pngs) == 12
    assert {p.split(os.sep)[0] for p in pngs} == set(eng.tasks.class_names[0])


# -- Engine.run / step_scan / run_stream ----------------------------------------


def _frames(n, seed=7):
    return np.random.RandomState(seed).randint(0, 256, (n, 64, 64, 3), np.uint8)


def test_run_scan_chunk_and_step_scan_are_bit_identical(engine):
    frames = _frames(11)
    labels = np.random.RandomState(1).randint(0, 2, (11, len(engine.tasks))).astype(np.int32)
    labels[3, 1] = -100
    keys = ("probs", "preds", "logits", "max_probs")
    want = engine.run(frames, labels, collect=keys)
    got = engine.run(frames, labels, collect=keys, scan_chunk=2)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    stacked = engine.step_scan(frames[:8].reshape(2, 4, 64, 64, 3), labels[:8].reshape(2, 4, -1))
    for i in range(2):
        one = engine.step(frames[4 * i: 4 * i + 4], labels[4 * i: 4 * i + 4])
        assert set(one) == set(stacked)
        for k in one:
            assert torch.equal(stacked[k][i], one[k]), k


@pytest.mark.parametrize("scan_chunk", ["auto", 2, 3])
def test_run_stream_matches_run(engine, scan_chunk):
    """Full batches buffered k at a time, a short batch mid-stream and the
    tail flushed in order: the rows and extras line up with Engine.run."""
    frames = _frames(19)
    cuts = [0, 4, 8, 10, 14, 18, 19]
    stream = [(frames[a:b], None, [f"p{i}" for i in range(a, b)]) for a, b in zip(cuts, cuts[1:])]
    res, extras = engine.run_stream(iter(stream), collect=("probs", "preds"), scan_chunk=scan_chunk)
    want = engine.run(frames, collect=("probs", "preds"))
    np.testing.assert_array_equal(res["probs"], want["probs"])
    np.testing.assert_array_equal(res["preds"], want["preds"])
    assert extras == [f"p{i}" for i in range(19)]


def test_run_stream_empty_stream_shapes(engine):
    t, kmax = len(engine.tasks), engine.tasks.max_classes
    res, extras = engine.run_stream(iter([]), collect=("probs", "logits", "preds", "max_probs", "tokens"))
    assert extras == []
    assert res["probs"].shape == res["logits"].shape == (0, t, kmax)
    assert res["preds"].shape == res["max_probs"].shape == (0, t)
    assert res["preds"].dtype == np.int32 and res["tokens"].shape == (0,)
    assert res["probs"][:, 0].shape == (0, kmax)


@pytest.mark.parametrize("scan_chunk,k", [("auto", 1), ("off", 1), (None, 1), (3, 3), ("2", 2)])
def test_resolve_scan_chunk(engine, scan_chunk, k):
    assert engine.resolve_scan_chunk(scan_chunk) == k


# -- data -------------------------------------------------------------------------


@pytest.mark.parametrize("pack_k", [None, 4])
def test_loader_matches_jax(synth, pack_k):
    jb = list(JLoader(_ds(synth, JDataset), batch_size=5, num_workers=2, pack_k=pack_k))
    tb = list(BatchLoader(_ds(synth, MultiTaskDataset), batch_size=5, num_workers=2, pack_k=pack_k))
    assert [b[0].shape[0] for b in tb] == [5, 5, 2]  # the tail is not padded
    assert len(tb) == len(jb)
    for (ji, jl, jp), (ti, tl, tp) in zip(jb, tb):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        assert tp == jp


@pytest.mark.parametrize("option", ["search_folder", "find_images_by_sub_folder", "subsample"])
def test_dataset_options_match_jax(synth, option):
    kw = {} if option == "subsample" else {option: "/elsewhere"}
    jds = JDataset(os.path.join(synth, "dataset.json"), os.path.join(synth, "tasks.json"), **kw)
    tds = MultiTaskDataset(os.path.join(synth, "dataset.json"), os.path.join(synth, "tasks.json"), **kw)
    if option == "subsample":
        jds.subsample(5, seed=3)
        tds.subsample(5, seed=3)
    assert tds.paths() == jds.paths() and tds.task_names == jds.task_names
    for (_, jl), (_, tl) in zip(jds.samples, tds.samples):
        np.testing.assert_array_equal(tl, jl)


def test_dataset_labels_use_ignore_index(synth):
    ds = _ds(synth, MultiTaskDataset)
    glare = ds.task_names.index("Glare or Reflections")
    labels = np.stack([lab for _, lab in ds.samples])
    assert (labels[:, glare] == -100).sum() == 4 and (labels[:, :glare] >= 0).all()


class _InMemory:
    """The loader's duck-typed dataset contract, one frame failing."""
    task_names = ["A"]

    def paths(self):
        return [f"frame{i}" for i in range(5)]

    def load(self, i):
        if i == 2:
            raise OSError("unreadable")
        return np.full((8, 8, 3), i, np.uint8), np.array([i], np.int32)


@pytest.mark.parametrize("skip_errors", [False, True])
def test_loader_error_sentinel_and_skip_errors(skip_errors):
    loader = BatchLoader(_InMemory(), batch_size=2, num_workers=2, skip_errors=skip_errors)
    if not skip_errors:  # the failure reaches the consumer instead of hanging it
        with pytest.raises(OSError, match="unreadable"):
            list(loader)
        return
    batches = list(loader)
    assert [b[2] for b in batches] == [["frame0", "frame1"], ["frame3"], ["frame4"]]
    np.testing.assert_array_equal(batches[1][1], [[3]])


# -- benchmark --------------------------------------------------------------------


def _without_auc(summary):
    out = json.loads(json.dumps(summary))
    for block in out.values():
        block["per_class"].pop("auc")
        block["global"].pop("auc_macro")
    return out


@pytest.mark.parametrize("auto_mapping", [False, True])
def test_benchmark_matches_jax(synth, engines, auto_mapping, tmp_path):
    """The mapping JSON sends one model class to each bench class, so the
    bench scores are the probabilities and every field must agree.  The
    tiny model predicts one class for every image, and auto-mapping sends
    all four model classes to one bench class, whose score is then a sum
    of probabilities equal to 1 up to rounding: its ROC ranks rounding
    noise, which differs between the engines.  There the AUCs are held to
    scikit-learn's on the port's own probabilities instead."""
    jeng, eng = engines
    args = (os.path.join(synth, "images"), os.path.join(synth, "mapping.json"))
    jsum = jbench.run_benchmark(jeng, *args, str(tmp_path / "j"), str(tmp_path / "j" / "roc"),
                                auto_mapping=auto_mapping)
    tsum = tbench.run_benchmark(eng, *args, str(tmp_path / "t"), str(tmp_path / "t" / "roc"),
                                auto_mapping=auto_mapping)
    assert_same(json.load(open(tmp_path / "j" / "best_mapping.json")),
                json.load(open(tmp_path / "t" / "best_mapping.json")))
    assert_same(json.load(open(tmp_path / "t" / "benchmark_summary.json")),
                json.loads(json.dumps(tsum)))
    assert sorted(os.listdir(tmp_path / "t" / "roc")) == sorted(os.listdir(tmp_path / "j" / "roc"))
    if not auto_mapping:
        assert_same(json.loads(json.dumps(jsum)), json.loads(json.dumps(tsum)))
        return
    assert_same(_without_auc(jsum), _without_auc(tsum))
    images = jbench.walk_benchmark_folder(args[0], {"Weather Type": ["sun", "rain", "snow", "fog"]})
    probs = eng.run(np.stack([tinf.load_image_uint8(p) for p, _ in images]))["probs"][:, 0, :4]
    bench = ["sun", "rain", "snow", "fog"]
    assign = tbench._assignment_from_json(
        json.load(open(tmp_path / "t" / "best_mapping.json"))["Weather Type"],
        eng.tasks.class_names[0], bench)
    y_true = np.array([bench.index(top) for _, top in images])
    want = jbench._task_summary("Weather Type", bench, y_true,
                                probs @ tbench._one_hot(assign, 4), str(tmp_path))
    assert_same(json.loads(json.dumps(want)), json.loads(json.dumps(tsum["Weather Type"])))


def test_benchmark_pred_image_overlay_options(synth, engine, tmp_path):
    out_dir = str(tmp_path / "custom_pred_dir")
    tbench.run_benchmark(
        engine, os.path.join(synth, "images"), os.path.join(synth, "mapping.json"),
        str(tmp_path / "b"), str(tmp_path / "b" / "roc"), save_pred_images=True,
        pred_images_dir=out_dir, overlay_topk=2, draw_prob_threshold=1.1,
    )
    assert len(os.listdir(out_dir)) == 12
    assert not os.path.exists(tmp_path / "b" / "pred_images")


def test_benchmark_unknown_mapping_task_is_named(synth, engine, tmp_path):
    bad = tmp_path / "bad_mapping.json"
    bad.write_text(json.dumps({"No Such Task": {"sun": ["Clear"]}}))
    with pytest.raises(ValueError, match="No Such Task"):
        tbench.run_benchmark(engine, os.path.join(synth, "images"), str(bad),
                             str(tmp_path / "o"), str(tmp_path / "o" / "roc"))


def test_walk_filter_matches_jax(tmp_path):
    d = tmp_path / "bench" / "sun"
    d.mkdir(parents=True)
    for name in (".jpg", "a.JPG", "b.txt", "noext"):
        (d / name).write_bytes(b"x")
    (tmp_path / "bench" / "SUN").mkdir()
    (tmp_path / "bench" / "SUN" / "c.jpg").write_bytes(b"x")
    args = (str(tmp_path / "bench"), {"T": ["sun"]})
    found = tbench.walk_benchmark_folder(*args)
    assert sorted(os.path.basename(p) for p, _ in found) == [".jpg", "a.JPG"]
    assert sorted(found) == sorted(jbench.walk_benchmark_folder(*args))


@pytest.mark.parametrize("p_bench,auc_macro", [
    ([[0.1, 0.9], [0.9, 0.1]], None),  # every defined AUC 0.0: the reference's None
    ([[0.9, 0.1], [0.1, 0.9]], 1.0),
])
def test_task_summary_matches_jax(tmp_path, p_bench, auc_macro):
    y_true, p_bench = np.array([0, 1]), np.array(p_bench)
    got = tbench._task_summary("T", ["a", "b"], y_true, p_bench, str(tmp_path))
    assert got["global"]["auc_macro"] == auc_macro
    assert_same(jbench._task_summary("T", ["a", "b"], y_true, p_bench, str(tmp_path)), got,
                atol=1e-12)


def test_task_summary_single_class_auc_is_none(tmp_path):
    """A bench class absent from y_true has no AUC: None, as the reference
    recorded it (scikit-learn raised there then)."""
    got = tbench._task_summary("T", ["a", "b", "c"], np.array([0, 1, 0]),
                               np.array([[0.6, 0.3, 0.1], [0.2, 0.7, 0.1], [0.5, 0.1, 0.4]]),
                               str(tmp_path))
    assert got["per_class"]["auc"] == {"a": 1.0, "b": 1.0, "c": None}
    assert got["global"]["auc_macro"] == 1.0


def test_auto_map_matches_jax_and_exhaustive(monkeypatch):
    import itertools

    rng = np.random.RandomState(0)
    for _ in range(10):
        m, b = rng.randint(2, 6), rng.randint(2, 4)
        c = rng.randint(0, 20, size=(m, b))
        best = max(tbench._macro_f1_from_assignment(c, v, b)
                   for v in itertools.product(range(b), repeat=m))
        assert tbench.auto_map_task(c) == jbench.auto_map_task(c)
        with monkeypatch.context() as mp:
            mp.setattr(tbench, "EXHAUSTIVE_LIMIT", 0)  # the coordinate-ascent path
            _, score = tbench.auto_map_task(c)
        assert score >= best - 1e-9


# -- folder inference ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["run_inference", "test_folder_predictions"])
def test_folder_workloads_match_jax(synth, engines, mode, tmp_path):
    jeng, eng = engines
    folder = os.path.join(synth, "images")
    jres = getattr(jinf, mode)(jeng, folder, str(tmp_path / "j"))
    tres = getattr(tinf, mode)(eng, folder, str(tmp_path / "t"))
    assert_same(json.loads(json.dumps(jres)), json.loads(json.dumps(tres)))
    produced = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == produced
    for name in produced:
        assert_same(json.load(open(tmp_path / "j" / name)), json.load(open(tmp_path / "t" / name)))


def test_run_inference_skips_corrupt_and_annotates(synth, engine, tmp_path):
    tree = tmp_path / "tree"
    shutil.copytree(os.path.join(synth, "images"), tree)
    (tree / "sun" / "corrupt.jpg").write_bytes(b"not an image at all")
    res = tinf.run_inference(engine, str(tree), save_dir=str(tmp_path / "o"), save_test_images=True)
    assert len(res) == 12 and not any("corrupt" in p for p in res)
    assert len([f for _, _, fs in os.walk(tmp_path / "o") for f in fs if f.endswith(".jpg")]) == 12


def test_folder_predictions_includes_dotfile_images(engine, tmp_path):
    d = tmp_path / "tree" / "sun"
    d.mkdir(parents=True)
    arr = np.random.RandomState(0).randint(0, 256, (64, 64, 3), np.uint8)
    Image.fromarray(arr).save(d / "a.jpg")
    Image.fromarray(arr).save(str(d / ".jpg"), format="JPEG")
    (d / "b.txt").write_text("junk")
    tinf.test_folder_predictions(engine, str(tmp_path / "tree"), str(tmp_path / "out"))
    allp = json.load(open(tmp_path / "out" / "all_predictions.json"))
    assert sorted(os.path.basename(p) for p in allp) == [".jpg", "a.jpg"]


def test_run_inference_gradcam_fusions_match_jax(synth, engines, tmp_path):
    """``visualize_gradcam`` writes the JAX package's
    ``GradCAM/<predicted class>/<name>_fusion.jpg`` tree."""
    jeng, eng = engines
    folder = os.path.join(synth, "images")
    jinf.run_inference(jeng, folder, str(tmp_path / "j"), visualize_gradcam=True,
                       num_workers=2)
    tinf.run_inference(eng, folder, str(tmp_path / "t"), visualize_gradcam=True,
                       num_workers=2)

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, names in os.walk(os.path.join(root, "GradCAM")) for f in names)

    got = tree(tmp_path / "t")
    assert got == tree(tmp_path / "j")
    assert len(got) == 12 and all(p.endswith("_fusion.jpg") for p in got)
    with Image.open(tmp_path / "t" / got[0]) as im:
        assert im.size == (224, 224)


def test_render_task_overlay_matches_jax():
    img = np.zeros((240, 640, 3), np.uint8)
    lines = [f"Task {i} - True: foo, Pred: bar, Prob: 0.{i}0 " for i in range(12)]
    out = tinf.render_task_overlay(img, lines)
    np.testing.assert_array_equal(out, jinf.render_task_overlay(img, lines))
    assert np.array_equal(out[170:], img[170:]) and out[:60].sum() > 0
    assert np.array_equal(tinf.render_task_overlay(img, []), img)


# -- watch-folder service -------------------------------------------------------------


def _atomic_save(img, dest):
    tmp = dest.parent / (".tmp_" + dest.name)
    img.save(tmp, format="JPEG")
    os.replace(tmp, dest)


def _wait_for(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.05)
    return pred()


def test_watch_service_matches_jax_engine(engines, tmp_path):
    """One poll cycle: last_prediction.json holds the JAX engine's
    prediction of the frame; the history CSV has the JAX header and a row."""
    jeng, eng = engines
    watch = tmp_path / "watch"
    watch.mkdir()
    arr = np.random.RandomState(0).randint(0, 256, (64, 64, 3), np.uint8)
    _atomic_save(Image.fromarray(arr), watch / "2026-08-16_12-00-00.jpg")
    svc = tinf.WatchFolderService(eng, [str(watch)], [0.1], str(tmp_path / "out"),
                                  save_dir_to_canon=str(tmp_path / "canon"))
    svc.start(block=False)
    sub = tmp_path / "out" / "watch"
    assert _wait_for(lambda: (sub / "last_prediction.json").exists())
    (watch / "notatimestamp.jpg").write_bytes(b"ignored")
    time.sleep(0.2)
    svc.stop()
    for t in svc.threads:
        t.join(timeout=5)
        assert not t.is_alive()
    got = json.load(open(sub / "last_prediction.json"))
    assert got["timestamp"] == "2026-08-16_12-00-00" and got["image"] == "2026-08-16_12-00-00.jpg"
    frame = tinf.load_image_uint8(str(watch / "2026-08-16_12-00-00.jpg"))
    want = jinf._pred_entry(jeng, np.asarray(jeng.run(frame[None], collect=("probs",))["probs"])[0])
    assert_same(want, got["prediction"])
    assert json.load(open(tmp_path / "canon" / "WeatherInfos.json")) == got
    rows = csv_rows(sub / "prediction_history.csv")
    cols = ["timestamp", "image"] + [c for t in eng.tasks.names
                                     for c in (f"{t}_predicted_class", f"{t}_probability")]
    assert rows[0] == cols and len(rows) == 2


def test_watch_csv_rotates_on_header_mismatch(tmp_path):
    for mod, name in ((tinf, "t.csv"), (jinf, "j.csv")):
        p = str(tmp_path / name)
        ap = mod.WatchFolderService._append_csv_row
        ap(p, ["timestamp", "image", "A_pred"], {"timestamp": 1, "image": "x", "A_pred": "y"})
        ap(p, ["timestamp", "image", "B_pred"], {"timestamp": 2, "image": "z", "B_pred": "w"})
        ap(p, ["timestamp", "image", "B_pred"], {"timestamp": 3, "image": "q", "B_pred": "v"})
        assert os.path.exists(p + ".stale-0") and not os.path.exists(p + ".stale-1")
    assert open(tmp_path / "t.csv").read() == open(tmp_path / "j.csv").read()
    assert open(tmp_path / "t.csv.stale-0").read() == open(tmp_path / "j.csv.stale-0").read()


def test_sensor_truth_rules_match_jax():
    rules = {
        "Weather Type": {
            "default": "Clear",
            "rules": [
                {"class": "Rain", "when": [{"sensor": "rain_mm", "op": "gt", "value": 0.5}]},
                {"class": "Fog", "when": [{"sensor": "visibility_m", "op": "lt", "value": 200},
                                          {"sensor": "rain_mm", "op": "lte", "value": 0.5}]},
                {"class": "Snow", "when": [{"sensor": "kind", "op": "in", "list": ["snow"]}]},
            ],
        }
    }
    for sensors, want in (({"rain_mm": 1.0}, "Rain"), ({"rain_mm": 0.0, "visibility_m": 100}, "Fog"),
                          ({"rain_mm": 0.0, "visibility_m": 500}, "Clear"), ({}, "Clear"),
                          ({"kind": "snow"}, "Snow")):
        assert tinf.derive_truth(rules, "Weather Type", sensors) == want
        assert jinf.derive_truth(rules, "Weather Type", sensors) == want


def test_watch_folder_sensor_metrics(engine, tmp_path):
    """Sensor annotations and truth rules -> performance.json and its
    history every ``metrics_every`` frames, weighted scores as scikit-learn
    computes them."""
    from sklearn.metrics import f1_score

    watch, ann = tmp_path / "w2", tmp_path / "ann"
    watch.mkdir()
    ann.mkdir()
    rules = {"Weather Type": {"default": "Clear", "rules": [
        {"class": "Rain", "when": [{"sensor": "rain_mm", "op": "gt", "value": 0.5}]}]}}
    (tmp_path / "rules.json").write_text(json.dumps(rules))
    svc = tinf.WatchFolderService(engine, [str(watch)], [0.1], str(tmp_path / "out"),
                                  truth_mapping_path=str(tmp_path / "rules.json"),
                                  annotations_folder=str(ann), metrics_every=2)
    svc.start(block=False)
    rng = np.random.RandomState(0)
    sub = tmp_path / "out" / "w2"
    preds = []
    for i in range(2):
        name = f"2026-08-16_12-00-0{i}"
        (ann / f"{name}.json").write_text(json.dumps({"sensorValues": [{"name": "rain_mm", "value": float(i)}]}))
        _atomic_save(Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8)), watch / f"{name}.jpg")
        assert _wait_for(lambda: (sub / "last_prediction.json").exists() and json.load(
            open(sub / "last_prediction.json"))["image"] == f"{name}.jpg")
        preds.append(json.load(open(sub / "last_prediction.json"))["prediction"]["Weather Type"]
                     ["predicted_class"])
    assert _wait_for(lambda: (sub / "performance.json").exists())
    svc.stop()
    perf = json.load(open(sub / "performance.json"))
    want = f1_score(["Clear", "Rain"], preds, average="weighted", zero_division=0)
    assert abs(perf["Weather Type_f1"] - want) <= 1e-12
    assert perf["global_f1"] == pytest.approx(np.mean([perf[f"{t}_f1"] for t in engine.tasks.names]))
    assert csv_rows(sub / "performance_history.csv")[0][-1] == "global_f1"


@pytest.mark.parametrize("case", ["retries_half_written", "gives_up_on_corrupt"])
def test_watch_folder_bad_frames(engine, tmp_path, case):
    """A frame caught mid-write is retried until it decodes; a corrupt one
    is given up after max_load_retries and a newer frame is still served."""
    import io

    watch = tmp_path / "w"
    watch.mkdir()
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(1).randint(0, 256, (64, 64, 3), np.uint8)).save(buf, "JPEG")
    data = buf.getvalue()
    first = watch / "2026-08-16_13-00-00.jpg"
    first.write_bytes(data[: len(data) // 2] if case == "retries_half_written" else b"never a jpeg")
    retries = 50 if case == "retries_half_written" else 3
    svc = tinf.WatchFolderService(engine, [str(watch)], [0.05], str(tmp_path / "o"),
                                  max_load_retries=retries)
    svc.start(block=False)
    time.sleep(0.4)  # several polls fail on the bad file
    sub = tmp_path / "o" / "w"
    assert not (sub / "last_prediction.json").exists()
    if case == "retries_half_written":
        first.write_bytes(data)
        want = first.name
    else:
        want = "2026-08-16_13-00-01.jpg"
        (watch / want).write_bytes(data)
    assert _wait_for(lambda: (sub / "last_prediction.json").exists())
    svc.stop()
    assert json.load(open(sub / "last_prediction.json"))["image"] == want
