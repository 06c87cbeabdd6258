"""The port's embedding workloads on the CPU against the JAX package's, on
the same params (``params_from_jax``) and the same tiny synthetic image
tree (``tools/make_synth_dataset.py``): ``compute_embeddings`` for every
family and every kind it exposes (embeddings within 1e-5, labels and paths
equal), the capture auto-upgrade and the ``not exposed`` error,
``export_interactive_html`` byte for byte, ``perform_tsne``'s file and
shape, ``clustering_mode``'s JSON, and the CLI's tsne, tsne_interactive and
clustering modes writing the JAX CLI's files.  The t-SNE and HDBSCAN cores
are held to scikit-learn in tests/test_torch_tsne_hdbscan.py.
"""

import json
import os

import numpy as np
import pytest
import torch

import wadt  # noqa: F401
from wadt.cli import main as jax_main

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import cli
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.config import (
    enable_parity_precision,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.data import (
    BatchLoader, MultiTaskDataset,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import checkpoint as tckpt
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import (
    Engine,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import get_family
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import embed

from _torch_threads import one_torch_thread  # noqa: F401
from tools.make_synth_dataset import make as make_synth

EMB_TOL = 1e-5
HPARAMS = {
    "pmg": dict(ndf=8, patch_size=16, patch_div=2, gram_channels=16, d_model=32,
                transformer_layers=1, transformer_heads=2, norm="batch"),
    "pm": dict(ndf=8, patch_size=16),
    "rtm": dict(truncate_layer=5, attn_token_dim=32),
}
KINDS = [("pmg", "logits"), ("pmg", "pooled"), ("pm", "logits"), ("pm", "task"), ("pm", "shared"),
         ("rtm", "logits"), ("rtm", "task"), ("rtm", "shared")]
CLASSES = ["Clear", "Rain", "Snow", "Fog"]

enable_parity_precision()


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("embed")
    path = make_synth(str(root / "synth"), n_per_class=3, size=64)
    with open(os.path.join(path, "tasks.json")) as f:
        tasks = json.load(f)
    return path, tasks, str(root)


_MODELS = {}


def _models(family, tasks):
    """The same random model in both packages."""
    if family not in _MODELS:
        import jax

        from wadt.models import get_family as jget

        jspec = jget(family).build_spec(tasks, HPARAMS[family])
        jparams = jget(family).init(jax.random.PRNGKey(1), jspec)
        tspec = get_family(family).build_spec(tasks, HPARAMS[family])
        _MODELS[family] = (jspec, jparams, tspec, tckpt.params_from_jax(jparams, tspec))
    return _MODELS[family]


def _loaders(synth, pack_k, jpack_k):
    from wadt.data import BatchLoader as JLoader, MultiTaskDataset as JDataset

    path, _, _ = synth
    args = (os.path.join(path, "dataset.json"), os.path.join(path, "tasks.json"))
    return (BatchLoader(MultiTaskDataset(*args), batch_size=4, num_workers=2, pack_k=pack_k),
            JLoader(JDataset(*args), batch_size=4, num_workers=2, pack_k=jpack_k))


def _engines(family, tasks):
    from wadt.engine.executor import Engine as JEngine

    jspec, jparams, tspec, tparams = _models(family, tasks)
    return (Engine(family, tspec, tparams, batch_size=4, device="cpu"),
            JEngine(family, jspec, jparams, batch_size=4))


@pytest.mark.parametrize("family,kind", KINDS, ids=[f"{f}-{k}" for f, k in KINDS])
def test_compute_embeddings_matches_jax(synth, family, kind):
    eng, jeng = _engines(family, synth[1])
    loader, jloader = _loaders(synth, eng.pack_k, jeng.pack_k)
    embs, labs, paths = embed.compute_embeddings(eng, loader, kind=kind, per_task=True)
    from wadt.workloads.embed import compute_embeddings as jcompute

    jembs, jlabs, jpaths = jcompute(jeng, jloader, kind=kind, per_task=True)
    assert sorted(embs) == sorted(jembs) == sorted(synth[1])
    for t in jembs:
        want = np.asarray(jembs[t])
        assert embs[t].shape == want.shape and embs[t].shape[0] == 12
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(embs[t], want, atol=EMB_TOL * scale, rtol=EMB_TOL, err_msg=t)
        np.testing.assert_array_equal(labs[t], jlabs[t])
        assert paths[t] == jpaths[t]


def test_compute_embeddings_single_task_form(synth):
    eng, _ = _engines("pmg", synth[1])
    loader, _ = _loaders(synth, eng.pack_k, None)
    e, lab, paths = embed.compute_embeddings(eng, loader, kind="logits", per_task=False)
    first = list(synth[1])[0]
    assert e.shape == (12, len(synth[1][first])) and lab.shape == (12,) and len(paths) == 12


def test_capture_auto_upgrade_keeps_the_engine(synth):
    """An engine built without the tap gets a capture-enabled copy on the
    same params, dtype and device; the caller's engine is not changed
    (the counterpart of tests/test_loader_edges.py:107)."""
    _, _, tspec, tparams = _models("pm", synth[1])
    eng = Engine("pm", tspec, tparams, batch_size=4, dtype=torch.bfloat16, device="cpu")
    assert eng.capture == ()
    loader, _ = _loaders(synth, None, None)
    embs, labs, paths = embed.compute_embeddings(eng, loader, kind="task")
    assert eng.capture == ()
    t = list(synth[1])[0]
    assert embs[t].shape == (12, tspec.trunk_channels) and embs[t].dtype == np.float32
    want = Engine("pm", tspec, tparams, batch_size=4, dtype=torch.bfloat16,
                  capture=("task_embeddings",), device="cpu")
    loader, _ = _loaders(synth, None, None)
    again, _, _ = embed.compute_embeddings(want, loader, kind="task")
    np.testing.assert_array_equal(embs[t], again[t])


def test_kind_not_exposed_is_named(synth):
    eng, _ = _engines("pmg", synth[1])
    with pytest.raises(ValueError, match="not exposed"):
        embed.compute_embeddings(eng, [], kind="task")


def _viewer_inputs(synth):
    path, _, _ = synth
    rng = np.random.RandomState(3)
    imgs = sorted(os.path.join(r, f) for r, _, fs in os.walk(os.path.join(path, "images"))
                  for f in fs)
    x2d = {"Weather Type": rng.randn(len(imgs), 2).astype(np.float32) * 10,
           "Visibility": rng.randn(len(imgs), 2).astype(np.float32)}
    labs = {"Weather Type": rng.randint(0, 4, len(imgs)), "Visibility": rng.randint(-1, 2, len(imgs))}
    classes = {"Weather Type": CLASSES, "Visibility": ["Low", "Good"]}
    return x2d, labs, classes, {t: list(imgs) for t in x2d}


@pytest.mark.parametrize("thumbs", [True, False], ids=["thumbnails", "no-thumbnails"])
def test_export_interactive_html_bytes_equal_jax(synth, thumbs, tmp_path):
    from wadt.workloads.embed import export_interactive_html as jexport

    x2d, labs, classes, paths = _viewer_inputs(synth)
    got = embed.export_interactive_html(x2d, labs, classes, paths, str(tmp_path / "p.html"),
                                        thumbnails=thumbs)
    want = jexport(x2d, labs, classes, paths, str(tmp_path / "j.html"), thumbnails=thumbs)
    with open(got, "rb") as a, open(want, "rb") as b:
        src = a.read()
        assert src == b.read()
    assert (b"/9j/" in src) == thumbs  # base64 JPEG thumbnails


def test_export_interactive_html_respects_the_thumbnail_cap(synth, tmp_path):
    x2d, labs, classes, paths = _viewer_inputs(synth)
    out = embed.export_interactive_html(x2d, labs, classes, paths, str(tmp_path / "cap.html"),
                                        thumb_limit=2)
    with open(out) as f:
        thumbs = f.read().split("const THUMBS=")[1].split(";\n")[0]
    assert len(json.loads(thumbs)) == 2


def test_perform_tsne_file_and_shape_match_jax(synth, tmp_path):
    from wadt.workloads.embed import perform_tsne as jtsne

    rng = np.random.RandomState(4)
    e = rng.randn(12, 4).astype(np.float32)
    lab = rng.randint(0, 4, 12)
    x2d, png = embed.perform_tsne(e, lab, CLASSES, None, str(tmp_path / "p"), "Weather Type",
                                  device="cpu")
    jx2d, jpng = jtsne(e, lab, CLASSES, None, str(tmp_path / "j"), "Weather Type")
    assert os.path.basename(png) == os.path.basename(jpng) == "tsne_Weather_Type.png"
    assert x2d.shape == np.asarray(jx2d).shape == (12, 2) and os.path.getsize(png) > 1000
    assert np.isfinite(x2d).all()


def test_perform_tsne_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = np.random.RandomState(5).randn(8, 3).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        embed.perform_tsne(e, np.zeros(8, int), CLASSES, None, str(tmp_path), "t")


def test_clustering_mode_json_equals_jax(synth, tmp_path):
    """Labels from the tiny model's logits: HDBSCAN sees the same points in
    both packages up to the logits' 1e-5, far from any distance tie."""
    from wadt.workloads.embed import clustering_mode as jclustering

    eng, jeng = _engines("pmg", synth[1])
    loader, jloader = _loaders(synth, eng.pack_k, jeng.pack_k)
    args = ("Weather Type", "Clear")
    got = embed.clustering_mode(eng, loader, *args, str(tmp_path / "p"), (2, 3), (1, 2))
    want = jclustering(jeng, jloader, *args, str(tmp_path / "j"), (2, 3), (1, 2))
    assert got == json.loads(json.dumps(want))
    for d in ("p", "j"):
        assert os.listdir(tmp_path / d) == ["Clear_clustering_results.json"]
    with open(tmp_path / "p" / "Clear_clustering_results.json") as a, \
            open(tmp_path / "j" / "Clear_clustering_results.json") as b:
        assert json.load(a) == json.load(b)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.mark.parametrize("extra", [
    ["--mode", "tsne"],
    ["--mode", "tsne", "--per_task_tsne"],
    ["--mode", "tsne_interactive", "--thumb_limit", "4"],
    ["--mode", "clustering", "--clustering_class", "Clear", "--min_cluster_size", "2",
     "--min_samples", "1"],
], ids=["tsne", "tsne-per-task", "tsne_interactive", "clustering"])
def test_cli_embedding_modes_write_the_jax_files(synth, extra):
    """``--mode tsne`` (first task, or one PNG a task with
    ``--per_task_tsne``), ``tsne_interactive`` (a PNG a task and the HTML
    viewer) and ``clustering`` (one JSON) with ``--device cpu`` write the
    JAX CLI's files under its names."""
    path, _, root = synth
    cfg = os.path.join(root, "pmg_hparams.json")
    with open(cfg, "w") as f:
        json.dump({"hparams": HPARAMS["pmg"]}, f)
    base = ["pmg", "--build_classifier", os.path.join(path, "tasks.json"), "--config_path", cfg,
            "--batch_size", "4", "--data", os.path.join(path, "dataset.json"),
            "--num_workers", "2"] + extra
    tag = "-".join(a.strip("-") for a in extra[:3])
    saves = {}
    for name, main, dev in (("jax", jax_main, []), ("port", cli.main, ["--device", "cpu"])):
        saves[name] = os.path.join(root, f"cli_{tag}_{name}")
        assert main(base + ["--save_dir", saves[name]] + dev) == 0
    got, want = _files(saves["port"]), _files(saves["jax"])
    assert got == want and got
    if "tsne_interactive" in extra:
        assert "tsne_interactive.html" in got
    if "clustering" in extra:
        with open(os.path.join(saves["port"], "Clear_clustering_results.json")) as f:
            res = json.load(f)
        assert sum(len(v) for v in res["clusters"].values()) == 3  # the three Clear images
