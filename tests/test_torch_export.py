"""The port's AOT serving artifact (``engine/export.py``) on the CPU: saved,
reloaded and run against the live engine at the JAX package's tolerances
(``tests/test_export.py``), in float32 and bf16; the saved graph carries
the ``wadt_torch`` operators of K1, K2 and K5; a fresh process runs it
without any model module; and its probabilities agree with the JAX
package's exported predictor on the same params."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import REPO

import wadt  # noqa: F401
from wadt.engine.executor import Engine as JEngine
from wadt.engine.export import ExportedPredictor as JExportedPredictor
from wadt.engine.export import export_engine as jexport_engine
from wadt.models import pmg as jpmg

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.checkpoint import (
    params_from_jax,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import Engine
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.export import (
    ExportedPredictor,
    export_engine,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
    s2d_pack_uint8,
)
from _torch_threads import one_torch_thread  # noqa: F401

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"
TINY = dict(
    ndf=8, patch_size=16, patch_div=2, gram_channels=16, d_model=32,
    transformer_layers=1, transformer_heads=2, norm="batch",
)
TASKS = {"A": ["a0", "a1", "a2"], "B": ["b0", "b1"]}
DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def jax_params():
    import jax

    jspec = jpmg.build_spec(TASKS, TINY)
    return jspec, jpmg.init(jax.random.PRNGKey(0), jspec)


@pytest.fixture(scope="module")
def engines(jax_params):
    spec = pmg.build_spec(TASKS, TINY)
    params = params_from_jax(jax_params[1], spec)
    return {k: Engine("pmg", spec, params, batch_size=4, dtype=dt, device="cpu")
            for k, dt in DTYPES.items()}


@pytest.fixture(scope="module")
def artifacts(engines, tmp_path_factory):
    out = {}
    for k, eng in engines.items():
        d = str(tmp_path_factory.mktemp(f"export_{k}"))
        out[k] = (d, export_engine(eng, d))
    return out


def test_export_writes_artifact(artifacts, engines):
    out, meta = artifacts["float32"]
    assert sorted(os.listdir(out)) == ["export_meta.json", "forward.pt2"]
    with open(os.path.join(out, "export_meta.json")) as f:
        assert json.load(f) == meta
    assert meta["family"] == "pmg" and meta["batch_size"] == 4
    assert meta["tasks"]["names"] == ["A", "B"] and meta["tasks"]["num_classes"] == [3, 2]
    assert meta["pack_k"] == engines["float32"].pack_k  # PMG engines read the stem kernel's input
    assert meta["input_shape"] == [4, 224, 224, 3]
    assert meta["platforms"] == ["cpu"] and meta["torch_version"] == torch.__version__
    assert meta["dtype"] == "float32" and artifacts["bf16"][1]["dtype"] == "bfloat16"
    assert meta["outputs"] == ["logits", "probs", "max_probs", "preds"]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_exported_matches_engine(artifacts, engines, dtype):
    pred = ExportedPredictor(artifacts[dtype][0], device="cpu")
    rng = np.random.RandomState(0)
    # 6 images: an exact batch and a padded tail batch
    imgs = rng.randint(0, 256, (6, 224, 224, 3), np.uint8)
    want = engines[dtype].run(imgs, collect=("probs", "preds", "logits"))
    got = pred.run(imgs, collect=("probs", "preds", "logits"))
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(got["preds"], want["preds"])
    assert got["preds"].shape == (6, 2)
    # packed frames (the stem kernel's space-to-depth wire format) give the same
    packed = pred.run(s2d_pack_uint8(imgs, engines[dtype].pack_k), collect=("logits",))
    np.testing.assert_array_equal(packed["logits"], got["logits"])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_saved_graph_carries_the_kernel_operators(artifacts, dtype):
    program = torch.export.load(os.path.join(artifacts[dtype][0], "forward.pt2"))
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    want = {"wadt_torch.patch_gram.default", "wadt_torch.stem.default"}
    if dtype == "bf16":
        want.add("wadt_torch.gram_proj.default")
    assert {o for o in ops if o.startswith("wadt_torch.")} == want


def test_exported_rejects_bad_input(artifacts):
    pred = ExportedPredictor(artifacts["float32"][0], device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        pred.run(np.zeros((2, 224, 224, 3), np.float32))
    with pytest.raises(ValueError, match="got"):
        pred.run(np.zeros((2, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="no label inputs"):
        pred.dispatch(np.zeros((2, 224, 224, 3), np.uint8), labels=np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="micro-batch 5 > exported batch 4"):
        pred.dispatch(np.zeros((5, 224, 224, 3), np.uint8))


def test_exported_rejects_future_format(artifacts, tmp_path):
    dst = tmp_path / "fut"
    shutil.copytree(artifacts["float32"][0], dst)
    meta = json.loads((dst / "export_meta.json").read_text())
    meta["format_version"] = 999
    (dst / "export_meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="unsupported export format"):
        ExportedPredictor(str(dst), device="cpu")


def test_export_meta_outputs_match_module(engines, tmp_path):
    """meta["outputs"] records what the program really returns: a capture
    tap the family never emits is not advertised, and asking for exactly
    meta["outputs"] succeeds."""
    src = engines["float32"]
    eng = Engine("pmg", src.spec, src.params, batch_size=2, capture=("features", "no_such_tap"),
                 device="cpu")
    meta = export_engine(eng, str(tmp_path))
    assert "features" in meta["outputs"] and "no_such_tap" not in meta["outputs"]
    pred = ExportedPredictor(str(tmp_path), device="cpu")
    imgs = np.zeros((2, 224, 224, 3), np.uint8)
    out = pred.run(imgs, collect=tuple(pred.meta["outputs"]))
    assert set(out) == set(meta["outputs"])
    np.testing.assert_array_equal(out["features"], eng.run(imgs, collect=("features",))["features"])


def test_export_refuses_mesh_engine():
    class _FakeMesh:
        pass

    mesh_engine = object.__new__(Engine)
    mesh_engine.mesh = _FakeMesh()
    with pytest.raises(ValueError, match="single-device"):
        export_engine(mesh_engine, "/tmp/never")


def test_one_platform_per_artifact(artifacts, engines, tmp_path):
    """An artifact holds the engine's device type only, and loads only there:
    the predictor's default device, the card, is refused for a CPU artifact."""
    with pytest.raises(ValueError, match="one platform"):
        export_engine(engines["float32"], str(tmp_path / "x"), platforms=("cpu", "cuda"))
    assert not os.path.exists(tmp_path / "x")
    with pytest.raises(ValueError, match=r"exported for \['cpu'\], not cuda"):
        ExportedPredictor(artifacts["float32"][0])


def test_jax_artifact_is_refused_by_name(jax_params, tmp_path):
    jspec, jparams = jax_params
    jexport_engine(JEngine("pmg", jspec, jparams, batch_size=2), str(tmp_path), platforms=("cpu",))
    with pytest.raises(ValueError, match="forward.jaxexport"):
        ExportedPredictor(str(tmp_path), device="cpu")


def test_fresh_process_runs_the_artifact_without_model_code(artifacts, engines):
    """A process that imports only the export module loads and runs the
    artifact; no model module is imported."""
    out = artifacts["bf16"][0]
    code = f"""
import json, sys
import numpy as np
from {PORT}.engine.export import ExportedPredictor
pred = ExportedPredictor({out!r}, device="cpu")
res = pred.run(np.random.RandomState(3).randint(0, 256, (5, 224, 224, 3), np.uint8))
models = sorted(n for n in sys.modules if n.startswith("{PORT}.models"))
print(json.dumps({{"models": models, "preds": res["preds"].tolist()}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["models"] == []
    want = engines["bf16"].run(np.random.RandomState(3).randint(0, 256, (5, 224, 224, 3), np.uint8))
    assert got["preds"] == want["preds"].tolist()


def test_artifact_matches_jax_exported_predictor(jax_params, artifacts, tmp_path):
    jspec, jparams = jax_params
    jexport_engine(JEngine("pmg", jspec, jparams, batch_size=4), str(tmp_path), platforms=("cpu",))
    imgs = np.random.RandomState(7).randint(0, 256, (6, 224, 224, 3), np.uint8)
    want = JExportedPredictor(str(tmp_path)).run(imgs, collect=("probs", "preds"))
    got = ExportedPredictor(artifacts["float32"][0], device="cpu").run(imgs, collect=("probs", "preds"))
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["preds"], want["preds"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_artifact_launches_the_kernels_on_the_card(jax_params, dtype, tmp_path, cuda_device):
    """On the card the loaded program launches K1 and K2 (and K5 in bf16)
    once a batch, and matches the live engine at the JAX test's tolerances."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    spec = pmg.build_spec(TASKS, TINY)
    eng = Engine("pmg", spec, params_from_jax(jax_params[1], spec), batch_size=4,
                 dtype=DTYPES[dtype], device=cuda_device)
    export_engine(eng, str(tmp_path))
    pred = ExportedPredictor(str(tmp_path), device=cuda_device)
    imgs = np.random.RandomState(0).randint(0, 256, (6, 224, 224, 3), np.uint8)
    want = eng.run(imgs, collect=("probs", "preds", "logits"))
    ck.reset_launches()
    got = pred.run(imgs, collect=("probs", "preds", "logits"))
    assert ck.LAUNCHES["patch_gram"] == ck.LAUNCHES["stem"] == 2
    assert ck.LAUNCHES["gram_proj"] == (2 if dtype == "bf16" else 0)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got["preds"], want["preds"])
