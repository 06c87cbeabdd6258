"""The port's import boundary: it imports neither JAX nor the JAX package,
and ``chip_smoke.py`` refuses to run without a card or without the port."""

import os
import re
import shutil
import subprocess
import sys

import pytest

from tests.conftest import REPO
from _torch_threads import one_torch_thread  # noqa: F401

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"
JAX_PKG = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu"
FORBIDDEN = re.compile(rf"\bjax\b|\boptax\b|\bwadt\b|\bsklearn\b|{JAX_PKG}(?!_torch)")


def _run(code, cwd=REPO, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_every_port_module_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
import {PORT} as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "wadt"
             or n == "{JAX_PKG}" or n.startswith("{JAX_PKG}.")
             or n == "sklearn" or n.startswith("sklearn."))
assert not bad, bad
print("ok", len([n for n in sys.modules if n.startswith("{PORT}")]))
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _scanned_files():
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "weather_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO, PORT)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _forbidden_import_lines(path):
    with open(path) as f:
        return [f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}"
                for i, line in enumerate(f, 1)
                if re.match(r"\s*(import|from)\s", line) and FORBIDDEN.search(line)]


def test_no_import_line_names_jax():
    files = _scanned_files()
    offending = [line for path in files for line in _forbidden_import_lines(path)]
    assert len(files) > 10
    assert not offending, offending


@pytest.mark.parametrize("rel", ["models/resnet.py", "models/rtm.py", "engine/checkpoint.py",
                                 "workloads/stream.py", "utils/goldens.py"])
def test_rtm_modules_are_scanned_and_clean(rel):
    """The RTM slice's modules are among those the scan reads, and the walk
    over every module imports them without JAX."""
    path = os.path.join(REPO, PORT, rel)
    assert path in _scanned_files()
    assert not _forbidden_import_lines(path)
    mod = f"{PORT}." + rel[:-3].replace("/", ".")
    out = _run(f"import sys, {mod}; bad = [n for n in sys.modules if n == 'jax' or "
               f"n.startswith('jax.') or n == '{JAX_PKG}' or n.startswith('{JAX_PKG}.')]; "
               "assert not bad, bad")
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("rel", ["models/pm.py", "models/__init__.py", "ops/nn.py",
                                 "ops/attention.py", "engine/executor.py"])
def test_bf16_and_pm_modules_are_scanned_and_clean(rel):
    """The bf16 and PM slice's modules are among those the scan reads, and
    each imports without JAX."""
    test_rtm_modules_are_scanned_and_clean(rel)


EVAL_MODULES = ["models/trunk.py", "models/pmg.py", "ops/preprocess.py", "data/__init__.py",
                "data/dataset.py", "utils/metrics.py", "utils/reporting.py",
                "workloads/evaluate.py", "workloads/benchmark.py", "workloads/inference.py"]


def _module(rel):
    return f"{PORT}." + rel[:-3].replace("/", ".").replace(".__init__", "")


@pytest.fixture(scope="module")
def eval_imports():
    """One fresh interpreter imports the evaluation slice's modules and
    lists what it loaded of JAX, scikit-learn and the JAX package."""
    mods = ", ".join(_module(rel) for rel in EVAL_MODULES)
    out = _run(f"import sys, {mods}; print(sorted(n for n in sys.modules if n.split('.')[0] in "
               f"('jax', 'sklearn', 'wadt', '{JAX_PKG}')))")
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


@pytest.mark.parametrize("rel", EVAL_MODULES)
def test_evaluation_modules_are_scanned_and_clean(rel, eval_imports):
    """The evaluation slice's modules are among those the scan reads, and
    import without JAX or scikit-learn (their metrics are numpy)."""
    path = os.path.join(REPO, PORT, rel)
    assert path in _scanned_files()
    assert not _forbidden_import_lines(path)
    assert eval_imports == "[]"


DEPLOY_MODULES = ["engine/checkpoint.py", "engine/wire.py", "engine/export.py",
                  "engine/serving.py", "workloads/serve.py", "cli.py"]


@pytest.fixture(scope="module")
def deploy_imports():
    """One fresh interpreter imports the deployment slice's modules and
    lists what it loaded of JAX, scikit-learn and the JAX package."""
    mods = ", ".join(_module(rel) for rel in DEPLOY_MODULES)
    out = _run(f"import sys, {mods}; print(sorted(n for n in sys.modules if n.split('.')[0] in "
               f"('jax', 'sklearn', 'wadt', '{JAX_PKG}')))")
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


@pytest.mark.parametrize("rel", DEPLOY_MODULES)
def test_deployment_modules_are_scanned_and_clean(rel, deploy_imports):
    """The deployment slice's modules are among those the scan reads, and
    import without JAX or scikit-learn."""
    path = os.path.join(REPO, PORT, rel)
    assert path in _scanned_files()
    assert not _forbidden_import_lines(path)
    assert deploy_imports == "[]"


TRAIN_MODULES = ["parallel/__init__.py", "parallel/train.py", "workloads/train.py", "ops/augment.py",
                 "ops/norms.py", "models/resnet.py"]


@pytest.fixture(scope="module")
def train_imports():
    """One fresh interpreter imports the training slice's modules and lists
    what it loaded of JAX, optax, scikit-learn and the JAX package."""
    mods = ", ".join(_module(rel) for rel in TRAIN_MODULES)
    out = _run(f"import sys, {mods}; print(sorted(n for n in sys.modules if n.split('.')[0] in "
               f"('jax', 'optax', 'sklearn', 'wadt', '{JAX_PKG}')))")
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


@pytest.mark.parametrize("rel", TRAIN_MODULES)
def test_training_modules_are_scanned_and_clean(rel, train_imports):
    """The training slice's modules, the ``parallel`` package among them,
    are among those the scan reads, and import without JAX or optax."""
    path = os.path.join(REPO, PORT, rel)
    assert path in _scanned_files()
    assert not _forbidden_import_lines(path)
    assert train_imports == "[]"


EXPLAIN_MODULES = ["workloads/explain.py", "workloads/style_transfer.py", "ops/gram.py",
                   "models/trunk.py"]


@pytest.fixture(scope="module")
def explain_imports():
    """One fresh interpreter imports the explainability and style-transfer
    slice's modules and lists what it loaded of JAX, optax, scikit-learn and
    the JAX package."""
    mods = ", ".join(_module(rel) for rel in EXPLAIN_MODULES)
    out = _run(f"import sys, {mods}; print(sorted(n for n in sys.modules if n.split('.')[0] in "
               f"('jax', 'optax', 'sklearn', 'wadt', '{JAX_PKG}')))")
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


@pytest.mark.parametrize("rel", EXPLAIN_MODULES)
def test_explain_modules_are_scanned_and_clean(rel, explain_imports):
    """The explainability and style-transfer slice's modules are among
    those the scan reads, and import without JAX or optax."""
    path = os.path.join(REPO, PORT, rel)
    assert path in _scanned_files()
    assert not _forbidden_import_lines(path)
    assert explain_imports == "[]"


EMBED_MODULES = ["utils/tsne.py", "utils/hdbscan.py", "workloads/embed.py",
                 "workloads/_embed_html.py"]


@pytest.fixture(scope="module")
def embed_imports():
    """One fresh interpreter imports the embedding slice's modules and lists
    what it loaded of JAX, optax, scikit-learn and the JAX package."""
    mods = ", ".join(_module(rel) for rel in EMBED_MODULES)
    out = _run(f"import sys, {mods}; print(sorted(n for n in sys.modules if n.split('.')[0] in "
               f"('jax', 'optax', 'sklearn', 'wadt', '{JAX_PKG}')))")
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


@pytest.mark.parametrize("rel", EMBED_MODULES)
def test_embed_modules_are_scanned_and_clean(rel, embed_imports):
    """The embedding slice's modules (the port's own t-SNE and HDBSCAN) are
    among those the scan reads, and import without JAX or scikit-learn."""
    path = os.path.join(REPO, PORT, rel)
    assert path in _scanned_files()
    assert not _forbidden_import_lines(path)
    assert embed_imports == "[]"


MESH_MODULES = ["parallel/mesh.py", "parallel/multihost.py", "parallel/dryrun.py",
                "parallel/train.py", "ops/kernel_select.py", "engine/executor.py",
                "workloads/stream.py"]


@pytest.fixture(scope="module")
def mesh_imports():
    """One fresh interpreter imports the multi-device and route-selection
    slice's modules and lists what it loaded of JAX, optax, scikit-learn
    and the JAX package."""
    mods = ", ".join(_module(rel) for rel in MESH_MODULES)
    out = _run(f"import sys, {mods}; print(sorted(n for n in sys.modules if n.split('.')[0] in "
               f"('jax', 'optax', 'sklearn', 'wadt', '{JAX_PKG}')))")
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


@pytest.mark.parametrize("rel", MESH_MODULES)
def test_mesh_modules_are_scanned_and_clean(rel, mesh_imports):
    """The mesh, multihost, dryrun and kernel-selection modules (and the
    engine, train step and camera that use them) are among those the scan
    reads, and import without JAX or optax."""
    path = os.path.join(REPO, PORT, rel)
    assert path in _scanned_files()
    assert not _forbidden_import_lines(path)
    assert mesh_imports == "[]"


def test_export_module_imports_no_model_code():
    """The serving side of an artifact needs no model: importing the export
    module and the operator registrations loads no ``models`` module."""
    out = _run(f"import sys, {PORT}.engine.export, {PORT}.ops.cuda_kernels; "
               f"print(sorted(n for n in sys.modules if n.startswith('{PORT}.models')))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_gram_proj_source_is_built_and_noted():
    """K5's CUDA source is one the build compiles, and it names the TPU
    kernel it replaces and what bounds it."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels,
    )

    assert "gram_proj.cu" in cuda_kernels._SOURCES
    assert "gram_proj" in cuda_kernels.LAUNCHES
    with open(os.path.join(REPO, PORT, "csrc", "gram_proj.cu")) as f:
        src = f.read()
    assert "tools/exp_pmg_projkernel.py:65" in src and "make_proj_kernel.proj" in src
    assert "What bounds it" in src and "sm_90a" in src
    assert 'extern "C" int wadt_gram_proj_bf16' in src


def test_tsne_repulsion_source_is_built_and_noted():
    """The t-SNE repulsion's CUDA source is one the build compiles, says that
    it replaces no TPU kernel and why it was added, and what bounds it."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels,
    )

    assert "tsne_repulsion.cu" in cuda_kernels._SOURCES
    assert "tsne_repulsion" in cuda_kernels.LAUNCHES
    with open(os.path.join(REPO, PORT, "csrc", "tsne_repulsion.cu")) as f:
        src = f.read()
    assert "Replaces no TPU kernel" in src and "perform_tsne" in src
    assert "What bounds it" in src and "sm_90a" in src
    assert 'extern "C" int wadt_tsne_repulsion' in src


def test_hdbscan_source_is_built_and_noted():
    """HDBSCAN's CUDA source is one the build compiles, says that it replaces
    no TPU kernel and why it was added, and what bounds each kernel."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels,
    )

    assert "hdbscan.cu" in cuda_kernels._SOURCES
    assert {"hdbscan_core", "hdbscan_mst"} <= set(cuda_kernels.LAUNCHES)
    with open(os.path.join(REPO, PORT, "csrc", "hdbscan.cu")) as f:
        src = f.read()
    assert "Replaces no TPU kernel" in src and "hdbscan_clustering" in src
    assert src.count("What bounds it") == 2 and "sm_90a" in src
    assert 'extern "C" int wadt_hdbscan_core' in src and 'extern "C" int wadt_hdbscan_mst' in src


def _smoke(cuda_available, cwd):
    return _run("import runpy, sys, torch; "
                f"torch.cuda.is_available = lambda: {cuda_available}; "
                "sys.argv = ['chip_smoke.py']; runpy.run_path('chip_smoke.py', run_name='__main__')",
                cwd=cwd)


def test_chip_smoke_fails_without_a_card():
    out = _smoke(False, REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo it
    fails even where a card is reported: the port is not there."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _smoke(True, str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "ModuleNotFoundError" in out.stderr
