"""PyTorch and CUDA port of the weather-attribute detection framework, for
one NVIDIA H100.

It stands beside the JAX package
``heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu``,
which stays the reference: same public functions, same layouts (NHWC
activations, stacked ``[B, T, Kmax]`` logits), same param tree.  It imports
neither JAX nor anything of the JAX package.  Ported so far: the PMG, PM
and RTM families (random init, a ``.pth``/``.npz`` or a native directory;
``.pth`` export, non-strict loading), batch inference (``Engine.run``
and ``run_stream`` on uint8 frames, float32 or bf16), the evaluation
workloads (``workloads.evaluate``, ``benchmark``, ``inference``: metrics
computed in numpy), the data loader (``data``) and the camera path in
float32 and bf16 (``workloads.stream.StreamPredictor``), the deployment path (the AOT
serving artifact ``engine.export``, the micro-batcher ``engine.serving``,
the HTTP server ``workloads.serve``), training (``fit``, the train step
``parallel.train.make_train_step``: train-mode forwards, AdamW, float32 or
bf16 mixed precision, augmentation, resume), explainability
(``workloads.explain``: Grad-CAM and integrated gradients) and patch-Gram
style transfer (``workloads.style_transfer``), the embedding workloads
(``workloads.embed``: t-SNE and HDBSCAN clustering on the port's own
``utils.tsne`` and ``utils.hdbscan``), and the CLI (``cli.py``,
``weather_torch.py``), with hand-written CUDA kernels
(``ops/cuda_kernels.py``): the six TPU kernels' ports, the t-SNE's
repulsion, HDBSCAN's core distances and minimum spanning tree, and the
ResNet and PatchGAN trunks' norm epilogues; K1, K2, K5 and the two
epilogues are also ``torch.ops.wadt_torch`` operators, all but K2 with
gradients.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``::

    eng = load_engine("pmg", "best_model_PMG.pth", "tasks.json", batch_size=256)
    out = eng.run(images_u8)          # {"preds": [N,T], "probs": [N,T,Kmax]}
    eng16 = load_engine("pmg", "best_model_PMG.pth", dtype=torch.bfloat16)
    out = fit("pmg", eng.spec, "dataset.json", "tasks.json", "run/", {"bf16": True})
    ex = workloads.explain.Explainer("pmg", eng.spec, eng.params)
    cam, logits = ex.gradcam(images_u8, task, classes)
"""

__version__ = "0.1.0"

from . import config  # noqa: F401


def load_engine(family, model_path=None, tasks=None, hparams=None, **engine_kwargs):
    """One call from a ``.pth`` checkpoint to an :class:`Engine` (PMG, PM or RTM).

    - ``tasks``: registry dict ``{task: [class, ...]}`` or a JSON path;
      defaults to the bundled 12-task weather registry.
    - ``hparams``: dict or JSON path; when omitted, sidecar JSONs are
      discovered next to ``model_path``.
    - ``model_path``: a torch ``.pth`` or ``.npz`` state dict, loaded
      strictly (for PM the checkpoint's own SE blocks decide
      ``attn_use_se``), or a directory written by
      ``engine.checkpoint.save_native``, checked against the spec's tree
      (a JAX Orbax directory is refused).  ``None`` builds randomly
      initialized params (``init(torch.Generator().manual_seed(0), spec)``).
    - ``engine_kwargs``: forwarded to :class:`Engine` (``batch_size``,
      ``dtype``, ``prob_threshold``, ``packed``, ``device`` ...).
    """
    import os

    import torch

    from .config import default_tasks_path, load_hparams, load_tasks
    from .engine import checkpoint
    from .engine.executor import Engine
    from .models import get_family

    # falsy paths ("" from an unset shell variable) mean "no checkpoint"
    model_path = model_path or None
    if tasks is None:
        tasks = default_tasks_path()
    if isinstance(tasks, (str, os.PathLike)):
        tasks = load_tasks(os.fspath(tasks))
    if hparams is None:
        hparams = load_hparams(None, model_path)
    elif isinstance(hparams, (str, os.PathLike)):
        hparams = load_hparams(os.fspath(hparams), model_path)
    else:
        hparams = dict(hparams)
    mod = get_family(family)
    if model_path is None:
        spec = mod.build_spec(tasks, hparams)
        params = mod.init(torch.Generator().manual_seed(0), spec)
    elif os.path.isdir(model_path):
        spec = mod.build_spec(tasks, hparams)
        params = checkpoint.load_native(
            model_path, like=mod.init(torch.Generator().manual_seed(0), spec)
        )
    else:
        state = checkpoint.load_state_dict(model_path)
        if family.lower() == "pm":
            hparams["attn_use_se"] = checkpoint.checkpoint_has_se(state)
        spec = mod.build_spec(tasks, hparams)
        params = checkpoint.convert(family, state, spec)
    return Engine(family, spec, params, **engine_kwargs)


def fit(family, spec, data_json, classes_json, save_dir, options=None, **kwargs):
    """Train a model: ``workloads.train.fit`` (``init_params``, ``mesh`` and
    ``device`` go in ``kwargs``)."""
    from .workloads.train import fit as _fit

    return _fit(family, spec, data_json, classes_json, save_dir, options, **kwargs)


def make_train_step(family, spec, optimizer=None, **kwargs):
    """One train step and its initializer: ``parallel.train.make_train_step``."""
    from .parallel.train import make_train_step as _make

    return _make(family, spec, optimizer, **kwargs)

