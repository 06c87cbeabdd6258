"""Unified CLI of the port: one ``weather-torch`` command with the model
family as the first positional, mirroring the JAX package's ``weather`` CLI
flag for flag (plus ``--device``).

Modes: classifier (with the ``--visualize_gradcam``,
``--integrated_gradients`` and ``--style_transfer`` epilogues), tsne,
tsne_interactive, clustering, benchmark, inference (``--visualize_gradcam``
fusions too), folder, watch_folder, camera, serve (a live engine, or
``--exported`` from an AOT artifact), export and train.
``--data_parallel`` runs one process per card: under ``torchrun`` (more
than one process in the environment's ``WORLD_SIZE``) the engine and the
train mode run on a mesh over the world, every rank runs the mode's engine
calls in step, and rank 0 alone writes into ``--save_dir``; the modes that
serve or watch a live source (serve, camera, watch_folder) and export run
one process.  A single process that sees one card runs unsharded, and one
that sees several raises with the ``torchrun`` command line to use.

Examples:
  python weather_torch.py pmg --mode classifier --data ds.json \\
      --build_classifier configs/tasks.json --model_path best_model_PMG.pth
  python weather_torch.py pmg --mode export --build_classifier configs/tasks.json \\
      --model_path best_model_PMG.pth --export_dir artifact/
  python weather_torch.py pmg --mode serve --exported artifact/ --port 8000
  python weather_torch.py pmg --mode train --data ds.json \\
      --build_classifier configs/tasks.json --config_path hparams.json --bf16 --augment
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
from typing import Any, Dict

MODES = [
    "classifier", "tsne", "tsne_interactive", "clustering", "camera",
    "benchmark", "folder", "watch_folder", "inference", "train", "serve",
    "export",
]

# each family's own embedding tap for tsne, tsne_interactive and clustering
_NATIVE_KIND = {"pmg": "logits", "rtm": "task", "pm": "task"}
# the modes --data_parallel cannot spread over processes: a live source or
# a port serves one process, and an export takes an engine without a mesh
_ONE_PROCESS_MODES = ("serve", "camera", "watch_folder", "export")


def build_argparser() -> argparse.ArgumentParser:
    from . import __version__

    p = argparse.ArgumentParser(
        prog="weather-torch",
        description="Multi-task weather attribute detection, PyTorch and CUDA",
    )
    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    p.add_argument("family", choices=["pm", "pmg", "rtm"], help="model family")
    p.add_argument("--data", type=str, help="dataset manifest JSON")
    p.add_argument("--build_classifier", type=str, default=None,
                   help="tasks/classes registry JSON (required except for "
                        "`--mode serve --exported`, which reads tasks from "
                        "the artifact)")
    p.add_argument("--model_path", type=str, default=None,
                   help=".pth / .npz checkpoint (omit for random init)")
    p.add_argument("--config_path", type=str, default=None, help="hparams JSON")
    p.add_argument("--mode", choices=MODES, default="classifier")
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--save_dir", default="results", type=str)
    p.add_argument("--prob_threshold", default=None, type=float,
                   help="min max-probability before a prediction becomes "
                        "Unknown (default 0.5; `--mode serve --exported` "
                        "defaults to the artifact's recorded threshold)")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--measure_time", action="store_true")
    p.add_argument("--scan_chunk", default="off",
                   help="classifier mode: run k full batches per dispatch "
                        "(one upload, one copy back; 'auto' is 1 until a "
                        "better k is measured, an int forces k, 'off' = "
                        "per-batch).  Metrics are identical; --measure_time "
                        "forces per-batch (times_*.json is one wall-time per "
                        "batch)")
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--count_params", action="store_true")
    p.add_argument("--search_folder", type=str, default=None)
    p.add_argument("--find_images_by_sub_folder", type=str, default=None)
    p.add_argument("--bf16", action="store_true", help="bfloat16 activations")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler device trace (classifier mode)")
    p.add_argument("--export_torch", type=str, default=None,
                   help="export the (converted) params as a reference-loadable .pth")
    p.add_argument("--save_pred_images", action="store_true",
                   help="benchmark mode: GT/Pred green-red annotated overlays")
    p.add_argument("--pred_images_dir", type=str, default=None,
                   help="benchmark overlay output dir (default "
                        "<save_dir>/pred_images; RTM_evaluation.py:1227)")
    p.add_argument("--overlay_topk", type=int, default=1,
                   help="benchmark overlay: top-k classes per task line "
                        "(the reference declares but ignores this; "
                        "implemented here)")
    p.add_argument("--draw_prob_threshold", type=float, default=None,
                   help="benchmark overlay: skip task lines whose top prob "
                        "is below this (reference declares but ignores)")
    p.add_argument("--no_gt_labels", action="store_true",
                   help="classifier-mode RTM overlays: omit the True: "
                        "ground-truth parts (test_RTM.py:70)")
    # PM attention-head overrides (test_PM.py:117-120).  Precedence mirrors
    # the reference: config/sidecar value wins over the CLI flag, and the
    # checkpoint SE probe decides attn_use_se whenever weights are loaded.
    p.add_argument("--ablate_attention", action="store_true")
    p.add_argument("--attn_use_se", action="store_true", default=None)
    p.add_argument("--attn_no_softmax", action="store_true")
    p.add_argument("--attn_tau", type=float, default=0.7)
    p.add_argument("--parity_precision", action="store_true",
                   help="full-f32 matmuls (bit-parity with the torch reference)")
    p.add_argument("--compilation_cache", nargs="?", type=str, default=None,
                   const=os.path.join("~", ".cache", "wadt", "xla_cache"),
                   metavar="DIR",
                   help="no effect here (kept for the JAX CLI's command "
                        "lines): the CUDA kernels are built once per source "
                        "hash and cached under the package's csrc/_build/")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the batch axis over the processes of a torchrun "
                        "launch, one per card (torchrun --nproc_per_node=N "
                        "weather_torch.py ... --data_parallel)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default the CUDA card; "
                        "'cpu' runs the kernels' plain versions)")
    # explainability
    p.add_argument("--visualize_gradcam", action="store_true")
    p.add_argument("--save_gradcam_images", action="store_true")
    p.add_argument("--gradcam_task", type=str, default=None)
    p.add_argument("--colormap", type=str, default="hot")
    p.add_argument("--integrated_gradients", action="store_true")
    # inference/folder
    p.add_argument("--image_folder", type=str)
    p.add_argument("--test_images_folder", type=str)
    p.add_argument("--target_task", type=str, default=None)
    p.add_argument("--save_test_images", action="store_true")
    # watch mode
    p.add_argument("--watch_folders", type=str, default=None,
                   help="comma-separated folders")
    p.add_argument("--poll_intervals", type=str, default=None,
                   help="comma-separated seconds")
    p.add_argument("--save_dir_to_canon", default=None, type=str)
    p.add_argument("--truth_mapping", type=str, default=None,
                   help="sensor truth-rule JSON (rolling service metrics)")
    p.add_argument("--annotations_folder", type=str, default=None)
    p.add_argument("--eval_annotations", action="store_true",
                   help="watch mode: require sensor-annotation eval "
                        "(errors without --annotations_folder, "
                        "test_PM.py:111; with the folder given, eval is "
                        "on either way)")
    p.add_argument("--metrics_every", type=int, default=10)
    # camera
    p.add_argument("--camera_index", type=int, default=0)
    p.add_argument("--kalman_filter", action="store_true")
    p.add_argument("--save_camera_video", action="store_true")
    p.add_argument("--video_path", type=str, default=None,
                   help="use a video file instead of the webcam")
    p.add_argument("--no_display", action="store_true")
    p.add_argument("--record", action="store_true",
                   help="start recording immediately (headless recording; "
                        "with a display the 'r' key toggles)")
    p.add_argument("--max_frames", type=int, default=None)
    # benchmark
    p.add_argument("--benchmark_folder", type=str)
    p.add_argument("--benchmark_mapping", type=str)
    p.add_argument("--roc_output", type=str, default="roc_curves")
    p.add_argument("--auto_mapping", action="store_true")
    # tsne / clustering
    p.add_argument("--per_task_tsne", action="store_true")
    p.add_argument("--no_thumbnails", action="store_true",
                   help="tsne_interactive: skip embedding click-to-view thumbnails")
    p.add_argument("--thumb_limit", type=int, default=2000,
                   help="tsne_interactive: max unique images embedded as thumbnails")
    p.add_argument("--colors", nargs="+", default=None)
    p.add_argument("--embedding_kind", choices=["logits", "task", "shared", "pooled"],
                   default=None, help="embedding tap (default: family-native)")
    p.add_argument("--clustering_class", type=str)
    p.add_argument("--clustering_task", type=str, default=None)
    p.add_argument("--min_cluster_size", type=int, nargs="+", default=[10, 15, 20])
    p.add_argument("--min_samples", type=int, nargs="+", default=[5, 10])
    # style transfer (PMG)
    p.add_argument("--style_transfer", action="store_true")
    p.add_argument("--target_loss", type=float, default=1e-18)
    p.add_argument("--style_iterations", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.0005)
    p.add_argument("--init_type", type=str, default="noise")
    # training (train mode; recorded reference recipe)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--train_lr", type=float, default=3e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--balance_loss", action="store_true")
    p.add_argument("--use_focal", action="store_true")
    p.add_argument("--focal_gamma", type=float, default=2.0)
    p.add_argument("--val_split", type=float, default=0.2)
    p.add_argument("--freeze_encoder", action="store_true")
    p.add_argument("--dropout_rate", type=float, default=0.1,
                   help="transformer train-mode dropout (reference default)")
    p.add_argument("--augment", action="store_true",
                   help="train augmentation on the device (random flip, "
                        "<=8px translate, brightness/contrast jitter) inside "
                        "the train step, drawn from (seed, step): resume-exact")
    p.add_argument("--resume", action="store_true",
                   help="continue from save_dir/last_state (full optimizer state)")
    p.add_argument("--save_every", type=int, default=1,
                   help="epochs between resumable TrainState checkpoints")
    # serve mode
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_wait_ms", type=float, default=2.0,
                   help="micro-batch coalescing window")
    p.add_argument("--max_body_mb", type=float, default=32.0,
                   help="reject POST bodies over this size with 413")
    p.add_argument("--result_timeout_s", type=float, default=60.0,
                   help="per-request inference timeout (504 on expiry)")
    p.add_argument("--max_queue", type=int, default=None,
                   help="pending-request cap before 503 (default 2*batch*depth)")
    # export mode (AOT serving artifact)
    p.add_argument("--export_dir", type=str, default=None,
                   help="export mode: artifact output dir "
                        "(default save_dir/exported)")
    p.add_argument("--export_platforms", type=str, default=None,
                   help="export mode: the artifact's platform, which must be "
                        "the engine's device type (the default); an artifact "
                        "holds one")
    p.add_argument("--exported", type=str, default=None,
                   help="serve mode: serve from an AOT export artifact dir "
                        "(no model code / checkpoint load)")
    # RTM architecture flags
    p.add_argument("--no_attention", action="store_true")
    p.add_argument("--attn_token_dim", type=int, default=None)
    p.add_argument("--cls_hidden_dims", type=int, nargs="*", default=[])
    p.add_argument("--cls_num_layers", type=int, default=0)
    return p


def _data_parallel_mesh(args):
    """``--data_parallel``: the mesh over a ``torchrun`` world (each process
    on its own card, ``LOCAL_RANK``; NCCL on cards, gloo on the CPU; a
    process group already up is used as it is), or None for a single
    process that sees one device.  A single process that sees several
    cards raises: the port runs one process per card, where the JAX package
    runs one controller over them all.  So do the modes of
    ``_ONE_PROCESS_MODES`` under a world of several processes."""
    import torch

    world = int(os.environ.get("WORLD_SIZE", "1"))
    cuda = torch.device(args.device).type == "cuda"
    if world <= 1:
        n = torch.cuda.device_count() if cuda else 1
        if n > 1:
            raise RuntimeError(
                f"--data_parallel runs one process per card (ROADMAP.md section C): launch "
                f"it as torchrun --nproc_per_node={n} weather_torch.py ... --data_parallel"
            )
        print("[data_parallel] single device visible; running unsharded")
        return None
    if args.mode in _ONE_PROCESS_MODES:
        raise ValueError(f"--mode {args.mode} runs in one process; --data_parallel over {world} "
                         "processes runs the batch modes and train (ROADMAP.md section C)")
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} must divide evenly over {world} "
                         "processes for --data_parallel")
    import torch.distributed as dist

    from .parallel.mesh import make_mesh
    from .parallel.multihost import initialize_process

    if cuda:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
    if not dist.is_initialized():
        initialize_process(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", world,
                           int(os.environ["RANK"]), backend="nccl" if cuda else "gloo")
    if dist.get_world_size() != world:
        raise RuntimeError(f"WORLD_SIZE is {world}, the process group's {dist.get_world_size()}")
    print(f"data-parallel over {world} processes")
    return make_mesh()


def build_engine(args) -> "Any":
    import torch

    from .engine import checkpoint
    from .config import load_hparams, load_tasks
    from .utils.reporting import print_model_parameters

    if args.parity_precision:
        from .config import enable_parity_precision

        enable_parity_precision()

    if args.compilation_cache:
        print("--compilation_cache has no effect here: the CUDA kernels are built once "
              "per source hash and cached under the package's csrc/_build/")

    mesh = None
    if args.data_parallel:
        mesh = _data_parallel_mesh(args)

    tasks = load_tasks(args.build_classifier)
    print(f"Tasks: {len(tasks)} -> {list(tasks)}")
    hparams: Dict[str, Any] = load_hparams(args.config_path, args.model_path)

    native_dir = args.model_path and os.path.isdir(args.model_path)
    if args.family == "pm":
        # CLI fallbacks for the attention-head knobs: a config/sidecar value
        # wins; attn_use_se is decided by load_engine's checkpoint SE probe
        # whenever weights are loaded
        hparams.setdefault("attn_tau", args.attn_tau)
        hparams.setdefault("attn_softmax_spatial", not args.attn_no_softmax)
        # ablate_attention: the CLI value always wins
        hparams["ablate_attention"] = args.ablate_attention
        # attn_use_se is explicit-enable only: a no-checkpoint build without
        # the flag keeps the spec default (SE on)
        if args.attn_use_se:
            hparams.setdefault("attn_use_se", True)
    if args.family == "rtm":
        hparams.setdefault("use_attention", not args.no_attention)
        if args.attn_token_dim is not None:
            hparams.setdefault("attn_token_dim", args.attn_token_dim)
        hparams.setdefault("cls_hidden_dims", args.cls_hidden_dims)
        hparams.setdefault("cls_num_layers", args.cls_num_layers)

    from . import load_engine

    engine = load_engine(
        args.family,
        args.model_path,
        tasks,
        hparams,
        batch_size=args.batch_size,
        prob_threshold=args.prob_threshold,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        mesh=mesh,
        device=args.device,
    )
    if native_dir:
        print(f"Native checkpoint loaded from {args.model_path}")
    elif args.model_path:
        print(f"Model loaded from {args.model_path}")
    else:
        print("[WARN] no --model_path: random initialization")

    if args.count_params:
        print_model_parameters(args.family, engine.params, engine.spec)
    if args.export_torch:
        checkpoint.save_torch_checkpoint(
            args.family, engine.params, engine.spec, args.export_torch
        )
        print(f"exported torch-format checkpoint to {args.export_torch}")

    return engine


def make_loader(args, engine):
    from .data import BatchLoader, MultiTaskDataset

    if not args.data:
        raise ValueError("--data is required for this mode.")
    ds = MultiTaskDataset(
        args.data,
        args.build_classifier,
        search_folder=args.search_folder,
        find_images_by_sub_folder=args.find_images_by_sub_folder,
    )
    ds.subsample(args.num_samples)
    return ds, BatchLoader(ds, batch_size=args.batch_size, num_workers=args.num_workers,
                           pack_k=engine.pack_k)


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    os.makedirs(args.save_dir, exist_ok=True)

    if args.mode == "serve" and args.exported:
        # artifact serving: tasks and weights live in the exported program;
        # no registry, model code or checkpoint load
        from .engine.export import ExportedPredictor
        from .workloads.serve import InferenceServer

        pred = ExportedPredictor(args.exported, device=args.device)
        if args.prob_threshold is None:
            # the artifact's baked "preds" used this threshold at export
            # time: serve consistently with it unless explicitly overridden
            args.prob_threshold = float(pred.meta.get("prob_threshold", 0.5))
        pred.warmup()
        InferenceServer(pred, host=args.host, port=args.port,
                        prob_threshold=args.prob_threshold,
                        max_wait_ms=args.max_wait_ms,
                        max_body_bytes=int(args.max_body_mb * 1024 * 1024),
                        result_timeout_s=args.result_timeout_s,
                        max_queue=args.max_queue).serve_forever()
        return 0

    if args.prob_threshold is None:
        args.prob_threshold = 0.5
    if not args.build_classifier:
        parser.error("--build_classifier is required for this mode")
    engine = build_engine(args)
    mesh = engine.mesh
    scratch = None
    if mesh is not None and not mesh.is_main and args.mode != "train":
        # every rank runs the mode's engine calls (collectives) in step; rank
        # 0 alone writes into --save_dir, the others into a directory removed
        # at the end (fit writes from rank 0 itself, and resumes on every rank)
        scratch = tempfile.mkdtemp(prefix=f"weather_torch_rank{mesh.rank}_")
        args.save_dir = scratch
    try:
        _run_mode(args, engine)
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
    if mesh is not None:
        mesh.barrier()  # rank 0's files are whole when any rank returns
    return 0


def _run_mode(args, engine) -> None:
    """Run ``args.mode`` on a built engine.  Under a mesh, the work that
    runs no collective after the engine's calls (Grad-CAM, integrated
    gradients, style transfer, t-SNE) runs on rank 0 alone."""
    main_rank = engine.mesh is None or engine.mesh.is_main
    writer = None
    if args.tensorboard:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(log_dir=os.path.join(args.save_dir, "TensorBoard"))

    if args.mode == "classifier":
        from .workloads.evaluate import evaluate

        ds, loader = make_loader(args, engine)
        evaluate(engine, loader, args.save_dir,
                 measure_time=args.measure_time, tensorboard_writer=writer,
                 save_test_images=args.save_test_images, profile=args.profile,
                 show_gt_labels=not args.no_gt_labels,
                 scan_chunk=args.scan_chunk)

        if (args.visualize_gradcam or args.integrated_gradients) and main_rank:
            _run_explain(args, engine, ds, writer)
        if args.style_transfer and main_rank:
            _run_style_transfer(args, engine, ds)

    elif args.mode == "train":
        from .workloads.train import fit

        if not args.data:
            raise ValueError("train mode needs --data")
        fit(
            args.family, engine.spec, args.data, args.build_classifier,
            args.save_dir,
            options=dict(
                epochs=args.epochs, batch_size=args.batch_size,
                lr=args.train_lr, weight_decay=args.weight_decay,
                accum_steps=args.accum_steps, balance_loss=args.balance_loss,
                use_focal=args.use_focal, focal_gamma=args.focal_gamma,
                val_split=args.val_split, freeze_encoder=args.freeze_encoder,
                num_workers=args.num_workers, dropout_rate=args.dropout_rate,
                resume=args.resume, save_every=args.save_every,
                bf16=args.bf16, augment=args.augment,
            ),
            init_params=engine.params if args.model_path else None,
            mesh=engine.mesh,
            device=args.device,
        )

    elif args.mode == "serve":
        from .workloads.serve import InferenceServer

        engine.warmup()
        InferenceServer(engine, host=args.host, port=args.port,
                        prob_threshold=args.prob_threshold,
                        max_wait_ms=args.max_wait_ms,
                        max_body_bytes=int(args.max_body_mb * 1024 * 1024),
                        result_timeout_s=args.result_timeout_s,
                        max_queue=args.max_queue).serve_forever()

    elif args.mode == "export":
        from .engine.export import export_engine

        out = args.export_dir or os.path.join(args.save_dir, "exported")
        platforms = None
        if args.export_platforms:
            platforms = [s.strip() for s in args.export_platforms.split(",") if s.strip()]
        meta = export_engine(engine, out, platforms=platforms)
        print(f"exported {meta['family']} forward (batch {meta['batch_size']}, "
              f"{meta['dtype']}, platforms {','.join(meta['platforms'])}) -> {out}")

    elif args.mode == "benchmark":
        from .workloads.benchmark import run_benchmark

        if not args.benchmark_folder or not args.benchmark_mapping:
            raise ValueError("benchmark mode needs --benchmark_folder and --benchmark_mapping")
        run_benchmark(engine, args.benchmark_folder, args.benchmark_mapping,
                      args.save_dir, args.roc_output,
                      auto_mapping=args.auto_mapping, num_samples=args.num_samples,
                      num_workers=args.num_workers,
                      save_pred_images=args.save_pred_images,
                      pred_images_dir=args.pred_images_dir,
                      overlay_topk=args.overlay_topk,
                      draw_prob_threshold=args.draw_prob_threshold)

    elif args.mode == "inference":
        from .workloads.inference import run_inference

        folder = args.image_folder or args.test_images_folder
        if not folder:
            raise ValueError("inference mode needs --image_folder")
        run_inference(engine, folder, save_dir=args.save_dir,
                      num_samples=args.num_samples,
                      save_test_images=args.save_test_images,
                      num_workers=args.num_workers,
                      visualize_gradcam=args.visualize_gradcam and main_rank,
                      gradcam_task=args.gradcam_task, colormap=args.colormap)

    elif args.mode == "folder":
        from .workloads.inference import test_folder_predictions

        folder = args.test_images_folder or args.image_folder
        if not folder:
            raise ValueError("folder mode needs --test_images_folder")
        test_folder_predictions(engine, folder, args.save_dir,
                                save_test_images=args.save_test_images,
                                target_task=args.target_task,
                                num_workers=args.num_workers)

    elif args.mode == "watch_folder":
        from .workloads.inference import WatchFolderService

        if not args.watch_folders:
            raise ValueError("watch_folder mode needs --watch_folders")
        if args.eval_annotations and not args.annotations_folder:
            raise ValueError("--eval_annotations needs --annotations_folder")
        folders = [f for f in args.watch_folders.split(",") if f]
        intervals = (
            [float(x) for x in args.poll_intervals.split(",")]
            if args.poll_intervals
            else [5.0] * len(folders)
        )
        svc = WatchFolderService(
            engine, folders, intervals, args.save_dir,
            save_dir_to_canon=args.save_dir_to_canon,
            truth_mapping_path=args.truth_mapping,
            annotations_folder=args.annotations_folder,
            metrics_every=args.metrics_every,
        )
        svc.start(block=True)

    elif args.mode == "camera":
        import torch

        from .workloads.stream import run_camera

        run_camera(args.family, engine.spec, engine.params, args.save_dir,
                   prob_threshold=args.prob_threshold,
                   measure_time=args.measure_time,
                   camera_index=args.camera_index,
                   kalman_filter=args.kalman_filter,
                   save_camera_video=args.save_camera_video,
                   video_path=args.video_path,
                   display=not args.no_display,
                   max_frames=args.max_frames,
                   record=args.record,
                   dtype=torch.bfloat16 if args.bf16 else torch.float32,
                   device=args.device)

    elif args.mode in ("tsne", "tsne_interactive"):
        from .workloads.embed import compute_embeddings, export_interactive_html, perform_tsne

        tasks_dict = engine.tasks.as_dict()
        ds, loader = make_loader(args, engine)
        kind = args.embedding_kind or _NATIVE_KIND[args.family]
        per_task = args.per_task_tsne or args.mode == "tsne_interactive"
        embs, labs, paths = compute_embeddings(engine, loader, kind=kind, per_task=per_task)
        if main_rank and args.mode == "tsne":
            if per_task:
                for t in engine.tasks.names:
                    perform_tsne(embs[t], labs[t], tasks_dict[t], args.colors, args.save_dir, t,
                                 device=engine.device)
            else:
                first = engine.tasks.names[0]
                perform_tsne(embs, labs, tasks_dict[first], args.colors, args.save_dir,
                             "AllTasks", device=engine.device)
        elif main_rank:
            x2d = {}
            for t in engine.tasks.names:
                x2d[t], _ = perform_tsne(embs[t], labs[t], tasks_dict[t], args.colors,
                                         args.save_dir, t, device=engine.device)
            export_interactive_html(
                x2d, labs, tasks_dict, paths,
                os.path.join(args.save_dir, "tsne_interactive.html"),
                thumbnails=not args.no_thumbnails,
                thumb_limit=args.thumb_limit,
            )

    elif args.mode == "clustering":
        from .workloads.embed import clustering_mode

        if not args.clustering_class:
            raise ValueError("clustering mode needs --clustering_class")
        ds, loader = make_loader(args, engine)
        task = args.clustering_task or engine.tasks.names[0]
        kind = args.embedding_kind or _NATIVE_KIND[args.family]
        clustering_mode(engine, loader, task, args.clustering_class, args.save_dir,
                        args.min_cluster_size, args.min_samples, kind=kind)

    if writer:
        writer.close()


def _run_explain(args, engine, ds, writer=None):
    from .data import BatchLoader
    from .workloads.explain import Explainer, ig_heatmap, overlay_cam, save_gradcam_batch

    explainer = Explainer(args.family, engine.spec, engine.params, device=engine.device)
    task = args.gradcam_task or engine.tasks.names[0]
    if task not in engine.tasks.names:
        print(f"[GradCAM] Task '{task}' not in registry -> disabled.")
        return
    loader = BatchLoader(ds, batch_size=args.batch_size, num_workers=args.num_workers)
    gradcam_dir = os.path.join(args.save_dir, "gradcam")
    ig_dir = os.path.join(args.save_dir, "integrated_gradients")
    for bi, (images, labels, paths) in enumerate(loader):
        if args.visualize_gradcam and args.save_gradcam_images:
            save_gradcam_batch(explainer, images, labels, task, gradcam_dir,
                               batch_idx=bi, cmap=args.colormap)
        if args.visualize_gradcam and writer is not None and bi == 0:
            # TensorBoard: the first batch's overlays
            targets = explainer.resolve_targets(task, labels, explainer.logits(images))
            cam, _ = explainer.gradcam(images, task, targets)
            for i in range(min(4, images.shape[0])):
                over = overlay_cam(images[i], cam[i], args.colormap)
                writer.add_image(f"GradCAM/{task}/{i}", over, dataformats="HWC")
        if args.integrated_gradients:
            import cv2

            os.makedirs(ig_dir, exist_ok=True)
            targets = explainer.resolve_targets(
                task, labels, explainer.logits(images), default_argmax=False)
            attrs = explainer.integrated_gradients(images, task, targets)
            for i in range(images.shape[0]):
                heat = ig_heatmap(attrs[i])
                over = overlay_cam(images[i], heat, args.colormap)
                out = os.path.join(ig_dir, f"ig_b{bi:04d}_i{i:03d}_task-{task}.png")
                cv2.imwrite(out, cv2.cvtColor(over, cv2.COLOR_RGB2BGR))


def _run_style_transfer(args, engine, ds):
    import numpy as np
    from PIL import Image

    from .ops.preprocess import load_image_normalized
    from .workloads.style_transfer import (
        run_patch_gram_style_transfer_batch,
        style_transfer_composite,
    )

    if args.family != "pmg":
        print("[style-transfer] only the PMG family has a Gram trunk; skipping")
        return
    out_dir = os.path.join(args.save_dir, "StyleTransfer")
    os.makedirs(out_dir, exist_ok=True)
    n = min(args.num_samples or len(ds), len(ds))
    paths = [ds.samples[idx][0] for idx in range(n)]
    # one optimization loop per chunk of images, each image on its own
    # Adam trajectory with its own early stop
    chunk = 32
    for lo in range(0, n, chunk):
        batch_paths = paths[lo : lo + chunk]
        print(
            f"style transfer images {lo + 1}-{lo + len(batch_paths)} of {n} "
            f"(one batched optimization)"
        )
        x = np.stack([load_image_normalized(p) for p in batch_paths])
        gens, losses, iters = run_patch_gram_style_transfer_batch(
            engine.params, engine.spec, x,
            num_iterations=args.style_iterations, lr=args.lr,
            init_type=args.init_type, target_loss=args.target_loss,
            seed_offset=lo,  # noise init keyed on each image's global index
            device=engine.device,
        )
        for path, gen, loss, its in zip(batch_paths, gens, losses, iters):
            base = os.path.splitext(os.path.basename(path))[0]
            combined = style_transfer_composite(Image.open(path).convert("RGB"), gen)
            out = os.path.join(out_dir, f"{base}_styled.png")
            combined.save(out)
            print(f"saved {out} (loss={float(loss):.6f}, iters={int(its)})")


if __name__ == "__main__":
    sys.exit(main())
