#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of the repository:

    python3 chip_smoke.py [--profile] [--record]

Phases, each of which raises on failure:

1. print the card's name and power limit (nvidia-smi), build the ten CUDA
   sources from ``<port>/csrc`` (nvcc, sm_90a, one process per source);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and on ragged shapes that take their other code paths
   (K2: float32 at 2e-4, two calls bit-identical, the bf16 mode to limits
   (a) and (b) of PERF.md section 2, with the load and store paths each
   call took; ``tsne_repulsion`` at N 64 and 4,099, phase 24's limits);
3. golden fixture: the shipped PMG checkpoint's logits on the fixture input
   match the frozen reference logits at 2e-4;
4. main path: ``Engine.run`` at batch 256 on 600 seeded uint8 224-px frames
   with launch counts reset just before; both kernels must have launched,
   probabilities sum to 1, the first 8 frames' logits match the port's CPU
   path, and ``prob_threshold=0.99`` gives all Unknown;
5. times (CUDA events; card name and power limit beside them): each kernel,
   its plain version and one PyTorch library call that computes the same
   function, beside the least time the card could take (K1: ``torch.baddbmm``
   on the split patches, with ``torch.bmm`` and the ``split_patches`` copy
   they need timed apart; the archived K1 in turns where ``_archive/``
   holds it); K2 in both modes beside its two bounds, the host time of one
   wrapper call, ``torch.addmm`` on the packed operand in float32 and in
   bf16, and where ``_archive/`` holds the previous K2 as ``stem_v1.cu``, the archived
   K2 in turns with the new one and the old bf16 stem block (archived K2,
   cast, batch norm, LeakyReLU) in turns with the bf16 mode; the engine's
   images per second end to end and on device-resident batches.
   ``--profile`` adds K2's stage cut in both modes and a ``torch.profiler``
   table of device time by kernel over a few device-resident steps;
6. the camera path's kernels against their plain versions on the card: the
   fused trunk + Gram at the shipped shapes (batch 1 and 8) and on a ragged
   spec, the fused head for the bf16 and q8 folds (batch 1 and 8), for a
   spec without transformer and for narrow layers (d 64, FFN 128, 2 heads;
   batch 1 and 8, clusters of 8 and 16), each called twice: bit-identical;
7. the golden-fixture walk of the fused head variants on the card: argmax
   agrees on decisive samples, drift <= HEAD_FOLD_MAX_DRIFT;
8. camera path: ``StreamPredictor`` on the fused route and the fused bf16
   head, named explicitly (``"auto"`` follows phase 23's record), on the shipped
   checkpoint over 64 seeded frames, launch counts reset just before; both
   camera kernels must have launched, the probabilities follow the Kalman
   recursion and match the port's CPU path on 8 frames; the packed route
   runs at batch 1 through the stem and Gram kernels;
9. camera times: both camera kernels at batch 1 beside their bounds and
   plain versions, the fused head's two launches apart (and, where the
   gitignored ``_archive/`` holds the previous kernel sources, the previous
   fused trunk + Gram and fused head in turns with the new ones), and
   per-frame latency of three
   routes: device time per
   step back to back, one step's device span on an idle card and the host
   time to enqueue it, and host wall time per frame from ``submit`` to the
   probabilities on the host; at the end of the run, after every host
   timing, device kernels and kernel time per step (``torch.profiler``).
   ``--profile`` adds each route's table of device time by kernel, and the
   head kernel's time with its fold cut to its first 0, 1, ... layers;
10. the RTM int8 kernel (K6, ``dequant_matvec``) against its plain version
    on the card, in float32 and in bf16, at the camera path's full-width
    shape and on the fixtures' ragged shapes (K6_SHAPES), within 1e-4 x
    max|y|, two calls bit-identical; and its dequantization over every int8
    value and every finite bf16 scale pattern (a float32 sweep in float32
    mode), on the 16-byte and the byte-wise paths, bit for bit the plain
    version's (``k6_exhaustive``);
11. the three RTM golden fixtures on the card: logits of the loaded
    engine's params at 2e-4, and the ``apply_stream`` walk on the float32
    and int8 folds (argmax agrees on every fixture; drift printed);
12. RTM batch inference at full width (ResNet-50 through ``layer4``,
    C = d = 2048, the 12-task registry, seeded random weights):
    ``Engine.run`` at batch 128 over 384 frames, probabilities sum to 1,
    logits match the port's CPU path on 2 frames; device step time and
    end-to-end images per second.  ``--profile`` adds the step's table of
    device time by kernel;
13. the RTM camera path at full width: the default ``folded_q8`` route over
    64 frames with the Kalman filter on, launch counts reset just before;
    K6 must launch once per frame, and the probabilities match the port's
    CPU path on 8 frames (the fold is built once, on the card, and reused
    there).  Per route (``generic``, ``folded``, ``folded_q8``) the latency
    of phase 9, and its device kernels per step at the end of the run; K6
    at batch 1 with L2 out of play beside its bound, its plain version, a
    ``torch.bmm`` yardstick and ``torch._weight_int8pack_mm`` where this
    torch has it, and the previous K6 in turns where ``_archive/`` holds it
    as ``int8_matvec_v1.cu``;
14. the bf16 path's kernels on the card at its shapes: K1 in bf16 against
    its plain version at batch 256 and on two ragged shapes (atol 0, rtol
    2^-8; two calls bit-identical), with its time, bound and yardsticks
    (and the archived K1 in turns); K2's bf16 mode on the engine's own
    fold to limits (a) and (b); the bf16 ``linear`` (one
    cuBLAS call) within one bf16 ulp of the float32 product plus bias
    rounded; the bf16 token projection kernel (K5, ``gram_proj``) against
    its plain version at batch 256 of the shipped spec (the Gram from K1
    in bf16; two calls bit-identical; bf16 output within one bf16 ulp) and
    on six shapes that take every tile width, ragged M and K tails, within
    1e-4 x max|y|; its time with the Gram read from device memory (four
    rotating copies), its plain version's, ``torch.addmm`` of the same bf16
    operands and the bias (K5's function in one library call, held to the
    plain version within K5's bf16-out limit) and ``torch.matmul`` without
    the bias, its bound, the host time of one call, and the previous K5 in
    turns where ``_archive/`` holds it;
15. PMG bf16 batch: ``Engine(dtype=torch.bfloat16)`` on the shipped
    checkpoint at batch 256 over phase 4's 600 frames, launch counts reset
    just before; K5 and K1 must have launched.  Argmax agreement (at least
    99.5 % of (frame, task) pairs) and probability drift against phase 4's
    float32 run, the shipped fixture in
    bf16 (argmax on decisive samples, drift <= 0.05), device step time (in
    turns with float32), the host's enqueue time of one step, and
    end-to-end images per second beside the float32 engine's; the host
    time of one eager call of each registered kernel's wrapper (K1, K2,
    K5, ``bn_epilogue``, ``instance_norm_leaky``) and of its launcher
    alone, in turns (what the wrapper's call rule adds to a step); where
    the gitignored ``_archive/parent/`` holds a parent commit's port,
    that port's PMG step and this tree's in turns, each in its own process
    (device time and the host's enqueue of one step);
16. PM: the five PM golden fixtures on the card at 2e-4, ``pm_small``'s
    attention (2e-4) and task embeddings (2e-3); the PM headline spec
    (``pm.build_spec`` on the 12-task registry: ndf 64, patch 70, instance
    norm, SE; seeded ``pm.init`` weights) at batch 256 in float32 and bf16:
    logits against the port's CPU path on 2 frames, device step time and
    images per second;
17. RTM bf16 batch at phase 12's width and batch: argmax agreement and
    probability drift against the float32 run, the drift within
    RTM_BF16_DRIFT (PERF.md section 2), device step time and images per
    second;
18. the evaluation path on the shipped PMG at batch 256: ``evaluate`` over
    600 seeded in-memory frames with seeded labels (about 10 % missing, one
    task with two classes present) through the port's ``BatchLoader``, in
    float32, in bf16 and with ``scan_chunk=2``, launch counts reset just
    before each; (a) metrics_test.json equals the metrics of ``Engine.run``
    on the same frames exactly, (b) test_loss its loss accounting, (c) the
    ``scan_chunk=2`` run the per-batch bytes, (d) K2 and K1 (and K5 in bf16)
    launched once a batch, (e) probabilities on 16 frames within 1e-3 of
    the port's CPU path in float32 (0.05 in bf16); ``run_benchmark`` with
    auto-mapping, ``run_inference`` and ``test_folder_predictions`` on 64
    seeded PNGs and one ``WatchFolderService`` poll cycle at batch 1, (f)
    their artifacts equal to what ``Engine.run`` gives on the decoded
    frames; evaluate's images per second end to end against ``Engine.run``'s
    in turns, and the watch service's wall time for one frame.  Where the
    machine has no matplotlib, a recording stand-in for ``matplotlib.pyplot``
    checks that every ROC figure was asked for (none is drawn);
19. the deployment path on the shipped PMG at batch 32: (a)
    ``save_torch_checkpoint`` -> ``load_engine(.pth)`` and ``save_native``
    -> ``load_engine(dir)``, probabilities bit for bit the original's on 96
    seeded frames; (b) the CLI's ``--mode export`` in float32 and in bf16
    (one subprocess each), each artifact reloaded by ``ExportedPredictor``
    and run on the 96 frames: preds equal to ``Engine.run``'s, logits
    within 1e-5 x max|logit| (bit-equality printed), K1 and K2 (and K5 in
    bf16) launched by the artifact once a batch, its device step in turns
    with the engine's, the host's enqueue of one step of each, and both end
    to end; (c) ``InferenceServer`` on 127.0.0.1 over the float32 ``Engine``
    and over the bf16 artifact: 64 seeded PNG ``/predict`` requests from 8
    client threads of a client process, each response's
    classes equal to ``Engine.run``'s on its decoded frame and its
    probabilities within 1e-5, ``/healthz`` and ``/stats`` checked;
    requests per second, p50 and p99 latency from ``/stats``, the
    kernels' launches and the host's decode time of one request;
20. the training path (``training_phase``): (a) the gradients through K1
    (float32 and bf16), K5 and the bf16 ``matmul_f32`` against autograd
    through their plain versions at z = [64,14,14,96] (K1 float32 within
    1e-5 x max|dz|, the others 1e-2 x max), each backward's time beside
    its forward's; (b) one PMG-shipped train step from the shipped weights
    (batch 64, float32, TF32 off, dropout 0) on the card against the CPU:
    loss within 1e-5 relative, every gradient leaf within 1e-4 x its max
    (the attention key bias, exactly 0, at noise on both), params within
    2 x lr, running statistics within 1e-5 x max; (c) twenty steps on one
    fixed batch of 64 in float32 and in bf16 (dropout 0.1, the default
    augmentation), launch counts reset just before each: loss finite and
    falling, bf16 master params and optimizer state float32, the bf16
    first-step loss within 2e-2 of float32's, K1 once a step and K5 once a
    bf16 step; ms a step (CUDA events, median of steps 5-20), train img/s,
    the host's enqueue of a step and of the optimizer's update alone, and
    peak memory; (d) PM (5 steps, batch
    32) and RTM (10 steps, batch 16) at their headline widths from seeded
    init: loss finite and falling, ms a step; (e) ``fit`` (PMG-shipped
    hparams, random init, 2 epochs, batch 32, bf16, augmentation) on 192
    seeded PNGs: the artifacts written, ``best_model.pth`` through
    ``load_engine`` bit for bit an Engine on the returned params, and
    ``weather_torch.py pmg --mode train`` for 1 epoch in a subprocess
    writing the same set.

21. explainability and style transfer (``explain_phase``): (a) the shipped
    PMG's Grad-CAM at batch 32 (float32, TF32 off) through K1 and its
    registered backward, launch counts reset just before: K1 launched, CAM
    within 1e-3 and logits within 1e-4 x max|logit| of the port's CPU path
    on 4 frames, ms a call and img/s; the golden CAMs of
    ``pmg_tiny_instance_se`` (instance norm at the target: the CAM is 0,
    its channel weights must vanish to 1e-5 x max|gradient|) and
    ``pm_batchnorm_sigmoid`` (5e-3) on the card; (b) integrated gradients
    (50 Gauss-Legendre steps, batch 4) through K1, within 1e-3 x max|attr|
    of the CPU path, ms a call; (c) the PM and RTM headline Grad-CAM
    (phase 16's and phase 12's seeded weights) at batch 8, held to the CPU
    on 2 frames (PM's instance norm: empty on both), ms a call; (d) the
    shipped style grams at 2e-3 and 20 iterations of the style loop (4
    seeded images, gray init) against the CPU: losses within 1e-3
    relative, iterations equal, ms an iteration; (e) ``weather_torch.py pmg
    --mode classifier --visualize_gradcam --save_gradcam_images
    --integrated_gradients --style_transfer`` on 16 seeded PNGs in a
    subprocess, writing the JAX CLI's gradcam/, integrated_gradients/ and
    StyleTransfer/ names, with its wall time.

22. the bf16 camera path and the embedding workloads
    (``stream_bf16_embed_phase``): (a) the shipped PMG's bf16
    ``StreamPredictor`` over 64 seeded frames, Kalman on and off, on the
    fused route (bit for bit the float32 predictor), the packed route (bit
    for bit ``Engine(dtype=bf16, batch_size=1)``) and the generic route
    (bit for bit ``pmg.apply`` on the bf16 tree at batch 1), both within
    5e-3 in probability of float32 (BF16_CAMERA_DRIFT, the bf16 limit of
    PERF.md section 2) with their argmax agreement printed, with the
    launches of K3 and K4, or K2, K1 and K5, once a frame, and each route's
    latency as in phase 9; (b) K6's bf16 mode against its plain version at
    [1,12,2048] x [12,2048,2048] within 1e-4 x max|y|, its time with L2 out
    of play beside its bound, its plain version and ``torch.bmm`` on the
    bf16-dequantized fold (and the previous K6 in turns where ``_archive/``
    holds it); (c) the PM headline (generic) and RTM headline
    (generic, folded, folded_q8 with K6's bf16 mode once a frame) bf16
    cameras against the card's float32 predictors: the drift in
    probability (RTM within RTM_BF16_DRIFT, PM within BF16_CAMERA_DRIFT) and
    the argmax agreement, with each route's latency; (d) ``compute_embeddings`` on
    the shipped PMG over 2,048 seeded labelled frames at batch 256 (float32
    logits and pooled taps, bf16 logits; K1 and K2, and K5 in bf16, once a
    batch; the logits equal ``Engine.run``'s), img/s beside ``Engine.run``;
    the port's t-SNE (scikit-learn's Barnes-Hut objective, the repulsion
    summed exactly by the ``tsne_repulsion`` kernel, once an iteration) of
    one task's logits on the card (N 2,048: ms, KL, launches), its first
    512 points on the card and on the CPU (KL within 1 % relative,
    trustworthiness within 0.01; a second card run bit-identical),
    ``tsne_repulsion`` against its float64 plain version at both final
    layouts (phase 24's limits), and
    ``hdbscan_clustering`` on one class on the card (one core-distance and
    one MST launch a distinct ``min_samples``) and one HDBSCAN whose labels
    equal the CPU's; (e) ``cli.main`` in this process: ``--mode tsne``,
    ``tsne_interactive`` (thumbnails) and ``clustering`` on 64 seeded PNGs,
    writing the JAX CLI's file names (the PNGs into phase 18's recording
    stand-in where matplotlib is missing), with the wall time of each.

23. multi-device execution and the measured route selection
    (``mesh_phase``, ``select_phase``): (a) the shipped PMG
    ``Engine(mesh=make_mesh())`` over a world of 1 on NCCL (one all-reduce
    run on NCCL) at batch 256 over phase 4's 600 frames, float32 and bf16:
    logits within 1e-5 x max|logit| of the engine without a mesh, K1 and
    K2 (and K5 in bf16) launched; (b) the sharded PMG-shipped train step
    on 2 ranks sharing the card over gloo, ``("data",)`` (2,) and
    ``("data", "model")`` (1, 2), global batch 64, three float32 steps
    (TF32 off) and three bf16 steps (dropout 0.1), each from the
    one-process run's state: losses within 1e-5 relative (bf16 1e-2) of
    the one-process step; in float32 the one-process step rerun on the
    sharded run's branch at every LeakyReLU and ReLU (the elements whose
    own branch differs counted), and the sharded gradients within 1e-4 x
    each leaf's max and params within 1e-5 x each leaf's max of it (2 x lr
    where a gradient is float32 noise); bf16 params within the larger of
    1e-2 x max and 2 x lr; K1 once a step and K5 once a bf16 step on every
    rank, ms a step beside the unsharded step's; (c) the port's
    ``parallel.dryrun`` (``host_local_batch``, 1e-5) over gloo on the CPU
    and on the card, in two processes beside (a); (d) every selectable
    op's variants (the PMG camera routes and head folds and the RTM camera
    routes at batch 1, each a step's time over 20 back-to-back steps; the
    engine's scan chunk for PMG at batch 256 and RTM at 128 in float32 and
    bf16, per image of ``Engine.run`` over 8 batches), 5 rounds in turns,
    median and spread beside the committed record's calls, the kernel
    routes whose every round beat the default's, ``--record`` adding the
    call to the record; every ``"auto"`` checked against the record in
    effect and every entry against the rule that wrote it; and the
    batch-1 K1, K2 (bf16 mode) and K5 of PMG's bf16 packed and generic
    camera routes beside their bounds, plain versions and library calls
    (K1 ``torch.baddbmm`` on the split patches plus the split copy, K2
    ``torch.addmm`` on the packed bf16 operand, K5 ``torch.addmm`` with the
    bias).

24. the t-SNE at dataset scale (``tsne_phase``): 65,536 seeded 48-D points
    in 12 Gaussian clusters.  (a) ``tsne_repulsion`` against its plain
    version in float64 at a seeded layout of std 10: rep within 1e-4 x
    max|rep|, each row's z within 1e-4 relative and Z within 1e-5; (b) the
    kNN and sparse P alone (s, entries), then the whole ``tsne`` with
    launch counts reset just before: wall s, final KL,
    iterations (one kernel launch each), and the peak of
    ``torch.cuda.max_memory_allocated`` over the call's own baseline, under
    4 GB (one dense N x N float32 matrix is 17.2 GB); the layout finite,
    and its 5 nearest neighbours in the same cluster for at least 90 % of
    (point, neighbour) pairs; (c) (a)'s check at the final layout; (d) the
    kernel's device time (CUDA events, median of 5 rounds of 20 launches)
    beside its bound (N (N - 1) pairs of 12 float32 FLOPs and one MUFU
    reciprocal) and its plain version's time in float32.  ``--profile``
    adds (e): 50 descent iterations at N 65,536 and on the first 2,048
    points, host wall an iteration untraced, then device time by kernel and
    the device's idle share (``tsne_descent_trace``).

25. HDBSCAN at dataset scale (``hdbscan_phase``): (a) each kernel of
    ``csrc/hdbscan.cu`` against its float64 plain version, bit for bit and
    two calls bit-identical: ``hdbscan_core`` at N 8,192 and a ragged
    4,099 (7 points repeated) at k 1, 5, 10, 33 (past the insertion path)
    and N, in float32 and float64, and at (b)'s N 65,536, D 48, k 5 and 10,
    where its insertion path is also timed at k 4, 8, 16 and 32; ``hdbscan_mst``
    at N 4,096 (D 48), 1,024 (D 192), and points rounded to one decimal
    with 100 repeats (tied weights) at N 2,048 and at more points than the
    largest grid has threads (each thread owning several nodes); each
    kernel's time beside its bound (float64 operations at 34 TFLOP/s) and
    its plain version's; (b) ``hdbscan_clustering`` over
    its default grid of phase 24's 65,536 points (D 48), then of 65,536
    seeded points at D 192: each stage's time (core distances, each MST,
    the host's single linkage and condensing), wall s, launches (each
    kernel twice: once per distinct ``min_samples``), the peak of
    ``torch.cuda.max_memory_allocated`` over the call's baseline under 1 GB,
    and 12 clusters found, each at least 99 % one seeded cluster.
26. the RTM trunk's inference epilogue (``bn_epilogue_phase``): (a) every
    distinct site of ResNet-50's bf16 trunk at batch 128 (the norm, with
    its ReLU, the identity or the downsample branch's norm), the kernel
    against its plain version bit for bit, each one's time a launch beside
    the byte bound, and the sums over the 49 sites of one forward, also
    at batch 1 in float32 (the camera); (b) the bf16 RTM engine step at
    batch 128 on the kernel and on the plain version in turns (device and
    host enqueue time), with 49 launches a batch and ``Engine.run``'s
    probabilities equal bit for bit on both; (c) a bf16 RTM
    ``torch.export`` artifact holding 49 ``wadt_torch.bn_epilogue`` nodes,
    reloaded by ``ExportedPredictor``: the same predictions as
    ``Engine.run``, probabilities compared, 49 launches a batch.
27. the PM trunk's instance norm and LeakyReLU (``instance_norm_phase``):
    (a) each of the five sites of the float32 PM headline trunk at batch
    256, the kernel against the plain chain (within 1e-6 of each plane's
    largest value, two calls the same bits), the kernel's time a launch in
    place (as the trunk calls it) beside the byte bound (one read and one
    write) and the plain chain's time, and their sums; (b) the float32 PM
    engine step at batch 256 on the kernel and on the plain chain in turns
    (device time, and each one's peak memory over the resident state),
    with 5 launches a batch and ``Engine.run``'s probabilities within 1e-5
    of the plain chain's.
28. the Engine's upload (``upload_phase``), staged through its pinned
    two-slot ring on a copy stream against the direct pageable upload (the
    engine with its ring taken out, the upload before the ring), on phase
    26 (b)'s bf16 RTM engine at batch 128 and phase 27 (b)'s float32 PM
    engine at batch 256, over calls of 2,048 frames (a 1,024-frame pool
    twice, as the benchmark's cells): ``Engine.run``'s probabilities and
    predictions bit for bit the direct upload's; calls in turns (direct,
    staged, staged, direct; three rounds) in images per second; from one
    profiled call of each, the device trace's host-to-device copy time a
    batch and the share of each copy that kernels overlap (the first copy
    of a call apart); from one recorded call, ``engine.staged``,
    ``engine.stage_wait`` and the host time of ``engine.stage`` a batch.
29. the RTM trunk's train-mode batch norm (``bn_train_phase``): (a) every
    distinct site of the train-mode trunk at batch 128, in float32 and in
    bf16 (the norm and its ReLU, the identity or the downsample branch's
    norm, then the ReLU), forward and backward: the kernels against the
    chain in float64, its gradients under the kernels' own ReLU mask (1e-5
    of each tensor's largest value in float32, one bf16 rounding in bf16;
    at most 1e-5 of the outputs on the other side of the ReLU; the float32
    chain's own gap printed beside), two calls the same bits, and the
    device time of a forward and backward for the kernels, the present
    chain (``bn_train_plain``) and the library
    (``F.batch_norm(training=True)``, the sum, ``torch.relu``) beside the
    byte bound (each input and output once), summed over the 49 sites;
    (b) one step of the RTM train step the cell runs
    (``train.make_train_step("rtm")``: trunk, heads, loss and AdamW) at
    batch 128 in float32, after a first, with its ``bn_train`` launches
    (102 forward, 98 backward); (c) where the gitignored
    ``_archive/parent/`` holds a parent commit's port, the RTM train step
    (batch 128, float32, TF32 off, seeded weights and images) of the
    parent and of this tree in turns, each in its own process: device time
    a step, peak memory and the first steps' losses, and their gap.

``--profile`` also prints, for phases 15-17 and 20 (c), each step's device kernels,
kernel time and table of device time by kernel, in phase 14 K1's bf16
time with its work cut stage by stage, and in phase 13 K6's stage cut
(``k6_cuts``: loads only and math only, both modes, of the current K6 and
of the previous one where ``_archive/`` holds it).  Host times come from runs
without ``--profile``: once a profiler session has run, the host's launch
cost stays higher for the rest of the process.

Output: one line per phase, then a ``{"kernels": [...]}`` JSON line (K1's,
K2's and K5's entries also hold ``eval_launches`` and ``deploy_launches``,
their launches on each path of phases 18 and 19, and K1's and K5's
``train_launches``, their launches in phase 20's twenty steps, K1's
``explain_launches``, its launches in phase 21's Grad-CAM and IG calls, and
every kernel's ``stream_bf16_launches`` and ``embed_launches``, its
launches on each bf16 camera route and each embedding path of phase 22
(the t-SNE and HDBSCAN runs included), the HDBSCAN kernels' ``shape`` of
their times, ``main_path_ms`` at N 65,536 and ``hdbscan_launches`` of
phase 25,
and K1's, K2's and K5's ``mesh_launches``, their launches on the mesh
engine and on each rank of the sharded train step in phase 23;
K6's bf16 mode has an entry of its own, ``dequant_matvec_bf16``), the
card's nvidia-smi line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, with no result line, when no CUDA card is available or the
port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, float32
# FLOP/s outside the tensor cores, dense bf16 FLOP/s of the tensor cores,
# and float64 FLOP/s outside them.  A bound counts each operation at the peak of its operands' type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
# float64 FLOP/s outside the tensor cores; it counts an FMA as two, and the
# HDBSCAN kernels fuse none
PEAK_F64_FLOP_PER_S = 34e12

PORT = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch"
JAX_PKG = "heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu"
FIXTURES = os.path.join("tests", "fixtures")
BATCH = 256
N_FRAMES = 600
CAMERA_FRAMES = 64
LATENCY_FRAMES = 200
K3_TOL = 5e-3  # the JAX package's own bound for the fused trunk (tests/test_pallas.py:133)
K4_TOL = 1e-3
K6_TOL = 1e-4  # times max|y| of the plain version
# [B, T, C, D] of phase 10: the camera's fold at full width, the
# rtm_trunc5_attn fold and its mlp_q8 layer, the byte-wise path with 4-row groups
K6_SHAPES = ((1, 12, 2048, 2048), (2, 3, 256, 256), (2, 3, 256, 32), (5, 3, 40, 24))
RTM_BATCH = 128
RTM_FRAMES = 384
K5_TOL = 1e-4  # times max|y| of the plain version
BF16_FIXTURE_DRIFT = 0.05  # logit drift of a bf16 run on a golden fixture (utils/goldens.py)
BF16_PMG_AGREEMENT = 0.995  # share of (frame, task) pairs whose bf16 argmax is float32's (PERF.md 2)
PM_FRAMES = 512


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean device time of ``reps`` back-to-back
    calls, between CUDA events.  A sleep kernel queued first lets the host
    enqueue every call before the first event fires, so host launch cost
    stays outside the interval.  The sleep lasts at least 1.5 times the
    host's measured enqueue time of ``reps`` calls (cycles counted at 2 GHz,
    above the card's SM clock, so the sleep is never shorter)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = max(50_000_000, int(1.5 * enqueue_s * 2e9))
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def bound_ms(nbytes: float, flops: float, bf16_flops: float = 0.0, f64_flops: float = 0.0):
    """Least time: bytes over HBM rate, or float32, bf16 and float64 FLOPs over their peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOP_PER_S + bf16_flops / PEAK_BF16_FLOP_PER_S
             + f64_flops / PEAK_F64_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want, atol: float, rtol: float, what: str) -> float:
    import torch

    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {got.numel()} values outside "
            f"atol={atol} rtol={rtol}; max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


def random_pmg_params(spec, rng):
    """Seeded random PMG params of ``spec`` (float32 CPU tensors, the port's
    tree layout) with non-trivial batch-norm statistics."""
    import torch

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype("float32"))

    def lin(i, o):
        return {"w": t(i, o, scale=i ** -0.5), "b": t(o, scale=0.1)}

    def norm(c, stats=True):
        p = {"scale": t(c, scale=0.1) + 1.0, "bias": t(c, scale=0.1)}
        if stats:
            p.update(mean=t(c, scale=0.1), var=t(c).abs() + 0.5)
        return p

    gc, d = spec.gram_channels, spec.d_model
    params = {
        "trunk": [{"conv": {"w": t(b.kernel, b.kernel, b.cin, b.cout,
                                   scale=(b.kernel * b.kernel * b.cin) ** -0.5)},
                   "norm": norm(b.cout)} for b in spec.plan],
        "chan_proj": {"w": t(1, 1, spec.trunk_channels, gc, scale=spec.trunk_channels ** -0.5)},
        "token_proj": lin(gc * gc, d),
        "queries": t(len(spec.tasks), d, scale=d ** -0.5),
        "heads": {"w": t(len(spec.tasks), d, spec.tasks.max_classes, scale=d ** -0.5),
                  "b": t(len(spec.tasks), spec.tasks.max_classes, scale=0.1)},
    }
    if spec.has_transformer:
        params["transformer"] = [{
            "attn": {**{n: t(d, d, scale=d ** -0.5) for n in ("wq", "wk", "wv", "wo")},
                     **{n: t(d, scale=0.1) for n in ("bq", "bk", "bv", "bo")}},
            "norm1": norm(d, stats=False), "norm2": norm(d, stats=False),
            "ffn1": lin(d, 2 * d), "ffn2": lin(2 * d, d),
        } for _ in range(spec.transformer_layers)]
    return params


def tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def stem_path(x8, cout: int, bf16: bool = False) -> str:
    """The paths K2 takes on uint8 ``x8``: its plan's bulk or plain loads,
    tensor or direct stores."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    b, h, w, cin = x8.shape
    plan = ck.stem_plan(b, h, w, cin, 4, cout, ck._sm_count(x8.device), x8.data_ptr() % 16 == 0, bf16)
    return f"{plan.path} ({plan.rows} rows a tile, {plan.grid} blocks)"


def stem_bf16_check(x8, w, bias, s, t, what: str) -> dict:
    """K2's bf16 mode against the limits: (a) with the norm and LeakyReLU it
    equals the PyTorch bf16 chain applied to the kernel's own sum (no
    norm) bit for bit; (b) that sum is within one bf16 ulp of the plain
    version's rounding (2^-7 |want| + 2e-4), and at most 1 % of the outputs
    differ from it at all.  Returns the share that differ and the path."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, nn,
    )

    bf16 = torch.bfloat16
    y0 = ck.stem(x8, w, None, None, 4, leaky=False, out_dtype=bf16, bias=bias)
    y = ck.stem(x8, w, s, t, 4, leaky=True, out_dtype=bf16, bias=bias)
    torch.cuda.synchronize()
    if not torch.equal(y.view(torch.int16), nn.leaky_relu(y0 * s + t, 0.2).view(torch.int16)):
        raise AssertionError(f"stem bf16 {what}: the norm and LeakyReLU differ from the bf16 chain")
    want = ck.stem_plain(x8, w, None, None, 4, leaky=False, out_dtype=bf16, bias=bias).float()
    max_err(y0.float(), want, 2e-4, 2 ** -7, f"stem bf16 {what} sum")
    share = float((y0.float() != want).float().mean())
    if share > 0.01:
        raise AssertionError(f"stem bf16 {what}: {share:.4%} of the sums round otherwise")
    full = ck.stem_plain(x8, w, s, t, 4, leaky=True, out_dtype=bf16, bias=bias).float()
    return {"what": what, "share": share, "path": stem_path(x8, w.shape[1], True),
            "err": float((y.float() - full).abs().max())}


ARCHIVE = "_archive"  # gitignored: earlier kernel versions kept for an A/B in one call
# archived source -> the C entry points it holds and their argument types
# (ctypes.c_void_p for pointers and the stream, c_int for sizes)
ARCHIVED = {
    "gram_proj_v2.cu": {"wadt_gram_proj_bf16": "PPPPPIIIIP"},
    "head_v2.cu": {"wadt_fused_head": "PPIPPTIPPPPIPIIIIIIIIP"},
    "int8_matvec_v1.cu": {"wadt_dequant_matvec": "PPPPIIIIP", "wadt_dequant_matvec_bf16": "PPPPIIIIP"},
    "patch_gram_v1.cu": {"wadt_patch_gram_f32": "PPIIIIIP", "wadt_patch_gram_bf16": "PPIIIIIP"},
    "stem_v1.cu": {"wadt_stem_u8_f32": "PPPPPIIIIIIIP"},
    "trunk_gram_v1.cu": {"wadt_trunk_gram_u8": "PPPPPPPPPPIIIIIIIIIIIP"},
}


PARENT = os.path.join(ARCHIVE, "parent")  # gitignored: a parent commit's port, for a whole-step A/B
# run in a process of its own from a checkout's root: that checkout's PMG
# batch step at batch 256 in float32 and bf16 (phase 15's timing), as JSON
STEP_AB = """
import json, os, statistics, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
port.config.enable_parity_precision()
meta = json.load(open(os.path.join(cs.FIXTURES, "pmg_shipped.json")))
eng = port.load_engine("pmg", os.path.join(cs.FIXTURES, "pmg_shipped.pth"), meta["tasks"], meta["hparams"],
                       batch_size=cs.BATCH, device="cuda")
eng16 = executor.Engine("pmg", eng.spec, eng.params, batch_size=cs.BATCH, dtype=torch.bfloat16)
xb = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (cs.BATCH, 224, 224, 3), np.uint8)).cuda()
f32, b16 = cs.in_turns(lambda: eng.step(xb), lambda: eng16.step(xb), reps=1, rounds=10)


def enqueue_ms(e):  # host time to enqueue one step behind a sleep (phase 15's measure)
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        e.step(xb)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


print(json.dumps([f32, b16, enqueue_ms(eng), enqueue_ms(eng16)]))
"""


def parent_step_ab(card: str) -> None:
    """Where the gitignored ``_archive/parent/`` holds a parent commit's port
    (``git archive <commit> <port> chip_smoke.py tests/fixtures/pmg_shipped.json
    tests/fixtures/pmg_shipped.pth``), the PMG batch step of the parent and
    of this tree in turns (parent, this, this, parent), each in a process of
    its own that builds its own kernels."""
    if not os.path.isdir(PARENT):
        return
    runs = []
    for root in (PARENT, ".", ".", PARENT):
        out = subprocess.run([sys.executable, "-c", STEP_AB], cwd=root, capture_output=True, text=True,
                             timeout=600, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    (p1, p2, pe1, pe2), (c1, c2, ce1, ce2), (c3, c4, ce3, ce4), (p3, p4, pe3, pe4) = runs
    print(f"[15] PMG batch step at batch {BATCH}, the parent's port ({PARENT}) against this tree in turns: "
          f"device float32 {p1:.3f} / {p3:.3f} -> {c1:.3f} / {c3:.3f} ms, bf16 {p2:.3f} / {p4:.3f} -> "
          f"{c2:.3f} / {c4:.3f} ms; host enqueue of one step float32 {pe1:.3f} / {pe3:.3f} -> "
          f"{ce1:.3f} / {ce3:.3f} ms, bf16 {pe2:.3f} / {pe4:.3f} -> {ce2:.3f} / {ce4:.3f} ms | {card}")


def archived_kernels() -> dict:
    """The previous versions of the redesigned kernels that the gitignored
    ``_archive/`` holds (copies of earlier commits' sources, not committed:
    K5 and K4 as ``gram_proj_v2.cu`` and ``head_v2.cu``, K1 and K3 as
    ``patch_gram_v1.cu`` and ``trunk_gram_v1.cu``, K2 as ``stem_v1.cu``, K6
    as ``int8_matvec_v1.cu``; each optional), built
    into one library of their own: entry point name -> ctypes function.
    Empty where the checkout has none of them."""
    import ctypes

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    srcs = [f for f in ARCHIVED if os.path.isfile(os.path.join(ARCHIVE, f))]
    if not srcs:
        return {}
    out = os.path.join(ARCHIVE, "build")
    os.makedirs(out, exist_ok=True)
    objs = [os.path.join(out, f + ".o") for f in srcs]
    nvcc = ck._nvcc()
    ck._run_all([[nvcc, *ck._NVCC_FLAGS, "-c", os.path.join(ARCHIVE, f), "-o", o]
                 for f, o in zip(srcs, objs)], "nvcc (archive)")
    so = os.path.join(out, "libarchived.so")
    ck._run_all([[nvcc, "-shared", *objs, "-o", so]], "nvcc link (archive)")
    lib = ctypes.CDLL(os.path.abspath(so))
    kinds = {"P": ctypes.c_void_p, "I": ctypes.c_int, "T": ctypes.POINTER(ctypes.c_void_p)}
    fns = {}
    for f in srcs:
        for name, sig in ARCHIVED[f].items():
            fn = getattr(lib, name)
            fn.argtypes = [kinds[c] for c in sig]
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def archived_call(fn, *args):
    """A function that runs an archived kernel on the current stream and
    raises if its launch fails."""
    import torch

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"archived kernel failed: {err}")

    return run


def archived_head_call(fused_head, tokens, fold, spec):
    """A function that runs the archived K4 (two launches) on ``tokens``."""
    import ctypes

    import torch

    tp, layers = fold["token_proj"], fold.get("transformer", ())
    q8 = "w8" in tp
    w = tp["w8"] if q8 else tp["w"]
    order = (("norm1", "scale"), ("norm1", "bias"), ("attn", "wq"), ("attn", "bq"), ("attn", "wk"),
             ("attn", "bk"), ("attn", "wv"), ("attn", "bv"), ("attn", "wo"), ("attn", "bo"),
             ("norm2", "scale"), ("norm2", "bias"), ("ffn1", "w"), ("ffn1", "b"), ("ffn2", "w"),
             ("ffn2", "b"))
    ptrs = [lp[g][k].data_ptr() for lp in layers for g, k in order]
    table = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    b, npatch, din = tokens.shape
    d = w.shape[1]
    ff = layers[0]["ffn1"]["w"].shape[1] if layers else 0
    ntask, kmax = fold["heads"]["b"].shape
    chunks = -(-din // 256)
    partial = torch.empty((chunks, b * npatch, d), dtype=torch.float32, device=tokens.device)
    out = torch.empty((b, ntask, kmax), dtype=torch.float32, device=tokens.device)

    def run():
        err = fused_head(
            tokens.data_ptr(), w.data_ptr(), int(q8), tp["scale"].data_ptr() if q8 else None,
            tp["b"].data_ptr(), table, len(layers), fold["queries"].data_ptr(),
            fold["heads"]["w"].data_ptr(), fold["heads"]["b"].data_ptr(), partial.data_ptr(), chunks,
            out.data_ptr(), b, npatch, din, d, ff, spec.transformer_heads, ntask, kmax,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"archived fused_head failed: {err}")
        return out

    return run


def route_latency(label: str, p, x1, frames, card: str) -> None:
    """Print one camera route's latency: device time of one step with all its
    launches queued behind a sleep, one step's device span on an idle card
    and the host time to enqueue it, and host wall time per frame from
    ``submit`` to the probabilities on the host."""
    import numpy as np
    import torch

    for f in frames[:10]:
        np.asarray(p.submit(f))
    step_ms = device_ms(lambda: p.step(x1), reps=1, rounds=20)
    walls, enqueues, spans, steps = [], [], [], []
    for i in range(LATENCY_FRAMES):
        t0 = time.perf_counter()
        handle = p.submit(frames[i % len(frames)])
        t1 = time.perf_counter()
        np.asarray(handle)
        walls.append(time.perf_counter() - t0)
        enqueues.append(t1 - t0)
        # one step alone on an idle card: its device span, launch gaps included
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        p.step(x1)
        steps.append(time.perf_counter() - t0)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    print(f"{label}: {step_ms * 1e3:.1f} us of device time per step (launches queued ahead), "
          f"{statistics.median(spans) * 1e3:.1f} us span of one step alone, enqueued by the host "
          f"in {statistics.median(steps) * 1e6:.1f} us; host wall per frame, submit to host "
          f"probs {statistics.median(walls) * 1e6:.1f} us, of which submit returns after "
          f"{statistics.median(enqueues) * 1e6:.1f} us (medians of {LATENCY_FRAMES}) | {card}")


def profile_step(label: str, fn, steps: int = 3) -> None:
    """Device kernels, kernel time per step and the table of device time by
    kernel of ``steps`` calls of ``fn`` (``torch.profiler``; ``--profile``
    only: host launch costs stay higher afterwards)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]
    print(f"{label}: {len(evs) / steps:.1f} device kernels per step, "
          f"{sum(e.time_range.elapsed_us() for e in evs) / steps:.1f} us of kernel time per step")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))


def kernels_per_step(routes, profile: bool) -> None:
    """Device kernels and kernel time per step of each (label, predictor,
    frame), from ``torch.profiler`` over 10 steps; ``profile`` adds the table
    of device time by kernel.  Run after every host timing: the host's
    launch cost stays higher once a profiler session has run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    for label, p, x1 in routes:
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                p.step(x1)
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]
        print(f"{label}: {len(evs) / 10:.1f} device kernels per step, "
              f"{sum(e.time_range.elapsed_us() for e in evs) / 10:.1f} us of kernel time per step")
        if profile:
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))


def camera_phases(profile: bool, card: str, spec, params, routes: list, old: dict) -> list:
    """Phases 6-9 (the camera path) on the shipped ``spec`` and ``params``
    (on the card); returns the camera kernels' entries of the kernels line
    and appends each timed route to ``routes``."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint, executor,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, kalman,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import goldens
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import stream

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(3)

    # -- 6. camera kernels against their plain versions, on the card --------
    trunk_w = ck.fold_trunk_gram_weights(params, spec)
    x8 = torch.from_numpy(rng.randint(0, 256, (8, 224, 224, 3), np.uint8)).to(dev)
    x1 = x8[:1]
    k3_err = 0.0
    for xb in (x1, x8):
        got = ck.fused_trunk_gram(xb, trunk_w, spec)
        torch.cuda.synchronize()
        k3_err = max(k3_err, max_err(got, ck.fused_trunk_gram_plain(xb, trunk_w, spec), K3_TOL,
                                     K3_TOL, f"fused_trunk_gram [{xb.shape[0]},224,224,3]"))
        if not torch.equal(ck.fused_trunk_gram(xb, trunk_w, spec), got):
            raise AssertionError(f"fused_trunk_gram batch {xb.shape[0]}: two calls differ")
    # ragged: a 7x7 final map, replicate-padded to 9x9 for div 3; 120 px
    # wide leaves 8 columns beyond a multiple of K = 16
    rag_spec = pmg.build_spec({"a": ["x", "y"]}, dict(
        ndf=16, patch_size=64, patch_div=3, gram_channels=32, d_model=64,
        transformer_layers=0, use_token_attention=False))
    rag_w = ck.fold_trunk_gram_weights(
        checkpoint.to_device(random_pmg_params(rag_spec, rng), dev), rag_spec)
    xr = torch.from_numpy(rng.randint(0, 256, (2, 112, 120, 3), np.uint8)).to(dev)
    got = ck.fused_trunk_gram(xr, rag_w, rag_spec)
    rag_err = max_err(got, ck.fused_trunk_gram_plain(xr, rag_w, rag_spec), K3_TOL, K3_TOL,
                      "fused_trunk_gram ragged [2,112,120,3]")
    if not torch.equal(ck.fused_trunk_gram(xr, rag_w, rag_spec), got):
        raise AssertionError("fused_trunk_gram ragged: two calls differ")
    torch.cuda.synchronize()
    print(f"[6] fused_trunk_gram vs plain: max abs err {k3_err:.3e} (batch 1 and 8), "
          f"{rag_err:.3e} (ragged), atol/rtol {K3_TOL}, two calls bit-identical; clusters of "
          f"{ck.trunk_gram_plan(spec, 224, 224).cluster} (shipped) and "
          f"{ck.trunk_gram_plan(rag_spec, 112, 120).cluster} (ragged) blocks a patch")

    tokens8 = ck.fused_trunk_gram_plain(x8, trunk_w, spec)
    tokens1 = tokens8[:1].contiguous()
    folds = {v: pmg.fold_head_weights(params, spec, v) for v in ("bf16", "q8")}
    nt_spec = pmg.build_spec(spec.tasks.as_dict(), dict(
        ndf=32, patch_size=64, patch_div=3, gram_channels=96, d_model=192,
        transformer_layers=0, use_token_attention=False))
    nt_fold = pmg.fold_head_weights(
        checkpoint.to_device(random_pmg_params(nt_spec, rng), dev), nt_spec, "q8")
    # narrow layers (d 64, FFN 128, 2 heads): 8 columns a block of 8, and on
    # a cluster of 16 half the blocks own no d-wide columns
    nw_spec = pmg.build_spec(spec.tasks.as_dict(), dict(
        ndf=16, patch_size=64, patch_div=3, gram_channels=32, d_model=64, transformer_layers=2,
        transformer_heads=2, use_token_attention=True))
    nw_fold = pmg.fold_head_weights(
        checkpoint.to_device(random_pmg_params(nw_spec, rng), dev), nw_spec, "bf16")
    nw8 = torch.from_numpy(rng.randn(8, 9, 32 * 32).astype(np.float32)).to(dev)
    k4_err = 0.0
    cases = [(f"{v} batch {tb.shape[0]}", tb, f, spec, None)
             for v, f in folds.items() for tb in (tokens1, tokens8)]
    cases.append(("q8 no transformer batch 8", tokens8, nt_fold, nt_spec, None))
    cases += [(f"narrow d 64 batch {tb.shape[0]} cluster {cl or 8}", tb, nw_fold, nw_spec, cl)
              for tb in (nw8[:1].contiguous(), nw8) for cl in (None, 16)]
    for what, tb, f, sp, cl in cases:
        got = ck._fused_head_launch(tb, f, sp, cluster=cl)
        torch.cuda.synchronize()
        want = ck.fused_head_plain(tb, f, sp)
        k4_err = max(k4_err, max_err(got, want, K4_TOL, K4_TOL, f"fused_head {what}"))
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError(f"fused_head {what}: argmax differs from the plain version")
        if not torch.equal(ck._fused_head_launch(tb, f, sp, cluster=cl), got):
            raise AssertionError(f"fused_head {what}: two calls on the same inputs differ")
    print(f"[6] fused_head vs plain: max abs err {k4_err:.3e} (bf16 and q8 folds at batch 1 "
          f"and 8, no-transformer spec, narrow d 64 spec on clusters of 8 and 16), atol/rtol "
          f"{K4_TOL}, argmax equal, two calls bit-identical")

    # -- 7. golden-fixture walk of the fused head, on the card ---------------
    rows = goldens.pmg_head_fold_fixture_parity(FIXTURES, ["fused_bf16", "fused_q8"], device=dev)
    for variant, rs in rows.items():
        for name, agree, drift in rs:
            if not agree or drift > goldens.HEAD_FOLD_MAX_DRIFT:
                raise AssertionError(f"{variant} on {name}: argmax agrees {agree}, drift {drift}")
        print(f"[7] golden walk {variant}: {len(rs)} fixtures, argmax agrees, max drift "
              f"{max(r[2] for r in rs):.3e} (limit {goldens.HEAD_FOLD_MAX_DRIFT})")

    # -- 8. camera path ---------------------------------------------------------
    cam = np.random.RandomState(4).randint(0, 256, (CAMERA_FRAMES, 224, 224, 3), np.uint8)
    pred = stream.StreamPredictor("pmg", spec, params, use_kalman=True, trunk_kernel="fused",
                                  head_fold="fused_bf16")
    if (pred.route, pred.head_fold) != ("fused", "fused_bf16"):
        raise AssertionError(f"camera route is {pred.route}/{pred.head_fold}")
    ck.reset_launches()
    handles = [pred.submit(f) for f in cam]
    probs = np.stack([np.asarray(h) for h in handles])
    torch.cuda.synchronize()
    cam_launches = dict(ck.LAUNCHES)
    for name in ("fused_trunk_gram", "fused_head"):
        if cam_launches[name] == 0:
            raise AssertionError(f"camera path never launched the {name} kernel")
    # the smoothed rows sum to what the Kalman recursion makes of a constant 1
    state, sums = kalman.init_state(1, 1), []
    for _ in range(CAMERA_FRAMES):
        state, m = kalman.filter_update(state, torch.ones(1, 1))
        sums.append(float(m))
    mask = executor.class_mask(spec.tasks)
    if (probs.shape != (CAMERA_FRAMES, len(spec.tasks), spec.tasks.max_classes)
            or not np.allclose(probs.sum(-1), np.asarray(sums)[:, None], atol=1e-5)
            or np.abs(probs[:, ~mask]).max() != 0):
        raise AssertionError("camera probability rows do not sum to 1 over the real classes")
    cpu_params = checkpoint.to_device(params, "cpu")
    cpu_pred = stream.StreamPredictor("pmg", spec, cpu_params, use_kalman=True, trunk_kernel="fused",
                                      head_fold="fused_bf16", device="cpu")
    cam_err = max_err(torch.from_numpy(probs[:8]), torch.from_numpy(np.stack(
        [cpu_pred(f) for f in cam[:8]])), 1e-3, 1e-3, "camera probs vs the port's CPU path")
    packed = stream.StreamPredictor("pmg", spec, params, use_kalman=True, trunk_kernel="packed")
    ck.reset_launches()
    pk = np.stack([packed(f) for f in cam[:8]])
    torch.cuda.synchronize()
    packed_launches = dict(ck.LAUNCHES)
    for name in ("stem", "patch_gram"):
        if packed_launches[name] == 0:
            raise AssertionError(f"packed camera route never launched the {name} kernel")
    cpu_packed = stream.StreamPredictor("pmg", spec, cpu_params, use_kalman=True,
                                        trunk_kernel="packed", device="cpu")
    packed_err = max_err(torch.from_numpy(pk[:2]), torch.from_numpy(np.stack(
        [cpu_packed(f) for f in cam[:2]])), 2e-4, 2e-4, "packed camera probs vs the CPU path")
    print(f"[8] camera path fused+fused_bf16: {CAMERA_FRAMES} frames, launches {cam_launches}, "
          f"probs vs CPU max abs err {cam_err:.3e} (atol/rtol 1e-3); packed route: launches "
          f"{packed_launches}, vs CPU {packed_err:.3e} (2e-4)")

    # -- 9. camera times ---------------------------------------------------------
    b0, b1, b2 = spec.plan
    k1, k2, gc, div = b0.kernel, b1.kernel, spec.gram_channels, spec.patch_div
    hf = 224 // (k1 * k2)
    side = -(-hf // div)
    # weights the work needs: conv1's one diagonal block, not W0bd's zeros
    macs = (k2 * k2 * k1 * k1 * b0.cin * b0.cout + k2 * k2 * b0.cout * b1.cout
            + b1.cout * b2.cout + b2.cout * gc)
    weights = (k1 * k1 * b0.cin * b0.cout + k2 * k2 * b0.cout * b1.cout + b1.cout * b2.cout
               + b2.cout * gc)
    nbytes = x1.numel() + 2 * weights + 4 * (b0.cout + b1.cout + b2.cout + gc) + 4 * tokens1.numel()
    b_ms, b_by = bound_ms(nbytes, 2.0 * div * div * side * side * gc * gc,
                          bf16_flops=2.0 * hf * hf * macs)
    entries = [{
        "name": "fused_trunk_gram", "route": "cuda", "source": f"{PORT}/csrc/trunk_gram.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_kernels.py:309",
        "launches": cam_launches["fused_trunk_gram"], "max_abs_err": max(k3_err, rag_err),
        "ms": device_ms(lambda: ck.fused_trunk_gram(x1, trunk_w, spec)),
        "plain_ms": device_ms(lambda: ck.fused_trunk_gram_plain(x1, trunk_w, spec)),
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes a conv chain and a per-patch Gram
        "library_ms": None,
    }]
    if "wadt_trunk_gram_u8" in old:  # the archived K3 (one block per patch) in turns
        t_old = torch.empty_like(tokens1)
        old_ms, new_ms = in_turns(
            archived_call(old["wadt_trunk_gram_u8"], x1.data_ptr(), *(t.data_ptr() for t in trunk_w),
                          t_old.data_ptr(), 1, 224, 224, b0.cin, k1, k2, b0.cout, b1.cout, b2.cout, gc, div),
            lambda: ck.fused_trunk_gram(x1, trunk_w, spec))
        print(f"[9] fused_trunk_gram at batch 1 in turns: archived v1 {old_ms * 1e3:.1f} us, new "
              f"{new_ms * 1e3:.1f} us ({ck.trunk_gram_plan(spec, 224, 224).cluster} blocks a patch) | {card}")
    fb = folds["bf16"]
    d, npatch, din = spec.d_model, tokens1.shape[1], tokens1.shape[2]
    ff = fb["transformer"][0]["ffn1"]["w"].shape[1]
    ntask, kmax = fb["heads"]["b"].shape
    layer_flops = 2.0 * npatch * (4 * d * d + 2 * d * ff + 2 * npatch * d)
    head_flops = (spec.transformer_layers * layer_flops
                  + 2.0 * ntask * (2 * npatch * d + d * kmax))
    nbytes = 4 * tokens1.numel() + tree_nbytes(fb) + 4 * ntask * kmax
    b_ms, b_by = bound_ms(nbytes, head_flops, bf16_flops=2.0 * npatch * din * d)
    tok_bf16 = tokens1[0].to(torch.bfloat16)
    entries.append({
        "name": "fused_head", "route": "cuda", "source": f"{PORT}/csrc/head.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_kernels.py:477",
        "launches": cam_launches["fused_head"], "max_abs_err": k4_err,
        "ms": device_ms(lambda: ck.fused_head(tokens1, fb, spec)),
        "plain_ms": device_ms(lambda: ck.fused_head_plain(tokens1, fb, spec)),
        "bound_ms": b_ms, "bound_by": b_by,
        # partial yardstick: token_proj alone, bf16 [9, 9216] x [9216, 192];
        # leaves out the transformer, the pooling and the heads
        "library_ms": device_ms(lambda: torch.matmul(tok_bf16, fb["token_proj"]["w"])),
    })
    for k in entries:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.1f} us"
        print(f"[9] {k['name']} at batch 1: {k['ms'] * 1e3:.1f} us (bound {k['bound_ms'] * 1e3:.2f}"
              f" us by {k['bound_by']}), plain {k['plain_ms'] * 1e3:.1f} us, library {lib} | {card}")
    # launch 1 (token_proj partial sums) and launch 2 (the cluster) apart
    part = torch.empty((-(-din // 256), npatch, d), dtype=torch.float32, device=dev)
    out1 = torch.empty((1, ntask, kmax), dtype=torch.float32, device=dev)
    ck._fused_head_launch(tokens1, fb, spec, out=out1, partial=part)
    l1_ms = device_ms(lambda: ck._fused_head_launch(tokens1, fb, spec, stages=1, out=out1, partial=part))
    l2_ms = device_ms(lambda: ck._fused_head_launch(tokens1, fb, spec, stages=2, out=out1, partial=part))
    plan = ck.head_share_plan(npatch, d, ff, spec.transformer_heads, spec.transformer_layers, ntask, kmax)
    print(f"[9] fused_head at batch 1, launches apart: launch 1 {l1_ms * 1e3:.1f} us, launch 2 "
          f"{l2_ms * 1e3:.1f} us (clusters of {plan.cluster}, {plan.smem} bytes of shared memory a "
          f"block) | {card}")
    if "wadt_fused_head" in old:  # the archived K4 (launch 2 on one block per image) in turns
        old_ms, new_ms = in_turns(archived_head_call(old["wadt_fused_head"], tokens1, fb, spec),
                                  lambda: ck.fused_head(tokens1, fb, spec))
        print(f"[9] fused_head at batch 1 in turns: archived v2 {old_ms * 1e3:.1f} us, new "
              f"{new_ms * 1e3:.1f} us | {card}")
    if profile:  # the head kernel's time with the fold cut to its first n layers
        for n in range(len(fb["transformer"]) + 1):
            sub = dict(fb, transformer=fb["transformer"][:n])
            print(f"[9] fused_head with {n} of its layers: "
                  f"{device_ms(lambda: ck.fused_head(tokens1, sub, spec)) * 1e3:.1f} us | {card}")

    for trunk_kernel, head_fold in (("fused", "fused_bf16"), ("fused", "bf16"), ("packed", None)):
        kw = {"head_fold": head_fold} if head_fold else {}
        p = stream.StreamPredictor("pmg", spec, params, use_kalman=True,
                                   trunk_kernel=trunk_kernel, **kw)
        label = f"[9] camera step {trunk_kernel}+{head_fold}"
        route_latency(label, p, x1, cam, card)
        routes.append((label, p, x1))
    return entries


def random_rtm_params(spec, seed: int):
    """Seeded random RTM params of ``spec`` (float32 CPU tensors in the port's
    tree layout, drawn with numpy): He-scaled convolutions, non-trivial
    batch-norm statistics and a small scale on each residual branch's last
    norm, so that the 16 bottleneck blocks keep the activations finite."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import resnet

    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, shift=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale) + np.float32(shift)
        return torch.from_numpy(a)

    def conv(k, cin, cout):
        return {"w": t((k, k, cin, cout), (2.0 / (k * k * cin)) ** 0.5)}

    def bn(c, gain=1.0):
        return {"scale": t(c, 0.1 * gain, gain), "bias": t(c, 0.1), "mean": t(c, 0.1),
                "var": torch.from_numpy(rng.random(c, dtype=np.float32) + 0.5)}

    bb, cin = {"conv1": conv(7, 3, 64), "bn1": bn(64)}, 64
    for si, (nblocks, planes) in enumerate(resnet.STAGES):
        blocks, cout = [], planes * resnet.EXPANSION
        for bi in range(nblocks):
            blk = {"conv1": conv(1, cin, planes), "bn1": bn(planes),
                   "conv2": conv(3, planes, planes), "bn2": bn(planes),
                   "conv3": conv(1, planes, cout), "bn3": bn(cout, 0.2)}
            if bi == 0:
                blk["downsample"] = {"conv": conv(1, cin, cout), "bn": bn(cout)}
            blocks.append(blk)
            cin = cout
        bb[f"layer{si + 1}"] = blocks
    nt, kmax = len(spec.tasks), spec.tasks.max_classes
    c, d, dims = spec.num_features, spec.token_dim, spec.mlp_dims
    params = {"backbone": bb, "mlp": [
        {"w": t((nt, i, o), i ** -0.5), "b": t((nt, o), 0.1)} for i, o in zip(dims[:-1], dims[1:])]}
    if spec.use_attention:
        params["attn"] = {"proj_w": t((nt, c, d), c ** -0.5), "q": t((nt, d)),
                          "out_w": t((nt, d, c), d ** -0.5)}
    fw, fb = t((nt, dims[-1], kmax), dims[-1] ** -0.5), t((nt, kmax), 0.1)
    for i, k in enumerate(spec.tasks.num_classes):
        fw[i, :, k:] = 0.0
        fb[i, k:] = 0.0
    params["final"] = {"w": fw, "b": fb}
    return params


def k6_exhaustive(dev) -> str:
    """K6's dequantization over every int8 value, bit for bit against its
    plain version, in both modes and on both load paths.  x is 256 one-hot
    rows (row b selects c = b) and row c of w8 holds the int8 value c - 128
    in every column, so each y[b, 0, d] is the one exact product
    (b - 128) x scale[d], rounded as the mode rounds it.  The columns' scales
    are every finite bf16 bit pattern whose product with 128 stays finite
    (63,488 columns, subnormals and zeros included; bf16 mode), and those
    patterns with seeded random low 16 bits (float32 mode).  The byte-wise
    path runs on the first D - 8 columns (D % 16 == 8)."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    bits = np.arange(1 << 16, dtype=np.uint32)
    bits = bits[((bits >> 7) & 0xFF) <= 247]  # exponent <= 247: finite, and 128 x s finite
    low = np.random.RandomState(101).randint(0, 1 << 16, bits.size).astype(np.uint32)
    scales = {
        "bf16": torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16),
        "float32": torch.from_numpy((bits << 16 | low).view(np.float32).copy()),
    }
    d = bits.size
    w8 = torch.arange(-128, 128, dtype=torch.int8, device=dev)[None, :, None].expand(1, 256, d).contiguous()
    eye = torch.eye(256, device=dev)[:, None, :]
    rows = []
    for mode, sc in scales.items():
        dt = torch.bfloat16 if mode == "bf16" else torch.float32
        x, sc = eye.to(dt), sc.to(dev)[None]
        for path, n in (("16-byte", d), ("byte-wise", d - 8)):
            w, s = (w8, sc) if n == d else (w8[..., :n].contiguous(), sc[..., :n].contiguous())
            if ck.dequant_matvec_plan(256, 1, 256, n).vec16 != (n == d):
                raise AssertionError(f"dequant_matvec plan: D {n} takes the wrong path")
            got = ck.dequant_matvec(x, w, s)
            want = ck.dequant_matvec_plain(x, w, s)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[:4].tolist()
                raise AssertionError(f"dequant_matvec {mode} {path}: {int((got != want).sum())} of "
                                     f"{got.numel()} one-hot products differ from the plain version, "
                                     f"first at [b, t, d] {bad}")
            rows.append(f"{mode} {path} {got.numel():,}")
        del x, sc
    return ("dequant_matvec exhaustive dequantization, every int8 value x every finite bf16 scale "
            f"pattern ({d:,} columns; float32: with seeded low bits), one-hot x: bit for bit the plain "
            "version's products in " + ", ".join(rows))


def k6_turns(old: dict, name: str, xq, copies, card: str) -> str | None:
    """The archived K6 (``_archive/int8_matvec_v1.cu``, entry point
    ``name``) and the current one in turns (old, new, new, old), both
    reading the weights from device memory (``copies``: 4 rotating copies
    of (w8, scale)); None where the archive does not hold it."""
    import itertools

    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    if name not in old:
        return None
    b, t, c = xq.shape
    d = copies[0][0].shape[-1]
    y = torch.empty((b, t, d), dtype=torch.float32, device=xq.device)
    calls = [archived_call(old[name], xq.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), b, t, c, d)
             for w, s in copies]
    calls[0]()
    torch.cuda.synchronize()
    err = float((y - ck.dequant_matvec(xq, *copies[0])).abs().max())
    olds, ring = itertools.cycle(calls), itertools.cycle(copies)
    old_ms, new_ms = in_turns(lambda: next(olds)(), lambda: ck.dequant_matvec(xq, *next(ring)))
    return (f"dequant_matvec{' bf16 mode' if xq.dtype == torch.bfloat16 else ''} at [{b},{t},{c}] x "
            f"[{t},{c},{d}] in turns, L2 out of play: archived v1 {old_ms * 1e3:.1f} us, new "
            f"{new_ms * 1e3:.1f} us (max |new - v1| {err:.3e}) | {card}")


# K6's stage cut for --profile: each variant replaces these source lines of
# the archived v1 (where _archive/ holds it) or of the current kernel
K6_CUTS = {
    "int8_matvec_v1.cu": (
        ("loads only (each word XORed into a sum)", (
            ("    const float w = weight<BF16>(static_cast<signed char>(word >> (8 * e)), sc[base + e]);",
             "    const float w = 0.f;\n    if (e == 0) acc[0][base] = __int_as_float(__float_as_int(acc[0][base]) ^ word);"),
            ("    for (int j = 0; j < BT; ++j) acc[j][base + e] = fmaf(xs[j * C + c], w, acc[j][base + e]);",
             "    (void)w;"))),
        ("math only (register data, no loads)", (
            ("        v[u] = c < C ? __ldg(reinterpret_cast<const int4*>(wc + (size_t)c * D))\n"
             "                     : make_int4(0, 0, 0, 0);",
             "        v[u] = make_int4(c * 0x01010101 ^ col, c * 0x01030507 + r, c ^ 0x5a5a5a5a ^ col, "
             "c + r * 0x00010001);"),)),
    ),
    "int8_matvec.cu": (
        ("loads only (each row's 16 bytes XORed into a sum)", (
            ("      fma_row<BT, BF16>(acc, xv, sc2, v);",
             "      acc[0][0] = __uint_as_float(__float_as_uint(acc[0][0]) ^ v.x ^ v.y ^ v.z ^ v.w);"),)),
        ("math only (register data, no weight copies)", (
            ("      const uint4 v = ring[(k % kStages) * kThreads + threadIdx.x];",
             "      const uint4 v = make_uint4(k * 0x01010101u ^ col, k * 0x01030507u + r, "
             "k ^ 0x5a5a5a5au ^ col, k + r * 0x00010001u);"),
            ("      if (s < ksteps) issue(s);", "      (void)issue;"),
            ("      if (k + kStages - 1 < ksteps) issue(k + kStages - 1);  // into the slot read at k - 1",
             ""))),
    ),
}


def k6_cuts(card: str) -> None:
    """``--profile``: K6 at the camera shape, L2 out of play, both modes,
    whole and with its loads or its math cut out (``K6_CUTS``), for the
    current kernel and the archived v1 where ``_archive/`` holds it.  Each
    variant is built alone into ``_archive/k6_cuts/`` (one nvcc a variant,
    all started together)."""
    import ctypes
    import itertools

    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    sources = {"int8_matvec.cu": os.path.join(ck._CSRC, "int8_matvec.cu"),
               "int8_matvec_v1.cu": os.path.join(ARCHIVE, "int8_matvec_v1.cu")}
    out = os.path.join(ARCHIVE, "k6_cuts")
    os.makedirs(out, exist_ok=True)
    variants = []  # (source, label, .cu path)
    for src, path in sources.items():
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            text = f.read()
        for i, (label, subs) in enumerate((("whole", ()),) + K6_CUTS[src]):
            cut = text
            for a, b in subs:
                if cut.count(a) != 1:
                    raise AssertionError(f"K6 cut {label!r} of {src}: the line {a!r} is not in it once")
                cut = cut.replace(a, b)
            cu = os.path.join(out, f"{src[:-3]}_{i}.cu")
            with open(cu, "w") as f:
                f.write(cut)
            variants.append((src, label, cu))
    nvcc = ck._nvcc()
    ck._run_all([[nvcc, *ck._NVCC_FLAGS, "-shared", cu, "-o", cu[:-3] + ".so"] for _, _, cu in variants],
                "nvcc (K6 cuts)")
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(15)
    t, c, d = 12, 2048, 2048
    x = torch.from_numpy(rng.randn(1, t, c).astype(np.float32)).to(dev)
    w8 = torch.from_numpy(rng.randint(-127, 128, (t, c, d)).astype(np.int8)).to(dev)
    sc = torch.from_numpy((rng.rand(t, d).astype(np.float32) + 0.5) * 1e-3).to(dev)
    y = torch.empty((1, t, d), dtype=torch.float32, device=dev)
    plan = ck.dequant_matvec_plan(1, t, c, d)
    copies = [(w8.clone(), sc.clone(), sc.to(torch.bfloat16)) for _ in range(4)]
    rows = []
    for src, label, cu in variants:
        lib = ctypes.CDLL(os.path.abspath(cu[:-3] + ".so"))
        for mode, xm in (("float32", x), ("bf16", x.to(torch.bfloat16))):
            fn = getattr(lib, "wadt_dequant_matvec" + ("_bf16" if mode == "bf16" else ""))
            extra = () if src.endswith("_v1.cu") else (plan.group, plan.stages, plan.smem)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (4 + len(extra)) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            calls = itertools.cycle([archived_call(fn, xm.data_ptr(), w.data_ptr(),
                                                   (s16 if mode == "bf16" else s).data_ptr(), y.data_ptr(),
                                                   1, t, c, d, *extra) for w, s, s16 in copies])
            rows.append(f"{src} {mode} {label} {device_ms(lambda: next(calls)()) * 1e3:.1f} us")
    print(f"[13] K6 stage cut at [1,{t},{c}] x [{t},{c},{d}], L2 out of play: " + "; ".join(rows)
          + f" | {card}")


def rtm_phases(profile: bool, card: str, routes: list, old: dict) -> tuple:
    """Phases 10-13 (the RTM family) at full width; returns K6's entry of
    the kernels line and phase 12's float32 run (spec, params, frames,
    results, wall time) for phase 17, and appends each timed camera route
    to ``routes``."""
    import itertools

    import numpy as np
    import torch

    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint, executor,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import rtm
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, kalman,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import goldens
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import stream

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(10)

    # -- 10. K6 against its plain version, on the card ----------------------
    def k6_case(b, t, c, d):
        x = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).to(dev)
        w8 = torch.from_numpy(rng.randint(-127, 128, (t, c, d)).astype(np.int8)).to(dev)
        scale = torch.from_numpy((rng.rand(t, d).astype(np.float32) + 0.5) * 1e-3).to(dev)
        return x, w8, scale

    k6_err = k6_rel = k6_err16 = k6_rel16 = 0.0
    # full width at batch 1; the rtm_trunc5_attn fold (C 256) and its mlp_q8
    # layer (D 32); a shape that takes the byte-wise path and 4-row groups.
    # Both modes; two calls bit-identical.
    plans = []
    for shape in K6_SHAPES:
        x, w8, scale = k6_case(*shape)
        for x_, s_, what in ((x, scale, ""), (x.to(torch.bfloat16), scale.to(torch.bfloat16), " bf16")):
            got = ck.dequant_matvec(x_, w8, s_)
            again = ck.dequant_matvec(x_, w8, s_)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"dequant_matvec{what} {list(shape)}: two calls differ")
            want = ck.dequant_matvec_plain(x_, w8, s_)
            ymax = float(want.abs().max())
            err = max_err(got, want, K6_TOL * ymax, 0.0, f"dequant_matvec{what} {list(shape)}")
            if what:
                k6_err16, k6_rel16 = max(k6_err16, err), max(k6_rel16, err / ymax)
            else:
                k6_err, k6_rel = max(k6_err, err), max(k6_rel, err / ymax)
        p = ck.dequant_matvec_plan(*shape)
        plans.append(f"{list(shape)}: {'ring of ' + str(p.stages) if p.vec16 else 'byte-wise'}, "
                     f"group {p.group}, grid {p.grid}")
    print(f"[10] dequant_matvec vs plain: max abs err float32 {k6_err:.3e} = {k6_rel:.3e} x max|y|, bf16 "
          f"mode {k6_err16:.3e} = {k6_rel16:.3e} x max|y|, at [B,T,C,D] = "
          + "; ".join(plans) + f"; bound {K6_TOL} x max|y|; two calls bit-identical in both modes")
    print(f"[10] {k6_exhaustive(dev)}")

    # -- 11. RTM golden fixtures on the card ------------------------------------
    fix_err = 0.0
    for name in ("rtm_trunc5_attn", "rtm_trunc5_default_dim", "rtm_trunc6_gap"):
        with open(os.path.join(FIXTURES, f"{name}.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(FIXTURES, f"{name}.npz"))
        eng = port.load_engine("rtm", os.path.join(FIXTURES, f"{name}.pth"), meta["tasks"],
                               meta["hparams"], batch_size=2, device="cuda")
        xf = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))).to(dev)
        with torch.inference_mode():
            logits, _ = rtm.apply(eng.params, xf, eng.spec)
        for i, task in enumerate(eng.spec.tasks.names):
            want = torch.from_numpy(data[f"logits/{task}"]).to(dev)
            fix_err = max(fix_err, max_err(logits[:, i, : want.shape[1]], want, 2e-4, 2e-4,
                                           f"{name} fixture / {task}"))
    print(f"[11] RTM golden logits on the card (3 fixtures): max abs err {fix_err:.3e}, atol/rtol 2e-4")
    for q8 in (False, True):
        rows = goldens.rtm_stream_fixture_parity(FIXTURES, quantize_fold=q8, device=dev)
        if len(rows) != 2 or not all(agree for _, agree, _ in rows):
            raise AssertionError(f"RTM golden walk, {'q8' if q8 else 'f32'} fold: {rows}")
        print(f"[11] RTM golden walk, {'q8' if q8 else 'f32'} fold, apply_stream on the card: "
              f"argmax agrees on {len(rows)} fixtures, drift "
              + ", ".join(f"{n} {d:.3e}" for n, _, d in rows))

    # -- 12. RTM batch inference at full width ---------------------------------
    spec = rtm.build_spec(config.load_tasks(config.default_tasks_path()), {})
    params = random_rtm_params(spec, seed=12)
    eng = executor.Engine("rtm", spec, params, batch_size=RTM_BATCH, device="cuda")
    frames = np.random.RandomState(13).randint(0, 256, (RTM_FRAMES, 224, 224, 3), np.uint8)
    ck.reset_launches()
    out = eng.run(frames, collect=("probs", "preds", "logits"))
    torch.cuda.synchronize()
    mask = executor.class_mask(spec.tasks)
    check_probs(out, RTM_FRAMES, spec, "RTM batch")
    want = executor.Engine("rtm", spec, params, batch_size=2, device="cpu").run(
        frames[:2], collect=("logits",))["logits"]
    scale = float(np.abs(want).max())
    batch_err = max_err(torch.from_numpy(out["logits"][:2]), torch.from_numpy(want),
                        1e-3 * scale, 1e-3, "RTM batch logits vs the port's CPU path")
    xb = torch.from_numpy(frames[:RTM_BATCH]).to(dev)
    step_ms = device_ms(lambda: eng.step(xb), reps=5, rounds=3)
    wall, walls = run_wall(eng, frames)
    print(f"[12] RTM batch (ResNet-50 through layer4, C 2048, 12 tasks, d 2048, seeded weights): "
          f"{RTM_FRAMES} frames at batch {RTM_BATCH}, logits vs CPU on 2 frames max abs err "
          f"{batch_err:.3e} (max |logit| {scale:.3f}; atol 1e-3 x max, rtol 1e-3), launches "
          f"{dict(ck.LAUNCHES)} (the batch path runs no hand-written kernel), "
          f"preds[0] {out['preds'][0].tolist()}")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                eng.step(xb)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    print(f"[12] RTM engine step on a device-resident batch of {RTM_BATCH}: {step_ms:.3f} ms = "
          f"{RTM_BATCH / step_ms * 1e3:,.0f} img/s (device); Engine.run end to end on {RTM_FRAMES} "
          f"host frames: {RTM_FRAMES / wall:,.0f} img/s (median of 3: "
          f"{[round(w, 4) for w in walls]} s) | {card}")
    del eng
    rtm_f32 = {"spec": spec, "params": params, "frames": frames, "out": out, "wall": wall}

    # -- 13. RTM camera path at full width -------------------------------------
    cam = np.random.RandomState(14).randint(0, 256, (CAMERA_FRAMES, 224, 224, 3), np.uint8)
    gparams = checkpoint.to_device(params, dev)
    pred = stream.StreamPredictor("rtm", spec, gparams, use_kalman=True, trunk_kernel="folded_q8")
    if pred.route != "folded_q8":
        raise AssertionError(f"RTM camera route is {pred.route}")
    torch.cuda.synchronize()
    ck.reset_launches()
    handles = [pred.submit(f) for f in cam]
    probs = np.stack([np.asarray(h) for h in handles])
    torch.cuda.synchronize()
    cam_launches = dict(ck.LAUNCHES)
    if cam_launches["dequant_matvec"] != CAMERA_FRAMES:
        raise AssertionError(f"RTM camera path launched K6 {cam_launches['dequant_matvec']} "
                             f"times over {CAMERA_FRAMES} frames")
    state, sums = kalman.init_state(1, 1), []
    for _ in range(CAMERA_FRAMES):
        state, m = kalman.filter_update(state, torch.ones(1, 1))
        sums.append(float(m))
    if (probs.shape != (CAMERA_FRAMES, len(spec.tasks), spec.tasks.max_classes)
            or not np.allclose(probs.sum(-1), np.asarray(sums)[:, None], atol=1e-5)
            or np.abs(probs[:, ~mask]).max() != 0):
        raise AssertionError("RTM camera probability rows do not sum to 1 over the real classes")
    # the fold was built once, on the card; the CPU path reuses it
    cpu_pred = stream.StreamPredictor("rtm", spec, checkpoint.to_device(pred.params, "cpu"),
                                      use_kalman=True, trunk_kernel="folded_q8", device="cpu")
    cam_err = max_err(torch.from_numpy(probs[:8]), torch.from_numpy(np.stack(
        [cpu_pred(f) for f in cam[:8]])), 1e-3, 1e-3, "RTM camera probs vs the port's CPU path")
    del cpu_pred
    print(f"[13] RTM camera path folded_q8: {CAMERA_FRAMES} frames, launches {cam_launches}, "
          f"probs vs CPU on 8 frames max abs err {cam_err:.3e} (atol/rtol 1e-3)")

    x1 = torch.from_numpy(cam[:1]).to(dev)
    for route in ("generic", "folded", "folded_q8"):
        p = pred if route == "folded_q8" else stream.StreamPredictor(
            "rtm", spec, gparams, use_kalman=True, trunk_kernel=route)
        label = f"[13] RTM camera step {route}"
        route_latency(label, p, x1, cam, card)
        routes.append((label, p, x1))

    # K6 at batch 1, L2 out of play: the calls rotate through 4 copies of the
    # fold's weights (4 x 50.3 MB, four times the 50 MB L2), so each call
    # reads weights that 150 MB of other weights have passed since
    fold8, fscale = pred.params["attn_fold_q8"], pred.params["attn_fold_scale"]
    t, c, d = fold8.shape
    xq = torch.from_numpy(rng.randn(1, t, c).astype(np.float32)).to(dev)
    copies = [(fold8.clone(), fscale.clone()) for _ in range(4)]
    ring = itertools.cycle(copies)
    ring_plain = itertools.cycle(copies)
    k6_ms = device_ms(lambda: ck.dequant_matvec(xq, *next(ring)))
    plain_ms = device_ms(lambda: ck.dequant_matvec_plain(xq, *next(ring_plain)))
    turns = k6_turns(old, "wadt_dequant_matvec", xq, copies, card)
    # partial yardstick: one torch.bmm on the float32-dequantized fold, which
    # reads 4x the bytes (201 MB, four times the L2 on its own)
    deq = (fold8.float() * fscale[:, None, :]).contiguous()
    xt = xq[0][:, None, :].contiguous()
    lib_ms = device_ms(lambda: torch.bmm(xt, deq))
    del copies, deq
    try:  # PyTorch's int8 weight-only product, one call per task
        w_nk = [fold8[i].t().contiguous() for i in range(t)]

        def int8pack_all():
            for i in range(t):
                torch._weight_int8pack_mm(xq[0, i:i + 1], w_nk[i], fscale[i])

        int8pack_all()
        torch.cuda.synchronize()
        int8pack = f"{device_ms(int8pack_all) * 1e3:.1f} us for {t} calls (L2 warm)"
        del w_nk
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        int8pack = f"not available on this card's torch ({type(e).__name__}: {str(e).splitlines()[0][:120]})"
    nbytes = xq.numel() * 4 + fold8.numel() + fscale.numel() * 4 + t * d * 4
    b_ms, b_by = bound_ms(nbytes, 2.0 * t * c * d)
    print(f"[13] dequant_matvec at batch 1 [1,{t},{c}] x [{t},{c},{d}] int8, L2 out of play "
          f"(4 rotating weight copies): {k6_ms * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}), "
          f"plain {plain_ms * 1e3:.1f} us, torch.bmm on the float32-dequantized fold "
          f"{lib_ms * 1e3:.1f} us (partial yardstick, 4x the bytes); torch._weight_int8pack_mm: "
          f"{int8pack} | {card}")
    if turns:
        print(f"[13] {turns}")
    if profile:
        k6_cuts(card)
    return {
        "name": "dequant_matvec", "route": "cuda", "source": f"{PORT}/csrc/int8_matvec.cu",
        "replaces": "tools/exp_rtm_int8_stream.py:77",
        "launches": cam_launches["dequant_matvec"], "max_abs_err": k6_err,
        "ms": k6_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    }, rtm_f32


def check_probs(out, n: int, spec, what: str) -> None:
    """Finite logits, and probability rows that sum to 1 over each task's
    real classes."""
    import numpy as np

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor

    mask = executor.class_mask(spec.tasks)
    probs = out["probs"]
    if (probs.shape != (n, len(spec.tasks), spec.tasks.max_classes)
            or not np.isfinite(out["logits"]).all()
            or not np.allclose(probs.sum(-1), 1.0, atol=1e-5) or np.abs(probs[:, ~mask]).max() != 0):
        raise AssertionError(f"{what}: probabilities are not finite rows summing to 1")


def agreement(a, b):
    """(share of (frame, task) pairs whose argmax agrees, max probability
    difference) between two runs' probabilities."""
    import numpy as np

    return float((a.argmax(-1) == b.argmax(-1)).mean()), float(np.abs(a - b).max())


def k1_yardsticks(z, div: int) -> dict:
    """Device times (ms) of K1's library yardsticks on NHWC ``z``: one
    ``torch.baddbmm`` of the split patches (P^T P times 1/area, the whole
    arithmetic), ``torch.bmm`` (P^T P), and the ``split_patches`` copy
    (replicate pad and split) that both need first."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import gram

    patches, area = gram.split_patches(z, div)
    p = patches.reshape(-1, area, z.shape[-1])
    pt = p.transpose(1, 2)
    out = torch.empty((p.shape[0], z.shape[-1], z.shape[-1]), dtype=z.dtype, device=z.device)
    return {
        "baddbmm": device_ms(lambda: torch.baddbmm(out, pt, p, beta=0, alpha=1.0 / area)),
        "bmm": device_ms(lambda: torch.bmm(pt, p)),
        "split": device_ms(lambda: gram.split_patches(z, div)),
    }


# csrc/patch_gram.cu's bf16 epilogue, cut stage by stage for --profile: each
# cut replaces these source lines (and keeps the cuts before it)
K1_CUTS = (
    ("the certificate's sequential recomputations",
     (("if (b0 + lane < total) {", "if (false) {"),)),
    ("the certificate",
     (("if (d & 0xffffu) redo |= 1u << (k * 8 + e);", ";"),
      ("if ((d >> 16) && j + 1 < C) redo |= 1u << (k * 8 + e + 1);", ";"))),
    ("the tensor-core products", (("const int ksteps = up(nn, 16) / 16;", "const int ksteps = 0;"),)),
)


def k1_bf16_cuts(z16, div: int, card: str) -> None:
    """``--profile``: K1 in bf16 on ``z16`` with its work cut stage by stage
    (each cut a copy of ``csrc/patch_gram.cu`` built into the gitignored
    ``csrc/_build/cuts/``; the outputs of a cut kernel are not checked):
    what the recomputations, the certificate and the products each cost."""
    import ctypes

    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    src = open(os.path.join(ck._CSRC, "patch_gram.cu")).read()
    out = os.path.join(ck._BUILD, "cuts")
    os.makedirs(out, exist_ok=True)
    nvcc = ck._nvcc()
    flags = [f for f in ck._NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmds, sos = [], []
    for n, (label, subs) in enumerate(K1_CUTS):
        for old, new in subs:
            if old not in src:
                raise AssertionError(f"K1 cut {label!r}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        cu, so = os.path.join(out, f"cut{n}.cu"), os.path.join(out, f"cut{n}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmds.append([nvcc, *flags, "-shared", cu, "-o", so])
        sos.append((label, so))
    ck._run_all(cmds, "nvcc (K1 cuts)")
    b, h, w, c = z16.shape
    plan = ck.patch_gram_plan(b, h, w, c, div, ck._sm_count(z16.device), True)
    g = torch.empty((b, div * div, c * c), dtype=torch.bfloat16, device=z16.device)
    times = [("whole", device_ms(lambda: ck.patch_gram(z16, div)))]
    for label, so in sos:
        fn = ctypes.CDLL(os.path.abspath(so)).wadt_patch_gram_bf16
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        times.append((f"without {label}", device_ms(archived_call(
            fn, z16.data_ptr(), g.data_ptr(), b, h, w, c, div, plan.kc, plan.band, plan.grid))))
    print("[14] patch_gram bf16 with its work cut stage by stage (each cut keeps the earlier ones): "
          + ", ".join(f"{label} {ms * 1e3:.1f} us" for label, ms in times) + f" | {card}")


# csrc/stem.cu cut stage by stage for --profile: each cut replaces these
# source lines (and keeps the cuts before it)
K2_CUTS = (
    ("the epilogue arithmetic", (
        ("out[h][j][0] = finish_bf16(a, acc[j][2 * h], acc[j][2 * h + 1], bias, sc, sh);",
         "out[h][j][0] = __float_as_uint(acc[j][2 * h]);"),
        ("const float2 y = finish_f32(a, acc[j][2 * h], acc[j][2 * h + 1], sc, sh);",
         "const float2 y = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);"))),
    ("the products", (("for (int ks = 0; ks < kKS; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {"),)),
    ("the stores", (("if (a.tma && m * 16 + 16 <= npx) {", "if (false) {"),
                    ("if (p >= npx) continue;", "continue;"))),
)


def k2_cuts(x8, wf, s, shift, wb, bias, s16, t16, card: str) -> None:
    """``--profile``: K2 in both modes at [256,224,224,3] -> 32 with its work
    cut stage by stage (each cut a copy of ``csrc/stem.cu`` built into the
    gitignored ``csrc/_build/cuts/``; the outputs of a cut kernel are not
    checked): whole; loads, products and stores; loads and stores only;
    loads only."""
    import ctypes

    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    src = open(os.path.join(ck._CSRC, "stem.cu")).read()
    out = os.path.join(ck._BUILD, "cuts")
    os.makedirs(out, exist_ok=True)
    nvcc = ck._nvcc()
    flags = [f for f in ck._NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmds, sos = [], []
    for n, (label, subs) in enumerate(K2_CUTS):
        for old, new in subs:
            if old not in src:
                raise AssertionError(f"K2 cut {label!r}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        cu, so = os.path.join(out, f"stem_cut{n}.cu"), os.path.join(out, f"stem_cut{n}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmds.append([nvcc, *flags, "-shared", cu, "-o", so])
        sos.append((label, so))
    ck._run_all(cmds, "nvcc (K2 cuts)")
    dev = x8.device
    b, h, w, cin = x8.shape
    lib = ck.build()
    for bf16 in (False, True):
        plan = ck.stem_plan(b, h, w, cin, 4, 32, ck._sm_count(dev), True, bf16)
        y = torch.empty((b, h // 4, w // 4, 32), dtype=torch.bfloat16 if bf16 else torch.float32, device=dev)
        ptrs = ((x8.data_ptr(), wb.data_ptr(), s16.data_ptr(), t16.data_ptr(), bias.data_ptr())
                if bf16 else (x8.data_ptr(), wf.data_ptr(), s.data_ptr(), shift.data_ptr(), None))
        rest = (b, h, w, cin, 4, 32, 2 if bf16 else 0, 1, plan.rows, plan.stages, plan.grid,
                int(plan.bulk), int(plan.tma))
        times = [("whole", device_ms(archived_call(lib.wadt_stem_u8, *ptrs, y.data_ptr(), *rest)))]
        for label, so in sos:
            fn = ctypes.CDLL(os.path.abspath(so)).wadt_stem_u8
            fn.argtypes = lib.wadt_stem_u8.argtypes
            fn.restype = ctypes.c_int
            times.append((f"without {label}", device_ms(archived_call(fn, *ptrs, y.data_ptr(), *rest))))
        print(f"[5] stem {'bf16' if bf16 else 'float32'} with its work cut stage by stage (each cut keeps "
              "the earlier ones): " + ", ".join(f"{label} {ms * 1e3:.1f} us" for label, ms in times)
              + f" | {card}")


def in_turns(fn_a, fn_b, **kw):
    """Device times of two functions measured in turns a, b, b, a; the
    median of each one's two."""
    a1 = device_ms(fn_a, **kw)
    b1 = device_ms(fn_b, **kw)
    b2 = device_ms(fn_b, **kw)
    a2 = device_ms(fn_a, **kw)
    return (a1 + a2) / 2, (b1 + b2) / 2


def run_wall(eng, frames):
    """(median, all) of 3 host-clock times of ``eng.run(frames)`` after a
    warm-up batch."""
    import torch

    eng.run(frames[: eng.batch_size])
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(frames)
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def pmg_bf16_phases(card: str, eng32, frames, out32, big, wall32: float, profile: bool,
                    old: dict) -> dict:
    """Phases 14-15: K5 against its plain version and timed, then the PMG
    bf16 batch path on the shipped checkpoint; returns the bf16 run's
    launch counts and K5's entry of the kernels line."""
    import itertools

    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, nn,
    )

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    spec = eng32.spec
    rng = np.random.RandomState(20)
    eng16 = executor.Engine("pmg", spec, eng32.params, batch_size=BATCH, dtype=bf16)

    # -- 14. K5 against its plain version, on the card ----------------------
    tp = eng16._run_params["token_proj"]
    w16, b32 = tp["w"], tp["b"].float()
    z16 = torch.from_numpy(rng.randn(BATCH, 14, 14, spec.gram_channels).astype(np.float32)).to(dev).to(bf16)
    g16 = ck.patch_gram(z16, spec.patch_div)  # the main path's bf16 Gram, [256, 9, 9216]
    torch.cuda.synchronize()
    # bf16 out: one rounding of float32 sums taken in another order, so the
    # two may differ by one bf16 ulp (2^-8 of the value) and by no more
    k1_err = max_err(g16.float(), ck.patch_gram_plain(z16, spec.patch_div).float(), 0.0, 2 ** -8,
                     f"patch_gram bf16 {list(z16.shape)} div {spec.patch_div}")
    # ragged: C % 8 != 0 takes scalar loads (C % 4 != 0 scalar stores too)
    k1_rag = 0.0
    for shape in ((2, 7, 5, 12), (2, 7, 5, 18)):
        zr = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev).to(bf16)
        k1_rag = max(k1_rag, max_err(ck.patch_gram(zr, 2).float(), ck.patch_gram_plain(zr, 2).float(),
                                     0.0, 2 ** -8, f"patch_gram bf16 {list(shape)} div 2"))
    if not torch.equal(ck.patch_gram(z16, spec.patch_div), g16):
        raise AssertionError("patch_gram bf16: two calls on the same inputs differ")
    k1_ms = device_ms(lambda: ck.patch_gram(z16, spec.patch_div))
    k1_bound, k1_by = bound_ms(2 * (z16.numel() + g16.numel()), 0.0,
                               bf16_flops=2.0 * BATCH * spec.patch_div ** 2 * 25 * spec.gram_channels ** 2)
    yard = k1_yardsticks(z16, spec.patch_div)
    print(f"[14] patch_gram in bf16 (bf16 in and out, float32 sums) vs plain: max abs err {k1_err:.3e} "
          f"at [{BATCH},14,14,{spec.gram_channels}] div {spec.patch_div}, {k1_rag:.3e} at [2,7,5,12] and "
          f"[2,7,5,18] div 2 (atol 0, rtol 2^-8), two calls bit-identical; {k1_ms * 1e3:.1f} us (bound "
          f"{k1_bound * 1e3:.1f} us by {k1_by}); yardsticks in bf16 on the split patches: torch.baddbmm "
          f"(P^T P / area) {yard['baddbmm'] * 1e3:.1f} us, torch.bmm {yard['bmm'] * 1e3:.1f} us; the "
          f"split_patches copy they need {yard['split'] * 1e3:.1f} us | {card}")
    if "wadt_patch_gram_bf16" in old:  # the archived K1 in bf16 (one block per patch) in turns
        g_old = torch.empty_like(g16)
        old_ms, new_ms = in_turns(
            archived_call(old["wadt_patch_gram_bf16"], z16.data_ptr(), g_old.data_ptr(), BATCH, 14, 14,
                          spec.gram_channels, spec.patch_div),
            lambda: ck.patch_gram(z16, spec.patch_div))
        print(f"[14] patch_gram bf16 in turns: archived v1 {old_ms * 1e3:.1f} us, new {new_ms * 1e3:.1f} us"
              f" | {card}")
    if profile:
        k1_bf16_cuts(z16, spec.patch_div, card)
    # K2 as the bf16 path runs it: the bf16 mode on the engine's own fold
    # (the bf16-rounded weight, the float32 bias, the batch norm's bf16
    # affine), limits (a) and (b) of phase 2
    x8 = torch.from_numpy(frames[:BATCH]).to(dev)
    st = eng16._stem
    k2 = stem_bf16_check(x8, st["w"], st["bias"], st["scale"], st["shift"], f"{list(x8.shape)} engine fold")
    print(f"[14] stem bf16 mode on the engine's fold at {list(x8.shape)} ({k2['path']}): the norm and "
          f"LeakyReLU equal the bf16 chain on the kernel's own sum bit for bit; the sum within one bf16 "
          f"ulp of the plain version's, {k2['share'] * 100:.4f} % of outputs differ (limit 1 %)")
    # bf16 linear (one cuBLAS call with the bias) at the path's shapes: the
    # float32 product plus bias, rounded once, within one bf16 ulp beyond
    # what float32 sums in another order may differ by (K * 2^-24 of the
    # sum of |terms|; it matters only where the terms cancel).  A bf16
    # reduction of partial sums would be off by ~2^-9 of them.
    lin_ulps = 0.0
    rp = eng16._run_params
    cases = [(rng.randn(BATCH, 14, 14, spec.trunk_channels),
              {"w": rp["chan_proj"]["w"].reshape(spec.trunk_channels, spec.gram_channels)})]
    for lp in rp.get("transformer", [])[:1]:
        cases += [(rng.randn(BATCH, spec.patch_div ** 2, spec.d_model), lp["ffn1"]),
                  (rng.randn(BATCH, spec.patch_div ** 2, 2 * spec.d_model), lp["ffn2"])]
    for xa, lp in cases:
        xl = torch.from_numpy(xa.astype(np.float32)).to(dev).to(bf16)
        want = torch.matmul(xl.float(), lp["w"].float())
        want = (want if lp.get("b") is None else want + lp["b"].float()).to(bf16).float()
        got = nn.linear(xl, lp).float()
        slack = xl.shape[-1] * 2.0 ** -24 * torch.matmul(xl.float().abs(), lp["w"].float().abs())
        mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
        ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
        ulps = float((((got - want).abs() - slack).clamp_min(0.0) / ulp).max())
        if ulps > 1.0:
            raise AssertionError(f"bf16 linear {list(xl.shape)} x {list(lp['w'].shape)}: {ulps} bf16 ulps off")
        lin_ulps = max(lin_ulps, ulps)
    print(f"[14] bf16 linear on the card (chan_proj, ffn1, ffn2 at batch {BATCH}) vs the float32 product "
          f"plus bias rounded once: at most {lin_ulps:.2f} bf16 ulp beyond the float32 order allowance "
          f"(bound 1)")
    y = ck.gram_proj(g16, w16, b32)
    torch.cuda.synchronize()
    want = ck.gram_proj_plain(g16, w16, b32)
    ymax = float(want.abs().max())
    k5_err = max_err(y, want, K5_TOL * ymax, 0.0, f"gram_proj {list(g16.shape)} x {list(w16.shape)}")
    k5_rel = k5_err / ymax
    if not torch.equal(ck.gram_proj(g16, w16, b32), y):
        raise AssertionError("gram_proj: two calls on the same inputs differ")
    # bf16 out, as the bf16 path calls it: the float32 sum plus bias rounded
    # once, within one bf16 ulp (2^-7 of the value) of the plain version's
    # rounding of its own float32 sum (K5_TOL x max|y| near zero)
    y16 = ck.gram_proj(g16, w16, b32, torch.bfloat16)
    torch.cuda.synchronize()
    k5_bf16 = max_err(y16.float(), ck.gram_proj_plain(g16, w16, b32, torch.bfloat16).float(),
                      K5_TOL * ymax, 2 ** -7, "gram_proj bf16 out")
    # every tile width (64: N 32, 40, 64; 128: N 72; 256: N 256 and two
    # 256-wide tiles for N 320), ragged M, and K tails (296, 264)
    for (bsz, npatch, k, n) in ((2, 9, 256, 32), (3, 16, 1024, 64), (2, 9, 296, 40),
                                (3, 7, 264, 72), (2, 9, 264, 256), (2, 9, 384, 320)):
        gr = torch.from_numpy(rng.randn(bsz, npatch, k).astype(np.float32)).to(dev).to(bf16)
        wr = torch.from_numpy(rng.randn(k, n).astype(np.float32) * k ** -0.5).to(dev).to(bf16)
        br = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
        got = ck.gram_proj(gr, wr, br)
        torch.cuda.synchronize()
        wr_want = ck.gram_proj_plain(gr, wr, br)
        rmax = float(wr_want.abs().max())
        err = max_err(got, wr_want, K5_TOL * rmax, 0.0, f"gram_proj ragged [{bsz},{npatch},{k}] x [{k},{n}]")
        k5_err, k5_rel = max(k5_err, err), max(k5_rel, err / rmax)
    print(f"[14] gram_proj vs plain: max abs err {k5_err:.3e}, {k5_rel:.3e} x max|y| (bound {K5_TOL} x "
          f"max|y|), at [M,K,N] = [{g16.shape[0] * g16.shape[1]},{g16.shape[2]},{w16.shape[1]}] "
          f"({ck.gram_proj_plan(g16.shape[0] * g16.shape[1], w16.shape[1], g16.shape[2], ck._sm_count(dev))}), "
          f"[18,256,32], [48,1024,64], [18,296,40], [21,264,72], [18,264,256], [18,384,320]; two calls "
          f"bit-identical; bf16 out {k5_bf16:.3e} (one bf16 ulp)")
    # timed with G read from device memory: 4 rotating copies, 170 MB, over
    # three times the 50 MB L2; W (3.5 MB) stays in L2 as it does between batches
    copies = [g16.clone() for _ in range(4)]
    rings = [itertools.cycle(copies) for _ in range(4)]
    k5_ms = device_ms(lambda: ck.gram_proj(next(rings[0]), w16, b32))
    plain_ms = device_ms(lambda: ck.gram_proj_plain(next(rings[1]), w16, b32))
    m, k = g16.shape[0] * g16.shape[1], g16.shape[2]
    # the library call that computes K5's function: torch.addmm of the bf16
    # operands and the bias in bf16, float32 sums (split-K reductions in
    # bf16 are off: enable_parity_precision), the bias added, one rounding;
    # held to the plain version's bf16 output within K5's bf16-out limit.
    # torch.matmul (no bias) is the earlier yardstick, printed beside it.
    b16 = b32.to(bf16)
    y_mm = torch.addmm(b16, g16.reshape(m, k), w16).reshape(y16.shape)
    torch.cuda.synchronize()
    addmm_err = max_err(y_mm.float(), ck.gram_proj_plain(g16, w16, b32, torch.bfloat16).float(),
                        K5_TOL * ymax, 2 ** -7, "torch.addmm bf16 (K5's function) vs gram_proj plain")
    lib_ms = device_ms(lambda: torch.addmm(b16, next(rings[2]).reshape(m, k), w16))
    mm_ms = device_ms(lambda: torch.matmul(next(rings[3]), w16))
    if "wadt_gram_proj_bf16" in old:  # the archived K5 (wmma, split K through device memory) in turns
        n = w16.shape[1]
        splits = 10
        part = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
        out_old = torch.empty((m, n), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ring_old = itertools.cycle(copies)
        old_ms, new_ms = in_turns(
            lambda: old["wadt_gram_proj_bf16"](next(ring_old).data_ptr(), w16.data_ptr(), b32.data_ptr(),
                                            out_old.data_ptr(), part.data_ptr(), m, n, k, splits, stream),
            lambda: ck.gram_proj(next(rings[0]), w16, b32))
        print(f"[14] gram_proj in turns, G from device memory: archived v2 {old_ms * 1e3:.1f} us, new "
              f"{new_ms * 1e3:.1f} us | {card}")
    t0 = time.perf_counter()
    for _ in range(100):
        ck.gram_proj(g16, w16, b32)
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    del copies
    n = w16.shape[1]
    nbytes = 2 * g16.numel() + 2 * w16.numel() + 4 * n + 4 * m * n
    b_ms, b_by = bound_ms(nbytes, 0.0, bf16_flops=2.0 * m * k * n)
    print(f"[14] gram_proj at batch {BATCH} [{m},{k}] x [{k},{n}] bf16, G from device memory: "
          f"{k5_ms * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}), plain {plain_ms * 1e3:.1f} us, "
          f"torch.addmm bf16 with the bias (K5's function, bf16 out; vs plain {addmm_err:.3e}, limit "
          f"{K5_TOL} x max|y| + one bf16 ulp) {lib_ms * 1e3:.1f} us, torch.matmul bf16 (no bias) "
          f"{mm_ms * 1e3:.1f} us; host time of one wrapper call (tensor maps encoded, launch "
          f"enqueued) {host_us:.1f} us | {card}")

    # -- 15. PMG bf16 batch ----------------------------------------------------
    ck.reset_launches()
    out16 = eng16.run(frames, collect=("probs", "preds", "logits"))
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    for name in ("gram_proj", "patch_gram", "stem"):
        if launches[name] == 0:
            raise AssertionError(f"PMG bf16 path never launched the {name} kernel")
    check_probs(out16, len(frames), spec, "PMG bf16 batch")
    agree, drift = agreement(out16["probs"], out32["probs"])
    top2 = np.sort(out32["probs"], axis=-1)
    decisive = top2[..., -1] - top2[..., -2] > 0.1
    if (drift > 0.05 or agree < BF16_PMG_AGREEMENT
            or not (out16["probs"].argmax(-1) == out32["probs"].argmax(-1))[decisive].all()):
        raise AssertionError(f"PMG bf16 vs float32: drift {drift}, argmax agreement {agree}")
    with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(FIXTURES, "pmg_shipped.npz"))
    xf = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))).to(dev)
    with torch.inference_mode():
        logits, _ = pmg.apply(eng16._run_params, xf.to(bf16), spec)
    logits = logits.float().cpu().numpy()
    fix_drift, fix_agree = 0.0, True
    for i, task in enumerate(spec.tasks.names):
        ref = data[f"logits/{task}"]
        got = logits[:, i, : ref.shape[1]]
        fix_drift = max(fix_drift, float(np.abs(got - ref).max()))
        r2 = np.sort(ref, axis=-1)
        dec = r2[:, -1] - r2[:, -2] > 2 * BF16_FIXTURE_DRIFT
        fix_agree &= bool((got.argmax(-1) == ref.argmax(-1))[dec].all())
    if fix_drift > BF16_FIXTURE_DRIFT or not fix_agree:
        raise AssertionError(f"pmg_shipped in bf16: drift {fix_drift}, argmax agrees {fix_agree}")
    print(f"[15] PMG bf16 batch: {len(frames)} frames at batch {BATCH}, launches {launches}; vs the "
          f"float32 run argmax agrees on {agree:.4f} of (frame, task) pairs, max prob drift {drift:.3e}; "
          f"pmg_shipped fixture in bf16: max logit drift {fix_drift:.3e} (limit {BF16_FIXTURE_DRIFT}), "
          f"argmax agrees on decisive samples")
    xb = torch.from_numpy(frames[:BATCH]).to(dev)
    # one step at a time behind the sleep: ten queued bf16 steps (~190
    # launches each) fill the launch queue, and the host's pace leaks in
    step32, step16 = in_turns(lambda: eng32.step(xb), lambda: eng16.step(xb), reps=1, rounds=10)
    enqueue = {label: enqueue_ms(lambda e=e: e.step(xb), reps=10) / 1e3
               for label, e in (("float32", eng32), ("bf16", eng16))}
    wall16, _ = run_wall(eng16, big)
    print(f"[15] engine step on a device-resident batch of {BATCH}, in turns: float32 {step32:.3f} ms "
          f"= {BATCH / step32 * 1e3:,.0f} img/s, bf16 {step16:.3f} ms = {BATCH / step16 * 1e3:,.0f} img/s "
          f"(device); host enqueue of one step: float32 {enqueue['float32'] * 1e3:.3f} ms, bf16 "
          f"{enqueue['bf16'] * 1e3:.3f} ms; Engine.run end to end on {len(big)} host frames: bf16 "
          f"{len(big) / wall16:,.0f} img/s, float32 (phase 5) {len(big) / wall32:,.0f} img/s | {card}")
    if profile:
        profile_step(f"[15] PMG float32 step at batch {BATCH}", lambda: eng32.step(xb), steps=5)
        profile_step(f"[15] PMG bf16 step at batch {BATCH}", lambda: eng16.step(xb), steps=5)
    del eng16
    return launches, {
        "name": "gram_proj", "route": "cuda", "source": f"{PORT}/csrc/gram_proj.cu",
        "replaces": "tools/exp_pmg_projkernel.py:65",
        "launches": launches["gram_proj"], "max_abs_err": k5_err,
        "ms": k5_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    }


def pm_phase(card: str, profile: bool) -> None:
    """Phase 16: the PM family on the card."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint, executor,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pm

    dev = torch.device("cuda", 0)
    fix_err = attn_err = emb_err = 0.0
    names = ("pm_ablate", "pm_batchnorm_sigmoid", "pm_deep_plan", "pm_no_se", "pm_small")
    for name in names:
        with open(os.path.join(FIXTURES, f"{name}.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(FIXTURES, f"{name}.npz"))
        spec = pm.build_spec(meta["tasks"], meta["hparams"])
        params = checkpoint.to_device(
            checkpoint.load_torch_checkpoint("pm", os.path.join(FIXTURES, f"{name}.pth"), spec), dev)
        xf = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))).to(dev)
        with torch.inference_mode():
            logits, aux = pm.apply(params, xf, spec, capture=("attn", "task_embeddings"))
        for i, task in enumerate(spec.tasks.names):
            want = torch.from_numpy(data[f"logits/{task}"]).to(dev)
            fix_err = max(fix_err, max_err(logits[:, i, : want.shape[1]], want, 2e-4, 2e-4,
                                           f"{name} fixture / {task}"))
            if name == "pm_small":
                attn_err = max(attn_err, max_err(aux["attn"][:, i], torch.from_numpy(
                    data[f"attn/{task}"][:, 0]).to(dev), 2e-4, 2e-4, f"pm_small attn / {task}"))
                emb_err = max(emb_err, max_err(aux["task_embeddings"][:, i], torch.from_numpy(
                    data[f"task_emb/{task}"]).to(dev), 2e-3, 2e-3, f"pm_small task_emb / {task}"))
    print(f"[16] PM golden logits on the card ({len(names)} fixtures): max abs err {fix_err:.3e} "
          f"(atol/rtol 2e-4); pm_small attention {attn_err:.3e} (2e-4), task embeddings "
          f"{emb_err:.3e} (2e-3)")

    spec = pm.build_spec(config.load_tasks(config.default_tasks_path()), {})
    params = pm.init(torch.Generator().manual_seed(16), spec)
    frames = np.random.RandomState(17).randint(0, 256, (PM_FRAMES, 224, 224, 3), np.uint8)
    xb = torch.from_numpy(frames[:BATCH]).to(dev)
    outs, engines = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        label = "bf16" if dtype == torch.bfloat16 else "float32"
        eng = executor.Engine("pm", spec, params, batch_size=BATCH, dtype=dtype)
        out = eng.run(frames, collect=("probs", "preds", "logits"))
        check_probs(out, PM_FRAMES, spec, f"PM headline {label}")
        want = executor.Engine("pm", spec, params, batch_size=2, dtype=dtype, device="cpu").run(
            frames[:2], collect=("logits",))["logits"]
        scale = float(np.abs(want).max())
        # float32: summation order only; bf16: roundings at other places
        # (cuDNN's bf16 output against the CPU's upcast convolution)
        tol = 1e-3 if dtype == torch.float32 else 5e-2
        err = max_err(torch.from_numpy(out["logits"][:2]), torch.from_numpy(want), tol * scale, tol,
                      f"PM headline {label} logits vs the port's CPU path")
        outs[label], engines[label] = out, eng
        print(f"[16] PM headline {label} (ndf 64, patch 70, instance norm, SE, trunk "
              f"{spec.trunk_channels} channels, 12 tasks, seeded weights): {PM_FRAMES} frames at batch "
              f"{BATCH}, logits vs CPU on 2 frames max abs err {err:.3e} (max |logit| {scale:.3f}; "
              f"atol {tol} x max, rtol {tol})")
    agree, drift = agreement(outs["bf16"]["probs"], outs["float32"]["probs"])
    step32, step16 = in_turns(lambda: engines["float32"].step(xb), lambda: engines["bf16"].step(xb),
                              reps=3, rounds=3)
    wall32, _ = run_wall(engines["float32"], frames)
    wall16, _ = run_wall(engines["bf16"], frames)
    print(f"[16] PM headline bf16 vs float32: argmax agrees on {agree:.4f} of (frame, task) pairs, max "
          f"prob drift {drift:.3e}; engine step at batch {BATCH} in turns: float32 {step32:.3f} ms = "
          f"{BATCH / step32 * 1e3:,.0f} img/s, bf16 {step16:.3f} ms = {BATCH / step16 * 1e3:,.0f} img/s "
          f"(device); Engine.run end to end on {PM_FRAMES} host frames: float32 "
          f"{PM_FRAMES / wall32:,.0f}, bf16 {PM_FRAMES / wall16:,.0f} img/s | {card}")
    if profile:
        for label in ("float32", "bf16"):
            profile_step(f"[16] PM headline {label} step at batch {BATCH}",
                         lambda: engines[label].step(xb))


def rtm_bf16_phase(card: str, f32: dict, profile: bool) -> None:
    """Phase 17: RTM batch inference in bf16 at phase 12's width and batch."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor

    dev = torch.device("cuda", 0)
    spec, params, frames = f32["spec"], f32["params"], f32["frames"]
    eng16 = executor.Engine("rtm", spec, params, batch_size=RTM_BATCH, dtype=torch.bfloat16)
    out16 = eng16.run(frames, collect=("probs", "preds", "logits"))
    check_probs(out16, RTM_FRAMES, spec, "RTM bf16 batch")
    agree, drift = agreement(out16["probs"], f32["out"]["probs"])
    eng32 = executor.Engine("rtm", spec, params, batch_size=RTM_BATCH)
    xb = torch.from_numpy(frames[:RTM_BATCH]).to(dev)
    step32, step16 = in_turns(lambda: eng32.step(xb), lambda: eng16.step(xb), reps=3, rounds=3)
    wall16, _ = run_wall(eng16, frames)
    print(f"[17] RTM bf16 batch (phase 12's width): {RTM_FRAMES} frames at batch {RTM_BATCH}; vs the "
          f"float32 run argmax agrees on {agree:.4f} of (frame, task) pairs, max prob drift {drift:.3e}; "
          f"engine step in turns: float32 {step32:.3f} ms = {RTM_BATCH / step32 * 1e3:,.0f} img/s, bf16 "
          f"{step16:.3f} ms = {RTM_BATCH / step16 * 1e3:,.0f} img/s (device); Engine.run end to end: "
          f"bf16 {RTM_FRAMES / wall16:,.0f} img/s, float32 (phase 12) {RTM_FRAMES / f32['wall']:,.0f} "
          f"img/s | {card}")
    print(f"[17] RTM bf16 batch gate: drift {drift:.3e} <= {RTM_BF16_DRIFT}")
    if drift > RTM_BF16_DRIFT:
        raise AssertionError(f"RTM bf16 batch vs float32: drift {drift:.3e} (bound {RTM_BF16_DRIFT})")
    if profile:
        profile_step(f"[17] RTM bf16 step at batch {RTM_BATCH}", lambda: eng16.step(xb))


class PyplotRecorder:
    """Stand-in for ``matplotlib.pyplot`` on a machine without matplotlib:
    every call is recorded and returns the recorder (``subplots`` a pair of
    it); nothing is drawn.  ``saved`` lists the paths of the figures asked
    for, ``cmaps`` the colormaps; a colormap maps gray to gray RGBA."""

    def __init__(self):
        self.saved = []
        self.cmaps = []

    def __call__(self, *args, **kwargs):
        return self

    def __getattr__(self, name):
        def call(*args, **kwargs):
            if name == "savefig":
                self.saved.append(args[0])
            if name == "get_cmap":
                self.cmaps.append(args[0])
                return gray_colormap
            return (self, self) if name == "subplots" else self

        return call


def gray_colormap(gray):
    """RGBA [..., 4] with gray in the three colours and alpha 1."""
    import numpy as np

    g = np.asarray(gray, np.float64)
    return np.stack([g, g, g, np.ones_like(g)], axis=-1)


def pyplot_stand_in():
    """None where matplotlib imports; else a recorder put into
    ``sys.modules`` as ``matplotlib`` and ``matplotlib.pyplot``."""
    import types

    try:
        import matplotlib  # noqa: F401
        return None
    except ImportError:
        rec = PyplotRecorder()
        mod = types.ModuleType("matplotlib")
        mod.use = lambda *args, **kwargs: None
        mod.pyplot = rec
        sys.modules["matplotlib"] = mod
        sys.modules["matplotlib.pyplot"] = rec
        return rec


class FrameDataset:
    """In-memory frames and labels behind the loader's dataset contract
    (``paths()``, ``load(i)``, ``task_names``): no decode sets the pace."""

    def __init__(self, frames, labels, task_names):
        self.frames, self.labels, self.task_names = frames, labels, list(task_names)

    def paths(self):
        return [f"frame{i:04d}" for i in range(len(self.frames))]

    def load(self, i):
        return self.frames[i], self.labels[i]


def eval_labels(tasks, n: int, rng):
    """Seeded labels [n, T]: about 10 % IGNORE_INDEX, and the first task of
    three or more classes with only two of them present."""
    import numpy as np

    lab = np.stack([rng.randint(0, k, n) for k in tasks.num_classes], axis=1).astype(np.int32)
    two = next(i for i, k in enumerate(tasks.num_classes) if k >= 3)
    lab[:, two] = rng.choice([0, 2], n)
    lab[rng.rand(*lab.shape) < 0.1] = -100
    return lab


def recomputed_metrics(eng, frames, labels, roc_dir: str) -> dict:
    """metrics_test.json as ``evaluate`` should write it, from ``Engine.run``
    on the same frames, batch by batch: the same metric functions on the
    same rows, and the reference's loss accounting (per batch, the sum of
    the labeled tasks' mean losses, times the batch's rows)."""
    import numpy as np

    out = eng.run(frames, labels, collect=("probs", "preds"))
    loss_sum, total = 0.0, 0
    for s in range(0, len(frames), eng.batch_size):
        r = eng.run(frames[s: s + eng.batch_size], labels[s: s + eng.batch_size], collect=())
        per_task = r["loss_per_task"].astype(np.float32)  # float32, as the step wrote it
        loss_sum += float(np.sum(per_task[r["count_per_task"] > 0])) * len(frames[s: s + eng.batch_size])
        total += len(frames[s: s + eng.batch_size])
    metrics = recomputed_metrics_only(eng.tasks, out, labels, roc_dir)
    f1 = float(np.mean([m["f1_score"] for m in metrics.values()]))
    return {"test_loss": loss_sum / total, "overall_f1": f1, "tasks": metrics}, out


def recomputed_metrics_only(tasks, out, labels, roc_dir: str) -> dict:
    """Each task's metric dict from ``Engine.run``'s probs and preds on the
    labeled rows, with the ROC artifacts under ``roc_dir``."""
    import numpy as np

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import (
        metrics as um,
    )

    metrics = {}
    for ti, task in enumerate(tasks.names):
        m = labels[:, ti] != -100
        k = tasks.num_classes[ti]
        metrics[task] = um.task_metrics_and_roc(
            task, tasks.class_names[ti], out["preds"][m, ti].astype(np.int64),
            labels[m, ti].astype(np.int64), out["probs"][m, ti, :k].astype(np.float64), roc_dir)
    return metrics


def same_json(path: str, root: str, want, want_root: str) -> bool:
    """The JSON file equals ``want`` exactly once each side's output
    directory is replaced by one placeholder."""
    with open(path) as f:
        got = json.loads(f.read().replace(root, "<out>"))
    return got == json.loads(json.dumps(want).replace(want_root, "<out>"))


def evaluation_phase(card: str, eng32) -> dict:
    """Phase 18: the evaluation workloads on the shipped PMG at batch 256
    (evaluate in float32, bf16 and with scan_chunk=2; run_benchmark,
    run_inference, test_folder_predictions and one watch-folder poll
    cycle), each checked against ``Engine.run``; returns each path's
    launch counts, read just after the path with the counts reset just
    before it."""
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.data import (
        BatchLoader,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
        load_image_uint8,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import (
        benchmark, evaluate, inference,
    )

    recorder = pyplot_stand_in()
    if recorder is not None:
        print("[18] matplotlib is not installed here: the ROC PNGs were not drawn; a recording "
              "stand-in for matplotlib.pyplot checks that a figure was asked for on every curve")
    spec = eng32.spec
    tasks = spec.tasks
    rng = np.random.RandomState(18)
    frames = rng.randint(0, 256, (N_FRAMES, 224, 224, 3), np.uint8)
    labels = eval_labels(tasks, N_FRAMES, rng)
    dataset = FrameDataset(frames, labels, tasks.names)
    n_batches = -(-N_FRAMES // BATCH)
    eng16 = executor.Engine("pmg", spec, eng32.params, batch_size=BATCH, dtype=torch.bfloat16)
    counts = {}
    tmp = tempfile.mkdtemp()
    try:
        def figures_ok(pngs):
            if recorder is None:
                return all(os.path.exists(p) for p in pngs)
            return set(pngs) <= set(recorder.saved)

        def run_eval(label, eng, **kw):
            out_dir = os.path.join(tmp, label)
            ck.reset_launches()
            loss, metrics, f1, _ = evaluate.evaluate(eng, BatchLoader(dataset, batch_size=BATCH),
                                                     out_dir, **kw)
            torch.cuda.synchronize()
            counts[label] = dict(ck.LAUNCHES)
            want = {"stem": n_batches, "patch_gram": n_batches,
                    "gram_proj": n_batches if eng.dtype == torch.bfloat16 else 0}
            got = {name: counts[label][name] for name in want}
            if got != want:  # (d) one launch of each a batch: no plain version stood in
                raise AssertionError(f"evaluate {label}: launches {got}, want {want}")
            return out_dir, loss

        drift, out_rows = {}, {}
        for label, eng in (("float32", eng32), ("bf16", eng16)):
            out_dir, loss = run_eval(label, eng)
            want, out = recomputed_metrics(eng, frames, labels, os.path.join(tmp, f"{label}_want", "roc"))
            out_rows[label] = out
            path = os.path.join(out_dir, "metrics_test.json")
            if not same_json(path, out_dir, want, os.path.join(tmp, f"{label}_want")):  # (a)
                raise AssertionError(f"evaluate {label}: metrics_test.json differs from the metrics "
                                     f"of Engine.run on the same frames")
            if loss != want["test_loss"]:  # (b)
                raise AssertionError(f"evaluate {label}: test_loss {loss} != {want['test_loss']}")
            pngs = [m["roc_png"] for m in json.load(open(path))["tasks"].values() if m["roc_png"]]
            if len(pngs) != len(tasks) or not figures_ok(pngs):
                raise AssertionError(f"evaluate {label}: ROC figures {pngs}")
            cpu = executor.Engine("pmg", spec, eng32.params, batch_size=16, dtype=eng.dtype,
                                  device="cpu").run(frames[:16])["probs"]
            drift[label] = float(np.abs(out["probs"][:16] - cpu).max())  # (e)
            limit = 1e-3 if label == "float32" else 0.05
            if drift[label] > limit:
                raise AssertionError(f"evaluate {label}: card vs CPU probabilities differ by "
                                     f"{drift[label]} (limit {limit})")
        sc_dir, _ = run_eval("float32 scan_chunk=2", eng32, scan_chunk=2)
        with open(os.path.join(tmp, "float32", "metrics_test.json")) as f:
            per_batch = json.loads(f.read().replace(os.path.join(tmp, "float32"), "<out>"))
        if not same_json(os.path.join(sc_dir, "metrics_test.json"), sc_dir, per_batch, "<out>"):  # (c)
            raise AssertionError("evaluate scan_chunk=2: metrics_test.json differs from per-batch")
        for csv_path in glob.glob(os.path.join(tmp, "float32", "roc", "*.csv")):
            with open(csv_path, "rb") as a, open(os.path.join(sc_dir, "roc", os.path.basename(csv_path)),
                                                  "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"evaluate scan_chunk=2: {os.path.basename(csv_path)} differs")
        print(f"[18] evaluate on the shipped PMG, {N_FRAMES} in-memory frames at batch {BATCH} "
              f"(BatchLoader), 12 tasks, ~10 % labels missing: metrics_test.json equals the metrics "
              f"of Engine.run on the same frames (a) and test_loss its loss accounting (b), exactly, "
              f"in float32 and bf16; scan_chunk=2 gives the same bytes (c); launches a run "
              f"{ {k: {n: v[n] for n in ('stem', 'patch_gram', 'gram_proj')} for k, v in counts.items()} } "
              f"(d); card vs CPU probabilities on 16 frames: float32 {drift['float32']:.3e} (limit "
              f"1e-3), bf16 {drift['bf16']:.3e} (limit 0.05) (e)")

        # end to end: evaluate (loader, engine, metrics, artifacts) against
        # Engine.run on the same frames in memory, in turns, median of 3
        for label, eng in (("float32", eng32), ("bf16", eng16)):
            t_eval, t_run = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                evaluate.evaluate(eng, BatchLoader(dataset, batch_size=BATCH), os.path.join(tmp, "timed"))
                t_eval.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run(frames, labels)
                t_run.append(time.perf_counter() - t0)
            e, r = statistics.median(t_eval), statistics.median(t_run)
            # the host's metric work alone: the metric functions and ROC
            # artifacts evaluate runs after the last batch
            t0 = time.perf_counter()
            recomputed_metrics_only(eng.tasks, out_rows[label], labels, os.path.join(tmp, "timed_m"))
            m_ms = (time.perf_counter() - t0) * 1e3
            print(f"[18] {label}: evaluate end to end {N_FRAMES / e:,.0f} img/s ({e * 1e3:.1f} ms; "
                  f"runs {[round(t * 1e3, 1) for t in t_eval]} ms; of which the metrics and ROC "
                  f"artifacts alone take {m_ms:.1f} ms), Engine.run on the same frames "
                  f"{N_FRAMES / r:,.0f} img/s ({r * 1e3:.1f} ms; runs {[round(t * 1e3, 1) for t in t_run]}"
                  f" ms), in turns, median of 3 | {card}")

        # the folder, benchmark and watch paths on 64 seeded PNGs in
        # class-named folders (320x256, and 300x240 ones that are resized)
        bench = ["sun", "rain", "snow", "fog"]
        folder = os.path.join(tmp, "bench")
        for i in range(64):
            w, h = (320, 256) if i % 2 == 0 else (300, 240)
            d = os.path.join(folder, bench[i % 4])
            os.makedirs(d, exist_ok=True)
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(os.path.join(d, f"img{i:02d}.png"))
        names = list(tasks.class_names[0])
        perm = rng.permutation(len(names))
        mapping = {tasks.names[0]: {b: [names[j] for j in perm[i::4]] for i, b in enumerate(bench)},
                   "Light Conditions": {"day": ["Day"], "night": []}}  # no such folders: one class
        mapping_path = os.path.join(tmp, "mapping.json")
        with open(mapping_path, "w") as f:
            json.dump(mapping, f)
        ck.reset_launches()
        summary = benchmark.run_benchmark(eng32, folder, mapping_path, os.path.join(tmp, "b"),
                                          os.path.join(tmp, "b", "roc"), auto_mapping=True)
        inf = inference.run_inference(eng32, folder, os.path.join(tmp, "inf"))
        fold = inference.test_folder_predictions(eng32, folder, os.path.join(tmp, "fold"))
        torch.cuda.synchronize()
        counts["benchmark + folder"] = dict(ck.LAUNCHES)
        per_run = -(-64 // BATCH)  # each of the three workloads runs every image once
        if (counts["benchmark + folder"]["stem"] != 3 * per_run
                or counts["benchmark + folder"]["patch_gram"] != 3 * per_run):
            raise AssertionError(f"benchmark + folder launches {counts['benchmark + folder']}")
        images = benchmark.walk_benchmark_folder(folder, {t: list(m) for t, m in mapping.items()})
        decoded = np.stack([load_image_uint8(p) for p, _ in images])
        probs = eng32.run(decoded, collect=("probs",))["probs"]
        want_summary = {}
        os.makedirs(os.path.join(tmp, "b_want"))
        for task, tmap in mapping.items():
            ti = tasks.names.index(task)
            p = probs[:, ti, : tasks.num_classes[ti]]
            bnames = list(tmap)
            gt = np.asarray([bnames.index(top) if top in bnames else len(bnames) - 1
                             for _, top in images])
            conf = (benchmark._one_hot(p.argmax(1), tasks.num_classes[ti]).T
                    @ benchmark._one_hot(gt, len(bnames))).astype(np.int64)
            assign, _ = benchmark.auto_map_task(conf)
            want_summary[task] = benchmark._task_summary(
                task, bnames, gt, p @ benchmark._one_hot(np.asarray(assign), len(bnames)),
                os.path.join(tmp, "b_want"))
        with open(os.path.join(tmp, "b", "benchmark_summary.json")) as f:
            if json.load(f) != json.loads(json.dumps(want_summary)) or summary != want_summary:  # (f)
                raise AssertionError("run_benchmark: summary differs from Engine.run's on the decoded frames")
        with open(os.path.join(tmp, "b", "best_mapping.json")) as f:
            best = json.load(f)
        if sorted(c for v in best[tasks.names[0]].values() for c in v) != sorted(names):
            raise AssertionError(f"best_mapping.json: not every model class mapped once: {best}")
        pngs = [os.path.join(tmp, "b", "roc", f"roc_{t.replace(' ', '_')}.png") for t in mapping]
        if not figures_ok(pngs):
            raise AssertionError(f"run_benchmark: ROC figures {pngs}")
        paths = [p for p, _ in images]
        by_path = {p: inference._pred_entry(eng32, probs[i]) for i, p in enumerate(paths)}
        with open(os.path.join(tmp, "inf", "inference_results.json")) as f:
            if json.load(f) != by_path or inf != by_path:  # (f)
                raise AssertionError("run_inference: predictions differ from Engine.run's")
        with open(os.path.join(tmp, "fold", "all_predictions.json")) as f:
            allp = json.load(f)
        if allp != {os.path.relpath(p, folder): e for p, e in by_path.items()}:  # (f)
            raise AssertionError("test_folder_predictions: predictions differ from Engine.run's")
        if set(fold) != set(tasks.names) or any(set(v) != {"by_class", "f1_score", "global_f1"}
                                               for v in fold.values()):
            raise AssertionError(f"folder_predictions.json schema: {fold}")
        print(f"[18] run_benchmark (auto-mapping, 2 tasks), run_inference and test_folder_predictions on "
              f"64 PNGs (decode, resize, crop): summaries and predictions equal Engine.run's on the "
              f"decoded frames (f); launches {counts['benchmark + folder']}")

        # one watch-folder poll cycle at batch 1, engine warmed up first
        eng1 = executor.Engine("pmg", spec, eng32.params, batch_size=1)
        eng1.run(decoded[:1])
        watch, wout = os.path.join(tmp, "watch"), os.path.join(tmp, "watch_out")
        os.makedirs(watch)
        frame = os.path.join(watch, "2026-10-17_12-00-00.png")
        shutil.copy(paths[0], frame + ".tmp")
        svc = inference.WatchFolderService(eng1, [watch], [0.005], wout)
        torch.cuda.synchronize()
        ck.reset_launches()
        svc.start(block=False)
        t0 = time.perf_counter()
        os.replace(frame + ".tmp", frame)
        last = os.path.join(wout, "watch", "last_prediction.json")
        while not os.path.exists(last) and time.perf_counter() - t0 < 60:
            time.sleep(0.0005)
        wall = time.perf_counter() - t0
        svc.stop()
        for t in svc.threads:
            t.join(timeout=10)
            if t.is_alive():
                raise AssertionError("watch service thread did not stop")
        counts["watch batch 1"] = dict(ck.LAUNCHES)
        with open(last) as f:
            got = json.load(f)
        want = inference._pred_entry(eng1, eng1.run(load_image_uint8(frame)[None])["probs"][0])
        if (got != {"timestamp": "2026-10-17_12-00-00", "image": os.path.basename(frame), "prediction": want}
                or counts["watch batch 1"]["stem"] != 1 or counts["watch batch 1"]["patch_gram"] != 1):
            raise AssertionError(f"watch service: {got}, launches {counts['watch batch 1']}")
        with open(os.path.join(wout, "watch", "prediction_history.csv")) as f:
            if len(f.read().splitlines()) != 2:
                raise AssertionError("watch service: prediction_history.csv is not a header and one row")
        print(f"[18] watch-folder service, batch 1: last_prediction.json and prediction_history.csv "
              f"in the JAX schema, the prediction equal to Engine.run's (f); launches "
              f"{counts['watch batch 1']}; {wall * 1e3:.1f} ms from the frame's rename to "
              f"last_prediction.json on disk (5 ms poll interval; decode, step, JSON, CSV) | {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if recorder is not None:
            del sys.modules["matplotlib"], sys.modules["matplotlib.pyplot"]
    return counts


def enqueue_ms(fn, reps: int = 20) -> float:
    """Median host time to enqueue one call of ``fn`` behind a sleep kernel
    (so the queue is empty and the card busy), in ms (phase 15's measure)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def dispatch_cost(card: str) -> dict:
    """Phase 15: host time of one eager call of each registered kernel at a
    main-path shape through its wrapper (the call rule of
    ``cuda_kernels._register``, then the launcher) and through the launcher
    alone, in turns (wrapper, launcher, launcher, wrapper; each the mean of
    100 calls, median of 5 rounds)."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    rng = np.random.RandomState(15)
    dev = torch.device("cuda", 0)
    z = torch.from_numpy(rng.randn(BATCH, 14, 14, 96).astype(np.float32)).to(dev)
    x8 = torch.from_numpy(rng.randint(0, 256, (BATCH, 224, 224, 3), np.uint8)).to(dev)
    w, s, t = (torch.from_numpy(a.astype(np.float32)).to(dev)
               for a in (rng.randn(48, 32) * 0.01, rng.rand(32) + 0.5, rng.randn(32)))
    g16 = torch.from_numpy(rng.randn(BATCH, 9, 9216).astype(np.float32)).to(dev).to(torch.bfloat16)
    w16 = torch.from_numpy(rng.randn(9216, 192).astype(np.float32) * 0.01).to(dev).to(torch.bfloat16)
    b = torch.from_numpy(rng.randn(192).astype(np.float32)).to(dev)
    # the RTM bf16 trunk's layer1 downsample site and a PM headline site
    xe, pe, oe, po = epilogue_site("downsample", (EPI_BATCH, 256, 56, 56), torch.bfloat16,
                                   np.random.default_rng(15), dev)
    flat = [pe[k] for k in ck._NORM_KEYS] + [oe] + [po[k] for k in ck._NORM_KEYS]
    xi = torch.randn((BATCH, 28, 28, 256), device=dev)
    pi = {"scale": torch.rand(256, device=dev) + 0.5, "bias": torch.randn(256, device=dev)}
    cases = {
        "patch_gram": (lambda: ck.patch_gram(z, 3), lambda: ck._patch_gram_launch(z, 3)),
        "stem": (lambda: ck.stem(x8, w, s, t, 4), lambda: ck._stem_launch(x8, w, s, t, 4, True, False, None)),
        "gram_proj": (lambda: ck.gram_proj(g16, w16, b, torch.bfloat16),
                      lambda: ck._gram_proj_launch(g16, w16, b, True)),
        "bn_epilogue": (lambda: ck.bn_epilogue(xe, pe, True, oe, po),
                        lambda: ck._bn_epilogue_launch(xe, *flat, True)),
        "instance_norm_leaky": (lambda: ck.instance_norm_leaky(xi, pi, inplace=True),
                                lambda: ck._inl_over(xi, pi["scale"], pi["bias"], 0.2)),
    }

    def host_us(fn, n=100):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return per

    out = {}
    for name, (call, raw) in cases.items():
        call(), raw()
        rounds = [(host_us(call), host_us(raw), host_us(raw), host_us(call)) for _ in range(5)]
        out[name] = (statistics.median((a + d) / 2 for a, _, _, d in rounds),
                     statistics.median((b_ + c) / 2 for _, b_, c, _ in rounds))
    add = {k: o - r for k, (o, r) in out.items()}
    print("[15] host time of one eager call, through the wrapper -> the launcher alone, in turns: "
          + ", ".join(f"{k} {o:.1f} -> {r:.1f} us" for k, (o, r) in out.items())
          + f"; the wrappers add {(add['patch_gram'] + add['stem']) / 1e3:.4f} ms to a PMG float32 step "
          f"(K1, K2), {(add['patch_gram'] + add['stem'] + add['gram_proj']) / 1e3:.4f} ms to a bf16 one "
          f"(K1, K2, K5), {EPI_SITES * add['bn_epilogue'] / 1e3:.4f} ms to an RTM forward "
          f"({EPI_SITES} bn_epilogue) and {5 * add['instance_norm_leaky'] / 1e3:.4f} ms to a PM one "
          f"(5 instance_norm_leaky) | {card}")
    return out


DEPLOY_BATCH = 32
DEPLOY_FRAMES = 96
SERVE_REQUESTS = 64
SERVE_CLIENTS = 8
EXPORT_LOGIT_TOL = 1e-5  # times max|logit| of Engine.run
SERVE_PROB_TOL = 1e-5


# run in a process of its own, so that the clients do not share the
# server's interpreter lock: POST each file to /predict from N threads (each
# request with a timeout); writes the responses, errors and wall seconds
CLIENTS = """
import json, sys, threading, time, urllib.request
port, clients, paths, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
bodies = []
for p in json.load(open(paths)):
    with open(p, "rb") as f:
        bodies.append(f.read())
res, errors = [None] * len(bodies), []


def client(idx):
    for i in idx:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=bodies[i], method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                res[i] = [r.status, json.loads(r.read())]
        except Exception as e:
            errors.append(f"request {i}: {e!r}")


threads = [threading.Thread(target=client, args=(range(c, len(bodies), clients),)) for c in range(clients)]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=300)
wall = time.perf_counter() - t0
with open(out, "w") as f:
    json.dump({"responses": res, "errors": errors, "wall": wall,
               "alive": any(t.is_alive() for t in threads)}, f)
"""


def post_all(port_no: int, paths, clients: int, work: str):
    """POST each file to ``/predict`` from ``clients`` threads of a client
    process; returns (responses in file order, wall seconds)."""
    paths_json, out_json = os.path.join(work, "client_paths.json"), os.path.join(work, "client_out.json")
    with open(paths_json, "w") as f:
        json.dump(list(paths), f)
    subprocess.run([sys.executable, "-c", CLIENTS, str(port_no), str(clients), paths_json, out_json],
                   check=True, timeout=600)
    with open(out_json) as f:
        got = json.load(f)
    if got["errors"] or got["alive"]:
        raise AssertionError(f"/predict clients failed: {got['errors'][:4]}, threads alive {got['alive']}")
    return got["responses"], got["wall"]


def get_json(port_no: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port_no}{path}", timeout=60) as r:
        return r.status, json.loads(r.read())


def deployment_phase(card: str, device: str = "cuda") -> dict:
    """Phase 19: the deployment path on the shipped PMG at batch 32:
    (a) ``.pth`` export and the native directory, each reloaded by
    ``load_engine``, bit for bit the original's probabilities on 96 frames;
    (b) the CLI's ``--mode export`` in float32 and bf16 (a subprocess each),
    each artifact reloaded by ``ExportedPredictor`` and run on the 96 frames
    against ``Engine.run`` (preds equal, logits within 1e-5 x max|logit|),
    with the artifact's own launches of K1, K2 (and K5 in bf16); (c)
    ``InferenceServer`` over the float32 ``Engine`` and over the bf16
    artifact, 64 seeded PNG requests from 8 client threads, each response
    against ``Engine.run`` on its decoded frame.  Returns each path's launch
    counts, read just after the path with the counts reset just before it.
    (``device="cpu"`` rehearses the phase on the plain versions.)"""
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint, executor,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.export import (
        ExportedPredictor,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
        load_image_uint8,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads.serve import (
        InferenceServer,
    )

    with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
        meta = json.load(f)
    pth = os.path.join(FIXTURES, "pmg_shipped.pth")
    eng = port.load_engine("pmg", pth, meta["tasks"], meta["hparams"], batch_size=DEPLOY_BATCH,
                           device=device)
    eng16 = executor.Engine("pmg", eng.spec, eng.params, batch_size=DEPLOY_BATCH, dtype=torch.bfloat16,
                            device=device)
    frames = np.random.RandomState(19).randint(0, 256, (DEPLOY_FRAMES, 224, 224, 3), np.uint8)
    want = {"float32": eng.run(frames, collect=("probs", "preds", "logits")),
            "bf16": eng16.run(frames, collect=("probs", "preds", "logits"))}
    n_batches = -(-DEPLOY_FRAMES // DEPLOY_BATCH)
    counts = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_19_")
    try:
        # -- (a) checkpoints --------------------------------------------------
        saved = {"pth": os.path.join(tmp, "pmg.pth"), "native": os.path.join(tmp, "native")}
        checkpoint.save_torch_checkpoint("pmg", eng.params, eng.spec, saved["pth"])
        checkpoint.save_native(eng.params, saved["native"])
        for label, path in saved.items():
            again = port.load_engine("pmg", path, meta["tasks"], meta["hparams"], batch_size=DEPLOY_BATCH,
                                     device=device)
            if not np.array_equal(again.run(frames)["probs"], want["float32"]["probs"]):
                raise AssertionError(f"load_engine({label}) gives other probabilities than the original")
            del again
        print(f"[19] (a) save_torch_checkpoint -> load_engine(.pth) and save_native -> load_engine(dir): "
              f"probs on {DEPLOY_FRAMES} frames bit for bit the original engine's")

        # -- (b) export through the CLI, reload, run --------------------------
        tasks_json, hparams_json = os.path.join(tmp, "tasks.json"), os.path.join(tmp, "hparams.json")
        with open(tasks_json, "w") as f:
            json.dump(meta["tasks"], f)
        with open(hparams_json, "w") as f:
            json.dump({"hparams": meta["hparams"]}, f)
        preds = {}
        for label, flags in (("float32", []), ("bf16", ["--bf16"])):
            art = os.path.join(tmp, f"artifact_{label}")
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "weather_torch.py", "pmg", "--mode", "export",
                            "--build_classifier", tasks_json, "--config_path", hparams_json,
                            "--model_path", pth, "--batch_size", str(DEPLOY_BATCH), "--export_dir", art,
                            "--save_dir", os.path.join(tmp, "cli"), "--parity_precision", "--device", device,
                            *flags],
                           check=True, timeout=600, capture_output=True, text=True)
            export_s = time.perf_counter() - t0
            pred = ExportedPredictor(art, device=device)
            pred.warmup()
            ck.reset_launches()
            got = pred.run(frames, collect=("probs", "preds", "logits"))
            torch.cuda.synchronize()
            counts[f"artifact {label}"] = launches = dict(ck.LAUNCHES)
            ref = want[label]
            err = float(np.abs(got["logits"] - ref["logits"]).max())
            scale = float(np.abs(ref["logits"]).max())
            if not np.array_equal(got["preds"], ref["preds"]) or err > EXPORT_LOGIT_TOL * scale:
                raise AssertionError(f"{label} artifact vs Engine.run: logits err {err} (max|logit| "
                                     f"{scale}), preds equal {np.array_equal(got['preds'], ref['preds'])}")
            need = ("patch_gram", "stem") + (("gram_proj",) if label == "bf16" else ())
            if any(launches[k] != n_batches for k in need):
                raise AssertionError(f"{label} artifact: launches {launches}, want {n_batches} of {need}")
            live = eng if label == "float32" else eng16
            xb = torch.from_numpy(frames[:DEPLOY_BATCH]).to(device)

            def run_artifact(p=pred, x=xb):
                with torch.inference_mode():
                    return p._call(x)

            step_live, step_art = in_turns(lambda e=live, x=xb: e.step(x), run_artifact, reps=5)
            enq_live, enq_art = (enqueue_ms(fn) for fn in (lambda e=live, x=xb: e.step(x), run_artifact))
            walls = {}
            for what, fn in (("Engine.run", lambda e=live: e.run(frames)),
                             ("ExportedPredictor.run", lambda p=pred: p.run(frames))):
                ts = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    ts.append(time.perf_counter() - t0)
                walls[what] = statistics.median(ts)
            print(f"[19] (b) {label} artifact (CLI --mode export in {export_s:.1f} s, "
                  f"{os.path.getsize(os.path.join(art, 'forward.pt2')) / 1e6:.1f} MB): vs Engine.run on "
                  f"{DEPLOY_FRAMES} frames preds equal, max logit err {err:.3e} (limit "
                  f"{EXPORT_LOGIT_TOL} x {scale:.3f}), logits bit-equal {err == 0.0}; launches by the "
                  f"artifact {launches} ({n_batches} batches); device step at batch {DEPLOY_BATCH}, in "
                  f"turns: Engine {step_live:.3f} ms, artifact {step_art:.3f} ms; host enqueue of one "
                  f"step: Engine {enq_live:.3f} ms, artifact {enq_art:.3f} ms; end to end on "
                  f"{DEPLOY_FRAMES} host frames: Engine.run {DEPLOY_FRAMES / walls['Engine.run']:,.0f} "
                  f"img/s, ExportedPredictor.run {DEPLOY_FRAMES / walls['ExportedPredictor.run']:,.0f} "
                  f"img/s | {card}")
            preds[label] = pred

        # -- (c) HTTP serving ---------------------------------------------------
        rng = np.random.RandomState(1919)
        paths = []
        for i in range(SERVE_REQUESTS):
            paths.append(os.path.join(tmp, f"request_{i:02d}.png"))
            Image.fromarray(rng.randint(0, 256, (256, 320, 3), np.uint8)).save(paths[-1])
        decode_s = []
        for path in paths:
            with open(path, "rb") as f:
                body = f.read()
            t0 = time.perf_counter()
            load_image_uint8(Image.open(io.BytesIO(body)))
            decode_s.append(time.perf_counter() - t0)
        decoded = np.stack([load_image_uint8(p) for p in paths])
        tasks = eng.spec.tasks
        for label, target, live in (("float32 Engine", eng, eng), ("bf16 artifact", preds["bf16"], eng16)):
            ref = live.run(decoded)
            srv = InferenceServer(target, host="127.0.0.1", port=0, prob_threshold=0.5).start()
            try:
                ck.reset_launches()
                out, wall = post_all(srv.port, paths, SERVE_CLIENTS, tmp)
                counts[f"serve {label}"] = launches = dict(ck.LAUNCHES)
                hz = get_json(srv.port, "/healthz")
                stats = get_json(srv.port, "/stats")[1]
            finally:
                srv.stop()
            if hz != (200, {"status": "ok", "model": "pmg", "tasks": len(tasks), "batch_size": DEPLOY_BATCH}):
                raise AssertionError(f"/healthz: {hz}")
            if stats.get("n") != SERVE_REQUESTS:
                raise AssertionError(f"/stats: {stats}")
            perr = 0.0
            for i, (code, body) in enumerate(out):
                if code != 200 or list(body["prediction"]) != list(tasks.names):
                    raise AssertionError(f"{label} /predict {i}: {code} {body}")
                for ti, t in enumerate(tasks.names):
                    p = body["prediction"][t]
                    k = tasks.num_classes[ti]
                    pred_i = int(ref["preds"][i, ti])
                    cls = "Unknown" if pred_i < 0 else tasks.class_names[ti][pred_i]
                    got_p = np.asarray([p["probs"][c] for c in tasks.class_names[ti]])
                    perr = max(perr, float(np.abs(got_p - ref["probs"][i, ti, :k]).max()))
                    if p["predicted_class"] != cls:
                        raise AssertionError(f"{label} /predict {i} task {t}: {p['predicted_class']} "
                                             f"vs Engine.run's {cls}")
            if perr > SERVE_PROB_TOL:
                raise AssertionError(f"{label} /predict probabilities {perr} from Engine.run's")
            need = ("patch_gram", "stem") + (("gram_proj",) if "bf16" in label else ())
            if any(launches[k] == 0 for k in need):
                raise AssertionError(f"{label} server: launches {launches}")
            print(f"[19] (c) InferenceServer over the {label}: {SERVE_REQUESTS} PNG /predict requests "
                  f"from {SERVE_CLIENTS} client threads of a client process, classes equal "
                  f"Engine.run's on the decoded "
                  f"frames, max prob err {perr:.3e} (limit {SERVE_PROB_TOL}); /healthz and /stats ok; "
                  f"{SERVE_REQUESTS / wall:,.1f} requests/s, latency p50 {stats['p50'] * 1e3:.2f} ms, "
                  f"p99 {stats['p99'] * 1e3:.2f} ms (/stats); launches {launches} ({SERVE_REQUESTS / max(1, launches['stem']):.1f} requests a batch); "
                  f"host decode of one request (PNG 320x256 -> 224 crop) "
                  f"{statistics.median(decode_s) * 1e3:.2f} ms (median) | {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


TRAIN_BATCH = 64
TRAIN_STEPS = 20
TRAIN_LR = 3e-4  # make_optimizer's default learning rate
PM_TRAIN_BATCH = 32
RTM_TRAIN_BATCH = 16
PM_TRAIN_HPARAMS: dict = {}  # the headline specs: each family's defaults on the 12-task registry
RTM_TRAIN_HPARAMS: dict = {}
# float32 steps of (d) per family: PM 5; RTM 10, because from random init at
# lr 3e-4 its first update overshoots (at headline width every weight of the
# [12, 2048, 2048] attention moves by lr at once): losses 1.367, 5.005,
# 4.137, 2.942, 1.710 over its first five steps on the H100
FAMILY_TRAIN_STEPS = {"pm": 5, "rtm": 10}
FIT_IMAGES = 192
FIT_BATCH = 32
FIT_ARTIFACTS = {"best_model", "best_model.pth", "hyperparameters.json", "training_history.json",
                 "last_state", "train_progress.json"}


def within_max(got, want, frac: float, what: str) -> float:
    """max|got - want| / max|want|, which must be at most ``frac`` (and got finite)."""
    import torch

    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got).all() or err > frac * scale:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {frac} x max|want| ({scale:.3e})")
    return err / scale if scale else 0.0


def grads_through(fn, inputs, weight):
    """Gradients of sum(fn(*inputs) * weight) for fresh leaves copied from ``inputs``."""
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    (fn(*xs).float() * weight).sum().backward()
    return [x.grad for x in xs]


def train_batch(tasks, n: int, seed: int):
    """Seeded 224-px frames, normalized on the host as fit's were in the
    JAX package, and seeded labels (eval_labels)."""
    import numpy as np

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
        normalize_uint8_host,
    )

    rng = np.random.RandomState(seed)
    return normalize_uint8_host(rng.randint(0, 256, (n, 224, 224, 3), np.uint8)), eval_labels(tasks, n, rng)


def timed_steps(step_fn, state, x, y, n: int):
    """n steps with a CUDA event after each -> (state, losses, device ms of
    each step between consecutive events)."""
    import numpy as np
    import torch

    evs = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    losses = []
    evs[0].record()
    for i in range(n):
        state, loss = step_fn(state, x, y)
        losses.append(loss)
        evs[i + 1].record()
    torch.cuda.synchronize()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses over {n} steps are not finite and falling: {losses}")
    return state, losses, [evs[i].elapsed_time(evs[i + 1]) for i in range(n)]


def training_phase(card: str, device: str = "cuda", profile: bool = False) -> dict:
    """Phase 20: the training path.  (a) the gradients through K1 (float32
    and bf16) and K5 against autograd through their plain versions at
    z = [64,14,14,96], with the backward's and the forward kernel's times;
    (b) one PMG-shipped train step from the shipped weights, batch 64,
    float32, dropout 0, on the card against the CPU; (c) twenty steps on one
    fixed batch of 64 in float32 and bf16 with dropout 0.1 and the default
    augmentation, launch counts reset just before each run: time a step,
    img/s, host enqueue, K1/K5 launches a step, peak memory; (d) float32
    steps of PM (5) and RTM (10) at their headline widths; (e) ``fit`` for 2
    epochs (bf16, augmentation) on 192 seeded PNGs, its best checkpoint
    reloaded by ``load_engine`` against an Engine on the returned params,
    and the CLI's ``--mode train`` for 1 epoch in a subprocess.  ``profile``
    adds (c)'s device kernels, kernel time and table of device time by
    kernel a step.  Returns the launch counts of (c)'s two runs."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.config import (
        default_tasks_path, load_tasks,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint, executor,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import (
        pm, pmg, rtm,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, nn,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import (
        train as ptrain,
    )

    dev = torch.device(device)
    t_phase = time.perf_counter()

    # -- (a) gradients through the operators -------------------------------
    rng = np.random.RandomState(20)
    z = torch.from_numpy(rng.randn(TRAIN_BATCH, 14, 14, 96).astype(np.float32)).to(dev)
    r1 = torch.from_numpy(rng.randn(TRAIN_BATCH, 9, 96 * 96).astype(np.float32)).to(dev)
    errs = {"K1 float32 dz": within_max(
        grads_through(lambda a: ck.patch_gram(a, 3), [z], r1)[0],
        grads_through(lambda a: ck.patch_gram_plain(a, 3), [z], r1)[0], 1e-5, "K1 float32 dz")}
    z16 = z.to(torch.bfloat16)
    errs["K1 bf16 dz"] = within_max(
        grads_through(lambda a: ck.patch_gram(a, 3), [z16], r1)[0],
        grads_through(lambda a: ck.patch_gram_plain(a, 3), [z16], r1)[0], 1e-2, "K1 bf16 dz")
    g16 = ck.patch_gram(z16, 3)
    w16 = torch.from_numpy(rng.randn(96 * 96, 192).astype(np.float32) * 0.01).to(dev).to(torch.bfloat16)
    b32 = torch.from_numpy(rng.randn(192).astype(np.float32)).to(dev)
    r2 = torch.from_numpy(rng.randn(TRAIN_BATCH, 9, 192).astype(np.float32)).to(dev)
    got = grads_through(lambda g, w, b: ck.gram_proj(g, w, b, torch.bfloat16), [g16, w16, b32], r2)
    want = grads_through(lambda g, w, b: ck.gram_proj_plain(g, w, b, torch.bfloat16), [g16, w16, b32], r2)
    for name, a, b in zip(("dG", "dW", "db"), got, want):
        errs[f"K5 {name}"] = within_max(a, b, 1e-2, f"K5 {name}")
    # the bf16 x bf16 -> float32 product of the transformer (ops.nn.matmul_f32:
    # cuBLAS's out_dtype product, whose gradient is the port's own function)
    a16 = torch.from_numpy(rng.randn(TRAIN_BATCH * 9, 192).astype(np.float32)).to(dev).to(torch.bfloat16)
    r3 = torch.from_numpy(rng.randn(TRAIN_BATCH * 9, 192).astype(np.float32)).to(dev)
    got = grads_through(nn.matmul_f32, [a16, w16[:192]], r3)
    want = grads_through(lambda a, b: torch.matmul(a.float(), b.float()), [a16, w16[:192]], r3)
    for name, a, b in zip(("dA", "dB"), got, want):
        errs[f"matmul_f32 bf16 {name}"] = within_max(a, b, 1e-2, f"matmul_f32 bf16 {name}")
    dg1, dg16, dy16 = r1, r1.to(torch.bfloat16), r2.to(torch.bfloat16)
    times = {
        "K1 float32": (device_ms(lambda: ck.patch_gram(z, 3)),
                       device_ms(lambda: ck.patch_gram_backward(z, 3, dg1))),
        "K1 bf16": (device_ms(lambda: ck.patch_gram(z16, 3)),
                    device_ms(lambda: ck.patch_gram_backward(z16, 3, dg16))),
        "K5": (device_ms(lambda: ck.gram_proj(g16, w16, b32, torch.bfloat16)),
               device_ms(lambda: ck.gram_proj_backward(g16, w16, torch.float32, dy16))),
    }
    print(f"[20] (a) gradients through the operators at z = {list(z.shape)} vs autograd through the plain "
          f"versions, max abs err / max|want|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + " (limits 1e-5 for K1 float32, 1e-2 for bf16, K5 and matmul_f32); forward kernel -> backward "
          + ", ".join(f"{k} {f * 1e3:.1f} -> {b * 1e3:.1f} us" for k, (f, b) in times.items())
          + f" | {card}")
    del z, z16, g16, r1, r2, r3, a16, dg1, dg16, dy16

    # -- (b) one PMG-shipped step, card against CPU ------------------------
    with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
        meta = json.load(f)
    spec = pmg.build_spec(meta["tasks"], meta["hparams"])
    shipped = checkpoint.load_torch_checkpoint("pmg", os.path.join(FIXTURES, "pmg_shipped.pth"), spec)
    x, y = train_batch(spec.tasks, TRAIN_BATCH, 20)
    after = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        _, step_fn = ptrain.make_train_step("pmg", spec, dropout_rate=0.0, device=d)
        params = ptrain.trainable_params(shipped, d)
        state, loss = step_fn(ptrain.TrainState(params, ptrain.make_optimizer().init(params), 0), x, y)
        grads = {p: t.grad.cpu() for p, t in zip(state.opt_state.paths, state.opt_state.leaves)}
        after[side] = (float(loss), grads, ptrain.leaf_dict(ptrain.snapshot(state.params)))
    (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = after["card"], after["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    if loss_rel > 1e-5:
        raise AssertionError(f"PMG train step loss on the card {l_card} vs the CPU {l_cpu}")
    g_top = max(float(g.abs().max()) for g in g_cpu.values())
    grad_rel = 0.0
    for path, g in g_cpu.items():
        if path.endswith("attn/bk"):
            # exact gradient 0 (the softmax is shift-invariant): rounding
            # noise on both sides, far below the model's gradients
            if max(float(g.abs().max()), float(g_card[path].abs().max())) > 1e-5 * g_top:
                raise AssertionError(f"{path}: gradient above noise")
            continue
        grad_rel = max(grad_rel, within_max(g_card[path], g, 1e-4, f"PMG step gradient {path}"))
    p_err = s_rel = 0.0
    for path, v in p_cpu.items():
        if path.endswith(("/mean", "/var")):
            s_rel = max(s_rel, within_max(p_card[path], v, 1e-5, f"running statistic {path}"))
        else:
            p_err = max(p_err, float((p_card[path] - v).abs().max()))
    if p_err > 2 * TRAIN_LR:
        raise AssertionError(f"PMG step params differ by {p_err:.3e} > 2 x lr")
    print(f"[20] (b) one PMG-shipped train step (batch {TRAIN_BATCH}, float32, TF32 off, dropout 0), card vs "
          f"CPU: loss {l_card:.6f} rel err {loss_rel:.2e} (limit 1e-5), gradients max err / leaf max "
          f"{grad_rel:.2e} (limit 1e-4; attn/bk, exactly 0, at noise), params max abs err {p_err:.2e} "
          f"(limit 2 x lr = {2 * TRAIN_LR:.0e}), running statistics {s_rel:.2e} x max (limit 1e-5)")
    del after, g_card, g_cpu, p_card, p_cpu

    # -- (c) twenty steps on one fixed batch, float32 and bf16 -------------
    xb, yb = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    counts, first = {}, {}
    for label, cdt in (("float32", None), ("bf16", torch.bfloat16)):
        _, step_fn = ptrain.make_train_step("pmg", spec, dropout_rate=0.1, augment=True,
                                            compute_dtype=cdt, device=dev)
        params = ptrain.trainable_params(shipped, dev)
        state = ptrain.TrainState(params, ptrain.make_optimizer().init(params), 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the earlier phases' live tensors, the params
        ck.reset_launches()
        state, losses, step_ms = timed_steps(step_fn, state, xb, yb, TRAIN_STEPS)
        counts[label] = launches = dict(ck.LAUNCHES)
        mem = torch.cuda.max_memory_allocated()
        want = {"patch_gram": TRAIN_STEPS, "gram_proj": TRAIN_STEPS if cdt else 0}
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"{label} train steps launched {launches}, want {want}")
        if cdt is not None:
            st = state.opt_state.adamw.state
            bad = [p for p, t in zip(state.opt_state.paths, state.opt_state.leaves)
                   if t.dtype != torch.float32 or st[t]["exp_avg"].dtype != torch.float32
                   or st[t]["exp_avg_sq"].dtype != torch.float32]
            bad += [p for p, t in ptrain.leaf_dict(state.params).items() if t.dtype != torch.float32]
            if bad:
                raise AssertionError(f"bf16 run: master params or optimizer state not float32: {bad[:4]}")
        first[label] = losses[0]
        enq = enqueue_ms(lambda: step_fn(state, xb, yb), reps=5)
        enq_opt = enqueue_ms(state.opt_state.update, reps=5)  # AdamW alone, on the last gradients
        med = statistics.median(step_ms[4:])
        print(f"[20] (c) PMG-shipped {label}, {TRAIN_STEPS} steps on one batch of {TRAIN_BATCH} (dropout 0.1, "
              f"DEFAULT_AUGMENT): loss {losses[0]:.4f} -> {losses[-1]:.4f}, {med:.3f} ms a step (CUDA events, "
              f"median of steps 5-{TRAIN_STEPS}) = {TRAIN_BATCH / med * 1e3:,.0f} train img/s, host enqueue "
              f"{enq:.3f} ms (the optimizer's update alone {enq_opt:.3f} ms), launches a step K1 "
              f"{launches['patch_gram'] / TRAIN_STEPS:g} K5 "
              f"{launches['gram_proj'] / TRAIN_STEPS:g}, max memory allocated {mem / 2**20:,.0f} MiB "
              f"({(mem - held) / 2**20:,.0f} MiB above what was held before the run) | {card}")
        if profile:
            profile_step(f"[20] PMG-shipped {label} train step at batch {TRAIN_BATCH}",
                         lambda: step_fn(state, xb, yb), steps=5)
        del state, params, step_fn
    drift = abs(first["bf16"] - first["float32"]) / abs(first["float32"])
    if drift > 2e-2:
        raise AssertionError(f"bf16 first-step loss {first['bf16']} vs float32 {first['float32']}")
    print(f"[20] (c) bf16 first-step loss vs float32: rel diff {drift:.2e} (limit 2e-2); bf16 master params "
          f"and optimizer state float32")
    del xb, yb, shipped

    # -- (d) PM and RTM at their headline widths ---------------------------
    tasks = load_tasks(default_tasks_path())
    for fam, mod, batch, hp in (("pm", pm, PM_TRAIN_BATCH, PM_TRAIN_HPARAMS),
                                ("rtm", rtm, RTM_TRAIN_BATCH, RTM_TRAIN_HPARAMS)):
        fspec = mod.build_spec(tasks, hp)
        init_fn, step_fn = ptrain.make_train_step(fam, fspec, device=dev)
        xf, yf = (torch.from_numpy(a).to(dev) for a in train_batch(fspec.tasks, batch, 21))
        n = FAMILY_TRAIN_STEPS[fam]
        state, losses, step_ms = timed_steps(step_fn, init_fn(0), xf, yf, n)
        med = statistics.median(step_ms[1:])
        print(f"[20] (d) {fam.upper()} headline ({', '.join(f'{k} {v}' for k, v in hp.items()) or 'defaults'}), "
              f"{n} float32 steps at batch {batch} from seeded init: losses {[round(v, 3) for v in losses]}, "
              f"{med:.3f} ms a step (median of steps 2-{n}) = {batch / med * 1e3:,.0f} train img/s | {card}")
        del state, init_fn, step_fn, xf, yf

    # -- (e) fit end to end, and the CLI's train mode -----------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_20_")
    try:
        frng = np.random.RandomState(22)
        manifest = {}
        for i in range(FIT_IMAGES):
            path = os.path.join(tmp, "images", f"img{i:03d}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(frng.randint(0, 256, (224, 224, 3), np.uint8)).save(path)
            entry = {"image_path": path}
            for t, classes in meta["tasks"].items():
                if frng.rand() > 0.1:
                    entry[t] = classes[frng.randint(len(classes))]
            manifest[f"img{i:03d}.png"] = entry
        data_json, tasks_json, hparams_json = (os.path.join(tmp, n) for n in
                                               ("dataset.json", "tasks.json", "hparams.json"))
        for path, obj in ((data_json, {"images": manifest}), (tasks_json, meta["tasks"]),
                          (hparams_json, {"hparams": meta["hparams"]})):
            with open(path, "w") as f:
                json.dump(obj, f)
        run_dir = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        out = port.fit("pmg", spec, data_json, tasks_json, run_dir,
                       {"epochs": 2, "batch_size": FIT_BATCH, "bf16": True, "augment": True}, device=device)
        fit_s = time.perf_counter() - t0
        made = set(os.listdir(run_dir))
        if not FIT_ARTIFACTS <= made:
            raise AssertionError(f"fit wrote {sorted(made)}, missing {sorted(FIT_ARTIFACTS - made)}")
        frames = frng.randint(0, 256, (FIT_BATCH * 2, 224, 224, 3), np.uint8)
        loaded = port.load_engine("pmg", os.path.join(run_dir, "best_model.pth"), meta["tasks"],
                                  meta["hparams"], batch_size=FIT_BATCH, device=device)
        direct = executor.Engine("pmg", spec, out["params"], batch_size=FIT_BATCH, device=device)
        if not np.array_equal(loaded.run(frames)["probs"], direct.run(frames)["probs"]):
            raise AssertionError("best_model.pth through load_engine differs from an Engine on fit's params")
        cli_dir = os.path.join(tmp, "cli")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "weather_torch.py", "pmg", "--mode", "train", "--data", data_json,
                              "--build_classifier", tasks_json, "--config_path", hparams_json,
                              "--batch_size", str(FIT_BATCH), "--epochs", "1", "--bf16", "--augment",
                              "--save_dir", cli_dir, "--device", device],
                             timeout=600, capture_output=True, text=True)
        cli_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"weather_torch.py --mode train failed:\n{run.stderr[-3000:]}")
        if set(os.listdir(cli_dir)) != made:
            raise AssertionError(f"the CLI wrote {sorted(os.listdir(cli_dir))}, fit wrote {sorted(made)}")
        hist = [round(h["train_loss"], 4) for h in out["history"]]
        print(f"[20] (e) fit (PMG-shipped hparams, random init, {FIT_IMAGES} seeded PNGs, 2 epochs, batch "
              f"{FIT_BATCH}, bf16, augmentation) in {fit_s:.1f} s: train loss {hist}, best val F1 "
              f"{out['best_f1']:.4f}, artifacts {sorted(made)}; best_model.pth via load_engine equals an Engine "
              f"on the returned params bit for bit; weather_torch.py --mode train (1 epoch) in {cli_s:.1f} s "
              f"wrote the same set | {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[20] training phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


EXPLAIN_BATCH = 32
EXPLAIN_CHECK = 4  # frames held to the port's CPU path
IG_BATCH = 4
IG_STEPS = 50
HEADLINE_CAM_BATCH = 8
HEADLINE_CAM_CHECK = 2
EXPLAIN_RTM_HPARAMS: dict = {}  # RTM's headline: ResNet-50 through layer4 (phase 12's width)
STYLE_IMAGES = 4
STYLE_ITERS = 20
STYLE_LOG_EVERY = 10
CLI_IMAGES = 16
CAM_TOL = 1e-3  # absolute (CAMs lie in [0, 1])
EXPLAIN_LOGIT_TOL = 1e-4  # times max|logit|
IG_TOL = 1e-3  # times max|attr|
STYLE_LOSS_RTOL = 1e-3
GOLDEN_CAM_TOL = 5e-3  # the JAX package's bound (tests/test_parity.py:146)
STYLE_GRAMS_TOL = 2e-3  # the JAX package's bound (tests/test_parity.py:96)
EMPTY_CAM_WEIGHT = 1e-5  # an instance norm's channel weights, times max|gradient|
# the CLI in a subprocess, with phase 18's stand-in for a missing matplotlib
CLI_EXPLAIN = """
import runpy, sys
import chip_smoke
chip_smoke.pyplot_stand_in()
sys.argv = ["weather_torch.py"] + sys.argv[1:]
runpy.run_path("weather_torch.py", run_name="__main__")
"""


def cam_parts(family, spec, params, x, ti: int, cls, target: str = "stem_conv"):
    """Grad-CAM before the min-max, through the port's split at its target:
    (raw CAM [B, h, w], channel weights [B, C], max|gradient|)."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads.explain import (
        gradcam_split,
    )

    target_feats, head_from = gradcam_split(family, spec, target)
    with torch.no_grad():
        f = target_feats(params, x)
    f.requires_grad_(True)
    with torch.enable_grad():
        lg = head_from(params, f)
        (g,) = torch.autograd.grad(lg[:, ti, :].gather(1, cls[:, None]).sum(), f)
    w = g.mean(dim=(1, 2))
    return torch.relu((f.detach() * w[:, None, None, :]).sum(-1)), w, float(g.abs().max())


def min_max(cam):
    import torch

    lo, hi = cam.amin(dim=(1, 2), keepdim=True), cam.amax(dim=(1, 2), keepdim=True)
    return (cam - lo) / torch.clamp(hi - lo, min=1e-7)


def empty_cam(w, gmax: float, what: str) -> float:
    """The CAM at an instance norm's input is 0: its input gradient has zero
    spatial mean in every channel, so the channel weights vanish up to
    float32 rounding.  Returns max|w| / max|gradient|."""
    rel = float(w.abs().max()) / gmax if gmax else 0.0
    if rel > EMPTY_CAM_WEIGHT:
        raise AssertionError(f"{what}: channel weights {rel:.3e} x max|gradient|, above "
                             f"{EMPTY_CAM_WEIGHT}: the CAM is not empty")
    return rel


def explain_phase(card: str, device: str = "cuda") -> dict:
    """Phase 21: explainability and style transfer.  (a) PMG-shipped
    Grad-CAM at batch 32 through K1 and its registered backward against
    the port's CPU path, and two golden CAMs on the card; (b) integrated
    gradients (50 Gauss-Legendre steps, batch 4); (c) PM and RTM headline
    Grad-CAM at batch 8; (d) the shipped style grams and 20 iterations of
    the style loop on 4 images against the CPU; (e) the CLI's classifier
    mode with every explain and style flag on 16 seeded PNGs.  Returns K1's
    launches on the Grad-CAM and IG paths, each read just after the path
    with the counts reset just before it.  (``device="cpu"`` rehearses the
    phase on the plain versions.)"""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import (
        pm, rtm,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.gram import (
        style_patch_grams,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
        normalize_uint8,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import (
        explain, style_transfer,
    )

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def wall_ms(fn, reps: int = 3) -> float:
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    def launched(what: str) -> dict:
        sync()
        got = dict(ck.LAUNCHES)
        if on_card and got["patch_gram"] < 1:
            raise AssertionError(f"{what} never launched the patch_gram kernel")
        return got

    t_phase = time.perf_counter()
    if isinstance(sys.modules.get("matplotlib.pyplot"), PyplotRecorder):
        print("[21] matplotlib is not installed here: overlays take phase 18's stand-in, a gray "
              "colormap; the CAMs and attributions are checked before they are drawn")
    with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
        meta = json.load(f)
    eng = port.load_engine("pmg", os.path.join(FIXTURES, "pmg_shipped.pth"), meta["tasks"],
                           meta["hparams"], batch_size=EXPLAIN_BATCH, device=device)
    spec = eng.spec
    ex = explain.Explainer("pmg", spec, eng.params, device=device)
    cpu_ex = explain.Explainer("pmg", spec, checkpoint.to_device(eng.params, "cpu"), device="cpu")
    task = spec.tasks.names[0]
    frames = np.random.RandomState(21).randint(0, 256, (EXPLAIN_BATCH, 224, 224, 3), np.uint8)
    x8 = torch.from_numpy(frames).to(dev)
    targets = ex.resolve_targets(task, None, ex.logits(frames))
    cls = torch.from_numpy(targets).to(dev)
    counts = {}

    # -- (a) PMG-shipped Grad-CAM through K1 ------------------------------
    ck.reset_launches()
    cam, logits = ex.gradcam_tensors(x8, task, cls)
    counts["gradcam"] = launched("PMG Grad-CAM")
    want_cam, want_logits = cpu_ex.gradcam(frames[:EXPLAIN_CHECK], task, targets[:EXPLAIN_CHECK])
    cam_err = max_err(cam[:EXPLAIN_CHECK].cpu(), torch.from_numpy(want_cam), CAM_TOL, 0.0,
                      "PMG Grad-CAM vs the port's CPU path")
    lscale = float(np.abs(want_logits).max())
    logit_err = max_err(logits[:EXPLAIN_CHECK].cpu(), torch.from_numpy(want_logits),
                        EXPLAIN_LOGIT_TOL * lscale, 0.0, "PMG Grad-CAM logits vs the port's CPU path")
    gc_wall = wall_ms(lambda: ex.gradcam_tensors(x8, task, cls))
    gc_dev = device_ms(lambda: ex.gradcam_tensors(x8, task, cls), reps=5, rounds=3) if on_card else None
    print(f"[21] (a) PMG-shipped Grad-CAM (last trunk conv, task {task!r}, batch {EXPLAIN_BATCH}, float32, "
          f"TF32 off): K1 launches {counts['gradcam']['patch_gram']} in one call (forward; its backward is "
          f"the registered plain product); vs the CPU path on {EXPLAIN_CHECK} frames CAM max abs err "
          f"{cam_err:.3e} (atol {CAM_TOL}), logits {logit_err:.3e} (atol {EXPLAIN_LOGIT_TOL} x max|logit| "
          f"{lscale:.3f}); {gc_wall:.3f} ms a call wall = {EXPLAIN_BATCH / gc_wall * 1e3:,.0f} img/s"
          + (f", {gc_dev:.3f} ms of device time" if gc_dev is not None else "") + f" | {card}")

    golden = {}
    for name in ("pmg_tiny_instance_se", "pm_batchnorm_sigmoid"):
        with open(os.path.join(FIXTURES, f"{name}.json")) as f:
            gmeta = json.load(f)
        data = np.load(os.path.join(FIXTURES, f"{name}.npz"))
        geng = port.load_engine(gmeta["family"], os.path.join(FIXTURES, f"{name}.pth"), gmeta["tasks"],
                                gmeta["hparams"], batch_size=2, device=device)
        xf = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))).to(dev)
        ti = geng.spec.tasks.names.index(str(data["gradcam/task"]))
        gcls = torch.from_numpy(data["gradcam/classes"].astype(np.int64)).to(dev)
        raw, w, gmax = cam_parts(gmeta["family"], geng.spec, geng.params, xf, ti, gcls)
        want = data["gradcam/cam"]
        if want.max() == 1.0:  # the reference's CAM carries a signal
            golden[name] = "max abs err %.3e (atol/rtol %s)" % (max_err(
                min_max(raw).cpu(), torch.from_numpy(want), GOLDEN_CAM_TOL, GOLDEN_CAM_TOL,
                f"{name} golden CAM on the card"), GOLDEN_CAM_TOL)
        else:  # instance norm at the target: the CAM is 0, the fixture rounding noise
            golden[name] = "empty as the reference's: channel weights %.3e x max|gradient| (bound %s)" % (
                empty_cam(w, gmax, f"{name} golden CAM on the card"), EMPTY_CAM_WEIGHT)
    print("[21] (a) golden CAMs on the card: " + "; ".join(f"{n} {v}" for n, v in golden.items()))

    # -- (b) integrated gradients through K1 -------------------------------
    ck.reset_launches()
    attr = ex.integrated_gradients_tensor(x8[:IG_BATCH], task, cls[:IG_BATCH], steps=IG_STEPS)
    counts["integrated_gradients"] = launched("PMG integrated gradients")
    want_attr = cpu_ex.integrated_gradients(frames[:IG_BATCH], task, targets[:IG_BATCH], steps=IG_STEPS)
    ig_rel = within_max(attr.cpu(), torch.from_numpy(want_attr), IG_TOL,
                        "PMG integrated gradients vs the port's CPU path")
    ig_wall = wall_ms(lambda: ex.integrated_gradients_tensor(x8[:IG_BATCH], task, cls[:IG_BATCH],
                                                               steps=IG_STEPS), reps=2)
    print(f"[21] (b) PMG-shipped integrated gradients ({IG_STEPS} Gauss-Legendre steps, batch {IG_BATCH}): "
          f"K1 launches {counts['integrated_gradients']['patch_gram']} in one call; vs the CPU path max abs "
          f"err {ig_rel:.3e} x max|attr| (bound {IG_TOL}); {ig_wall:.1f} ms a call wall, "
          f"{ig_wall / IG_STEPS:.2f} ms a step | {card}")

    # -- (c) PM and RTM headline Grad-CAM ----------------------------------
    tasks = config.load_tasks(config.default_tasks_path())
    rng = np.random.RandomState(22)
    hframes = rng.randint(0, 256, (HEADLINE_CAM_BATCH, 224, 224, 3), np.uint8)
    hx8 = torch.from_numpy(hframes).to(dev)
    hx = normalize_uint8(hx8)
    for family, hspec in (("pm", pm.build_spec(tasks, {})),
                          ("rtm", rtm.build_spec(tasks, EXPLAIN_RTM_HPARAMS))):
        # phase 16's and phase 12's seeded weights
        hparams = (pm.init(torch.Generator().manual_seed(16), hspec) if family == "pm"
                   else random_rtm_params(hspec, seed=12))
        hex_card = explain.Explainer(family, hspec, hparams, device=device)
        hex_cpu = explain.Explainer(family, hspec, hparams, device="cpu")
        htask = hspec.tasks.names[0]
        hcls = torch.from_numpy(hex_card.resolve_targets(htask, None, hex_card.logits(hx8))).to(dev)
        ti = 0
        raw, w, gmax = cam_parts(family, hspec, hex_card.params, hx, ti, hcls)
        raw_cpu, w_cpu, gmax_cpu = cam_parts(family, hspec, hex_cpu.params, hx[:HEADLINE_CAM_CHECK].cpu(),
                                             ti, hcls[:HEADLINE_CAM_CHECK].cpu())
        if family == "pm" and hspec.norm == "instance":
            verdict = "CAM empty on both (instance norm at the target): channel weights %.3e / %.3e x " \
                      "max|gradient| on the card / CPU (bound %s)" % (
                          empty_cam(w, gmax, "PM headline CAM on the card"),
                          empty_cam(w_cpu, gmax_cpu, "PM headline CAM on the CPU"), EMPTY_CAM_WEIGHT)
        else:
            verdict = "CAM vs the CPU path on %d frames max abs err %.3e (atol %s)" % (
                HEADLINE_CAM_CHECK, max_err(min_max(raw)[:HEADLINE_CAM_CHECK].cpu(), min_max(raw_cpu),
                                            CAM_TOL, 0.0, f"{family} headline CAM vs the CPU path"),
                CAM_TOL)
        ms = wall_ms(lambda: hex_card.gradcam_tensors(hx8, htask, hcls))
        print(f"[21] (c) {family.upper()} headline Grad-CAM (seeded weights, target "
              f"{'the last trunk conv' if family == 'pm' else 'stem conv1'}, batch {HEADLINE_CAM_BATCH}): "
              f"{verdict}; {ms:.2f} ms a call wall | {card}")
        del hex_card, hex_cpu

    # -- (d) style transfer on PMG shipped ---------------------------------
    data = np.load(os.path.join(FIXTURES, "pmg_shipped.npz"))
    xf = torch.from_numpy(np.ascontiguousarray(data["input"][0:1].transpose(0, 2, 3, 1))).to(dev)
    with torch.no_grad():
        sg = style_transfer.extract_style_grams(eng.params, spec, xf)[0]
    sg_err = max_err(sg.cpu(), torch.from_numpy(data["style_grams"]), STYLE_GRAMS_TOL, STYLE_GRAMS_TOL,
                     "pmg_shipped style grams on the card")
    styles = np.stack([(f.astype(np.float32) / 255.0 - np.asarray(config.IMAGENET_MEAN, np.float32))
                       / np.asarray(config.IMAGENET_STD, np.float32)
                       for f in np.random.RandomState(23).randint(0, 256, (STYLE_IMAGES, 224, 224, 3),
                                                                  np.uint8)])
    kw = dict(num_iterations=STYLE_ITERS, init_type="gray", target_loss=0.0, log_every=STYLE_LOG_EVERY)
    t0 = time.perf_counter()
    imgs, loss, iters = style_transfer.run_patch_gram_style_transfer_batch(eng.params, spec, styles,
                                                                            device=device, **kw)
    st_ms = (time.perf_counter() - t0) * 1e3
    _, loss_cpu, iters_cpu = style_transfer.run_patch_gram_style_transfer_batch(
        cpu_ex.params, spec, styles, device="cpu", **kw)
    if not np.array_equal(iters, iters_cpu):
        raise AssertionError(f"style loop iterations {iters} on the card, {iters_cpu} on the CPU")
    st_rel = float(np.max(np.abs(loss - loss_cpu) / np.abs(loss_cpu)))
    if not np.isfinite(loss).all() or st_rel > STYLE_LOSS_RTOL:
        raise AssertionError(f"style losses {loss} on the card, {loss_cpu} on the CPU")
    print(f"[21] (d) style: pmg_shipped style grams on the card max abs err {sg_err:.3e} (atol/rtol "
          f"{STYLE_GRAMS_TOL}); style loop on {STYLE_IMAGES} seeded 224 px images, gray init, {STYLE_ITERS} "
          f"iterations, log_every {STYLE_LOG_EVERY}: losses {[float('%.6g' % v) for v in loss]} vs the CPU "
          f"within {st_rel:.3e} relative (bound {STYLE_LOSS_RTOL}), iterations {iters.tolist()} equal; "
          f"{st_ms / STYLE_ITERS:.2f} ms an iteration wall (first call, host reads included) | {card}")
    del imgs

    # -- (e) the CLI's classifier mode with every explain and style flag ----
    tmp = tempfile.mkdtemp(prefix="chip_smoke_21_")
    try:
        frng = np.random.RandomState(24)
        manifest = {}
        for i in range(CLI_IMAGES):
            path = os.path.join(tmp, "images", f"img{i:03d}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(frng.randint(0, 256, (224, 224, 3), np.uint8)).save(path)
            entry = {"image_path": path}
            for t, classes in meta["tasks"].items():
                if frng.rand() > 0.1:
                    entry[t] = classes[frng.randint(len(classes))]
            manifest[f"img{i:03d}.png"] = entry
        data_json, tasks_json = os.path.join(tmp, "dataset.json"), os.path.join(tmp, "tasks.json")
        for path, obj in ((data_json, {"images": manifest}), (tasks_json, meta["tasks"])):
            with open(path, "w") as f:
                json.dump(obj, f)
        save = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", CLI_EXPLAIN, "pmg", "--mode", "classifier",
                              "--data", data_json, "--build_classifier", tasks_json,
                              "--model_path", os.path.join(FIXTURES, "pmg_shipped.pth"),
                              "--batch_size", str(CLI_IMAGES), "--visualize_gradcam",
                              "--save_gradcam_images", "--integrated_gradients", "--style_transfer",
                              "--style_iterations", "5", "--save_dir", save, "--device", device],
                             timeout=600, capture_output=True, text=True)
        cli_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"weather_torch.py --mode classifier with the explain flags failed:\n"
                                 f"{run.stderr[-3000:]}")
        made = {d: sorted(os.listdir(os.path.join(save, d)))
                for d in ("gradcam", "integrated_gradients", "StyleTransfer")}
        # the JAX CLI's names (class names follow the predictions)
        want = {"gradcam": [f"gradcam_b0000_i{i:03d}_task-{task}_class-" for i in range(CLI_IMAGES)],
                "integrated_gradients": [f"ig_b0000_i{i:03d}_task-{task}.png" for i in range(CLI_IMAGES)],
                "StyleTransfer": [f"img{i:03d}_styled.png" for i in range(CLI_IMAGES)]}
        for d, prefixes in want.items():
            names = made[d]
            if len(names) != CLI_IMAGES or not all(n.startswith(p) for n, p in zip(names, prefixes)):
                raise AssertionError(f"the CLI wrote {d}/{names[:3]}..., want {prefixes[:3]}...")
        print(f"[21] (e) weather_torch.py pmg --mode classifier --visualize_gradcam --save_gradcam_images "
              f"--integrated_gradients --style_transfer --style_iterations 5 on {CLI_IMAGES} seeded PNGs "
              f"(batch {CLI_IMAGES}, a subprocess): {cli_s:.1f} s wall, wrote "
              + ", ".join(f"{d}/ {len(v)} files ({v[0]}, ...)" for d, v in made.items()) + f" | {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[21] explain and style phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


STREAM16_FRAMES = CAMERA_FRAMES  # seeded frames a route, in (a) and (c)
# max |p_bf16 - p_float32| of RTM at full width, camera and batch: 1.5 x the most measured (7.359e-2,
# phase 17, PR 12's first run; PERF.md section 2)
RTM_BF16_DRIFT = 0.11
BF16_CAMERA_DRIFT = 5e-3  # max |p_bf16 - p_float32| of the PMG and PM bf16 cameras (PERF.md section 2)
EMBED_FRAMES = 2048
EMBED_BATCH = 256
TSNE_SUB = 512  # points held card against CPU
TSNE_KL_REL = 1e-2  # KL of the card's layout against the CPU's, relative
TSNE_TRUST_TOL = 0.01
EMBED_CLI_IMAGES = 64


def stream_bf16_embed_phase(card: str, routes: list, device: str = "cuda", old: dict | None = None) -> tuple:
    """Phase 22: the bf16 camera path and the embedding workloads.  (a) The
    shipped PMG's bf16 camera on the fused, packed and generic routes,
    Kalman on and off: fused bit for bit float32's, packed bit for bit
    ``Engine(dtype=bf16, batch_size=1)``, generic bit for bit ``pmg.apply``
    on the bf16 tree at batch 1, both within BF16_CAMERA_DRIFT of float32;
    (b) K6's bf16 mode against its plain version at the camera shape, with
    its time, bound and yardstick (and the archived K6 in turns where
    ``old`` holds it); (c) the PM and RTM headline bf16 cameras
    within BF16_CAMERA_DRIFT and RTM_BF16_DRIFT of the card's float32 ones;
    (d) ``compute_embeddings`` on the shipped PMG (float32 with the logits
    and pooled taps, bf16), the t-SNE on the card (and on its first TSNE_SUB points against the
    CPU) and HDBSCAN on one class; (e) the CLI's tsne, tsne_interactive and
    clustering modes on seeded PNGs, in the process.  Appends each timed
    bf16 route to ``routes``; returns (K6's bf16 entry of the kernels line,
    the launches of each bf16 camera route, the launches of each embedding
    path).  (``device="cpu"`` rehearses the phase on the plain versions.)"""
    import itertools
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import cli, config
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.data import (
        BatchLoader,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import (
        pm, pmg, rtm,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.nn import (
        cast_tree,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops.preprocess import (
        normalize_uint8,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import (
        hdbscan as hdb, tsne as ts,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import (
        embed, stream,
    )

    bf16 = torch.bfloat16
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def run(p, frames):
        handles = [p.submit(f) for f in frames]
        return np.stack([np.asarray(h) for h in handles])

    def counted(fn):
        sync()
        ck.reset_launches()
        out = fn()
        sync()
        return out, {k: v for k, v in ck.LAUNCHES.items() if v}

    def want_launches(what, got, want):
        if on_card and any(got.get(k, 0) != v for k, v in want.items()):
            raise AssertionError(f"{what} launched {got}, want {want}")

    t_phase = time.perf_counter()
    with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
        meta = json.load(f)
    eng = port.load_engine("pmg", os.path.join(FIXTURES, "pmg_shipped.pth"), meta["tasks"],
                           meta["hparams"], batch_size=1, device=device)
    spec, params = eng.spec, eng.params
    mask = executor.class_mask(spec.tasks)
    tmask = torch.as_tensor(mask, device=dev)
    cam = np.random.RandomState(22).randint(0, 256, (STREAM16_FRAMES, 224, 224, 3), np.uint8)
    x1 = torch.from_numpy(cam[:1]).to(dev)

    # -- (a) the shipped PMG's bf16 camera, route by route --------------------
    stream_launches = {}
    expect = {route: dict.fromkeys(names, STREAM16_FRAMES) for route, names in (
        ("fused", ("fused_trunk_gram", "fused_head")), ("packed", ("stem", "patch_gram", "gram_proj")),
        ("generic", ("patch_gram", "gram_proj")))}
    eng16 = executor.Engine("pmg", spec, params, batch_size=1, dtype=bf16, device=device)
    p16_run = cast_tree(params, bf16)
    for route in ("fused", "packed", "generic"):
        notes = []
        for kalman_on in (True, False):
            p32 = stream.StreamPredictor("pmg", spec, params, use_kalman=kalman_on, trunk_kernel=route,
                                         device=device)
            p16 = stream.StreamPredictor("pmg", spec, params, use_kalman=kalman_on, trunk_kernel=route,
                                         dtype=bf16, device=device)
            a = run(p32, cam)
            b, launches = counted(lambda: run(p16, cam))
            want_launches(f"PMG bf16 camera {route}", launches, expect[route])
            if kalman_on:
                stream_launches[f"pmg_{route}"] = launches
            tag = "Kalman on" if kalman_on else "Kalman off"
            if route == "fused":
                if not np.array_equal(a, b):
                    raise AssertionError(f"PMG fused bf16 camera ({tag}) differs from float32")
                notes.append(f"{tag} bit for bit float32's")
                continue
            if kalman_on:
                continue
            if route == "packed":
                ref = eng16.run(cam)["probs"]
                what = "Engine(dtype=bf16, batch_size=1).run"
            else:
                with torch.inference_mode():
                    ref = np.stack([executor.masked_softmax(pmg.apply(
                        p16_run, normalize_uint8(torch.from_numpy(f[None]).to(dev), bf16),
                        spec)[0].float(), tmask)[0].cpu().numpy() for f in cam])
                what = "pmg.apply on the bf16 tree at batch 1"
            if not np.array_equal(b, ref):
                raise AssertionError(f"PMG {route} bf16 camera differs from {what}: max "
                                     f"{np.abs(b - ref).max():.3e}")
            agree, drift = agreement(b, a)
            if drift > BF16_CAMERA_DRIFT:
                raise AssertionError(f"PMG {route} bf16 camera vs float32: max prob drift {drift:.3e} "
                                     f"(bound {BF16_CAMERA_DRIFT})")
            notes.append(f"{tag} bit for bit {what}; vs float32 max prob drift {drift:.3e} (gate "
                         f"{BF16_CAMERA_DRIFT}), argmax agrees on {agree:.4f} of (frame, task) pairs")
        print(f"[22] (a) PMG-shipped bf16 camera {route} over {STREAM16_FRAMES} frames: " + "; ".join(notes)
              + f"; launches with Kalman on {stream_launches[f'pmg_{route}']}")
        if on_card:
            label = f"[22] (a) PMG-shipped bf16 camera step {route}"
            p16 = stream.StreamPredictor("pmg", spec, params, use_kalman=True, trunk_kernel=route,
                                         dtype=bf16, device=device)
            route_latency(label, p16, x1, cam, card)
            routes.append((label, p16, x1))
    del eng16, p16_run

    # -- (b) K6's bf16 mode against its plain version -------------------------
    rng = np.random.RandomState(220)
    t, c, d = 12, 2048, 2048
    xq = torch.from_numpy(rng.randn(1, t, c).astype(np.float32)).to(dev).to(bf16)
    w8 = torch.from_numpy(rng.randint(-127, 128, (t, c, d)).astype(np.int8)).to(dev)
    sc = torch.from_numpy((rng.rand(t, d).astype(np.float32) + 0.5) * 1e-3).to(dev).to(bf16)
    got = ck.dequant_matvec(xq, w8, sc)
    sync()
    want = ck.dequant_matvec_plain(xq, w8, sc)
    ymax = float(want.abs().max())
    k6_err = max_err(got, want, K6_TOL * ymax, 0.0, "dequant_matvec bf16 [1,12,2048,2048]")
    k6 = {"name": "dequant_matvec_bf16", "route": "cuda", "source": f"{PORT}/csrc/int8_matvec.cu",
          "replaces": "tools/exp_rtm_int8_stream.py:77", "launches": None, "max_abs_err": k6_err}
    if on_card:
        # L2 out of play: 4 rotating copies of the weights (4 x 50.3 MB)
        copies = [(w8.clone(), sc.clone()) for _ in range(4)]
        ring, ring_plain = itertools.cycle(copies), itertools.cycle(copies)
        k6["ms"] = device_ms(lambda: ck.dequant_matvec(xq, *next(ring)))
        k6["plain_ms"] = device_ms(lambda: ck.dequant_matvec_plain(xq, *next(ring_plain)))
        turns = k6_turns(old or {}, "wadt_dequant_matvec_bf16", xq, copies, card)
        if turns:
            print(f"[22] (b) {turns}")
        # partial yardstick: one torch.bmm, float32 out, on the fold
        # dequantized to bf16 beforehand (100.7 MB, twice the bytes of w8)
        deq = (w8.to(bf16) * sc[:, None, :]).contiguous()
        xt = xq[0][:, None, :].contiguous()
        k6["library_ms"] = device_ms(lambda: torch.bmm(xt, deq, out_dtype=torch.float32))
        del copies, deq
        nbytes = xq.numel() * 2 + w8.numel() + sc.numel() * 2 + t * d * 4
        # a product, a sum and the dequantizing multiply a weight, in float32
        k6["bound_ms"], k6["bound_by"] = bound_ms(nbytes, 3.0 * t * c * d)
        print(f"[22] (b) dequant_matvec bf16 mode at [1,{t},{c}] x [{t},{c},{d}]: max abs err "
              f"{k6_err:.3e} = {k6_err / ymax:.3e} x max|y| (bound {K6_TOL}); L2 out of play: "
              f"{k6['ms'] * 1e3:.1f} us (bound {k6['bound_ms'] * 1e3:.2f} us by {k6['bound_by']}), plain "
              f"{k6['plain_ms'] * 1e3:.1f} us, torch.bmm on the bf16-dequantized fold (float32 out) "
              f"{k6['library_ms'] * 1e3:.1f} us | {card}")
    del w8, sc

    # -- (c) PM and RTM headline bf16 cameras against float32 ------------------
    tasks = config.load_tasks(config.default_tasks_path())
    pm_spec = pm.build_spec(tasks, {})
    rtm_spec = rtm.build_spec(tasks, {})
    heads = [("pm", pm_spec, pm.init(torch.Generator().manual_seed(16), pm_spec), ("generic",)),
             ("rtm", rtm_spec, random_rtm_params(rtm_spec, seed=12), ("generic", "folded", "folded_q8"))]
    rtm_drift = 0.0
    for family, fspec, fparams, froutes in heads:
        for route in froutes:
            p32 = stream.StreamPredictor(family, fspec, fparams, trunk_kernel=route, device=device)
            p16 = stream.StreamPredictor(family, fspec, fparams, trunk_kernel=route, dtype=bf16,
                                         device=device)
            a = run(p32, cam)
            b, launches = counted(lambda: run(p16, cam))
            if route == "folded_q8":
                want_launches("RTM bf16 camera folded_q8", launches, {"dequant_matvec": STREAM16_FRAMES})
                stream_launches["rtm_folded_q8"] = launches
                k6["launches"] = launches.get("dequant_matvec", 0)
            agree, drift = agreement(b, a)
            bound = RTM_BF16_DRIFT if family == "rtm" else BF16_CAMERA_DRIFT
            if family == "rtm":
                rtm_drift = max(rtm_drift, drift)
            if drift > bound:
                raise AssertionError(f"{family.upper()} {route} bf16 camera vs float32: max prob drift "
                                     f"{drift:.3e} (bound {bound})")
            print(f"[22] (c) {family.upper()} headline bf16 camera {route} over {STREAM16_FRAMES} frames "
                  f"vs the card's float32 predictor: max prob drift {drift:.3e} (gate {bound}), "
                  f"argmax agrees on {agree:.4f} of (frame, task) pairs; launches {launches}")
            if on_card:
                label = f"[22] (c) {family.upper()} headline bf16 camera step {route}"
                route_latency(label, p16, x1, cam, card)
                routes.append((label, p16, x1))
    del heads

    # -- (d) embeddings, t-SNE and HDBSCAN on the shipped PMG -------------------
    embed_launches = {}
    rng = np.random.RandomState(23)
    frames = rng.randint(0, 256, (EMBED_FRAMES, 224, 224, 3), np.uint8)
    labels = eval_labels(spec.tasks, EMBED_FRAMES, rng)
    dataset = FrameDataset(frames, labels, spec.tasks.names)
    bs = min(EMBED_BATCH, EMBED_FRAMES)
    eng32 = executor.Engine("pmg", spec, params, batch_size=bs, capture=("pooled",), device=device)
    eng16 = executor.Engine("pmg", spec, params, batch_size=bs, dtype=bf16, device=device)
    n_batches = -(-EMBED_FRAMES // bs)
    walls = {}
    results = {}
    for label, e, kind in (("float32 logits", eng32, "logits"), ("float32 pooled", eng32, "pooled"),
                           ("bf16 logits", eng16, "logits")):
        e.run(frames[:bs])  # warm
        t0 = time.perf_counter()
        res, launches = counted(lambda: embed.compute_embeddings(
            e, BatchLoader(dataset, batch_size=bs, pack_k=e.pack_k), kind=kind))
        walls[label] = time.perf_counter() - t0
        want = {"stem": n_batches, "patch_gram": n_batches}
        if label.startswith("bf16"):
            want["gram_proj"] = n_batches
        want_launches(f"compute_embeddings {label}", launches, want)
        embed_launches[label.replace(" ", "_")] = launches
        results[label] = res
    sync()
    t0 = time.perf_counter()
    ref = eng32.run(frames, collect=("logits",))["logits"]
    sync()
    run_wall_s = time.perf_counter() - t0
    embs, labs, paths = results["float32 logits"]
    t0_name = spec.tasks.names[0]
    k0 = spec.tasks.num_classes[0]
    if not np.array_equal(embs[t0_name], ref[:, 0, :k0]) or paths[t0_name] != dataset.paths():
        raise AssertionError("compute_embeddings' logits differ from Engine.run's on the same frames")
    pooled = results["float32 pooled"][0][t0_name]
    if pooled.shape != (EMBED_FRAMES, spec.d_model) or not np.isfinite(pooled).all():
        raise AssertionError(f"pooled embeddings {pooled.shape}")
    print(f"[22] (d) compute_embeddings, PMG shipped, {EMBED_FRAMES} seeded labelled frames at batch {bs}: "
          + ", ".join(f"{k} {EMBED_FRAMES / w:,.0f} img/s" for k, w in walls.items())
          + f"; Engine.run on the same frames {EMBED_FRAMES / run_wall_s:,.0f} img/s; logits equal "
          f"Engine.run's; launches {embed_launches} | {card}")

    x = torch.from_numpy(embs[t0_name]).to(dev)
    perp = min(30.0, max(1.0, (EMBED_FRAMES - 1) / 3.0))
    t0 = time.perf_counter()
    (y, kl), launches = counted(lambda: ts.tsne(x, perp))
    tsne_s = time.perf_counter() - t0
    if y.shape != (EMBED_FRAMES, 2) or not torch.isfinite(y).all() or not np.isfinite(kl):
        raise AssertionError("t-SNE layout not finite")
    if on_card and not 0 < launches.get("tsne_repulsion", 0) <= 1000:
        raise AssertionError(f"t-SNE at N {EMBED_FRAMES} launched {launches}")
    embed_launches[f"tsne_n{EMBED_FRAMES}"] = launches
    sub = embs[t0_name][:TSNE_SUB]
    psub = min(30.0, max(1.0, (TSNE_SUB - 1) / 3.0))
    t0 = time.perf_counter()
    (ys, kls), launches = counted(lambda: ts.tsne(torch.from_numpy(sub).to(dev), psub))
    sub_s = time.perf_counter() - t0
    embed_launches[f"tsne_n{TSNE_SUB}"] = launches
    t0 = time.perf_counter()
    yc, klc = ts.tsne(torch.from_numpy(sub), psub)
    cpu_s = time.perf_counter() - t0
    xs = torch.from_numpy(sub)
    tr_card, tr_cpu = ts.trustworthiness(xs, ys.cpu()), ts.trustworthiness(xs, yc)
    if abs(kls - klc) > TSNE_KL_REL * klc or abs(tr_card - tr_cpu) > TSNE_TRUST_TOL:
        raise AssertionError(f"t-SNE on {TSNE_SUB} points, card vs CPU: KL {kls:.5f} vs {klc:.5f}, "
                             f"trustworthiness {tr_card:.4f} vs {tr_cpu:.4f}")
    rep_line = ""
    if on_card:
        ys2, kls2 = ts.tsne(torch.from_numpy(sub).to(dev), psub)
        if not torch.equal(ys2, ys) or kls2 != kls:
            raise AssertionError(f"t-SNE on {TSNE_SUB} points: two runs on the card differ "
                                 f"(KL {kls!r} vs {kls2!r})")
        rep_line = "; a second run on the card bit-identical"
        # the kernel on this path's final layouts against its float64 plain version
        for what, yl in ((f"N {EMBED_FRAMES}", y), (f"N {TSNE_SUB}", ys)):
            c = repulsion_check(ck, yl.contiguous(), f"{what}, final layout of [22] (d)", sync)
            rep_line += (f"; tsne_repulsion vs plain float64 at the {what} layout: rep "
                         f"{c['rep_err'] / c['rep_max']:.2e} x max|rep| (limit {TSNE_REP_TOL}), z rows rel "
                         f"{c['z_rel']:.2e}, Z rel {c['z_sum_rel']:.2e} (limit {TSNE_Z_TOL})")
    cls = int(np.bincount(labs[t0_name][labs[t0_name] >= 0]).argmax())
    keep = labs[t0_name] == cls
    emb_cls = embs[t0_name][keep]
    t0 = time.perf_counter()
    clus, launches = counted(lambda: embed.hdbscan_clustering(
        emb_cls, [p for p, k in zip(paths[t0_name], keep) if k], device=device))
    hdb_s = time.perf_counter() - t0
    embed_launches["hdbscan_clustering"] = launches
    distinct = len({min(ms, len(emb_cls)) for ms in (5, 10)})
    want_launches("hdbscan_clustering", launches, {"hdbscan_core": distinct, "hdbscan_mst": distinct})
    t0 = time.perf_counter()
    hdb_labels = hdb.hdbscan(emb_cls, 10, 5, device=device)
    sync()
    hdb1_s = time.perf_counter() - t0
    if not np.array_equal(hdb_labels, hdb.hdbscan(emb_cls, 10, 5, device="cpu")):
        raise AssertionError(f"HDBSCAN (10, 5) of class {cls} on {device}: labels differ from the CPU's")
    print(f"[22] (d) t-SNE (Barnes-Hut objective, exact repulsion, perplexity {perp:g}) of task "
          f"{t0_name!r}'s logits on the card: N {EMBED_FRAMES} in {tsne_s * 1e3:.0f} ms, KL {kl:.5f}, "
          f"{embed_launches[f'tsne_n{EMBED_FRAMES}']}; its first {TSNE_SUB} points on the card "
          f"{sub_s * 1e3:.0f} ms and on the CPU {cpu_s * 1e3:.0f} ms: KL {kls:.5f} vs {klc:.5f} "
          f"(rel {abs(kls - klc) / klc:.2e}, bound {TSNE_KL_REL}), trustworthiness {tr_card:.4f} vs "
          f"{tr_cpu:.4f} (bound {TSNE_TRUST_TOL}); hdbscan_clustering on class {cls} ({int(keep.sum())} "
          f"points, 6-point grid, one core-distance and one MST launch a distinct min_samples: "
          f"{embed_launches['hdbscan_clustering']}): {hdb_s * 1e3:.0f} ms, {clus['n_clusters']} clusters; "
          f"one HDBSCAN (10, 5) {hdb1_s * 1e3:.0f} ms ({dev.type}; its labels the CPU's, label for label)"
          f"{rep_line} | {card}")
    del frames, dataset, eng32, eng16, results, x

    # -- (e) the CLI's embedding modes on seeded PNGs, in the process ----------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_22_")
    recorder = pyplot_stand_in()
    if recorder is not None:
        print("[22] (e) matplotlib is not installed here: perform_tsne draws into phase 18's "
              "recording stand-in, which checks that each t-SNE PNG was asked for")
    try:
        frng = np.random.RandomState(25)
        manifest = {}
        for i in range(EMBED_CLI_IMAGES):
            path = os.path.join(tmp, "images", f"img{i:03d}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(frng.randint(0, 256, (224, 224, 3), np.uint8)).save(path)
            entry = {"image_path": path}
            for task, classes in meta["tasks"].items():
                entry[task] = classes[frng.randint(len(classes))]
            manifest[f"img{i:03d}.png"] = entry
        data_json, tasks_json = os.path.join(tmp, "dataset.json"), os.path.join(tmp, "tasks.json")
        for path, obj in ((data_json, {"images": manifest}), (tasks_json, meta["tasks"])):
            with open(path, "w") as f:
                json.dump(obj, f)
        first_task = next(iter(meta["tasks"]))
        first_class = meta["tasks"][first_task][0]
        cli_walls = {}
        for mode, extra, want in (
                ("tsne", [], ["tsne_AllTasks.png"]),
                ("tsne_interactive", [], ["tsne_interactive.html"]
                 + [f"tsne_{t.replace(' ', '_')}.png" for t in meta["tasks"]]),
                ("clustering", ["--clustering_class", first_class, "--min_cluster_size", "3",
                                "--min_samples", "2"],
                 [f"{first_class.replace(' ', '_')}_clustering_results.json"])):
            save = os.path.join(tmp, mode)
            t0 = time.perf_counter()
            rc = cli.main(["pmg", "--mode", mode, "--data", data_json, "--build_classifier", tasks_json,
                           "--model_path", os.path.join(FIXTURES, "pmg_shipped.pth"),
                           "--batch_size", str(EMBED_CLI_IMAGES), "--num_workers", "4",
                           "--save_dir", save, "--device", device]
                          + extra)
            cli_walls[mode] = time.perf_counter() - t0
            made = set(os.listdir(save))
            drawn = {os.path.basename(p) for p in recorder.saved} if recorder else set()
            missing = [w for w in want if w not in made and not (w.endswith(".png") and w in drawn)]
            if rc != 0 or missing:
                raise AssertionError(f"weather_torch.py pmg --mode {mode}: rc {rc}, missing {missing}")
        with open(os.path.join(tmp, "tsne_interactive", "tsne_interactive.html")) as f:
            html = f.read()
        if html.count("/9j/") < EMBED_CLI_IMAGES:
            raise AssertionError("tsne_interactive.html carries fewer thumbnails than images")
        print(f"[22] (e) weather_torch.py pmg on {EMBED_CLI_IMAGES} seeded PNGs (cli.main in this process, "
              f"batch {EMBED_CLI_IMAGES}): "
              + ", ".join(f"--mode {m} {w:.1f} s wall" for m, w in cli_walls.items())
              + f"; wrote the JAX CLI's names (tsne_AllTasks.png, tsne_<task>.png x "
              f"{len(meta['tasks'])}, tsne_interactive.html with {EMBED_CLI_IMAGES} thumbnails, "
              f"{first_class.replace(' ', '_')}_clustering_results.json)"
              + ("; the PNGs through phase 18's stand-in (no matplotlib here)" if recorder else "")
              + f" | {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if recorder is not None:
            del sys.modules["matplotlib"], sys.modules["matplotlib.pyplot"]
    print(f"[22] bf16 camera and embedding phase took {time.perf_counter() - t_phase:.1f} s; RTM bf16 "
          f"camera drift at most {rtm_drift:.3e}")
    return k6, stream_launches, embed_launches


# ---------------------------------------------------------------------------
# Phase 23: multi-device execution and the measured route selection
# ---------------------------------------------------------------------------

MESH_BATCH = 64  # (b): the sharded train step's global batch (phase 20's)
MESH_STEPS = 3
MESH_RUNS = (("data", ("data",), (2,)), ("data_model", ("data", "model"), (1, 2)))
BF16_TRAIN_TOL = 1e-2  # PERF.md section 2's bf16 limit
SELECT_ROUNDS = 5
STREAM_STEPS = 20  # back-to-back camera steps between two events, per round
SCAN_KS = {"standalone": 1, "scan_k4": 4, "scan_k8": 8}
# each selectable op's fixed rule: what its reader runs where no record applies
SELECT_DEFAULTS = {"fused_trunk_gram": "fused", "pmg_head_fold": "fused_bf16",
                   "rtm_stream_folded": "folded_q8",
                   **{f"eval_scan_chunk_{fam}_{dt}": "standalone" for fam in ("pmg", "pm", "rtm")
                      for dt in ("f32", "bf16")}}


def shipped_train_start():
    """(spec, params) of the shipped PMG checkpoint, on the CPU."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg

    with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
        meta = json.load(f)
    spec = pmg.build_spec(meta["tasks"], meta["hparams"])
    return spec, checkpoint.load_torch_checkpoint("pmg", os.path.join(FIXTURES, "pmg_shipped.pth"), spec)


def mesh_reference(spec, params, x, y) -> dict:
    """(b)'s one-process run: MESH_STEPS PMG train steps (dropout 0.1) from
    ``params`` in float32 and bf16 -> per dtype the state before each step
    and after the last (CPU trees), each step's gradients (numpy), losses
    and host ms a step (median)."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import (
        train as ptrain,
    )

    ref = {}
    for label, dt in (("float32", None), ("bf16", torch.bfloat16)):
        opt = ptrain.make_optimizer()
        _, step = ptrain.make_train_step("pmg", spec, opt, compute_dtype=dt, device="cuda")
        p = ptrain.trainable_params(params, "cuda")
        state = ptrain.TrainState(p, opt.init(p), 0)
        out = {"states": [ptrain.snapshot(checkpoint._train_state_tree(state))], "grads": [],
               "losses": [], "times": []}
        for _ in range(MESH_STEPS):
            t0 = time.perf_counter()
            state, loss = step(state, x, y)
            out["losses"].append(float(loss))  # waits for the step
            out["times"].append(time.perf_counter() - t0)
            out["grads"].append(step_grads(state))
            out["states"].append(ptrain.snapshot(checkpoint._train_state_tree(state)))
        out["ms"] = statistics.median(out.pop("times")) * 1e3
        ref[label] = out
    return ref


def step_grads(state, mesh=None) -> dict:
    """The gradients of a train state's last step by leaf path (numpy),
    the task-sharded leaves gathered over the mesh's model axis."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import (
        train as ptrain,
    )

    ost = state.opt_state
    grads = {"acc": {q: t.grad for q, t in zip(ost.paths, ost.leaves)}}
    if mesh is not None:
        grads = ptrain._map_opt_tree(lambda t: mesh.gather(t, "model"), grads, mesh)
    return {q: t.cpu().numpy() for q, t in grads["acc"].items()}


@contextlib.contextmanager
def activation_branches(force=None):
    """Within: the port's LeakyReLUs (``models.trunk`` and ``models.pmg``)
    and every ``torch.relu`` (the SE block's and the transformer FFN's)
    record, in call order, which branch each element takes (input >= 0,
    or > 0 for the ReLU) into the yielded list.  With ``force`` (such a
    list from another run, on the host), each element takes ``force``'s
    branch instead of its own, slope and gradient included; the list then
    holds the branches the inputs would have taken.  The forward is the
    same function (``torch.where`` on the branch, as ``ops.nn.leaky_relu``),
    so a run whose branches all agree with ``force`` is unchanged."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import (
        pmg, trunk,
    )

    taken = []
    relu, leaky = torch.relu, trunk.leaky_relu

    def pick(x, own, other):
        branch = own if force is None else force[len(taken)].to(x.device)
        if branch.shape != x.shape:
            raise AssertionError(f"activation {len(taken)}: forced branches {tuple(branch.shape)} for an "
                                 f"input of {tuple(x.shape)}")
        taken.append(own)
        return torch.where(branch, x, other)

    def leaky_relu(x, negative_slope=0.2):
        return pick(x, x >= 0, x * negative_slope)

    torch.relu = lambda x: pick(x, x > 0, torch.zeros_like(x))
    trunk.leaky_relu = pmg.leaky_relu = leaky_relu
    try:
        yield taken
    finally:
        torch.relu, trunk.leaky_relu, pmg.leaky_relu = relu, leaky, leaky


def adamw_applied(tree: dict, grads: dict) -> dict:
    """The trainable params after AdamW's update in one process from the
    state ``tree`` (of :func:`mesh_reference`) with ``grads`` (numpy, by
    leaf path) -> numpy, by leaf path."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import (
        train as ptrain,
    )

    p = ptrain.trainable_params(tree["params"], "cuda")
    full = ptrain.make_optimizer().init(p)
    full.load_tree(tree["opt_state"])
    for q, t in zip(full.paths, full.leaves):
        t.grad = torch.from_numpy(grads[q]).cuda()
    full.update()
    return {q: t.detach().cpu().numpy() for q, t in zip(full.paths, full.leaves)}


def hold_sharded_step(got: dict, got_grads: dict, want: dict, grads: dict, applied: dict, bf16: bool,
                      what: str) -> tuple:
    """Hold a sharded step (params and gradients by leaf path, numpy) to the
    one-process step from the same state (``want``, ``grads``) and to
    AdamW applied in one process to the sharded gradients (``applied``).

    Every trainable param within 1e-5 x its leaf's max of ``applied``: the
    sharded update (task slices, their moments, weight decay) is the
    one-process update of the same gradients.  float32, the one-process
    step taking the sharded run's branch at every LeakyReLU and ReLU
    (:func:`forced_reference_step`): every gradient element within 1e-4 x
    its leaf's max (phase 20's bar; a leaf whose max is at most 1e-5 x the
    step's largest gradient, the attention key bias's exact 0, is noise in
    both runs), the running statistics within 1e-5 x their leaf's max;
    the params' distance to ``want`` is reported as a share of 1e-5 x
    each leaf's max (2 x lr where the element's gradient is float32 noise,
    at most 1e-4 x the step's largest), not gated: Adam divides each
    element's gradient difference by the element's own second moment, so
    a gradient element held to 1e-4 x its leaf's max can move its param by
    more than 1e-5 x the leaf's max where the leaf has moved by a few lr
    from 0.  bf16: every param and running statistic within the larger of
    BF16_TRAIN_TOL x its leaf's max and 2 x lr of ``want``, the gradients'
    relative l2 error reported.  Returns (the worst gradient error, as a
    share of its leaf's max in float32 and in relative l2 norm in bf16; the
    worst param error against ``applied`` and against ``want``, each as a
    share of its limit, with the leaf of the latter)."""
    import numpy as np

    top = max(float(np.abs(v).max()) for v in grads.values())
    worst_g = worst_a = 0.0
    worst_w = (0.0, "")
    for q, w in want.items():
        scale = float(np.abs(w).max())
        err = np.abs(got[q] - w)
        if q in grads:  # a trainable leaf (the others: batch norm's running statistics)
            g, gerr = np.abs(grads[q]), np.abs(got_grads[q] - grads[q])
            if float(g.max()) > 1e-5 * top:
                rel = (float(np.linalg.norm(gerr)) / float(np.linalg.norm(g)) if bf16
                       else float(gerr.max()) / float(g.max()))
                if not bf16 and rel > 1e-4:
                    raise AssertionError(f"{what} gradient {q}: max err {rel:.3e} x its leaf's max")
                worst_g = max(worst_g, rel)
            a_share = float(np.abs(got[q] - applied[q]).max()) / max(1e-5 * scale, 1e-30)
            if a_share > 1.0:
                raise AssertionError(f"{what} param {q}: {a_share:.3e} x 1e-5 x its leaf's max from AdamW "
                                     "applied in one process to the sharded gradients")
            worst_a = max(worst_a, a_share)
        # Adam moves an element whose gradient is float32 noise (at most 1e-4
        # x the step's largest) by up to lr in either run: 2 x lr (phase 20)
        noisy = np.full(w.shape, bf16) if q not in grads else bf16 | (np.abs(grads[q]) <= 1e-4 * top)
        tol = (BF16_TRAIN_TOL if bf16 else 1e-5) * scale
        share = max(float(err[~noisy].max(initial=0.0)) / max(tol, 1e-30),
                    float(err[noisy].max(initial=0.0)) / max(tol, 2 * TRAIN_LR))
        if share > 1.0 and (bf16 or q not in grads):
            raise AssertionError(f"{what} {q}: max err {float(err.max()):.3e} (leaf max {scale:.3e})")
        worst_w = max(worst_w, (share, q))
    return worst_g, worst_a, worst_w


def mesh_train_rank(rank: int, ref_path: str) -> dict:
    """(b), one rank of 2 sharing the card over gloo: on each of MESH_RUNS'
    meshes, in float32 (TF32 off) and bf16, one sharded PMG-shipped train
    step from each state of the one-process run (``ref_path``, saved by
    :func:`mesh_reference`, so that rounding differences do not compound
    from step to step), launch counts reset just before the steps.
    Returns each run's losses, launches and host ms a step (median), and
    for each step the gathered params and gradients after it (rank 0) and
    in float32 the branch each activation took (:func:`activation_branches`;
    one rank per data index, for its rows), which the parent holds to the
    one-process step."""
    import torch

    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import (
        train as ptrain,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel.mesh import (
        make_mesh,
    )

    port.config.enable_parity_precision()
    ref = torch.load(ref_path, weights_only=False)
    spec, _ = shipped_train_start()
    x, y = train_batch(spec.tasks, MESH_BATCH, 23)
    out = {}
    for name, axes, shape in MESH_RUNS:
        mesh = make_mesh(axes=axes, shape=shape)
        for label, dt in (("float32", None), ("bf16", torch.bfloat16)):
            opt = ptrain.make_optimizer()
            _, step = ptrain.make_train_step("pmg", spec, opt, mesh=mesh, compute_dtype=dt,
                                             device="cuda")
            torch.cuda.synchronize()
            ck.reset_launches()
            res = {"losses": [], "steps": []}
            times = []
            for i in range(MESH_STEPS):
                tree = ref[label]["states"][i]
                p = ptrain.trainable_params(tree["params"], "cuda")
                full = opt.init(p)
                full.load_tree(tree["opt_state"])
                state = ptrain.shard_state(ptrain.TrainState(p, full, int(tree["step"])), mesh)
                with (activation_branches() if dt is None else contextlib.nullcontext([])) as taken:
                    t0 = time.perf_counter()
                    state, loss = step(state, x, y)
                    res["losses"].append(float(loss))  # waits for the step
                    times.append(time.perf_counter() - t0)
                got = {q: t.detach().cpu().numpy() for q, t in
                       ptrain.leaf_dict(ptrain.gather_params(state.params, mesh)).items()}
                got_grads = step_grads(state, mesh)
                res["steps"].append({
                    "branches": ([m.cpu().numpy() for m in taken]
                                 if dt is None and mesh.index("model") == 0 else None),
                    "params": got if rank == 0 else None, "grads": got_grads if rank == 0 else None})
            res["launches"] = dict(ck.LAUNCHES)
            res["ms"] = statistics.median(times) * 1e3
            out[(name, label)] = res
    return out


def forced_reference_step(spec, tree: dict, x, y, branches: list) -> tuple:
    """The one-process float32 step from ``tree`` (a state of
    :func:`mesh_reference`) with every activation on ``branches`` ->
    (params, gradients, the number of elements whose own branch differs
    from ``branches`` in each activation, in call order)."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import (
        train as ptrain,
    )

    opt = ptrain.make_optimizer()
    _, step = ptrain.make_train_step("pmg", spec, opt, device="cuda")
    p = ptrain.trainable_params(tree["params"], "cuda")
    full = opt.init(p)
    full.load_tree(tree["opt_state"])
    with activation_branches(force=branches) as own:
        state, _ = step(ptrain.TrainState(p, full, int(tree["step"])), x, y)
    if len(own) != len(branches):
        raise AssertionError(f"the forced step ran {len(own)} activations, the sharded run {len(branches)}")
    flips = [int((a.cpu() != b).sum()) for a, b in zip(own, branches)]
    params = {q: t.detach().cpu().numpy() for q, t in ptrain.leaf_dict(state.params).items()}
    return params, step_grads(state), flips


def stream_us(step, x1) -> float:
    """One camera route's time a frame: CUDA events around STREAM_STEPS
    back-to-back steps (host enqueue and device work both count, as they
    do for a camera), in microseconds."""
    import torch

    for _ in range(3):
        step(x1)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STREAM_STEPS):
        step(x1)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / STREAM_STEPS * 1e3


def run_us(eng, frames, k: int) -> float:
    """``Engine.run`` over host frames with ``scan_chunk=k``, CUDA events
    around it: microseconds an image end to end."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    eng.run(frames, collect=("probs",), scan_chunk=k)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(frames) * 1e3


def measure_variants(fns: dict) -> dict:
    """Each variant's times over SELECT_ROUNDS rounds, the variants in
    turns within each round."""
    times = {v: [] for v in fns}
    for _ in range(SELECT_ROUNDS):
        for v, fn in fns.items():
            times[v].append(fn())
    return times


def sharded_train_phase(card: str) -> dict:
    """Phase 23 (b): the sharded PMG-shipped train step on 2 ranks sharing
    the card over gloo, ``("data",)`` (2,) and ``("data", "model")``
    (1, 2), float32 and bf16, against the one-process step.  Returns each
    rank's launch counts."""
    import tempfile

    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import (
        train as ptrain,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel.multihost import (
        spawn_world,
    )

    counts = {}
    spec, params = shipped_train_start()
    x, y = train_batch(spec.tasks, MESH_BATCH, 23)
    ref = mesh_reference(spec, params, x, y)
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "reference.pt")
        torch.save(ref, ref_path)
        t0 = time.perf_counter()
        ranks = spawn_world(mesh_train_rank, 2, ref_path, backend="gloo", timeout_s=300)
        spawn_s = time.perf_counter() - t0
    for (name, label), res0 in ranks[0].items():
        want = ref[label]
        tol = 1e-5 if label == "float32" else BF16_TRAIN_TOL
        for r, res in enumerate(ranks):
            got = res[(name, label)]
            if got["launches"]["patch_gram"] != MESH_STEPS or (
                    label == "bf16" and got["launches"]["gram_proj"] != MESH_STEPS):
                raise AssertionError(f"sharded {name} {label} rank {r} launched {got['launches']}")
            counts[f"train_{name}_{label}_rank{r}"] = got["launches"]
            for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
                if abs(a - b) > tol * abs(b):
                    raise AssertionError(f"sharded {name} {label} rank {r} step {i}: loss {a} vs {b}")
        worst, flips = (0.0, 0.0, (0.0, "")), []
        for i in range(MESH_STEPS):
            mine, tree = res0["steps"][i], want["states"][i]
            if label == "float32":
                # the one-process step on the sharded run's branches (the
                # rows of each data index, in order)
                parts = [rr[(name, label)]["steps"][i]["branches"] for rr in ranks]
                branches = [torch.from_numpy(np.concatenate(bs))
                            for bs in zip(*[b for b in parts if b is not None])]
                fp, fg, flipped = forced_reference_step(spec, tree, x, y, branches)
                shapes = [tuple(b.shape) for b in branches]
                top = max(float(np.abs(g).max()) for g in want["grads"][i].values())
                unforced = max(float(np.abs(mine["grads"][q] - g).max()) / float(np.abs(g).max())
                               for q, g in want["grads"][i].items() if np.abs(g).max() > 1e-5 * top)
                flips.append(f"{flipped} elements by activation, gradients {unforced:.2e} x leaf max "
                             "from the one-process step on its own")
            else:
                fp = {q: t.numpy() for q, t in ptrain.leaf_dict(want["states"][i + 1]["params"]).items()}
                fg = want["grads"][i]
            errs = hold_sharded_step(mine["params"], mine["grads"], fp, fg,
                                     adamw_applied(tree, mine["grads"]), label == "bf16",
                                     f"sharded {name} {label} step {i}")
            worst = (max(worst[0], errs[0]), max(worst[1], errs[1]), max(worst[2], errs[2]))
        if label == "float32":
            held = (f"elements where the sharded run's branch differs from the one-process step's, by "
                    f"step, at each LeakyReLU and ReLU in call order (inputs {shapes}): "
                    f"{'; '.join(flips)}; on the sharded branches, gradients {worst[0]:.2e} x leaf max at "
                    f"worst (limit 1e-4), params {worst[2][0]:.2f} x (1e-5 x leaf max; 2 x lr where a "
                    f"gradient is float32 noise) at worst ({worst[2][1]}; reported)")
        else:
            held = (f"gradients {worst[0]:.2e} in relative l2 norm at worst (not gated), params at worst "
                    f"{worst[2][0]:.2e} of their limit (the larger of {BF16_TRAIN_TOL} x leaf max and 2 x lr)")
        print(f"[23] (b) sharded PMG-shipped train step, {name} mesh of 2 ranks sharing the card (gloo), "
              f"global batch {MESH_BATCH}, {label}, {MESH_STEPS} steps, each from the one-process run's "
              f"state: losses {[round(v, 6) for v in res0['losses']]} vs "
              f"{[round(v, 6) for v in want['losses']]} (limit {tol} relative); held to the one-process "
              f"step: {held}; params {worst[1]:.2e} x (1e-5 x leaf max) at worst from AdamW applied in one "
              f"process to the sharded gradients (limit 1); launches rank 0 {res0['launches']}, rank 1 "
              f"{ranks[1][(name, label)]['launches']}; {res0['ms']:.1f} ms a step (rank 0, host, median of "
              f"{MESH_STEPS}{', branches recorded' if label == 'float32' else ''}) vs {want['ms']:.1f} ms "
              f"unsharded | {card}")
    print(f"[23] (b) the 2-rank world took {spawn_s:.1f} s (spawn, CUDA start, both meshes)")
    del ranks, ref

    return counts


def mesh_phase(card: str) -> dict:
    """Phase 23 (a)-(c): (a) the shipped PMG ``Engine`` over a world of 1 on
    NCCL against the engine without a mesh; (b) the sharded PMG-shipped
    train step on 2 ranks sharing the card over gloo, ``("data",)`` (2,)
    and ``("data", "model")`` (1, 2), against the one-process step; (c) the
    ``host_local_batch`` dryrun over gloo on the CPU and on the card.
    Returns the mesh paths' launch counts."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel.multihost import (
        initialize_process,
    )

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    counts = {}
    # (c) runs beside (a): the dryrun's own processes, on the CPU and on the card
    dry = {d: subprocess.Popen([sys.executable, "-m", f"{PORT}.parallel.dryrun", "--device", d],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
           for d in ("cpu", "cuda")}

    # -- (a) the engine over a world of 1 on NCCL ---------------------------
    with tempfile.TemporaryDirectory() as tmp:
        initialize_process("file://" + os.path.join(tmp, "rendezvous"), 1, 0, backend="nccl",
                           timeout_s=120)
        try:
            one = torch.ones(4, device=dev)
            dist.all_reduce(one)  # NCCL itself, once
            if not torch.equal(one, torch.ones(4, device=dev)):
                raise AssertionError("an all-reduce over a world of 1 changed its tensor")
            mesh = make_mesh()
            with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
                meta = json.load(f)
            frames = np.random.RandomState(1).randint(0, 256, (N_FRAMES, 224, 224, 3), np.uint8)
            errs = {}
            for label, dt in (("float32", torch.float32), ("bf16", torch.bfloat16)):
                kw = dict(batch_size=BATCH, dtype=dt, device="cuda")
                plain = port.load_engine("pmg", os.path.join(FIXTURES, "pmg_shipped.pth"),
                                         meta["tasks"], meta["hparams"], **kw)
                eng = executor.Engine("pmg", plain.spec, plain.params, mesh=mesh, **kw)
                want = plain.run(frames, collect=("logits",))["logits"]
                torch.cuda.synchronize()
                ck.reset_launches()
                got = eng.run(frames, collect=("logits", "probs"))
                torch.cuda.synchronize()
                counts[f"engine_{label}"] = launches = dict(ck.LAUNCHES)
                need = ("patch_gram", "stem") + (("gram_proj",) if dt == torch.bfloat16 else ())
                if any(launches[k] == 0 for k in need):
                    raise AssertionError(f"mesh engine {label} launched {launches}")
                errs[label] = within_max(torch.from_numpy(got["logits"]), torch.from_numpy(want),
                                         1e-5, f"mesh engine {label} logits")
                check_probs(got, N_FRAMES, plain.spec, f"mesh engine {label}")
            del eng, plain
        finally:
            dist.destroy_process_group()
    print(f"[23] (a) Engine(mesh=make_mesh()) over a world of 1 on NCCL (one all-reduce run), shipped "
          f"PMG at batch {BATCH} over {N_FRAMES} frames: logits vs the engine without a mesh "
          + ", ".join(f"{k} {v:.2e} x max|logit|" for k, v in errs.items())
          + f" (limit 1e-5); launches float32 {counts['engine_float32']}, bf16 {counts['engine_bf16']}")
    for d, proc in dry.items():
        out, _ = proc.communicate(timeout=600)
        last = out.strip().splitlines()[-1] if out.strip() else ""
        if proc.returncode != 0 or "PASS" not in last:
            raise AssertionError(f"dryrun on {d} failed (rc {proc.returncode}):\n{out[-3000:]}")
        print(f"[23] (c) the port's parallel.dryrun --device {d} (2 processes over gloo): {last}")

    counts.update(sharded_train_phase(card))
    print(f"[23] (a)-(c) took {time.perf_counter() - t_phase:.1f} s")
    return counts


def select_phase(card: str, record: bool) -> None:
    """Phase 23 (d): every selectable op's variants measured beside the
    committed record (one call added to it with ``record``), each
    ``"auto"`` checked against the record in effect, and the batch-1 K1,
    K2 (bf16 mode) and K5 of PMG's bf16 camera routes."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
        checkpoint, executor,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import rtm
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, kernel_select as ks, preprocess as pre,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import stream

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    spec, params = shipped_train_start()
    kind = torch.cuda.get_device_name(0)
    committed = json.loads(json.dumps(ks._table()))  # the record as committed, before any write
    for backend, ops in committed.items():
        for op, entry in ops.items():
            known = ks.known_variants(op)
            if (entry["winner"] not in ks.KERNEL_ROUTES[op] or entry["default"] != SELECT_DEFAULTS[op]
                    or any(not set(c) <= set(known) for c in entry["calls"])
                    or entry["winner"] != ks.decide(op, entry["calls"], entry["default"])):
                raise AssertionError(f"record {backend} / {op} is not one the code would write: {entry}")
    gparams = checkpoint.to_device(params, dev)
    cam = np.random.RandomState(4).randint(0, 256, (1, 224, 224, 3), np.uint8)
    x1 = torch.from_numpy(cam).to(dev)

    def cam_fn(family, fspec, fparams, **kw):
        p = stream.StreamPredictor(family, fspec, fparams, use_kalman=True, **kw)
        return lambda: stream_us(p.step, x1)

    fused = {"fused": cam_fn("pmg", spec, gparams, trunk_kernel="fused", head_fold="fused_bf16"),
             "packed": cam_fn("pmg", spec, gparams, trunk_kernel="packed")}
    heads = {hf: cam_fn("pmg", spec, gparams, trunk_kernel="fused", head_fold=hf)
             for hf in ks.known_variants("pmg_head_fold")}
    rspec = rtm.build_spec(config.load_tasks(config.default_tasks_path()), {})
    rparams = checkpoint.to_device(random_rtm_params(rspec, seed=12), dev)
    rtm_routes = {r: cam_fn("rtm", rspec, rparams, trunk_kernel=r)
                  for r in ks.known_variants("rtm_stream_folded")}
    measured = {
        "fused_trunk_gram": (measure_variants(fused), "batch 1 224 px shipped PMG, a camera step "
                             "(fused: K3 + K4 on the bf16 fold; packed: K2, K1 and the plain head)"),
        "pmg_head_fold": (measure_variants(heads), "batch 1 224 px shipped PMG, a camera step on "
                          "the fused route by head fold"),
        "rtm_stream_folded": (measure_variants(rtm_routes), "batch 1 224 px RTM headline (ResNet-50 "
                              "through layer4, d 2048), a camera step"),
    }
    del fused, heads, rtm_routes
    for family, fspec, fparams, bs, n in (("pmg", spec, gparams, BATCH, 8 * BATCH),
                                          ("rtm", rspec, rparams, RTM_BATCH, 8 * RTM_BATCH)):
        frames = np.random.RandomState(23).randint(0, 256, (n, 224, 224, 3), np.uint8)
        for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            eng = executor.Engine(family, fspec, fparams, batch_size=bs, dtype=dt, device="cuda")
            eng.run(frames[: 2 * bs], collect=("probs",))
            fns = {v: (lambda k=k: run_us(eng, frames, k)) for v, k in SCAN_KS.items()}
            measured[f"eval_scan_chunk_{family}_{label}"] = (
                measure_variants(fns), f"b{bs} {label} 224px, Engine.run over {n} host frames, "
                "per image end to end")
            del eng
        del frames
    agree = []
    for op, (rounds, shape) in measured.items():
        default = SELECT_DEFAULTS[op]
        beat = [v for v in ks.KERNEL_ROUTES[op] if v != default and max(rounds[v]) < min(rounds[default])]
        old = committed.get(kind, {}).get(op)
        agree.append(f"{op} {'/'.join(beat) or 'none'}"
                     + ("" if old is None else f" (recorded winner {old['winner']})"))
        print(f"[23] (d) {op}: " + ", ".join(
            f"{v} {statistics.median(t):.2f} (spread {max(t) - min(t):.2f})" for v, t in rounds.items())
            + f" us, median (max - min) of {SELECT_ROUNDS} rounds; recorded calls: "
            + ("; ".join("[" + ", ".join(f"{v} {statistics.median(t):.2f}" for v, t in c.items()) + "]"
                         for c in old["calls"]) if old else "none for this card") + f" | {card}")
        if record:
            ks.record(op, rounds, shape, default, backend=kind)
    print(f"[23] (d) kernel routes whose every round beat the default's in this call: {'; '.join(agree)}"
          + (f"; this call added to {ks.RECORD_PATH}" if record else "; the record was not written"))
    # each "auto" resolves to the record in effect (the defaults where none)
    ks._table.cache_clear()
    rec = ks._table().get(kind, {})

    def recorded(op):
        return rec[op]["winner"] if op in rec else SELECT_DEFAULTS[op]

    pa = stream.StreamPredictor("pmg", spec, gparams)
    want_route = recorded("fused_trunk_gram")
    want_fold = recorded("pmg_head_fold") if want_route == "fused" else None
    ra = stream.StreamPredictor("rtm", rspec, rparams)
    got_auto = {"pmg": (pa.route, pa.head_fold), "rtm": ra.route}
    want_auto = {"pmg": (want_route, want_fold), "rtm": recorded("rtm_stream_folded")}
    for family, fspec, fparams in (("pmg", spec, gparams), ("rtm", rspec, rparams)):
        for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            eng = executor.Engine(family, fspec, fparams, batch_size=2, dtype=dt, device="cuda")
            got_auto[f"{family}_{label}"] = eng.resolve_scan_chunk("auto")
            want_auto[f"{family}_{label}"] = SCAN_KS[recorded(f"eval_scan_chunk_{family}_{label}")]
    if got_auto != want_auto:
        raise AssertionError(f"'auto' resolves to {got_auto}, the record to {want_auto}")
    print(f"[23] (d) every 'auto' follows the record in effect for {kind} "
          f"({'written now' if record else 'committed' if rec else 'none: the fixed rules'}): {got_auto}")
    del pa, ra

    # the batch-1 kernels of PMG's bf16 packed and generic camera routes
    bf16 = torch.bfloat16
    rng = np.random.RandomState(23)
    z16 = torch.from_numpy(rng.randn(1, 14, 14, spec.gram_channels).astype(np.float32)).to(dev).to(bf16)
    g16 = ck.patch_gram(z16, spec.patch_div)
    eng16 = executor.Engine("pmg", spec, gparams, batch_size=1, dtype=bf16, device="cuda")
    st, tp = eng16._stem, eng16._run_params["token_proj"]
    w16, b32 = tp["w"].contiguous(), tp["b"].float()
    m, k, nout = g16.shape[0] * g16.shape[1], g16.shape[2], w16.shape[1]
    cout = st["w"].shape[1]
    # each kernel's library yardstick at batch 1, in the forms of phase 5's
    # and 14's: K1 torch.baddbmm on the split patches (plus the split copy,
    # timed apart), K2's bf16 mode torch.addmm on the packed operand in bf16
    # (no cast or pack, norm or LeakyReLU), K5 torch.addmm of the bf16 Gram
    # rows, weight and bias (its whole function)
    k1_yard = k1_yardsticks(z16, spec.patch_div)
    a2d16 = pre.s2d_pack(x1, 4).reshape(-1, 48).float().to(bf16)
    wst16, bst16, b16, g2d = st["w"].to(bf16), st["bias"].to(bf16), b32.to(bf16), g16.reshape(m, k)
    rows = []
    for name, fn, plain, lib, nbytes, flops in (
            ("patch_gram bf16 [1,14,14,96] div 3", lambda: ck.patch_gram(z16, spec.patch_div),
             lambda: ck.patch_gram_plain(z16, spec.patch_div),
             f"torch.baddbmm on the split patches {k1_yard['baddbmm'] * 1e3:.1f} us, plus "
             f"{k1_yard['split'] * 1e3:.1f} us for the split copy",
             2 * (z16.numel() + g16.numel()), 2.0 * spec.patch_div ** 2 * 25 * spec.gram_channels ** 2),
            ("stem bf16 mode [1,224,224,3] -> 32",
             lambda: ck.stem(x1, st["w"], st["scale"], st["shift"], 4, leaky=True, out_dtype=bf16,
                             bias=st["bias"]),
             lambda: ck.stem_plain(x1, st["w"], st["scale"], st["shift"], 4, leaky=True, out_dtype=bf16,
                                   bias=st["bias"]),
             f"torch.addmm on the packed bf16 operand "
             f"{device_ms(lambda: torch.addmm(bst16, a2d16, wst16)) * 1e3:.1f} us",
             x1.numel() + st["w"].numel() * 4 + cout * 8 + 56 * 56 * cout * 2, 2.0 * 56 * 56 * cout * 48),
            (f"gram_proj [{m},{k}] x [{k},{nout}] bf16 out",
             lambda: ck.gram_proj(g16, w16, b32, bf16), lambda: ck.gram_proj_plain(g16, w16, b32, bf16),
             f"torch.addmm bf16 with the bias {device_ms(lambda: torch.addmm(b16, g2d, w16)) * 1e3:.1f} us",
             2 * g16.numel() + 2 * w16.numel() + 4 * nout + 2 * m * nout, 2.0 * m * k * nout)):
        b_ms, b_by = bound_ms(nbytes, 0.0, bf16_flops=flops)
        rows.append(f"{name} {device_ms(fn) * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by {b_by}), "
                    f"plain {device_ms(plain) * 1e3:.1f} us, library: {lib}")
    print("[23] (d) batch-1 kernels of PMG's bf16 packed and generic camera routes: " + "; ".join(rows)
          + f" | {card}")
    del eng16
    print(f"[23] (d) took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 24: the t-SNE at dataset scale
# ---------------------------------------------------------------------------

TSNE_N = 65_536  # points of phase 24: one dense N x N float32 matrix would be 17.2 GB
TSNE_DIM = 48
TSNE_CLUSTERS = 12
TSNE_REP_TOL = 1e-4  # rep: times max|rep| of the float64 plain version; each row's z: relative
TSNE_Z_TOL = 1e-5  # Z = sum of z, relative
TSNE_MEM_LIMIT = 4e9  # bytes above the call's baseline, O(N k)
TSNE_CLUSTER_AGREE = 0.9  # 5-NN pairs of the layout in one cluster (~1/12 if the clusters merged)
# The MUFU's reciprocals a second: 16 a clock on an SM (CUDA C programming
# guide, arithmetic instruction throughput, compute capability 9.0) at the
# H100 SXM's 1.98 GHz boost clock, the clock of the 67 TFLOP/s above.
PEAK_MUFU_PER_S = 132 * 16 * 1.98e9


def cluster_points(n: int, dim: int, clusters: int, seed: int):
    """n seeded float32 points in ``clusters`` Gaussian clusters of unit
    spread in ``dim`` dimensions, centres drawn with std 4 -> (points,
    cluster labels)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    centres = rng.randn(clusters, dim) * 4.0
    labels = rng.randint(0, clusters, n)
    return (centres[labels] + rng.randn(n, dim)).astype(np.float32), labels


def repulsion_check(ck, y, what: str, sync) -> dict:
    """``tsne_repulsion`` on the float32 layout y against its plain version
    in float64 on the same points: rep within TSNE_REP_TOL x max|rep|, each
    row's z within TSNE_REP_TOL relative, Z within TSNE_Z_TOL."""
    import torch

    rep, z = ck.tsne_repulsion(y)
    sync()
    want_rep, want_z = ck.tsne_repulsion_plain(y.double())
    rep_err = max_err(rep.double(), want_rep, TSNE_REP_TOL * float(want_rep.abs().max()), 0.0,
                      f"tsne_repulsion rep {what}")
    z_rel = float(((z.double() - want_z).abs() / want_z).max())
    big_z = float(want_z.sum())
    z_sum_rel = abs(float(z.double().sum()) - big_z) / big_z
    if not z_rel <= TSNE_REP_TOL or not z_sum_rel <= TSNE_Z_TOL:
        raise AssertionError(f"tsne_repulsion {what}: z rows rel {z_rel:.3e} (limit {TSNE_REP_TOL}), "
                             f"Z rel {z_sum_rel:.3e} (limit {TSNE_Z_TOL})")
    return {"rep_err": rep_err, "rep_max": float(want_rep.abs().max()), "z_rel": z_rel,
            "z_sum_rel": z_sum_rel}


def tsne_descent_trace(ts, x, perp: float, what: str, card: str) -> None:
    """``--profile``: 50 iterations of the exaggerated descent on x's sparse
    P (one KL check, as the descent makes one each 50), timed without the
    profiler (host wall a iteration, CUDA events) and then traced: device
    time by kernel a iteration, and the device's idle share of the
    untraced wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    iters = 50
    p = ts.joint_p_nn(x, perp).scaled(12.0)
    y0 = ts.pca_init(x)
    lr = max(x.shape[0] / 12.0 / 4.0, 50.0)
    ts._descend(y0, p, 0, iters, 0.5, lr, iters)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts._descend(y0, p, 0, iters, 0.5, lr, iters)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts._descend(y0, p, 0, iters, 0.5, lr, iters)
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]
    by_name: dict = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / iters / 1e3
    rep_ms = sum(v for k, v in by_name.items() if "tsne_repulsion" in k) / iters / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[24] (e) descent at N {x.shape[0]} ({what}), {iters} iterations: host wall "
          f"{wall_ms * 1e3:.1f} us an iteration untraced; traced, {len(evs) / iters:.1f} device kernels "
          f"and {busy_ms * 1e3:.1f} us of device time an iteration, tsne_repulsion {rep_ms * 1e3:.1f} us "
          f"({rep_ms / busy_ms * 100:.1f} % of device time), device idle "
          f"{max(0.0, 1.0 - busy_ms / wall_ms) * 100:.1f} % of the untraced wall; top kernels (us an "
          f"iteration): " + "; ".join(f"{k[:60]} {v / iters:.1f}" for k, v in top) + f" | {card}")


def tsne_phase(card: str, profile: bool) -> dict:
    """Phase 24: the port's t-SNE at dataset scale on the card (see the
    module docstring) -> the ``tsne_repulsion`` entry of the kernels line.
    ``profile`` adds ``tsne_descent_trace`` at N TSNE_N and on its first
    EMBED_FRAMES points."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import (
        tsne as ts,
    )

    t_phase = time.perf_counter()
    n = TSNE_N
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    pts, labels = cluster_points(n, TSNE_DIM, TSNE_CLUSTERS, 24)
    x = torch.from_numpy(pts).to(dev)
    y10 = torch.from_numpy((np.random.RandomState(24).randn(n, 2) * 10.0).astype(np.float32)).to(dev)
    at10 = repulsion_check(ck, y10, f"N {n}, layout std 10", sync)
    print(f"[24] (a) tsne_repulsion vs plain float64 at N {n}, seeded layout of std 10: rep max abs err "
          f"{at10['rep_err']:.3e} (max|rep| {at10['rep_max']:.3e}, limit {TSNE_REP_TOL} x), z rows rel "
          f"{at10['z_rel']:.2e} (limit {TSNE_REP_TOL}), Z rel {at10['z_sum_rel']:.2e} (limit {TSNE_Z_TOL})")

    perp = min(30.0, max(1.0, (n - 1) / 3.0))
    sync()
    t0 = time.perf_counter()
    entries = ts.joint_p_nn(x, perp).vals.numel()  # the sparse P alone, for the time's breakdown
    sync()
    p_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    t0 = time.perf_counter()
    y, kl = ts.tsne(x, perp)
    sync()
    wall_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    iters = launches["tsne_repulsion"]
    if not 0 < iters <= 1000 or sum(launches.values()) != iters:
        raise AssertionError(f"t-SNE at N {n} launched {launches}: want tsne_repulsion once an iteration")
    if y.shape != (n, 2) or not torch.isfinite(y).all() or not np.isfinite(kl):
        raise AssertionError(f"t-SNE at N {n}: layout {tuple(y.shape)} not finite or KL {kl}")
    if peak >= TSNE_MEM_LIMIT:
        raise AssertionError(f"t-SNE at N {n} peaked at {peak / 1e9:.2f} GB above its baseline "
                             f"(limit {TSNE_MEM_LIMIT / 1e9:g} GB)")
    _, nbr = ts.knn(y, 5)
    lab = torch.from_numpy(labels).to(dev)
    agree = float((lab[nbr] == lab[:, None]).float().mean())
    if agree < TSNE_CLUSTER_AGREE:
        raise AssertionError(f"t-SNE at N {n}: 5-NN cluster agreement {agree:.4f} < {TSNE_CLUSTER_AGREE}")
    k = min(n - 1, int(3.0 * perp + 1))
    print(f"[24] (b) t-SNE (Barnes-Hut objective, exact repulsion, perplexity {perp:g}, k {k}) of {n} "
          f"seeded {TSNE_DIM}-D points in {TSNE_CLUSTERS} clusters on the card: {wall_s:.2f} s wall (the "
          f"kNN and sparse P alone {p_s:.2f} s, {entries:,} entries), KL {kl:.5f}, {iters} iterations "
          f"(launches {launches}); peak memory {peak / 1e9:.3f} GB above a "
          f"{base / 1e9:.3f} GB baseline (limit {TSNE_MEM_LIMIT / 1e9:g}; one dense N x N float32 matrix "
          f"{4.0 * n * n / 1e9:.1f} GB); 5-NN cluster agreement {agree:.4f} (limit {TSNE_CLUSTER_AGREE}) "
          f"| {card}")
    final = repulsion_check(ck, y.contiguous(), f"N {n}, final layout", sync)
    print(f"[24] (c) tsne_repulsion vs plain float64 at the final layout (extent "
          f"{float(y.abs().max()):.1f}): rep max abs err {final['rep_err']:.3e} (max|rep| "
          f"{final['rep_max']:.3e}), z rows rel {final['z_rel']:.2e}, Z rel {final['z_sum_rel']:.2e}")

    pairs = float(n) * (n - 1)
    b_ms, b_by = bound_ms(n * 2 * 4 + n * 3 * 4, 12.0 * pairs)
    mufu_ms = pairs / PEAK_MUFU_PER_S * 1e3
    if mufu_ms > b_ms:
        b_ms, b_by = mufu_ms, "operations"
    yk = y.contiguous()
    k_ms = device_ms(lambda: ck.tsne_repulsion(yk), reps=20, rounds=5)
    plain_ms = device_ms(lambda: ck.tsne_repulsion_plain(yk), reps=2, rounds=3)
    print(f"[24] (d) tsne_repulsion at N {n}: {k_ms * 1e3:.1f} us a launch (median of 5 rounds of 20), "
          f"bound {b_ms * 1e3:.1f} us by {b_by} ({12.0 * pairs / PEAK_F32_FLOP_PER_S * 1e6:.1f} us of "
          f"float32 FLOPs, {mufu_ms * 1e3:.1f} us of MUFU reciprocals), {b_ms / k_ms * 100:.1f} % of it; "
          f"plain float32 {plain_ms * 1e3:.1f} us | {card}")
    if profile:
        tsne_descent_trace(ts, x, perp, "phase 24's points", card)
        xs = x[:EMBED_FRAMES].contiguous()
        tsne_descent_trace(ts, xs, min(30.0, max(1.0, (EMBED_FRAMES - 1) / 3.0)),
                           f"the first {EMBED_FRAMES} of them, phase 22 (d)'s N", card)
    print(f"[24] t-SNE phase took {time.perf_counter() - t_phase:.1f} s")
    return {
        "name": "tsne_repulsion", "route": "cuda", "source": f"{PORT}/csrc/tsne_repulsion.cu",
        "replaces": f"none: no TPU kernel; the JAX package's perform_tsne ({JAX_PKG}/workloads/embed.py:101) "
                    "runs scikit-learn's t-SNE on the host",
        "launches": iters, "max_abs_err": max(at10["rep_err"], final["rep_err"]),
        "ms": k_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        # no one PyTorch call sums the all-pairs Student-t forces
        "library_ms": None,
    }


# ---------------------------------------------------------------------------
# Phase 25: HDBSCAN at dataset scale
# ---------------------------------------------------------------------------

HDB_DIMS = (48, 192)  # phase 24's points, then PMG's task-embedding width
HDB_GRID = ((10, 15, 20), (5, 10))  # hdbscan_clustering's default grid
HDB_MEM_LIMIT = 1e9  # bytes above the call's baseline: x, its transposed copy, O(N) state
HDB_PURITY = 0.99  # least share of a found cluster's points in its main seeded cluster


def hdbscan_phase(card: str) -> list:
    """Phase 25: HDBSCAN's two kernels on the card (see the module
    docstring) -> their entries of the kernels line."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import (
        hdbscan as hdb,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.workloads import (
        embed,
    )

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    def held(fn, plain, what):
        """The kernel's output, bit for bit its plain version's and its own
        on a second call -> (output, plain seconds, max abs difference)."""
        got = fn()
        sync()
        t0 = time.perf_counter()
        want = plain()
        sync()
        plain_s = time.perf_counter() - t0
        err = float((got - want).abs().max()) if got.shape == want.shape else float("nan")
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{what}: the kernel differs from its plain version (max abs {err:.3e})")
        if not torch.equal(fn(), got):
            raise AssertionError(f"{what}: two calls on the same inputs differ")
        return got, plain_s, err

    # -- (a) each kernel against its float64 plain version, bit for bit ----------
    fast_cap = ck.HDBSCAN_FAST_K
    core_cases, core_err, mst_err = [], 0.0, 0.0
    for n, d, dtype, ks in ((8192, 48, torch.float32, (1, 5, 10, fast_cap + 1)),
                            (4099, 48, torch.float32, (1, 5, 10, fast_cap + 1, 4099)),
                            (4099, 48, torch.float64, (10, fast_cap + 1)),
                            (TSNE_N, HDB_DIMS[0], torch.float32, HDB_GRID[1])):  # (b)'s shape and k
        pts, _ = cluster_points(n, d, TSNE_CLUSTERS, 24 if n == TSNE_N else 25)
        pts[n - 7:] = pts[:7]  # distance-0 ties
        x = torch.from_numpy(pts).to(dev).to(dtype)
        for k in ks:
            core_err = max(core_err, held(
                lambda: ck.hdbscan_core_distances(x, k), lambda: ck.hdbscan_core_distances_plain(x, k),
                f"hdbscan_core N {n} D {d} {str(dtype)[6:]} k {k}")[2])
        core_cases.append(f"N {n} {str(dtype)[6:]} k {', '.join(map(str, ks))}")
        if n == TSNE_N:  # the insertion path's time by k, on (b)'s points
            k_ms = {k: device_ms(lambda: ck.hdbscan_core_distances(x, k), reps=2, rounds=3)
                    for k in (4, 8, 16, fast_cap)}
    print(f"[25] (a) hdbscan_core vs plain float64 on the card, bit for bit and two calls bit-identical: "
          f"{'; '.join(core_cases)} (D 48, 7 points repeated; k above {fast_cap} takes the radix select, "
          f"k = N included)")
    print(f"[25] (a) hdbscan_core's insertion path at N {TSNE_N}, D {HDB_DIMS[0]}, by k (8 values kept up "
          f"to k 8, then 32): " + ", ".join(f"k {k} {t:.2f} ms" for k, t in k_ms.items()) + f" | {card}")
    # more points than the largest MST grid has threads: each thread owns several nodes
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mst_grid = ck.HDBSCAN_MST_BLOCKS_PER_SM * sms * ck.HDBSCAN_MST_THREADS
    mst_big = mst_grid + mst_grid // 32 + 1
    mst_cases = []
    for n, d, tied in ((4096, 48, False), (1024, 192, False), (2048, 3, True), (mst_big, 3, True)):
        pts, _ = cluster_points(n, d, TSNE_CLUSTERS, 26)
        if tied:  # rounded to one decimal, 100 points repeated: equal weights everywhere
            pts = np.round(pts, 1)
            pts[n - 100:] = pts[:100]
        x = torch.from_numpy(pts).to(dev)
        core = ck.hdbscan_core_distances(x, 5)
        edges, plain_s, err = held(lambda: ck.hdbscan_prim_mst(x, core),
                                   lambda: ck.hdbscan_prim_mst_plain(x, core),
                                   f"hdbscan_mst N {n} D {d}{' tied' if tied else ''}")
        mst_err = max(mst_err, err)
        ties = n - 1 - int(torch.unique(edges[:, 2]).numel())
        owners = f", {n - mst_grid} threads own 2 nodes" if n > mst_grid else ""
        mst_cases.append(f"N {n} D {d}{', rounded with 100 repeats' if tied else ''} ({ties} tied weights"
                         f"{owners}; plain {plain_s:.2f} s)")
        if (n, d) == (4096, 48):
            mst_x, mst_core, mst_plain_s = x, core, plain_s
    print(f"[25] (a) hdbscan_mst vs plain float64 (one row of distances a step) on the card, edge for edge "
          f"bit for bit and two calls bit-identical (largest grid {mst_grid} threads): {'; '.join(mst_cases)}")

    # each kernel's time at a shape where its plain version also ran
    n, d = 8192, 48
    core_x = torch.from_numpy(cluster_points(n, d, TSNE_CLUSTERS, 25)[0]).to(dev)
    core_ms = device_ms(lambda: ck.hdbscan_core_distances(core_x, 10), reps=5, rounds=3)
    core_plain_ms = device_ms(lambda: ck.hdbscan_core_distances_plain(core_x, 10), reps=1, rounds=3)
    core_bound, core_by = bound_ms(n * d * 4 + n * 8, 0.0, f64_flops=3.0 * n * n * d)
    n, d = mst_x.shape
    mst_ms = device_ms(lambda: ck.hdbscan_prim_mst(mst_x, mst_core), reps=3, rounds=3)
    mst_bound, mst_by = bound_ms(n * d * 4 + n * 8 + (n - 1) * 24, 0.0,
                                 f64_flops=3.0 * d * n * (n - 1) / 2)
    print(f"[25] (a) hdbscan_core at N 8192, D 48, k 10: {core_ms * 1e3:.1f} us (bound {core_bound * 1e3:.1f} "
          f"us by {core_by}: 3 N^2 D float64 operations), plain {core_plain_ms * 1e3:.1f} us; hdbscan_mst at N "
          f"{n}, D {d}: {mst_ms * 1e3:.1f} us, {mst_ms * 1e3 / (n - 1):.2f} us a step (bound "
          f"{mst_bound * 1e3:.1f} us by {mst_by}: 1.5 N^2 D), plain {mst_plain_s * 1e3:.1f} ms of wall | {card}")
    del core_x, mst_x, mst_core

    # -- (b) hdbscan_clustering at N TSNE_N, D 48 and 192 ----------------------------
    main_ms: dict = {}
    launches_b: dict = {}
    for d in HDB_DIMS:
        pts, truth = cluster_points(TSNE_N, d, TSNE_CLUSTERS, 24)
        n = pts.shape[0]
        # the stages one at a time, as hdbscan_clustering runs them
        x = hdb.points(pts, dev)
        stages = []
        tree = None
        for ms in HDB_GRID[1]:
            sync()
            t0 = time.perf_counter()
            core = hdb.core_distances(x, ms)
            sync()
            t1 = time.perf_counter()
            edges = hdb.mutual_reachability_mst(x, core)
            sync()
            t2 = time.perf_counter()
            stages.append(f"core k {ms} {(t1 - t0) * 1e3:.1f} ms, MST {(t2 - t1) * 1e3:.1f} ms")
            main_ms.setdefault(d, {"core": t1 - t0, "mst": t2 - t1})
            if tree is None:
                t0 = time.perf_counter()
                tree = hdb.single_linkage(edges.cpu().numpy())
                link_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                for mcs in HDB_GRID[0]:
                    hdb.tree_labels(tree, mcs)
                labels_s = (time.perf_counter() - t0) / len(HDB_GRID[0])
        del x, core, edges, tree
        # the grid end to end, through the entry point
        paths = [str(i) for i in range(n)]
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launches()
        t0 = time.perf_counter()
        res = embed.hdbscan_clustering(pts, paths, *HDB_GRID)
        sync()
        wall_s = time.perf_counter() - t0
        launches = {k: v for k, v in ck.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated() - base
        launches_b[f"n{n}_d{d}"] = launches
        if launches != {"hdbscan_core": 2, "hdbscan_mst": 2}:
            raise AssertionError(f"hdbscan_clustering at N {n}, D {d} launched {launches}: want each "
                                 "kernel once per distinct min_samples")
        if peak >= HDB_MEM_LIMIT:
            raise AssertionError(f"hdbscan_clustering at N {n}, D {d} peaked at {peak / 1e9:.3f} GB above "
                                 f"its baseline (limit {HDB_MEM_LIMIT / 1e9:g} GB)")
        found = np.full(n, -1)
        for lbl, members in res["clusters"].items():
            found[[int(p) for p in members]] = int(lbl)
        majors, purity = set(), 1.0
        for c in range(res["n_clusters"]):
            counts = np.bincount(truth[found == c], minlength=TSNE_CLUSTERS)
            majors.add(int(counts.argmax()))
            purity = min(purity, counts.max() / counts.sum())
        if res["n_clusters"] != TSNE_CLUSTERS or len(majors) != TSNE_CLUSTERS or purity < HDB_PURITY:
            raise AssertionError(f"hdbscan_clustering at N {n}, D {d}: {res['n_clusters']} clusters over "
                                 f"{len(majors)} seeded ones, least purity {purity:.4f} (want "
                                 f"{TSNE_CLUSTERS} and {HDB_PURITY})")
        core_b = bound_ms(n * d * 4 + n * 8, 0.0, f64_flops=3.0 * n * n * d)[0]
        mst_b = bound_ms(n * d * 4 + n * 8 + (n - 1) * 24, 0.0, f64_flops=3.0 * d * n * (n - 1) / 2)[0]
        print(f"[25] (b) hdbscan_clustering (grid {HDB_GRID[0]} x {HDB_GRID[1]}) of {n} seeded {d}-D points "
              f"in {TSNE_CLUSTERS} clusters on the card: {wall_s:.2f} s wall, launches {launches}; stages "
              f"alone: {'; '.join(stages)} (bounds: core {core_b:.1f} ms, MST {mst_b:.1f} ms, float64 "
              f"operations); host: single linkage {link_s:.2f} s, condense, select and "
              f"label {labels_s:.2f} s a min_cluster_size (each tree once, then 3 of those); best "
              f"{res['best_params']}, {res['n_clusters']} clusters, one a seeded cluster each (least "
              f"purity {purity:.4f}), noise {int((found == -1).sum())}; peak memory {peak / 1e6:.1f} MB "
              f"above a {base / 1e9:.3f} GB baseline (limit {HDB_MEM_LIMIT / 1e9:g} GB; one dense N x N "
              f"float64 matrix {8.0 * n * n / 1e9:.1f} GB) | {card}")
        del pts, truth, res
    print(f"[25] HDBSCAN phase took {time.perf_counter() - t_phase:.1f} s")
    replaces = (f"none: no TPU kernel; the JAX package's hdbscan_clustering ({JAX_PKG}/workloads/embed.py:245) "
                "runs scikit-learn's HDBSCAN on the host")
    return [
        {"name": "hdbscan_core", "route": "cuda", "source": f"{PORT}/csrc/hdbscan.cu", "replaces": replaces,
         "launches": launches_b[f"n{TSNE_N}_d{HDB_DIMS[0]}"]["hdbscan_core"], "max_abs_err": core_err,
         "ms": core_ms, "plain_ms": core_plain_ms, "bound_ms": core_bound, "bound_by": core_by,
         # no one PyTorch call gives the k-th smallest distance without an N x N matrix
         "library_ms": None, "shape": "N 8192, D 48, k 10",
         "main_path_ms": {f"n{TSNE_N}_d{d}": v["core"] * 1e3 for d, v in main_ms.items()},
         "hdbscan_launches": {k: v["hdbscan_core"] for k, v in launches_b.items()}},
        {"name": "hdbscan_mst", "route": "cuda", "source": f"{PORT}/csrc/hdbscan.cu", "replaces": replaces,
         "launches": launches_b[f"n{TSNE_N}_d{HDB_DIMS[0]}"]["hdbscan_mst"], "max_abs_err": mst_err,
         "ms": mst_ms, "plain_ms": mst_plain_s * 1e3, "bound_ms": mst_bound, "bound_by": mst_by,
         # no PyTorch call builds a minimum spanning tree
         "library_ms": None, "shape": "N 4096, D 48",
         "main_path_ms": {f"n{TSNE_N}_d{d}": v["mst"] * 1e3 for d, v in main_ms.items()},
         "hdbscan_launches": {k: v["hdbscan_mst"] for k, v in launches_b.items()}},
    ]


# ---------------------------------------------------------------------------
# Phase 26: the RTM trunk's inference epilogue
# ---------------------------------------------------------------------------

EPI_BATCH = 128  # the benchmark's RTM inference batch
EPI_FRAMES = 16  # (c)'s frames, two batches of EPI_EXPORT_BATCH
EPI_EXPORT_BATCH = 8
EPI_SITES = 49  # norms a full-depth ResNet-50 forward runs as epilogues


def trunk_site_counts() -> dict:
    """{(kind, C, H): sites of that kind and shape in one ResNet-50 forward
    at 224 px}: "relu" (a norm and its ReLU), "identity" (a block's last
    norm, the identity and the ReLU), "downsample" (the last norm, the
    downsample branch's norm, the sum and the ReLU)."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import resnet

    counts = {("relu", 64, 112): 1}
    h = 56
    for si, (nblocks, planes) in enumerate(resnet.STAGES):
        h_in, h = h, h if si == 0 else h // 2
        for bi in range(nblocks):
            for key in (("relu", planes, h_in if bi == 0 else h), ("relu", planes, h),
                        ("downsample" if bi == 0 else "identity", planes * resnet.EXPANSION, h)):
                counts[key] = counts.get(key, 0) + 1
    if sum(counts.values()) != EPI_SITES:
        raise AssertionError(f"trunk sites: {sum(counts.values())}, want {EPI_SITES}")
    return counts


def epilogue_site(kind: str, shape, dtype, rng, dev):
    """(x, norm, other, other's norm) of one site: seeded conv-output-like
    values and norm statistics; ReLU outputs as the identity."""
    import torch

    def act():
        return torch.from_numpy(rng.standard_normal(shape, dtype="float32")).to(dev, dtype)

    def norm():
        c = shape[1]
        return {k: torch.from_numpy(v.astype("float32")).to(dev, dtype) for k, v in {
            "scale": rng.standard_normal(c) * 0.2 + 1.0, "bias": rng.standard_normal(c) * 0.3,
            "mean": rng.standard_normal(c) * 0.3, "var": rng.random(c) + 0.2}.items()}

    x, p = act(), norm()
    if kind == "identity":
        return x, p, torch.relu(act()), None
    if kind == "downsample":
        return x, p, act(), norm()
    return x, p, None, None


@contextlib.contextmanager
def plain_epilogue():
    """Every trunk site takes the plain version while the block runs."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    fused = ck.bn_epilogue
    ck.bn_epilogue = ck.bn_epilogue_plain
    try:
        yield
    finally:
        ck.bn_epilogue = fused


def bn_epilogue_phase(card: str) -> dict:
    """Phase 26: the ``bn_epilogue`` kernel on the RTM trunk (see the module
    docstring) -> its entry of the kernels line."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.export import (
        ExportedPredictor, export_engine,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import rtm
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(26)
    counts = trunk_site_counts()

    # -- (a) each site: bit for bit, kernel and plain times, byte bound ----
    def sites(batch, dtype):
        rows, sums, launches, err = [], {"kernel": 0.0, "plain": 0.0, "bound": 0.0}, 0, 0.0
        for (kind, c, h), n in counts.items():
            x, p, other, p_other = epilogue_site(kind, (batch, c, h, h), dtype, rng, dev)
            ck.reset_launches()
            got = ck.bn_epilogue(x, p, True, other, p_other)
            torch.cuda.synchronize()
            launches += ck.LAUNCHES["bn_epilogue"]
            plain = ck.bn_epilogue_plain(x, p, True, other, p_other)
            err = max(err, float((got.float() - plain.float()).abs().max()))
            if not torch.equal(got, plain):
                raise AssertionError(f"bn_epilogue {kind} [{batch},{c},{h},{h}] {dtype}: "
                                     "not the plain version's bits")
            k_ms = device_ms(lambda: ck.bn_epilogue(x, p, True, other, p_other))
            p_ms = device_ms(lambda: ck.bn_epilogue_plain(x, p, True, other, p_other))
            nbytes = x.numel() * x.element_size() * (2 if other is None else 3)
            b_ms, _ = bound_ms(nbytes, 0.0)
            rows.append(f"{kind} C {c} {h}x{h} (x{n}): {k_ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f}, "
                        f"{b_ms / k_ms * 100:.0f} %), plain {p_ms * 1e3:.1f}")
            for key, v in (("kernel", k_ms), ("plain", p_ms), ("bound", b_ms)):
                sums[key] += n * v
            del x, other, got, plain
        if launches != len(counts):
            raise AssertionError(f"bn_epilogue: {launches} launches for {len(counts)} sites")
        return rows, sums, err

    rows128, sums128, err128 = sites(EPI_BATCH, torch.bfloat16)
    print(f"[26] (a) bn_epilogue vs plain, bf16 batch {EPI_BATCH}, every trunk site bit for bit; a "
          "launch (median of 5 rounds of 20, CUDA events): " + "; ".join(rows128) + f" | {card}")
    print(f"[26] (a) one bf16 batch-{EPI_BATCH} forward's 49 sites: kernel {sums128['kernel']:.3f} ms, "
          f"plain {sums128['plain']:.3f} ms, bound {sums128['bound']:.3f} ms "
          f"({sums128['bound'] / sums128['kernel'] * 100:.0f} % of 3.35 TB/s) | {card}")
    _, sums1, err1 = sites(1, torch.float32)
    print(f"[26] (a) one float32 batch-1 forward's 49 sites (the camera), bit for bit: kernel "
          f"{sums1['kernel'] * 1e3:.1f} us, plain {sums1['plain'] * 1e3:.1f} us, bound "
          f"{sums1['bound'] * 1e3:.1f} us | {card}")

    # -- (b) the bf16 engine step on the kernel and on the plain version ---
    spec = rtm.build_spec(config.load_tasks(config.default_tasks_path()), {})
    params = random_rtm_params(spec, 26)
    eng = executor.Engine("rtm", spec, params, batch_size=EPI_BATCH, dtype=torch.bfloat16, device=dev)
    frames = np.random.default_rng(27).integers(0, 256, (2 * EPI_BATCH, 224, 224, 3), dtype=np.uint8)
    xb = torch.from_numpy(frames[:EPI_BATCH]).to(dev)
    ck.reset_launches()
    fused = eng.run(frames)
    launches = ck.LAUNCHES["bn_epilogue"]
    if launches != 2 * EPI_SITES:
        raise AssertionError(f"bf16 RTM engine, 2 batches: {launches} launches; want {2 * EPI_SITES}")
    with plain_epilogue():
        plain = eng.run(frames)
    if not (np.array_equal(fused["probs"], plain["probs"]) and np.array_equal(fused["preds"], plain["preds"])):
        raise AssertionError("bf16 RTM engine: the kernel's probabilities are not the plain version's")

    def step_plain():
        with plain_epilogue():
            return eng.step(xb)

    step_k, step_p = in_turns(lambda: eng.step(xb), step_plain, reps=3, rounds=3)
    enq_k, enq_p = enqueue_ms(lambda: eng.step(xb)), enqueue_ms(step_plain)
    print(f"[26] (b) bf16 RTM engine (12 tasks, C = d = 2048) at batch {EPI_BATCH}: "
          f"{launches // 2} launches a batch; "
          f"Engine.run's probabilities bit for bit the plain epilogue's on {len(frames)} frames; "
          f"step in turns: kernel {step_k:.3f} ms, plain {step_p:.3f} ms (device); host enqueue of a "
          f"step: kernel {enq_k:.3f} ms, plain {enq_p:.3f} ms | {card}")
    del eng, xb

    # -- (c) torch.export round trip of a bf16 RTM engine -------------------
    eng = executor.Engine("rtm", spec, params, batch_size=EPI_EXPORT_BATCH, dtype=torch.bfloat16,
                          device=dev)
    frames = frames[:EPI_FRAMES]
    want = eng.run(frames)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_26_")
    try:
        export_engine(eng, tmp)
        program = torch.export.load(os.path.join(tmp, "forward.pt2"))
        nodes = sum("wadt_torch.bn_epilogue" in str(n.target) for n in program.graph.nodes)
        if nodes != EPI_SITES:
            raise AssertionError(f"bf16 RTM artifact: {nodes} wadt_torch.bn_epilogue nodes, want {EPI_SITES}")
        pred = ExportedPredictor(tmp, device=dev)
        ck.reset_launches()
        got = pred.run(frames)
        torch.cuda.synchronize()
        art_launches = ck.LAUNCHES["bn_epilogue"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_batches = EPI_FRAMES // EPI_EXPORT_BATCH
    if art_launches != n_batches * EPI_SITES or not np.array_equal(got["preds"], want["preds"]):
        raise AssertionError(f"bf16 RTM artifact: {art_launches} launches (want {n_batches * EPI_SITES}), "
                             f"preds equal {np.array_equal(got['preds'], want['preds'])}")
    prob_gap = float(np.abs(got["probs"] - want["probs"]).max())
    print(f"[26] (c) bf16 RTM torch.export artifact: {nodes} wadt_torch.bn_epilogue nodes; "
          f"ExportedPredictor.run on {EPI_FRAMES} frames: {art_launches} launches, predictions equal "
          f"Engine.run's, probabilities {'bit for bit' if prob_gap == 0 else f'within {prob_gap:.3e}'}")
    print(f"[26] epilogue phase took {time.perf_counter() - t_phase:.1f} s")
    return {
        "name": "bn_epilogue", "route": "cuda", "source": f"{PORT}/csrc/bn_epilogue.cu",
        "replaces": "none: no TPU kernel; XLA fuses the JAX trunk's norm, residual sum and ReLU "
                    "into each convolution's output",
        "launches": launches // 2, "max_abs_err": max(err128, err1),
        "ms": sums128["kernel"], "plain_ms": sums128["plain"], "bound_ms": sums128["bound"],
        "bound_by": "bytes", "shape": f"the 49 sites of a bf16 batch-{EPI_BATCH} forward, summed",
        # no one PyTorch call computes a norm's affine, the residual and the ReLU in one pass
        "library_ms": None,
        "step_ms": {"kernel": step_k, "plain": step_p},
        "enqueue_ms": {"kernel": enq_k, "plain": enq_p},
    }


# ---------------------------------------------------------------------------
# Phase 27: the PM trunk's instance norm and LeakyReLU
# ---------------------------------------------------------------------------

PM_SITES = ((64, 112), (128, 56), (256, 28), (512, 14), (1024, 13))  # (C, H) at 224 px


@contextlib.contextmanager
def plain_instance_norm():
    """Every PM trunk site takes the plain chain while the block runs."""
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    fused = ck.instance_norm_leaky
    ck.instance_norm_leaky = lambda x, p, slope=0.2, inplace=False: ck.instance_norm_leaky_plain(x, p, slope)
    try:
        yield
    finally:
        ck.instance_norm_leaky = fused


def instance_norm_phase(card: str) -> dict:
    """Phase 27: the ``instance_norm_leaky`` kernel on the PM headline trunk
    (see the module docstring) -> its entry of the kernels line."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pm
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    config.enable_parity_precision()
    gen = torch.Generator(dev).manual_seed(27)

    # -- (a) each float32 batch-256 site: kernel, byte bound, plain chain ---
    rows, sums, err, exact_gaps = [], {"kernel": 0.0, "plain": 0.0, "bound": 0.0}, 0.0, []
    for c, h in PM_SITES:
        x = (torch.randn((BATCH, h, h, c), generator=gen, device=dev)
             * (torch.rand(c, generator=gen, device=dev) + 0.5) + torch.randn(c, generator=gen, device=dev))
        p = {"scale": torch.rand(c, generator=gen, device=dev) + 0.5,
             "bias": torch.randn(c, generator=gen, device=dev) * 0.3}
        ck.reset_launches()
        got = ck.instance_norm_leaky(x, p)
        torch.cuda.synchronize()
        if ck.LAUNCHES["instance_norm_leaky"] != 1 or not torch.equal(ck.instance_norm_leaky(x, p), got):
            raise AssertionError(f"instance_norm_leaky [{BATCH},{h},{h},{c}]: one launch, the same bits twice")
        plain = ck.instance_norm_leaky_plain(x, p)

        def gap_to(want, got=got):  # the largest gap over each plane's largest |want|
            return float(((got.double() - want).abs().amax(dim=(1, 2))
                          / want.abs().amax(dim=(1, 2))).max())

        gap = gap_to(plain.double())
        if gap > 1e-6:
            raise AssertionError(f"instance_norm_leaky [{BATCH},{h},{h},{c}]: {gap:.3e} of a plane's scale")
        exact = ck.instance_norm_leaky_plain(x.double(), {k: v.double() for k, v in p.items()})
        err = max(err, gap)
        exact_gaps.append(f"C {c}: kernel {gap_to(exact):.2e}, plain {gap_to(exact, plain):.2e}")
        del got, plain, exact
        y = x.clone()  # the main path writes over the conv output
        k_ms = device_ms(lambda: ck.instance_norm_leaky(y, p, inplace=True))
        p_ms = device_ms(lambda: ck.instance_norm_leaky_plain(x, p))
        b_ms, _ = bound_ms(2 * x.numel() * x.element_size(), 0.0)
        rows.append(f"C {c} {h}x{h}: {k_ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f}, "
                    f"{b_ms / k_ms * 100:.0f} %), plain {p_ms * 1e3:.1f}")
        for key, v in (("kernel", k_ms), ("plain", p_ms), ("bound", b_ms)):
            sums[key] += v
        del x, y
    print(f"[27] (a) instance_norm_leaky vs plain, float32 batch {BATCH}, every PM headline site within "
          f"1e-6 of its planes' scale (largest {err:.3e}), one launch, twice the same bits; in place, "
          "a launch (median of 5 rounds of 20, CUDA events): " + "; ".join(rows) + f" | {card}")
    print("[27] (a) largest gap to the float64 chain over each plane's largest value: "
          + "; ".join(exact_gaps))
    print(f"[27] (a) one float32 batch-{BATCH} PM forward's 5 sites: kernel {sums['kernel']:.3f} ms, "
          f"plain {sums['plain']:.3f} ms, bound {sums['bound']:.3f} ms (one read and one write, "
          f"{sums['bound'] / sums['kernel'] * 100:.0f} % of 3.35 TB/s) | {card}")

    # -- (b) the float32 PM engine step on the kernel and on the plain chain
    spec = pm.build_spec(config.load_tasks(config.default_tasks_path()), {})
    params = pm.init(torch.Generator().manual_seed(27), spec)
    eng = executor.Engine("pm", spec, params, batch_size=BATCH, device=dev)
    frames = np.random.default_rng(28).integers(0, 256, (2 * BATCH, 224, 224, 3), dtype=np.uint8)
    xb = torch.from_numpy(frames[:BATCH]).to(dev)
    ck.reset_launches()
    fused = eng.run(frames)
    launches = ck.LAUNCHES["instance_norm_leaky"]
    if launches != 10:
        raise AssertionError(f"float32 PM engine, 2 batches: {launches} launches; want 10")
    with plain_instance_norm():
        plain = eng.run(frames)
    gap = float(np.abs(fused["probs"] - plain["probs"]).max())
    if gap > 1e-5:
        raise AssertionError(f"float32 PM engine: probabilities {gap:.3e} from the plain chain's")

    def step_plain():
        with plain_instance_norm():
            return eng.step(xb)

    step_k, step_p = in_turns(lambda: eng.step(xb), step_plain, reps=3, rounds=3)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    eng.step(xb)
    torch.cuda.synchronize()
    peak_k = torch.cuda.max_memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    step_plain()
    torch.cuda.synchronize()
    peak_p = torch.cuda.max_memory_allocated(dev) - base
    print(f"[27] (b) float32 PM engine (ndf 64, 12 tasks) at batch {BATCH}: {launches // 2} launches "
          f"a batch; Engine.run's probabilities within {gap:.3e} of the plain chain's on {len(frames)} "
          f"frames; step in turns: kernel {step_k:.3f} ms, plain {step_p:.3f} ms "
          f"(device); a step's peak over the resident state: kernel {peak_k / 1e9:.3f} GB, plain "
          f"{peak_p / 1e9:.3f} GB | {card}")
    print(f"[27] instance norm phase took {time.perf_counter() - t_phase:.1f} s")
    return {
        "name": "instance_norm_leaky", "route": "cuda", "source": f"{PORT}/csrc/instance_norm_leaky.cu",
        "replaces": "none: no TPU kernel; XLA fuses the JAX trunk's instance norm and LeakyReLU "
                    "into each convolution's output",
        "launches": launches // 2, "max_rel_err": err,
        "ms": sums["kernel"], "plain_ms": sums["plain"], "bound_ms": sums["bound"],
        "bound_by": "bytes", "shape": f"the 5 sites of a float32 batch-{BATCH} PM forward, summed",
        # no one PyTorch call computes an instance norm, its affine and a LeakyReLU in one pass
        "library_ms": None,
        "step_ms": {"kernel": step_k, "plain": step_p},
    }


# ---------------------------------------------------------------------------
# Phase 28: the Engine's upload through its pinned staging ring
# ---------------------------------------------------------------------------

UPLOAD_POOL, UPLOAD_FRAMES = 1024, 2048  # the benchmark's inference calls


@contextlib.contextmanager
def direct_upload(eng):
    """The engine with its staging ring taken out: host frames go up as
    ``torch.as_tensor(frames).to(device)``, pageable, on the compute stream."""
    ring, eng._ring = eng._ring, None
    try:
        yield
    finally:
        eng._ring = ring


def copy_overlap(events) -> tuple:
    """(host-to-device copy ms of each call's batches, the share of each
    copy's time that a kernel ran beside it) from ``prof.events()``."""
    from torch.autograd import DeviceType

    copies, kernels = [], []
    for e in events:
        if getattr(e, "device_type", None) != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        r = (e.time_range.start, e.time_range.end)
        if e.name.startswith("Memcpy HtoD"):
            copies.append(r)
        elif not e.name.startswith(("Memcpy", "Memset")):
            kernels.append(r)
    busy = []
    for a, b in sorted(kernels):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    shares = [sum(max(0.0, min(b, t) - max(a, s)) for a, b in busy) / max(t - s, 1e-9)
              for s, t in sorted(copies)]
    return [(t - s) / 1e3 for s, t in sorted(copies)], shares


def upload_ab(label: str, eng, frames, card: str) -> dict:
    """Phase 28 on one engine: bit for bit, in turns, the device trace and
    the tracer's counts of the staged upload against the direct one."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import trace

    batches = -(-len(frames) // eng.batch_size)
    staged = eng.run(frames)
    with direct_upload(eng):
        direct = eng.run(frames)
    if not all(np.array_equal(staged[k], direct[k]) for k in ("probs", "preds")):
        raise AssertionError(f"[28] {label}: the staged upload's answers are not the direct upload's")

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(frames)
        return len(frames) / (time.perf_counter() - t0)

    def call_direct():
        with direct_upload(eng):
            return call()

    rates = {"direct": [], "staged": []}
    for _ in range(3):
        rates["direct"].append(call_direct())
        rates["staged"] += [call(), call()]
        rates["direct"].append(call_direct())
    with trace.recording():
        eng.run(frames)
    counts = trace.counters()
    stage_ms = [r.host_ms for r in trace.records() if r.name == "engine.stage"]
    traced = {}
    for side, fn in (("direct", call_direct), ("staged", call)):
        fn()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        traced[side] = copy_overlap(prof.events())
    if counts.get("engine.staged") != batches:
        raise AssertionError(f"[28] {label}: engine.staged {counts.get('engine.staged')}, want {batches}")
    med = {k: statistics.median(v) for k, v in rates.items()}
    h2d = {k: sum(v[0]) / batches for k, v in traced.items()}
    later = {k: v[1][1:] for k, v in traced.items()}
    print(f"[28] {label}: {len(frames)} frames a call, {batches} batches; answers bit for bit the direct "
          f"upload's; in turns (direct, staged, staged, direct; 3 rounds): direct "
          f"{[round(r, 1) for r in rates['direct']]} img/s (median {med['direct']:,.1f}), staged "
          f"{[round(r, 1) for r in rates['staged']]} (median {med['staged']:,.1f}, "
          f"{(med['staged'] / med['direct'] - 1) * 100:+.1f} %) | {card}")
    print(f"[28] {label}: device trace of one call a side: host-to-device copy a batch direct "
          f"{h2d['direct']:.3f} ms, staged {h2d['staged']:.3f} ms ({len(traced['staged'][0])} copies); "
          f"share of each copy after the call's first that kernels overlap: direct "
          f"{statistics.mean(later['direct'] or [0.0]):.3f} (min {min(later['direct'] or [0.0]):.3f}), staged "
          f"{statistics.mean(later['staged'] or [0.0]):.3f} (min {min(later['staged'] or [0.0]):.3f}); "
          f"first copy {traced['staged'][1][0] if traced['staged'][1] else 0.0:.3f}; one recorded call: "
          f"engine.staged {counts.get('engine.staged', 0)}, engine.stage_wait "
          f"{counts.get('engine.stage_wait', 0)}, engine.stage host {statistics.mean(stage_ms):.3f} ms a batch "
          f"(min {min(stage_ms):.3f}, max {max(stage_ms):.3f}) | {card}")
    return {"img_s": med, "h2d_ms": h2d, "overlap": {k: statistics.mean(v or [0.0]) for k, v in later.items()},
            "staged": counts.get("engine.staged", 0), "stage_wait": counts.get("engine.stage_wait", 0),
            "stage_ms": statistics.mean(stage_ms)}


def upload_phase(card: str) -> dict:
    """Phase 28: the Engine's staged upload against the direct one on phase
    26 (b)'s RTM and phase 27 (b)'s PM engines (see the module docstring)."""
    import numpy as np
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pm, rtm

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    config.enable_parity_precision()
    pool = np.random.default_rng(28).integers(0, 256, (UPLOAD_POOL, 224, 224, 3), dtype=np.uint8)
    frames = pool[np.arange(UPLOAD_FRAMES) % UPLOAD_POOL]
    del pool
    tasks = config.load_tasks(config.default_tasks_path())
    out = {}
    spec = rtm.build_spec(tasks, {})
    eng = executor.Engine("rtm", spec, random_rtm_params(spec, 26), batch_size=EPI_BATCH,
                          dtype=torch.bfloat16, device=dev)
    out["rtm_bf16"] = upload_ab(f"bf16 RTM engine at batch {EPI_BATCH}", eng, frames, card)
    del eng
    spec = pm.build_spec(tasks, {})
    eng = executor.Engine("pm", spec, pm.init(torch.Generator().manual_seed(27), spec), batch_size=BATCH,
                          device=dev)
    out["pm_f32"] = upload_ab(f"float32 PM engine at batch {BATCH}", eng, frames, card)
    del eng
    torch.cuda.empty_cache()
    print(f"[28] upload phase took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 29: the RTM trunk's train-mode batch norm
# ---------------------------------------------------------------------------

BNT_BATCH = 128  # the benchmark's train batch
BNT_STEPS = 10  # timed steps of (c), after 3 untimed
# run in a process of its own from a checkout's root: that checkout's RTM
# train step at batch 128 in float32 (phase 29 (c)), as JSON
TRAIN_AB = """
import json, os, statistics, sys
sys.path.insert(0, os.getcwd())
import torch
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import rtm
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import train
config.enable_parity_precision()
dev = torch.device("cuda", 0)
spec = rtm.build_spec(config.load_tasks(config.default_tasks_path()), {})
init_fn, step_fn = train.make_train_step("rtm", spec, device=dev, dropout_rate=0.0)
state = init_fn(29)
g = torch.Generator(dev).manual_seed(29)
x = torch.randn((BATCH, 224, 224, 3), generator=g, device=dev)
y = torch.stack([torch.randint(0, k, (BATCH,), generator=g, device=dev) for k in spec.tasks.num_classes], 1)
losses = []
for _ in range(3):
    state, loss = step_fn(state, x, y)
    losses.append(float(loss))
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
times = []
for _ in range(STEPS):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, loss = step_fn(state, x, y)
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
print(json.dumps({"ms": statistics.median(times), "losses": losses, "peak": torch.cuda.max_memory_allocated(),
                  "requested": torch.cuda.memory_stats()["requested_bytes.all.peak"]}))
"""


def bn_train_site(kind: str, shape, dtype, gen, dev):
    """(x, norm, other, other's norm, dy) of one train-mode site: seeded
    conv-output-like values (mean 0.5, spread 2), norm vectors of x's type
    and float32 running statistics; ReLU outputs as the identity."""
    import torch

    def act():
        return (torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5).to(dtype)

    def norm():
        c = shape[1]
        return {"scale": (torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0).to(dtype),
                "bias": (torch.randn(c, generator=gen, device=dev) * 0.3).to(dtype),
                "mean": torch.randn(c, generator=gen, device=dev) * 0.3,
                "var": torch.rand(c, generator=gen, device=dev) + 0.2}

    x, p = act(), norm()
    other = p_other = None
    if kind == "identity":
        other = torch.relu(act())
    elif kind == "downsample":
        other, p_other = act(), norm()
    return x, p, other, p_other, torch.randn(shape, generator=gen, device=dev).to(dtype)


def library_site(x, p, relu, other=None, p_other=None):
    """The library's train-mode site: ``F.batch_norm(training=True)`` (cuDNN),
    the sum, ``torch.relu``; running statistics moved in copies of x's type."""
    import torch
    import torch.nn.functional as F

    def bn(t, q):
        return F.batch_norm(t, q["mean"].to(t.dtype, copy=True), q["var"].to(t.dtype, copy=True),
                            q["scale"], q["bias"], training=True, momentum=0.1, eps=1e-5)

    y = bn(x, p)
    if other is not None:
        y = y + (other if p_other is None else bn(other, p_other))
    return (torch.relu(y) if relu else y), None, None


def site_grads(fn, x, p, other, p_other, dy, relu=True):
    """A site's forward and backward -> (y, every gradient): x, p's scale
    and bias, then other's and p_other's where the site has them."""
    import torch

    leaves = [x, p["scale"], p["bias"]] + ([] if other is None else [other]) + (
        [] if p_other is None else [p_other["scale"], p_other["bias"]])
    leaves = [t.detach().requires_grad_() for t in leaves]
    q = {**p, "scale": leaves[1], "bias": leaves[2]}
    o = None if other is None else leaves[3]
    qo = None if p_other is None else {**p_other, "scale": leaves[-2], "bias": leaves[-1]}
    with torch.enable_grad():
        y = fn(leaves[0], q, relu, o, qo)[0]
        return y.detach(), torch.autograd.grad(y, leaves, dy)


def bn_train_phase(card: str) -> dict:
    """Phase 29: the ``bn_train`` kernels on the RTM train-mode trunk (see
    the module docstring) -> its entry of the kernels line."""
    import torch

    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import config
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import resnet, rtm
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck,
    )
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import train

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    config.enable_parity_precision()
    gen = torch.Generator(dev).manual_seed(29)
    counts = trunk_site_counts()
    versions = {"kernel": ck.bn_train, "chain": ck.bn_train_plain, "library": library_site}

    # -- (a) each site, forward and backward: the chain's values, times -----
    def sites(dtype):
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
        sums = dict.fromkeys((*versions, "bound"), 0.0)
        rows, err, chain_err = [], 0.0, 0.0
        for (kind, c, h), n in counts.items():
            shape = (BNT_BATCH, c, h, h)
            x, p, other, p_other, dy = bn_train_site(kind, shape, dtype, gen, dev)
            ck.reset_launches()
            y, grads = site_grads(ck.bn_train, x, p, other, p_other, dy)
            torch.cuda.synchronize()
            launches = (ck.LAUNCHES["bn_train"], ck.LAUNCHES["bn_train_backward"])
            if launches != ((3 if kind == "downsample" else 2), 2):
                raise AssertionError(f"bn_train {kind} {shape}: launches {launches}")
            y2, grads2 = site_grads(ck.bn_train, x, p, other, p_other, dy)
            if not (torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))):
                raise AssertionError(f"bn_train {kind} {shape} {dtype}: two calls differ")
            del y2, grads2
            # the truth: the chain in float64 on the same values (the float32
            # chain's sums of 1.6 M values a channel stray ~1e-4 themselves);
            # its gradients for dy masked by the output under test's ReLU: a
            # value within a rounding of zero may take the ReLU on either
            # side, and one such value moves its channel's dscale and dbias by
            # a whole dy times its normalized value
            def chain_in(dt, mask=None):
                up = {k: v.to(dt) for k, v in p.items()}
                up_o = None if p_other is None else {k: v.to(dt) for k, v in p_other.items()}
                g = dy.to(dt) if mask is None else torch.where(mask > 0, dy.to(dt), 0.0)
                return site_grads(ck.bn_train_plain, x.to(dt), up, None if other is None else other.to(dt),
                                  up_o, g, relu=mask is None)

            def worst(y_, grads_, yw):
                flips = int(((y_.double() > 0) != (yw > 0)).sum())
                if flips > 1e-5 * yw.numel():
                    raise AssertionError(f"bn_train {kind} {shape} {dtype}: {flips} ReLUs differ")
                gw = chain_in(torch.float64, y_)[1]
                return [float((got.double() - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                        for got, ref in [(y_, yw)] + list(zip(grads_, gw))]

            truth = chain_in(torch.float64)[0]
            gaps = worst(y, grads, truth)
            chain_gap = max(worst(*chain_in(torch.float32), truth))
            for what, rel, t in zip(["y"] + [f"gradient {i}" for i in range(len(grads))], gaps,
                                    [tol] + [2 * tol] * len(grads)):
                if rel > t:
                    raise AssertionError(f"bn_train {kind} {shape} {dtype} {what}: {rel:.3e} from the "
                                         f"float64 chain, over {t} (the float32 chain: {chain_gap:.3e})")
            err, chain_err = max(err, *gaps), max(chain_err, chain_gap)
            del truth, y, grads
            times = {name: device_ms(lambda f=f: site_grads(f, x, p, other, p_other, dy), reps=5, rounds=3)
                     for name, f in versions.items()}
            # the function's least traffic: forward x (and other) in, y out;
            # backward dy and x (and other) in, the ReLU's mask recomputed from
            # them and the forward's statistics, dx (and other's) out
            passes = {"relu": 2 + 3, "identity": 3 + 5, "downsample": 3 + 5}[kind]
            b_ms, _ = bound_ms(passes * x.numel() * x.element_size(), 0.0)
            rows.append(f"{kind} C {c} {h}x{h} (x{n}): kernel {times['kernel']:.3f} ms, chain "
                        f"{times['chain']:.3f}, library {times['library']:.3f}, bound {b_ms:.3f}")
            for key, v in (*times.items(), ("bound", b_ms)):
                sums[key] += n * v
            del x, other, dy
        return rows, sums, err, chain_err

    out = {}
    for dtype, label in ((torch.float32, "float32"), (torch.bfloat16, "bf16")):
        rows, sums, err, chain_err = sites(dtype)
        out[label] = (sums, err)
        print(f"[29] (a) bn_train {label} batch {BNT_BATCH}, every train-mode site forward and backward "
              f"against the chain in float64: largest gap {err:.2e} of each tensor's largest value (the "
              f"float32 chain's {chain_err:.2e}), two calls the same bits; a site's forward and backward "
              "(median of 3 rounds of 5, CUDA events): "
              + "; ".join(rows) + f" | {card}")
        print(f"[29] (a) one {label} batch-{BNT_BATCH} train-mode trunk's 49 sites, forward and backward: "
              f"kernel {sums['kernel']:.3f} ms, chain {sums['chain']:.3f} ms, library {sums['library']:.3f} ms, "
              f"bound {sums['bound']:.3f} ms ({sums['bound'] / sums['kernel'] * 100:.0f} % of 3.35 TB/s) "
              f"| {card}")

    # -- (b) the cell's own train step: every site on the kernels ------------
    spec = rtm.build_spec(config.load_tasks(config.default_tasks_path()), {})
    init_fn, step_fn = train.make_train_step("rtm", spec, device=dev, dropout_rate=0.0)
    state = init_fn(29)
    x = torch.randn((BNT_BATCH, 224, 224, 3), generator=gen, device=dev)
    y = torch.stack([torch.randint(0, k, (BNT_BATCH,), generator=gen, device=dev)
                     for k in spec.tasks.num_classes], 1)
    state, _ = step_fn(state, x, y)  # the first step makes AdamW's moments
    torch.cuda.synchronize()
    ck.reset_launches()
    state, loss = step_fn(state, x, y)
    torch.cuda.synchronize()
    launches = (ck.LAUNCHES["bn_train"], ck.LAUNCHES["bn_train_backward"])
    if launches != (2 * EPI_SITES + len(resnet.STAGES), 2 * EPI_SITES):
        raise AssertionError(f"RTM train step: bn_train launches {launches}, want (102, 98)")
    print(f"[29] (b) one RTM train step (train.make_train_step('rtm'): trunk, heads, loss, AdamW), float32 "
          f"batch {BNT_BATCH}: bn_train launches {launches[0]} forward, {launches[1]} backward; loss "
          f"{float(loss):.6f}")
    del state, x, y, loss, init_fn, step_fn
    torch.cuda.empty_cache()

    # -- (c) the whole train step against the parent's, in turns -------------
    if os.path.isdir(PARENT):
        script = TRAIN_AB.replace("BATCH", str(BNT_BATCH)).replace("STEPS", str(BNT_STEPS))
        runs = []
        for root in (PARENT, ".", ".", PARENT):
            res = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True, text=True,
                                 timeout=900, check=True)
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        p1, c1, c2, p2 = runs
        gap = max(abs(a - b) / abs(b) for a, b in zip(c1["losses"], p1["losses"]))
        print(f"[29] (c) RTM train step, float32 batch {BNT_BATCH}, the parent's port ({PARENT}) against this "
              f"tree in turns: device {p1['ms']:.2f} / {p2['ms']:.2f} -> {c1['ms']:.2f} / {c2['ms']:.2f} ms a "
              f"step (median of {BNT_STEPS}); peak memory {p1['peak']} -> {c1['peak']} B allocated, "
              f"{p1['requested']} -> {c1['requested']} B requested; losses of the first "
              f"3 steps {p1['losses']} -> {c1['losses']}, largest relative gap {gap:.2e} | {card}")
        out["step"] = {"parent_ms": [p1["ms"], p2["ms"]], "ms": [c1["ms"], c2["ms"]], "loss_gap": gap,
                       "peak": [p1["peak"], c1["peak"]], "requested": [p1["requested"], c1["requested"]]}
    print(f"[29] train-mode norm phase took {time.perf_counter() - t_phase:.1f} s")
    sums, err = out["float32"]
    return {
        "name": "bn_train", "route": "cuda", "source": f"{PORT}/csrc/bn_train.cu",
        "replaces": "none: no TPU kernel; XLA fuses the JAX train step's norms, residual sums and ReLUs "
                    "around each convolution",
        "launches": {"forward": launches[0], "backward": launches[1]}, "max_rel_err": err,
        "ms": sums["kernel"], "plain_ms": sums["chain"], "library_ms": sums["library"],
        "bound_ms": sums["bound"], "bound_by": "bytes",
        "shape": f"the 49 sites of a float32 batch-{BNT_BATCH} train-mode trunk, forward and backward, summed",
        "bf16_ms": {k: out["bf16"][0][k] for k in (*versions, "bound")},
        "step_ms": out.get("step"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel from torch.profiler")
    ap.add_argument("--record", action="store_true",
                    help="add phase 23's measured routes to the port's ops/kernel_ab.json "
                         "for this card, as one more call")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    os.chdir(repo)
    sys.path.insert(0, repo)
    import heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch as port
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import executor
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.models import pmg
    from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
        cuda_kernels as ck, nn, norms, preprocess as pre,
    )

    port.config.enable_parity_precision()
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build(verbose=True)
    print(f"[1] kernels built in {time.perf_counter() - t0:.1f} s")
    old = archived_kernels()
    print(f"[1] archived kernel versions for an A/B: {', '.join(sorted(old)) or 'none in this checkout'}")

    # -- 2. kernels against their plain versions, on the card -------------
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randn(BATCH, 14, 14, 96).astype(np.float32)).to(dev)
    g = ck.patch_gram(z, 3)
    torch.cuda.synchronize()
    gram_err = max_err(g, ck.patch_gram_plain(z, 3), 1e-5, 1e-5, "patch_gram [256,14,14,96] div 3")
    if not torch.equal(ck.patch_gram(z, 3), g):
        raise AssertionError("patch_gram: two calls on the same inputs differ")
    # ragged shapes: replicate pad, partial output tiles, and (C % 4 != 0)
    # the kernel's scalar load and store path
    rag_err = 0.0
    for shape, div in (((2, 7, 5, 16), 2), ((2, 7, 5, 18), 2)):
        zr = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
        rag_err = max(rag_err, max_err(ck.patch_gram(zr, div), ck.patch_gram_plain(zr, div),
                                       1e-5, 1e-5, f"patch_gram {list(shape)} div {div}"))
    torch.cuda.synchronize()
    print(f"[2] patch_gram vs plain: max abs err {gram_err:.3e} (main shape, two calls "
          f"bit-identical), {rag_err:.3e} (ragged), atol/rtol 1e-5")

    x8 = torch.from_numpy(rng.randint(0, 256, (BATCH, 224, 224, 3), np.uint8)).to(dev)
    conv_w = torch.from_numpy(rng.randn(4, 4, 3, 32).astype(np.float32) * 0.1).to(dev)
    bn = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in {
        "scale": rng.rand(32) + 0.5, "bias": rng.randn(32) * 0.1,
        "mean": rng.randn(32) * 0.1, "var": rng.rand(32) + 0.5}.items()}
    aff_s, aff_t = (torch.as_tensor(a, device=dev) for a in pre.packed_affine(4))
    w0 = conv_w.reshape(48, 32)
    wf = (aff_s[:, None] * w0).contiguous()
    s, t = norms.batch_norm_affine(bn)
    shift = (-(aff_t @ w0) * s + t).contiguous()
    y = ck.stem(x8, wf, s, shift, 4, leaky=True)
    torch.cuda.synchronize()
    stem_err = max_err(y, ck.stem_plain(x8, wf, s, shift, 4, leaky=True), 2e-4, 2e-4,
                       "stem [256,224,224,3] -> 32")
    if not torch.equal(ck.stem(x8, wf, s, shift, 4, leaky=True), y):
        raise AssertionError("stem: two calls on the same inputs differ")
    paths = [f"[256,224,224,3]->32 {stem_path(x8, 32)}"]
    # ragged shapes: 360-byte input runs (W*cin % 16 != 0: the plain path,
    # byte loads), and 12 channels (a partial n-tile, masked stores)
    rag_err = 0.0
    ragged = []
    for shape, cout in (((2, 30, 30, 3), 16), ((2, 32, 32, 3), 12)):
        xr = torch.from_numpy(rng.randint(0, 256, shape, np.uint8)).to(dev)
        wr = torch.from_numpy(rng.randn(48, cout).astype(np.float32) * 0.01).to(dev)
        sr, tr = (torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dev) for _ in range(2))
        rag_err = max(rag_err, max_err(
            ck.stem(xr, wr, sr, tr, 4, leaky=False), ck.stem_plain(xr, wr, sr, tr, 4, leaky=False),
            2e-4, 2e-4, f"stem {list(shape)} -> {cout}"))
        paths.append(f"{list(shape)}->{cout} {stem_path(xr, cout)}")
        ragged.append((xr, cout))
    torch.cuda.synchronize()
    print(f"[2] stem vs plain: max abs err {stem_err:.3e} (main shape, two calls bit-identical), "
          f"{rag_err:.3e} (ragged), atol/rtol 2e-4; paths: {'; '.join(paths)}")
    # bf16 mode on the same images: the bf16-rounded weight, the bias, the
    # batch norm's affine on bf16 params
    bn16 = {k: v.to(torch.bfloat16) for k, v in bn.items()}
    s16, t16 = (v.contiguous() for v in norms.batch_norm_affine(bn16))
    wb = wf.to(torch.bfloat16).float().contiguous()
    bias = (-(aff_t @ w0)).contiguous()
    checks = [stem_bf16_check(x8, wb, bias, s16, t16, "[256,224,224,3]->32")]
    for xr, cout in ragged:
        rr = np.random.RandomState(cout)
        wr = torch.from_numpy(rr.randn(48, cout).astype(np.float32) * 0.01).to(dev).to(torch.bfloat16).float()
        br = torch.from_numpy(rr.randn(cout).astype(np.float32)).to(dev)
        sr, tr = (torch.from_numpy(rr.rand(cout).astype(np.float32) + 0.5).to(dev).to(torch.bfloat16)
                  for _ in range(2))
        checks.append(stem_bf16_check(xr, wr, br, sr, tr, f"{list(xr.shape)}->{cout}"))
    print("[2] stem bf16 mode: (a) the norm and LeakyReLU equal the bf16 chain on the kernel's own "
          "sum bit for bit; (b) the sum within one bf16 ulp of the plain version's rounding "
          "(2^-7 |want| + 2e-4), share of outputs that differ at all (limit 1 %): "
          + "; ".join(f"{c['what']} {c['path']} {c['share'] * 100:.4f} %" for c in checks))
    # tsne_repulsion at ragged N: 64 (the CLI's t-SNE in phase 22 (e): one
    # partial tile, the counted loop) and 4,099 (32 whole tiles, a 3-point
    # tail, rows past N in the last block), at std 10 and at the PCA init's
    # std 1e-4 (every q ~ 1), three duplicated points each
    rep_checks = []
    for n_r in (64, 4099):
        for std in (10.0, 1e-4):
            yr = rng.randn(n_r, 2) * std
            yr[[1, n_r // 2, n_r - 1]] = yr[0]
            c = repulsion_check(ck, torch.from_numpy(yr.astype(np.float32)).to(dev),
                                f"N {n_r}, layout std {std:g}", torch.cuda.synchronize)
            rep_checks.append(f"N {n_r} std {std:g}: rep {c['rep_err'] / c['rep_max']:.2e} x max|rep|, "
                              f"z rows rel {c['z_rel']:.2e}, Z rel {c['z_sum_rel']:.2e}")
    print(f"[2] tsne_repulsion vs plain float64 (limits {TSNE_REP_TOL} x max|rep|, z rows "
          f"{TSNE_REP_TOL} rel, Z {TSNE_Z_TOL} rel): " + "; ".join(rep_checks))

    # -- 3. golden fixture on the card --------------------------------------
    with open(os.path.join(FIXTURES, "pmg_shipped.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(FIXTURES, "pmg_shipped.npz"))
    eng = port.load_engine(
        "pmg", os.path.join(FIXTURES, "pmg_shipped.pth"), meta["tasks"],
        meta["hparams"], batch_size=BATCH, device="cuda",
    )
    spec = eng.spec
    xf = torch.from_numpy(np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))).to(dev)
    with torch.inference_mode():
        logits, _ = pmg.apply(eng.params, xf, spec)
    fix_err = 0.0
    for i, task in enumerate(spec.tasks.names):
        want = torch.from_numpy(data[f"logits/{task}"]).to(dev)
        fix_err = max(fix_err, max_err(logits[:, i, : want.shape[1]], want, 2e-4, 2e-4,
                                       f"pmg_shipped fixture / {task}"))
    print(f"[3] pmg_shipped golden logits on the card: max abs err {fix_err:.3e}, atol/rtol 2e-4")

    # -- 4. main path --------------------------------------------------------
    frames = np.random.RandomState(1).randint(0, 256, (N_FRAMES, 224, 224, 3), np.uint8)
    ck.reset_launches()
    out = eng.run(frames, collect=("probs", "preds", "logits"))
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    for name in ("patch_gram", "stem"):
        if launches[name] == 0:
            raise AssertionError(f"main path never launched the {name} kernel")
    probs, preds = out["probs"], out["preds"]
    if probs.shape != (N_FRAMES, len(spec.tasks), spec.tasks.max_classes):
        raise AssertionError(f"probs shape {probs.shape}")
    mask = executor.class_mask(spec.tasks)
    if not np.allclose(probs.sum(-1), 1.0, atol=1e-5) or np.abs(probs[:, ~mask]).max() != 0:
        raise AssertionError("probability rows do not sum to 1 over the real classes")
    cpu_eng = executor.Engine("pmg", spec, eng.params, batch_size=8, device="cpu")
    want = cpu_eng.run(frames[:8], collect=("logits",))["logits"]
    cpu_err = max_err(torch.from_numpy(out["logits"][:8]), torch.from_numpy(want), 2e-4, 2e-4,
                      "main path logits vs the port's CPU path")
    unknown = executor.Engine("pmg", spec, eng.params, batch_size=BATCH, prob_threshold=0.99,
                              device="cuda").run(frames[:BATCH])["preds"]
    if not (unknown == -1).all():
        raise AssertionError("prob_threshold=0.99 left some predictions known")
    print(f"[4] main path: {N_FRAMES} frames at batch {BATCH}, launches {launches}, "
          f"logits vs CPU max abs err {cpu_err:.3e}, preds[0] {preds[0].tolist()}")

    # -- 5. times -------------------------------------------------------------
    kernels = []
    nbytes = z.numel() * 4 + g.numel() * 4
    flops = 2.0 * BATCH * 9 * 25 * 96 * 96 + g.numel()
    b_ms, b_by = bound_ms(nbytes, flops)
    k1_yard = k1_yardsticks(z, 3)
    kernels.append({
        "name": "patch_gram", "route": "cuda", "source": f"{PORT}/csrc/patch_gram.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_kernels.py:68",
        "launches": launches["patch_gram"], "max_abs_err": gram_err,
        "ms": device_ms(lambda: ck.patch_gram(z, 3)),
        "plain_ms": device_ms(lambda: ck.patch_gram_plain(z, 3)),
        "bound_ms": b_ms, "bound_by": b_by,
        # torch.baddbmm (P^T P times 1/area) on the already split patches:
        # leaves out the replicate pad and the split, timed apart below
        "library_ms": k1_yard["baddbmm"],
    })
    nbytes = x8.numel() + wf.numel() * 4 + 2 * 32 * 4 + y.numel() * 4
    flops = 2.0 * y.numel() * 48 + 2.0 * y.numel()
    b_ms, b_by = bound_ms(nbytes, flops)
    a2d = pre.s2d_pack(x8, 4).reshape(-1, 48).float().contiguous()
    kernels.append({
        "name": "stem", "route": "cuda", "source": f"{PORT}/csrc/stem.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_kernels.py:118",
        "launches": launches["stem"], "max_abs_err": stem_err,
        "ms": device_ms(lambda: ck.stem(x8, wf, s, shift, 4, leaky=True)),
        "plain_ms": device_ms(lambda: ck.stem_plain(x8, wf, s, shift, 4, leaky=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        # torch.addmm on the packed float operand: leaves out the uint8 cast and
        # space-to-depth pack, the batch-norm scale and the LeakyReLU
        "library_ms": device_ms(lambda: torch.addmm(shift, a2d, wf)),
    })
    # K2's bf16 mode (the bf16 path's stem block): bf16 out, its products
    # bf16 x bf16 on the tensor cores; launches from the bf16 run (phase 15)
    y16 = ck.stem(x8, wb, s16, t16, 4, leaky=True, out_dtype=torch.bfloat16, bias=bias)
    b16_ms, b16_by = bound_ms(x8.numel() + wb.numel() * 4 + 32 * 8 + y16.numel() * 2, 0.0,
                              bf16_flops=2.0 * y16.numel() * 48)
    a2d16, wb16, bias16 = a2d.to(torch.bfloat16), wb.to(torch.bfloat16), bias.to(torch.bfloat16)
    stem16 = {
        "name": "stem_bf16", "route": "cuda", "source": f"{PORT}/csrc/stem.cu",
        "replaces": f"{JAX_PKG}/ops/pallas_kernels.py:118",
        "launches": None, "max_abs_err": checks[0]["err"],  # against the plain bf16 chain
        "ms": device_ms(lambda: ck.stem(x8, wb, s16, t16, 4, leaky=True, out_dtype=torch.bfloat16,
                                        bias=bias)),
        "plain_ms": device_ms(lambda: ck.stem_plain(x8, wb, s16, t16, 4, leaky=True,
                                                    out_dtype=torch.bfloat16, bias=bias)),
        "bound_ms": b16_ms, "bound_by": b16_by,
        # torch.addmm of the packed operand cast to bf16 and the bf16 weight,
        # bf16 out: no cast or pack, no norm, no LeakyReLU
        "library_ms": device_ms(lambda: torch.addmm(bias16, a2d16, wb16)),
    }
    kernels.append(stem16)
    del a2d, a2d16
    t0 = time.perf_counter()
    for _ in range(100):
        ck.stem(x8, wf, s, shift, 4, leaky=True)
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    print(f"[5] stem host time of one wrapper call (checks, plan, tensor map encoded, launch "
          f"enqueued): {host_us:.1f} us | {card}")
    if "wadt_stem_u8_f32" in old:  # the archived K2 (CUDA cores, one block per 512 pixels) in turns
        y_old = torch.empty_like(y)
        old_ms, new_ms = in_turns(
            archived_call(old["wadt_stem_u8_f32"], x8.data_ptr(), wf.data_ptr(), s.data_ptr(),
                          shift.data_ptr(), y_old.data_ptr(), BATCH, 224, 224, 3, 4, 32, 1),
            lambda: ck.stem(x8, wf, s, shift, 4, leaky=True))
        print(f"[5] stem float32 in turns: archived v1 {old_ms * 1e3:.1f} us, new {new_ms * 1e3:.1f} us"
              f" | {card}")
        # the bf16 stem block before: archived K2 with the identity affine
        # plus the bias, the cast, batch_norm_infer on the bf16 params (its
        # affine recomputed), the LeakyReLU; after: the bf16 mode alone
        ones = torch.ones(32, device=dev)

        def old_block():
            old["wadt_stem_u8_f32"](x8.data_ptr(), wb.data_ptr(), ones.data_ptr(), bias.data_ptr(),
                                    y_old.data_ptr(), BATCH, 224, 224, 3, 4, 32, 0,
                                    torch.cuda.current_stream().cuda_stream)
            return nn.leaky_relu(norms.batch_norm_infer(y_old.to(torch.bfloat16), bn16), 0.2)

        old_ms, new_ms = in_turns(old_block, lambda: ck.stem(
            x8, wb, s16, t16, 4, leaky=True, out_dtype=torch.bfloat16, bias=bias))
        print(f"[5] bf16 stem block in turns: before (archived v1, cast, batch norm, LeakyReLU) "
              f"{old_ms * 1e3:.1f} us, now (the bf16 mode) {new_ms * 1e3:.1f} us | {card}")
        del y_old
    if args.profile:
        k2_cuts(x8, wf, s, shift, wb, bias, s16, t16, card)
    for k in kernels:
        print(f"[5] {k['name']}: {k['ms'] * 1e3:.1f} us (bound {k['bound_ms'] * 1e3:.2f} us by "
              f"{k['bound_by']}), plain {k['plain_ms'] * 1e3:.1f} us, library "
              f"{k['library_ms'] * 1e3:.1f} us | {card}")
    print(f"[5] patch_gram yardsticks in float32 on the split patches: torch.baddbmm (P^T P / area) "
          f"{k1_yard['baddbmm'] * 1e3:.1f} us, torch.bmm (P^T P) {k1_yard['bmm'] * 1e3:.1f} us; the "
          f"split_patches copy they need {k1_yard['split'] * 1e3:.1f} us | {card}")
    if "wadt_patch_gram_f32" in old:  # the archived K1 (one block per patch) in turns
        g_old = torch.empty_like(g)
        old_ms, new_ms = in_turns(
            archived_call(old["wadt_patch_gram_f32"], z.data_ptr(), g_old.data_ptr(), BATCH, 14, 14, 96, 3),
            lambda: ck.patch_gram(z, 3))
        print(f"[5] patch_gram float32 in turns: archived v1 {old_ms * 1e3:.1f} us, new {new_ms * 1e3:.1f} us"
              f" ({ck.patch_gram_plan(BATCH, 14, 14, 96, 3, ck._sm_count(dev))}) | {card}")

    xb = torch.from_numpy(frames[:BATCH]).to(dev)
    step_ms = device_ms(lambda: eng.step(xb), reps=10, rounds=3)
    print(f"[5] engine step on a device-resident batch of {BATCH}: {step_ms:.3f} ms "
          f"= {BATCH / step_ms * 1e3:,.0f} img/s (device) | {card}")
    h2d = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(frames[:BATCH]).to(dev)
        torch.cuda.synchronize()
        h2d.append(time.perf_counter() - t0)
    print(f"[5] host-to-device copy of one pageable uint8 batch ({frames[:BATCH].nbytes / 1e6:.1f} MB): "
          f"{statistics.median(h2d) * 1e3:.3f} ms (median of 5) | {card}")
    big = np.concatenate([frames] * 5)[: 10 * BATCH]
    wall5, walls = run_wall(eng, big)
    print(f"[5] Engine.run end to end, {len(big)} host uint8 frames at batch {BATCH}: "
          f"{len(big) / wall5:,.0f} img/s (median of 3: {[round(w, 4) for w in walls]} s) | {card}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                eng.step(xb)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))

    routes: list = []
    kernels += camera_phases(args.profile, card, eng.spec, eng.params, routes, old)
    k6, rtm_f32 = rtm_phases(args.profile, card, routes, old)
    kernels.append(k6)
    launches16, k5 = pmg_bf16_phases(card, eng, frames, out, big, wall5, args.profile, old)
    kernels.insert(4, k5)
    stem16["launches"] = launches16["stem"]
    dispatch_cost(card)
    parent_step_ab(card)
    pm_phase(card, args.profile)
    rtm_bf16_phase(card, rtm_f32, args.profile)
    del rtm_f32
    eval_counts = evaluation_phase(card, eng)
    del eng
    deploy_counts = deployment_phase(card)
    train_counts = training_phase(card, profile=args.profile)
    explain_counts = explain_phase(card)
    k6_16, stream16_counts, embed_counts = stream_bf16_embed_phase(card, routes, old=old)
    kernels.append(k6_16)
    mesh_counts = mesh_phase(card)
    select_phase(card, args.record)
    kernels.append(tsne_phase(card, args.profile))
    kernels += hdbscan_phase(card)
    kernels.append(bn_epilogue_phase(card))
    kernels.append(instance_norm_phase(card))
    upload_phase(card)
    kernels.append(bn_train_phase(card))
    # each kernel's launches on the evaluation paths of phase 18 (K2's
    # float32 and bf16 modes count under one wrapper, split by path here)
    for k in kernels:
        name = {"stem_bf16": "stem"}.get(k["name"], k["name"])
        if name in ("stem", "patch_gram", "gram_proj"):
            k["eval_launches"] = {
                path: c[name] for path, c in eval_counts.items()
                if not (k["name"] == "stem" and path == "bf16")
                and not (k["name"] == "stem_bf16" and path != "bf16") and c[name]}
    # and on the deployment paths of phase 19 (the artifacts and the servers)
    for k in kernels:
        name = {"stem_bf16": "stem"}.get(k["name"], k["name"])
        if name in ("stem", "patch_gram", "gram_proj"):
            k["deploy_launches"] = {
                path: c[name] for path, c in deploy_counts.items()
                if c[name] and (k["name"] != "stem" or "bf16" not in path)
                and (k["name"] != "stem_bf16" or "bf16" in path)}
    # and on the training path of phase 20 (20 steps of each run)
    for k in kernels:
        if k["name"] in ("patch_gram", "gram_proj"):
            k["train_launches"] = {path: c[k["name"]] for path, c in train_counts.items() if c[k["name"]]}
        # and on the explain paths of phase 21 (one Grad-CAM call, one IG call)
        if k["name"] == "patch_gram":
            k["explain_launches"] = {path: c["patch_gram"] for path, c in explain_counts.items()}
    # and on the bf16 camera routes and the embedding paths of phase 22 (K2's
    # float32 and bf16 modes count under one wrapper, K6's likewise: every
    # run there is one mode's)
    for k in kernels:
        name = {"stem_bf16": "stem", "dequant_matvec_bf16": "dequant_matvec"}.get(k["name"], k["name"])
        f32_mode = k["name"] in ("stem", "dequant_matvec")
        k["stream_bf16_launches"] = {path: c[name] for path, c in stream16_counts.items()
                                     if c.get(name) and not f32_mode}
        k["embed_launches"] = {path: c[name] for path, c in embed_counts.items() if c.get(name)
                               and not (k["name"] == "stem" and path.startswith("bf16"))
                               and not (k["name"] == "stem_bf16" and not path.startswith("bf16"))}
    # and on the mesh paths of phase 23 (the mesh engine; each rank of the
    # sharded train step)
    for k in kernels:
        name = {"stem_bf16": "stem"}.get(k["name"], k["name"])
        if name in ("stem", "patch_gram", "gram_proj"):
            k["mesh_launches"] = {path: c[name] for path, c in mesh_counts.items() if c[name]
                                  and not (k["name"] == "stem" and "bf16" in path)
                                  and not (k["name"] == "stem_bf16" and "bf16" not in path)}
    kernels_per_step(routes, args.profile)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
