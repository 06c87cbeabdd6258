"""Embedding extraction, t-SNE and HDBSCAN clustering of the port.

The models' ``capture`` taps give the embeddings, one kind per call:

- ``kind="logits"``: per-task logits (PMG's tap);
- ``kind="task"``: RTM's per-task attention embeddings, PM's
  attention-weighted trunk embeddings;
- ``kind="shared"``: the GAP trunk embedding (RTM and PM);
- ``kind="pooled"``: PMG's per-task pooled tokens.

``perform_tsne`` lays them out with the port's t-SNE (``utils/tsne.py``:
scikit-learn's default Barnes-Hut objective, as the JAX package calls it,
with the repulsion summed exactly) on the embeddings' device and draws the
JAX package's scatter (seed 42, its colours, ``tsne_<task>.png``);
matplotlib is imported when it draws.  ``export_interactive_html`` writes the JAX package's
self-contained HTML viewer, byte for byte.  ``hdbscan_clustering`` runs the
port's HDBSCAN (``utils/hdbscan.py``: core distances and MST on the
embeddings' device, the tree's steps on the host) over the JAX package's
grid, and ``clustering_mode`` writes ``<class>_clustering_results.json``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.executor import Engine
from ..utils import hdbscan as hdb
from ..utils.tsne import tsne

_CAPTURE_FOR_KIND = {
    "logits": (),
    "task": ("task_embeddings",),
    "shared": ("shared_embedding",),
    "pooled": ("pooled",),
}

# Which embedding taps each family's apply() exposes.
_FAMILY_KINDS = {
    "pmg": {"logits", "pooled"},
    "pm": {"logits", "task", "shared"},
    "rtm": {"logits", "task", "shared"},
}


def compute_embeddings(engine: Engine, loader, kind: str = "logits", per_task: bool = True):
    """-> (embeddings, labels, paths): per-task dicts when ``per_task``, else
    single arrays of the first task.

    If the engine lacks the capture tap this kind needs, an engine with it
    is built on the same params, batch size, threshold, dtype, mesh and
    device.
    """
    tasks = engine.tasks
    supported = _FAMILY_KINDS.get(engine.family, {"logits"})
    if kind not in supported:
        raise ValueError(
            f"embedding kind {kind!r} is not exposed by the {engine.family!r} "
            f"family (supported: {sorted(supported)})"
        )
    capture = _CAPTURE_FOR_KIND[kind]
    if any(c not in engine.capture for c in capture):
        engine = Engine(
            engine.family, engine.spec, engine.params,
            batch_size=engine.batch_size, prob_threshold=engine.prob_threshold,
            dtype=engine.dtype, capture=tuple(set(engine.capture) | set(capture)),
            mesh=engine.mesh, packed="auto" if engine.pack_k else "off", device=engine.device,
        )
    embs: Dict[str, List[np.ndarray]] = {t: [] for t in tasks.names}
    labs: Dict[str, List[int]] = {t: [] for t in tasks.names}
    paths: List[str] = []

    for images, labels, batch_paths in loader:
        res = engine.run(images, labels, collect=("logits",) + capture)
        paths.extend(batch_paths)
        for ti, t in enumerate(tasks.names):
            k = tasks.num_classes[ti]
            if kind == "logits":
                e = res["logits"][:, ti, :k]
            elif kind == "task":
                e = res["task_embeddings"][:, ti]
            elif kind == "pooled":
                e = res["pooled"][:, ti]
            else:
                e = res["shared_embedding"]
            embs[t].append(e)
            if labels is not None:
                labs[t].extend(labels[:, ti].tolist())

    out_e = {t: (np.concatenate(v) if v else np.empty((0, 0))) for t, v in embs.items()}
    out_l = {t: np.asarray(v) for t, v in labs.items()}
    if per_task:
        return out_e, out_l, {t: list(paths) for t in tasks.names}
    first = tasks.names[0]
    return out_e[first], out_l[first], list(paths)


def perform_tsne(
    embeddings: np.ndarray,
    labels: np.ndarray,
    class_list: Sequence[str],
    colors: Optional[Sequence[str]],
    results_dir: str,
    task_name: str,
    seed: int = 42,
    device="cuda",
) -> Tuple[np.ndarray, str]:
    """The port's t-SNE on ``device`` (perplexity ``min(30, max(1, (n-1)/3))``)
    -> the JAX package's scatter PNG; returns (layout [n, 2], path).

    The t-SNE minimizes what the JAX package's ``TSNE()`` call minimizes,
    scikit-learn's Barnes-Hut objective on the sparse nearest-neighbour P,
    with the repulsion summed exactly over all pairs (on the card by the
    ``tsne_repulsion`` kernel), in O(N k) memory: N = 65,536 points fit
    the card easily.

    ``seed`` is kept from the JAX signature: the PCA init leaves nothing to
    draw, so the layout does not depend on it.  ``device`` defaults to the
    CUDA card and raises when there is none; ``"cpu"`` runs it on the CPU
    (in the embeddings' floating type).
    """
    del seed
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("perform_tsne: no CUDA device is available; pass device='cpu'")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = embeddings.shape[0]
    perplexity = min(30.0, max(1.0, (n - 1) / 3.0))
    x2d, _ = tsne(torch.as_tensor(np.asarray(embeddings)).to(dev), perplexity)
    x2d = x2d.cpu().numpy()
    plt.figure(figsize=(10, 10))
    uniq = np.unique(labels) if labels.size else np.array([])
    ncls = max(len(uniq), 1)
    if colors and len(colors) >= ncls:
        cmap = {lbl: colors[i] for i, lbl in enumerate(uniq)}
    else:
        base = plt.get_cmap("tab20", ncls)
        cmap = {lbl: base(i / ncls) for i, lbl in enumerate(uniq)}
    for lbl in uniq:
        m = labels == lbl
        name = class_list[lbl] if 0 <= lbl < len(class_list) else "Unknown"
        plt.scatter(x2d[m, 0], x2d[m, 1], label=name, color=cmap[lbl])
    if uniq.size:
        plt.legend()
    os.makedirs(results_dir, exist_ok=True)
    out = os.path.join(results_dir, f"tsne_{task_name.replace(' ', '_')}.png")
    plt.savefig(out)
    plt.close()
    print(f"t-SNE figure saved to {out}")
    return x2d, out


def _encode_thumbnails(all_paths: List[str], limit: int, size: int) -> Dict[str, str]:
    """{path: base64 JPEG thumbnail} for up to ``limit`` unique paths."""
    import base64
    import io

    from PIL import Image

    uniq: List[str] = []
    seen = set()
    for p in all_paths:
        if p and p not in seen:
            seen.add(p)
            uniq.append(p)
    if len(uniq) > limit:
        print(f"[tsne] embedding thumbnails for {limit} of {len(uniq)} images "
              f"(--thumb_limit to raise); the rest show path-only on click")
    thumbs: Dict[str, str] = {}
    for p in uniq[:limit]:
        try:
            with Image.open(p) as im:
                im = im.convert("RGB")
                im.thumbnail((size, size))
                buf = io.BytesIO()
                im.save(buf, "JPEG", quality=70)
            thumbs[p] = base64.b64encode(buf.getvalue()).decode("ascii")
        except Exception:
            continue  # an unreadable image: a click shows its path only
    return thumbs


def export_interactive_html(
    per_task_x2d: Dict[str, np.ndarray],
    per_task_labels: Dict[str, np.ndarray],
    tasks_dict: Dict[str, List[str]],
    paths: Dict[str, List[str]],
    out_path: str,
    thumbnails: bool = True,
    thumb_limit: int = 2000,
    thumb_size: int = 128,
) -> str:
    """One self-contained HTML viewer of the layouts (the JAX package's,
    byte for byte): a task dropdown, the scatter, the hovered point's path,
    wheel zoom about the cursor, a per-class colour picker, click-to-view
    from embedded base64 thumbnails (at most ``thumb_limit`` unique images,
    the rest path only), and a polygon selector (``p``; a double-click
    downloads ``inside_polygon_<task>.json``).  Needs no display."""
    from ._embed_html import VIEWER_JS

    payload = {
        t: {
            "xy": np.asarray(x2d, np.float32).round(3).tolist(),
            "labels": per_task_labels[t].tolist(),
            "classes": tasks_dict[t],
            "paths": paths.get(t, []),
        }
        for t, x2d in per_task_x2d.items()
    }
    thumbs: Dict[str, str] = {}
    if thumbnails:
        thumbs = _encode_thumbnails(
            [p for t in payload.values() for p in t["paths"]], thumb_limit, thumb_size,
        )
    html = (
        "<!DOCTYPE html><html><head><meta charset='utf-8'><title>t-SNE</title>"
        "<style>body{font-family:sans-serif;display:flex;gap:12px}"
        "#c{border:1px solid #888}#side{width:300px}"
        "#pv{max-width:280px;display:none;border:1px solid #aaa}"
        "#legend div{margin:2px 0}#pvcap{font-size:12px;word-break:break-all}"
        "</style></head><body><div>"
        "<select id='task'></select> <span id='info'></span><br>"
        "<canvas id='c' width='900' height='900'></canvas></div>"
        "<div id='side'><div id='legend'></div><hr>"
        "<img id='pv'><div id='pvcap'></div></div>"
        "<script>const DATA=" + json.dumps(payload) + ";\n"
        "const THUMBS=" + json.dumps(thumbs) + ";\n"
        + VIEWER_JS
        + "</script></body></html>"
    )
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    print(f"interactive t-SNE exported to {out_path}")
    return out_path


def hdbscan_clustering(
    embeddings: np.ndarray,
    paths: List[str],
    min_cluster_sizes: Sequence[int] = (10, 15, 20),
    min_samples_list: Sequence[int] = (5, 10),
    device="cuda",
) -> Dict:
    """HDBSCAN over the (min_cluster_size, min_samples) grid, keeping the
    first parameterization with the most clusters; both knobs clamped to the
    point count.  A class of 0 or 1 points is noise, with no parameters.

    The core distances and the MST run on ``device`` (default the CUDA
    card, which raises when there is none; ``"cpu"`` for the CPU), once per
    distinct clamped ``min_samples``; each tree is condensed for every
    ``min_cluster_size`` on the host."""
    n_pts = embeddings.shape[0]
    if n_pts < 2:
        return {
            "best_params": {"min_cluster_size": None, "min_samples": None},
            "n_clusters": 0,
            "clusters": {"-1": list(paths)} if n_pts else {},
        }
    x = hdb.points(embeddings, device)
    trees: Dict[int, np.ndarray] = {}
    best: Dict = {"n_clusters": -1}
    for mcs in min_cluster_sizes:
        for ms in min_samples_list:
            mcs_eff = min(mcs, max(2, n_pts))
            ms_eff = min(ms, max(1, n_pts))
            if ms_eff not in trees:
                trees[ms_eff] = hdb.linkage_tree(x, ms_eff)
            labels = hdb.tree_labels(trees[ms_eff], mcs_eff)
            n = len(set(labels.tolist()) - {-1})
            if n > best["n_clusters"]:
                best = {"n_clusters": n, "min_cluster_size": mcs, "min_samples": ms,
                        "labels": labels}
    clusters: Dict[str, List[str]] = {}
    for lbl, path in zip(best.get("labels", []), paths):
        clusters.setdefault(str(int(lbl)), []).append(path)
    return {
        "best_params": {
            "min_cluster_size": best.get("min_cluster_size"),
            "min_samples": best.get("min_samples"),
        },
        "n_clusters": best["n_clusters"],
        "clusters": clusters,
    }


def clustering_mode(
    engine: Engine,
    loader,
    task: str,
    class_name: str,
    save_dir: str,
    min_cluster_sizes: Sequence[int] = (10, 15, 20),
    min_samples_list: Sequence[int] = (5, 10),
    kind: str = "logits",
) -> Dict:
    """One class of one task -> ``<class>_clustering_results.json`` with the
    image paths of each cluster; HDBSCAN runs on the engine's device."""
    embs, labs, paths = compute_embeddings(engine, loader, kind=kind, per_task=True)
    ti = engine.tasks.names.index(task)
    cls_idx = list(engine.tasks.class_names[ti]).index(class_name)
    mask = labs[task] == cls_idx
    result = hdbscan_clustering(
        embs[task][mask],
        [p for p, m in zip(paths[task], mask) if m],
        min_cluster_sizes,
        min_samples_list,
        device=engine.device,
    )
    os.makedirs(save_dir, exist_ok=True)
    out = os.path.join(save_dir, f"{class_name.replace(' ', '_')}_clustering_results.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"clustering results saved to {out}")
    return result
