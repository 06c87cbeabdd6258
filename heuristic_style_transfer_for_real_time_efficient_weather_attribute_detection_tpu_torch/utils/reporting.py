"""Parameter-count reporters (``--count_params``): one walker over the
port's param tree (nested dicts and lists of tensors) and the per-family
breakdowns of the JAX package's ``utils/reporting.py``."""

from __future__ import annotations

from typing import Any, Dict, Mapping


def count(tree) -> int:
    """Number of values in every tensor of a param tree."""
    if isinstance(tree, Mapping):
        return sum(count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count(v) for v in tree)
    return int(tree.numel())


def print_model_parameters(family: str, params: Dict[str, Any], spec) -> Dict:
    fam = family.lower()
    t = spec.tasks
    report: Dict[str, Any] = {"total": count(params)}
    print("==== Model parameters ====")
    print(f"Total params: {report['total']:,}")

    if fam == "pmg":
        for block in ("trunk", "se", "chan_proj", "token_proj", "transformer"):
            n = count(params[block]) if block in params else 0
            report[block] = n
            print(f"{block:>18}: {n:,}" if n else f"{block:>18}: Identity (0)")
        q = count(params["queries"])
        report["queries"] = q
        print(f"{'Queries (tasks)':>18}: {q:,}")
        report["per_task"] = {}
        for i, task in enumerate(t.names):
            d = spec.d_model
            k = t.num_classes[i]
            n = d * k + k  # true (unpadded) classifier size
            report["per_task"][task] = {"query": d, "classifier": n}
            print(f"Task '{task}': attention(query)={d:,} | classifier={n:,}")
        print(f"use_channel_attention: {spec.use_channel_attention}")
        print(f"use_token_attention:   {spec.use_token_attention}")
        print(f"gram_channels:         {spec.gram_channels}")
        print(f"patch_div:             {spec.patch_div}")
    elif fam == "pm":
        trunk = count(params["trunk"])
        report["trunk"] = trunk
        print(f"Trunk params: {trunk:,}")
        c = spec.trunk_channels
        hid = max(c // 16, 1)
        report["per_task"] = {}
        for i, task in enumerate(t.names):
            k = t.num_classes[i]
            se = (c * hid + hid) + (hid * c + c) if spec.attn_use_se else 0
            head = se + (c + 1) + c * k  # attn_conv (w+b) + cls_conv
            report["per_task"][task] = head
            print(f"  - Task '{task}': {head:,} params (in_channels={c}, out_channels={k})")
    elif fam == "rtm":
        enc = count(params["backbone"])
        report["encoder"] = enc
        print(f"Truncated encoder params: {enc:,}")
        if "attn" in params:
            attn = count(params["attn"])
            report["attention"] = attn
            c, d = spec.num_features, spec.token_dim
            print(f"Attention modules (stacked over {len(t)} tasks): {attn:,} "
                  f"(theory per task ~ {c*d + d + d*c:,})")
        cls = count(params["mlp"]) + count(params["final"])
        report["classifiers"] = cls
        print(f"Classifier modules: {cls:,}")
    print("=================================")
    return report
