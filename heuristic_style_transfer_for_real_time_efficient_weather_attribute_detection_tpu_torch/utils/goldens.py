"""Golden-fixture parity walk of the compressed PMG head variants.

The camera path's head runs on a ``models.pmg.fold_head_weights`` tree
(bf16 or weight-only int8 ``token_proj``), through the plain head
(``pmg.head_from_gram_tokens``) or the fused head kernel
(``ops.cuda_kernels.fused_head``).  Each variant is held to the frozen
reference logits of every PMG golden fixture by the same walk, on the CPU
or on the card.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Sequence, Tuple, Union

# Max tolerated logit drift for a compressed PMG head variant: well above
# the bf16/q8 fold's own drift and well below any logit gap that could move
# a calibrated probability meaningfully.  Enforced next to the argmax check.
HEAD_FOLD_MAX_DRIFT = 0.05

VARIANTS = ("bf16", "q8", "fused_bf16", "fused_q8")
_TIE_MARGIN = 1e-3


def pmg_head_fold_fixture_parity(
    fixtures_dir: str, variants: Union[str, Sequence[str]], device="cuda"
) -> Union[List[Tuple[str, bool, float]], Dict[str, List[Tuple[str, bool, float]]]]:
    """Run the PMG head with ``fold_head_weights`` weights on every
    ``pmg_*`` golden fixture and compare with the frozen reference logits.

    ``variants`` is one name or a sequence of ``VARIANTS``: "bf16" / "q8"
    run ``pmg.head_from_gram_tokens`` on the fold; "fused_bf16" /
    "fused_q8" run the fused head (the kernel for a CUDA ``device``, its
    plain version on the CPU).  The fixture checkpoints load and the
    trunk -> Gram tokens run once per fixture, in float32, so drift beyond
    float32 noise isolates the head compression and the kernel.  ``device``
    defaults to the card; pass ``device="cpu"`` to run without one.

    The argmax check skips samples whose reference top-2 logit margin is
    below 1e-3: such decisions sit inside float32 reassociation noise.
    Magnitude errors on every sample are covered by the drift, which callers
    bound with :data:`HEAD_FOLD_MAX_DRIFT`.  Returns [(fixture_name,
    argmax_matches_on_decisive_samples, max_logit_drift)] for a single
    variant name, or {variant: rows} for a sequence.
    """
    import numpy as np
    import torch

    from ..engine import checkpoint
    from ..models import pmg
    from ..models.trunk import apply_trunk
    from ..ops import cuda_kernels
    from ..ops.gram import patch_gram_tokens
    from ..ops.nn import conv2d, se_block

    single = isinstance(variants, str)
    todo = [variants] if single else list(variants)
    for v in todo:
        if v not in VARIANTS:
            raise ValueError(f"unknown head fold variant {v!r}; expected one of {VARIANTS}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pmg_head_fold_fixture_parity: no CUDA device is available; pass device='cpu'"
        )
    out: Dict[str, List[Tuple[str, bool, float]]] = {v: [] for v in todo}
    for jf in sorted(glob.glob(os.path.join(fixtures_dir, "pmg_*.json"))):
        name = os.path.splitext(os.path.basename(jf))[0]
        with open(jf) as f:
            meta = json.load(f)
        spec = pmg.build_spec(meta["tasks"], meta["hparams"])
        params = checkpoint.to_device(
            checkpoint.load_torch_checkpoint("pmg", os.path.join(fixtures_dir, f"{name}.pth"), spec),
            device,
        )
        data = np.load(os.path.join(fixtures_dir, f"{name}.npz"))
        x = torch.from_numpy(np.ascontiguousarray(np.transpose(data["input"], (0, 2, 3, 1))))
        folds: Dict[str, dict] = {}
        with torch.inference_mode():
            feats = apply_trunk(params["trunk"], x.to(device), spec.plan, spec.norm)
            h = se_block(feats, params["se"]) if spec.use_channel_attention else feats
            tokens = patch_gram_tokens(conv2d(h, params["chan_proj"]).contiguous(), spec.patch_div)
            for variant in todo:
                fused = variant.startswith("fused_")
                fv = variant[len("fused_"):] if fused else variant
                if fv not in folds:
                    folds[fv] = pmg.fold_head_weights(params, spec, fv)
                if fused:
                    lg = cuda_kernels.fused_head(tokens, folds[fv], spec)
                else:
                    lg = pmg.head_from_gram_tokens(folds[fv], tokens, spec)
                lg = lg.float().cpu().numpy()
                agree, drift = True, 0.0
                for i, task in enumerate(spec.tasks.names):
                    want = data[f"logits/{task}"]
                    got = lg[:, i, : want.shape[1]]
                    top2 = np.sort(want, axis=-1)
                    decisive = (top2[:, -1] - top2[:, -2]) >= _TIE_MARGIN
                    agree &= bool((got.argmax(-1) == want.argmax(-1))[decisive].all())
                    drift = max(drift, float(np.abs(got - want).max()))
                out[variant].append((name, agree, drift))
    return out[todo[0]] if single else out
