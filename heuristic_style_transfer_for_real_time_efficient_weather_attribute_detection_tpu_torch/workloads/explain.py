"""Explainability: Grad-CAM and integrated gradients on the port's forward.

Grad-CAM hooks the reference's target activation (the last trunk conv's
raw output for PM and PMG, RTM's stem conv1 by default): one forward to
that activation, the rest of the model from it, and one backward of the
chosen logits to it; channel weights are the spatial mean of the gradient,
``cam = relu(sum_c w_c * F_c)``, min-max normalized per image.  The whole
batch takes one backward.

Integrated gradients (zero baseline) take one forward and backward of the
whole model per step, with the gradient taken with respect to the
interpolated input, summed in step order with Gauss-Legendre (the
default, as captum's) or right-Riemann weights.

On PMG both go through the registered Gram kernel ``patch_gram`` and its
backward: the K1 kernel on the card, its plain version on the CPU.  The overlays are rendered on the host with matplotlib's colormaps and
OpenCV, as in the JAX package, so their bytes are the same.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import IGNORE_INDEX
from ..engine.checkpoint import grad_ready
from ..models import get_family
from ..ops.preprocess import normalize_uint8


def gradcam_split(family: str, spec, rtm_target: str = "stem_conv") -> Tuple[Callable, Callable]:
    """(target_feats(params, x), head_from(params, acts)): the forward split
    at the Grad-CAM target activation, NHWC.

    PM and PMG: the last trunk block's conv output, before its norm and
    LeakyReLU.  RTM: ``"stem_conv"`` (default) is conv1's output, the
    activation the reference's shipped code hooks; ``"backbone_out"`` is the
    truncated backbone's output, an opt-in.
    """
    mod = get_family(family)
    if family in ("pm", "pmg"):
        from ..models.trunk import apply_trunk_from_last_conv, trunk_last_conv

        def target_feats(p, x):
            return trunk_last_conv(p["trunk"], x, spec.plan, spec.norm)

        def head_from(p, f):
            feats = apply_trunk_from_last_conv(p["trunk"], f, spec.plan, spec.norm)
            return mod.head_apply(p, feats, spec)[0]

    elif rtm_target == "stem_conv":
        from ..models import resnet

        def target_feats(p, x):
            return resnet.stem_conv(p["backbone"], x)

        def head_from(p, a):
            feats = resnet.apply_truncated_from_stem(p["backbone"], a, spec.truncate_after_layer)
            return mod.head_apply(p, feats, spec)[0]

    else:

        def target_feats(p, x):
            return mod.apply(p, x, spec, capture=("features",))[1]["features"]

        def head_from(p, f):
            return mod.head_apply(p, f, spec)[0]

    return target_feats, head_from


def _selected_sum(logits: torch.Tensor, task_idx: int, class_idx: torch.Tensor) -> torch.Tensor:
    """Sum over the batch of logit[b, task, class_idx[b]]."""
    return torch.gather(logits[:, task_idx, :], 1, class_idx[:, None]).sum()


class Explainer:
    """Grad-CAM and integrated gradients for one (family, spec, params).

    ``device`` defaults to the CUDA card and raises when there is none; pass
    ``device="cpu"`` for the plain versions.  ``rtm_target``: see
    :func:`gradcam_split`.  ``dtype`` is float32: a bf16 Explainer is not
    ported (ROADMAP.md A35).
    """

    def __init__(self, family: str, spec, params, dtype: torch.dtype = torch.float32,
                 rtm_target: str = "stem_conv", device="cuda"):
        if dtype != torch.float32:
            raise NotImplementedError(
                f"Explainer dtype {dtype} is not ported yet (ROADMAP.md A35); use torch.float32")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Explainer: no CUDA device is available; pass device='cpu' to run "
                "the plain versions on the CPU"
            )
        self.family = family
        self.mod = get_family(family)
        self.spec = spec
        self.dtype = dtype
        self.params = grad_ready(params, self.device)
        self._target_feats, self._head_from = gradcam_split(family, spec, rtm_target)

    # images (uint8 NHWC) and classes may be numpy arrays or tensors on any device

    def _normalized(self, images_u8) -> torch.Tensor:
        return normalize_uint8(torch.as_tensor(images_u8).to(self.device), self.dtype)

    def _classes(self, class_idx) -> torch.Tensor:
        return torch.as_tensor(class_idx).to(self.device, torch.int64)

    # -- public ------------------------------------------------------------

    def resolve_targets(
        self, task: str, labels: Optional[np.ndarray], logits: np.ndarray,
        default_argmax: bool = True,
    ) -> np.ndarray:
        """Target class per image: the label when valid, else the argmax
        (the Grad-CAM rule) or 0 (the integrated-gradients rule)."""
        ti = self.spec.tasks.names.index(task)
        k = self.spec.tasks.num_classes[ti]
        fallback = logits[:, ti, :k].argmax(-1) if default_argmax else np.zeros(
            logits.shape[0], np.int64
        )
        if labels is None:
            return fallback.astype(np.int32)
        lab = labels[:, ti]
        valid = (lab != IGNORE_INDEX) & (lab >= 0)
        return np.where(valid, lab, fallback).astype(np.int32)

    @torch.inference_mode()
    def _logits(self, images_u8) -> torch.Tensor:
        return self.mod.apply(self.params, self._normalized(images_u8), self.spec)[0]

    def logits(self, images_u8: np.ndarray) -> np.ndarray:
        """Plain forward [B, T, Kmax] (no gradient work), for resolving the
        target classes."""
        return self._logits(images_u8).float().cpu().numpy()

    def gradcam_tensors(self, images_u8, task: str, class_idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cam [B, h, w] in [0, 1], logits [B, T, Kmax]) on the device."""
        ti = self.spec.tasks.names.index(task)
        cls = self._classes(class_idx)
        with torch.no_grad():
            feats = self._target_feats(self.params, self._normalized(images_u8))
        feats.requires_grad_(True)
        with torch.enable_grad():
            logits = self._head_from(self.params, feats)
            (grads,) = torch.autograd.grad(_selected_sum(logits, ti, cls), feats)
        with torch.no_grad():
            w = grads.mean(dim=(1, 2), keepdim=True)
            cam = torch.relu((feats * w).sum(dim=-1))
            lo = cam.amin(dim=(1, 2), keepdim=True)
            hi = cam.amax(dim=(1, 2), keepdim=True)
            cam = (cam - lo) / torch.clamp(hi - lo, min=1e-7)
        return cam, logits.detach()

    def gradcam(
        self, images_u8: np.ndarray, task: str, class_idx: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(cam [B, h, w] in [0, 1], logits [B, T, Kmax]) as host numpy."""
        cam, logits = self.gradcam_tensors(images_u8, task, class_idx)
        return cam.cpu().numpy(), logits.cpu().numpy()

    def integrated_gradients_tensor(self, images_u8, task: str, class_idx, steps: int = 50,
                                    method: str = "gausslegendre") -> torch.Tensor:
        """Attributions [B, H, W, 3] on the device (zero baseline)."""
        ti = self.spec.tasks.names.index(task)
        cls = self._classes(class_idx)
        x = self._normalized(images_u8)
        baseline = torch.zeros_like(x)
        if method == "gausslegendre":
            nodes, weights = np.polynomial.legendre.leggauss(steps)
            alphas = torch.as_tensor((nodes + 1.0) / 2.0, dtype=self.dtype)
            wts = torch.as_tensor(weights / 2.0, dtype=self.dtype)
        else:  # right Riemann
            alphas = torch.arange(1, steps + 1, dtype=self.dtype) / steps
            wts = torch.full((steps,), 1.0 / steps, dtype=self.dtype)
        alphas, wts = alphas.to(self.device), wts.to(self.device)
        total = torch.zeros_like(x)
        for alpha, w in zip(alphas, wts):  # in step order, as the reference's scan
            z = (baseline + alpha * (x - baseline)).requires_grad_(True)
            with torch.enable_grad():
                lg = self.mod.apply(self.params, z, self.spec)[0]
                (g,) = torch.autograd.grad(_selected_sum(lg, ti, cls), z)
            total = total + w * g
        return (x - baseline) * total

    def integrated_gradients(
        self,
        images_u8: np.ndarray,
        task: str,
        class_idx: np.ndarray,
        steps: int = 50,
        method: str = "gausslegendre",
    ) -> np.ndarray:
        """Attributions [B, H, W, 3] as host numpy."""
        return self.integrated_gradients_tensor(images_u8, task, class_idx, steps,
                                                method).cpu().numpy()


# ---------------------------------------------------------------------------
# Overlay rendering (host side)
# ---------------------------------------------------------------------------


def apply_colormap(gray: np.ndarray, cmap_name: str = "hot") -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = plt.get_cmap(cmap_name)
    return cm(np.clip(gray, 0, 1))[:, :, :3]


def overlay_cam(
    image_u8: np.ndarray, cam: np.ndarray, cmap: str = "hot", alpha: float = 0.45
) -> np.ndarray:
    """cam [h, w] (feature resolution) -> [H, W, 3] uint8 overlay on the image."""
    import cv2

    H, W = image_u8.shape[:2]
    cam_big = cv2.resize(cam.astype(np.float32), (W, H), interpolation=cv2.INTER_LINEAR)
    heat = apply_colormap(cam_big, cmap)
    img01 = image_u8.astype(np.float32) / 255.0
    over = np.clip((1 - alpha) * img01 + alpha * heat, 0, 1)
    return (over * 255).astype(np.uint8)


def save_gradcam_batch(
    explainer: Explainer,
    images_u8: np.ndarray,
    labels: Optional[np.ndarray],
    task: str,
    out_dir: str,
    batch_idx: int = 0,
    cmap: str = "hot",
) -> None:
    """hstack(original | overlay) per image, under the reference's names
    ``gradcam_b{batch}_i{image}_task-{task}_class-{k}-{name}.png``."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    ti = explainer.spec.tasks.names.index(task)
    names = explainer.spec.tasks.class_names[ti]
    logits = explainer.logits(images_u8)  # plain forward for the targets
    targets = explainer.resolve_targets(task, labels, logits)
    cam, _ = explainer.gradcam(images_u8, task, targets)
    for i in range(images_u8.shape[0]):
        cls = int(targets[i])
        cls_name = names[cls] if 0 <= cls < len(names) else str(cls)
        over = overlay_cam(images_u8[i], cam[i], cmap)
        cat = np.hstack([images_u8[i], over])
        out = os.path.join(
            out_dir,
            f"gradcam_b{batch_idx:04d}_i{i:03d}_task-{task}_class-{cls}-{cls_name}.png",
        )
        cv2.imwrite(out, cv2.cvtColor(cat, cv2.COLOR_RGB2BGR))


def ig_heatmap(attr: np.ndarray) -> np.ndarray:
    """IG attribution [H, W, 3] -> normalized magnitude heatmap [H, W] in [0, 1]."""
    mag = np.abs(attr).sum(-1)
    hi = mag.max()
    return mag / hi if hi > 0 else mag
