"""Patch-Gram style transfer: the reference's one gradient-optimization loop.

Semantics kept from the JAX package:
- the style signature is the per-patch Grams of the PMG trunk's features
  under the style path's unpadded split (``ops.gram.style_patch_grams``,
  not the model's padded split);
- the generated image is raw [0, 1] pixels fed to the trunk without the
  ImageNet normalization;
- the loss of an image is the mean of ``(grams - style_grams)^2``;
- Adam on the pixels (optax's formula: b1 0.9, b2 0.999, eps 1e-8 outside
  the square root, bias-corrected), per-image early stop at
  ``target_loss``, and a final clamp to [0, 1].

A batch of style images runs in one loop.  An image is live while its
carried loss (+inf at the start) is >= ``target_loss``: every image's Adam
moments advance each iteration, only live images' pixels move, and the
carried loss and iteration count change only where live, so each image
follows the trajectory it would alone.  The early-stop test stays on the
device; the host reads the losses every ``log_every`` iterations.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from PIL import Image

from ..engine.checkpoint import grad_ready
from ..models import pmg
from ..ops.gram import style_patch_grams

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count``, computed in float32."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def extract_style_grams(params, spec: pmg.Spec, img_norm: torch.Tensor) -> torch.Tensor:
    """Style images (transform-normalized NHWC) -> target Grams [B, Np, C, C]
    of the trunk features."""
    return style_patch_grams(pmg.trunk_features(params, img_norm, spec), spec.patch_div)


def noise_init(shape, seed: int, index: int) -> torch.Tensor:
    """Uniform [0, 1) float32 pixels of one image, drawn on the CPU from a
    generator seeded by (seed, index): the same image gets the same noise
    whatever its position, chunk or device."""
    key = int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])
    return torch.rand(tuple(shape), generator=torch.Generator().manual_seed(key))


def run_patch_gram_style_transfer_batch(
    params,
    spec: pmg.Spec,
    style_imgs_norm: np.ndarray,
    num_iterations: int = 300,
    lr: float = 0.05,
    init_type: str = "noise",
    target_loss: float = 1e-3,
    seed: int = 0,
    log_every: int = 50,
    seed_offset: int = 0,
    device="cuda",
) -> Tuple[List[Image.Image], np.ndarray, np.ndarray]:
    """Optimize one generated image per style image, all in one loop.

    Each iteration computes every image's loss at its current pixels and
    applies the Adam step to the live ones; an image stops the first time
    its own loss drops below ``target_loss`` (that step is applied, as the
    reference breaks after ``optimizer.step()``).  ``seed_offset + i`` keys
    image i's noise init.  ``device`` defaults to the CUDA card and raises
    when there is none.

    Returns (list of PIL images, final per-image losses [B], iterations [B]).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("style transfer: no CUDA device is available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    params = grad_ready(params, dev)
    style = torch.as_tensor(np.asarray(style_imgs_norm, np.float32)).to(dev)
    batch = style.shape[0]
    with torch.no_grad():
        style_grams = extract_style_grams(params, spec, style)
    if init_type == "noise":
        gen = torch.stack([noise_init(style.shape[1:], seed, seed_offset + i)
                           for i in range(batch)]).to(dev)
    else:
        gen = torch.full(style.shape, 0.5, dtype=torch.float32, device=dev)
    mu, nu = torch.zeros_like(gen), torch.zeros_like(gen)
    loss = torch.full((batch,), float("inf"), dtype=torch.float32, device=dev)
    iters = torch.zeros((batch,), dtype=torch.int32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)  # iterations with any image live

    step = 0
    step_size = log_every if log_every and log_every > 0 else num_iterations
    while step < num_iterations:
        for _ in range(min(step_size, num_iterations - step)):
            step += 1
            live = loss >= target_loss
            g = gen.detach().requires_grad_(True)
            with torch.enable_grad():
                grams = style_patch_grams(pmg.trunk_features(params, g, spec), spec.patch_div)
                li = ((grams - style_grams) ** 2).mean(dim=(1, 2, 3))
                (grad,) = torch.autograd.grad(li.sum(), g)
            with torch.no_grad():
                mu = (1 - _B1) * grad + _B1 * mu
                nu = (1 - _B2) * (grad * grad) + _B2 * nu
                upd = (mu / _bias_correction(_B1, step)) / (
                    torch.sqrt(nu / _bias_correction(_B2, step)) + _EPS)
                gen = gen + (-lr * upd) * live[:, None, None, None].to(gen.dtype)
                iters = iters + live.to(torch.int32)
                it = it + live.any().to(torch.int32)
                loss = torch.where(live, li.detach(), loss)
        losses = loss.cpu().numpy()  # the host reads the carry once a chunk
        if log_every:
            print(f"[{int(it)}/{num_iterations}] style loss = "
                  f"{float(np.max(losses)):.6f} (worst of {batch})")
        if bool(np.all(losses < target_loss)):
            print(f"Target style loss reached: {float(np.max(losses)):.6f} < {target_loss}")
            break

    out = torch.clamp(gen, 0.0, 1.0).cpu().numpy()
    images = [Image.fromarray((out[i] * 255).astype(np.uint8)) for i in range(batch)]
    return images, loss.cpu().numpy(), iters.cpu().numpy()


def run_patch_gram_style_transfer(
    params,
    spec: pmg.Spec,
    style_img_norm: np.ndarray,
    num_iterations: int = 300,
    lr: float = 0.05,
    init_type: str = "noise",
    target_loss: float = 1e-3,
    seed: int = 0,
    log_every: int = 50,
    seed_offset: int = 0,
    device="cuda",
) -> Tuple[Image.Image, float, int]:
    """One style image -> (PIL image, final loss, iterations run).
    ``seed_offset`` reproduces an image's noise init from a batched run
    (its global index there)."""
    images, losses, iters = run_patch_gram_style_transfer_batch(
        params, spec, np.asarray(style_img_norm)[:1],
        num_iterations=num_iterations, lr=lr, init_type=init_type,
        target_loss=target_loss, seed=seed, log_every=log_every,
        seed_offset=seed_offset, device=device,
    )
    return images[0], float(losses[0]), int(iters[0])


def style_transfer_composite(
    original: Image.Image, generated: Image.Image, size: int = 256
) -> Image.Image:
    """Side-by-side original | generated at ``size`` px."""
    left = original.resize((size, size), Image.LANCZOS)
    right = generated.resize((size, size), Image.LANCZOS)
    combined = Image.new("RGB", (size * 2, size))
    combined.paste(left, (0, 0))
    combined.paste(right, (size, 0))
    return combined
