"""Error-guided pixel sampling for the global optimization.

Counterpart of bnv_fusion_tpu/sampler.py:21-68 (``model.error_guided_sampling``):
each frame keeps a coarse error map of patches; a ray batch mixes uniform
pixels with pixels drawn from a multinomial over the patches, weighted by
their error, and the rendered per-ray errors are folded back into the map.
Draws come from an explicit ``torch.Generator`` on the device where they
are made, so a map on the card is sampled without a host round trip.
"""

from __future__ import annotations

from typing import Tuple

import torch


def create_error_maps(n_frames: int, img_res: Tuple[int, int],
                      patch: int = 16,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Uniform error maps [n_frames, H // patch, W // patch] of ones."""
    h, w = img_res
    return torch.ones((n_frames, h // patch, w // patch), dtype=torch.float32,
                      device=device)


def sample_pixels(generator: torch.Generator, error_map: torch.Tensor,
                  img_res: Tuple[int, int], n_samples: int,
                  uniform_fraction: float = 0.5) -> torch.Tensor:
    """[n_samples] flat pixel ids on ``error_map``'s device: the first
    ``int(n_samples * uniform_fraction)`` uniform over the image, the rest
    from a multinomial over patches with probabilities proportional to
    max(error, 1e-8) (what a categorical over log(max(error, 1e-8)) draws),
    uniform within the patch.  Drawn on ``generator``'s device."""
    h, w = img_res
    gh, gw = error_map.shape
    patch_h, patch_w = h // gh, w // gw
    n_uniform = int(n_samples * uniform_fraction)
    n_weighted = n_samples - n_uniform
    dev = generator.device

    uniform = torch.randint(0, h * w, (n_uniform,), generator=generator,
                            device=dev)
    probs = torch.clamp(error_map.reshape(-1).to(dev), min=1e-8)
    patches = torch.multinomial(probs, n_weighted, replacement=True,
                                generator=generator)
    off_y = torch.randint(0, patch_h, (n_weighted,), generator=generator,
                          device=dev)
    off_x = torch.randint(0, patch_w, (n_weighted,), generator=generator,
                          device=dev)
    vy = torch.div(patches, gw, rounding_mode="floor") * patch_h + off_y
    vx = patches % gw * patch_w + off_x
    ids = torch.cat([uniform, vy * w + vx]).to(torch.int32)
    return ids.to(error_map.device)


def update_error_map(error_map: torch.Tensor, img_res: Tuple[int, int],
                     pixel_ids: torch.Tensor, errors: torch.Tensor,
                     momentum: float = 0.7) -> torch.Tensor:
    """The map after folding in per-pixel errors: each touched patch moves
    to momentum * old + (1 - momentum) * the mean error of its pixels;
    untouched patches keep their value.  Returns a new tensor."""
    h, w = img_res
    gh, gw = error_map.shape
    patch_h, patch_w = h // gh, w // gw
    ids = pixel_ids.to(error_map.device).long()
    py = torch.div(torch.div(ids, w, rounding_mode="floor"), patch_h,
                   rounding_mode="floor")
    px = torch.div(ids % w, patch_w, rounding_mode="floor")
    pid = torch.clamp(py, 0, gh - 1) * gw + torch.clamp(px, 0, gw - 1)
    sums = torch.zeros((gh * gw,), dtype=torch.float32,
                       device=error_map.device).index_add_(
        0, pid, errors.to(torch.float32))
    cnts = torch.zeros_like(sums).index_add_(0, pid, torch.ones_like(sums[pid]))
    mean = (sums / torch.clamp(cnts, min=1.0)).reshape(gh, gw)
    touched = (cnts > 0).reshape(gh, gw)
    new = momentum * error_map + (1 - momentum) * mean
    return torch.where(touched, new, error_map)
