"""Port parity: the error-guided sampler (bnv_fusion_tpu_torch.sampler) against
bnv_fusion_tpu.sampler.

Tolerances:
* ``update_error_map``: within 1e-6 of JAX's on the same pixel ids and
  errors (float32 sums of a few errors per patch, in another order);
* ``sample_pixels`` draws from a torch.Generator, whose stream is not JAX's,
  so it is held to the JAX function's properties (tests/test_sampler.py):
  ids in range, the first int(n * uniform_fraction) ids uniform over the
  image, every weighted id inside a patch the map weights, a high-error
  patch over-sampled as JAX over-samples it (shares within 0.05 of each
  other at 4000 draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import sampler as jsampler
from bnv_fusion_tpu_torch import sampler as tsampler


def test_create_error_maps_matches_jax():
    j = np.asarray(jsampler.create_error_maps(3, (60, 80), patch=16))
    t = tsampler.create_error_maps(3, (60, 80), patch=16)
    assert t.shape == j.shape == (3, 3, 5)
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("momentum", [0.7, 0.5])
def test_update_error_map_matches_jax(momentum):
    rng = np.random.RandomState(3)
    h, w = 64, 96
    em = (rng.rand(4, 6) * 2).astype(np.float32)
    # repeated pixels and patches left untouched
    ids = rng.randint(0, h * w // 2, 300).astype(np.int32)
    errs = (rng.rand(300) * 5).astype(np.float32)
    j = np.asarray(jsampler.update_error_map(
        jnp.asarray(em), (h, w), jnp.asarray(ids), jnp.asarray(errs),
        momentum=momentum))
    t = tsampler.update_error_map(torch.as_tensor(em), (h, w),
                                  torch.as_tensor(ids), torch.as_tensor(errs),
                                  momentum=momentum).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    assert (t != em).any() and (t == em).any()


def test_update_error_map_moves_toward_observations():
    em = tsampler.create_error_maps(1, (32, 32), patch=16)[0]
    ids = torch.arange(0, 256, dtype=torch.int32)   # first rows -> patch 0,0
    new = tsampler.update_error_map(em, (32, 32), ids, torch.full((256,), 5.0),
                                    momentum=0.5).numpy()
    assert abs(new[0, 0] - 3.0) < 1e-6
    assert new[1, 1] == 1.0


def test_sample_pixels_range_and_uniform_share():
    g = torch.Generator().manual_seed(0)
    em = tsampler.create_error_maps(1, (64, 128), patch=16)[0]
    em[:] = 1e-12
    em[1, 2] = 10.0                     # rows 16..31, cols 32..47
    n, frac = 4000, 0.5
    ids = tsampler.sample_pixels(g, em, (64, 128), n, uniform_fraction=frac)
    assert ids.shape == (n,) and ids.dtype == torch.int32
    ids = ids.numpy()
    assert ids.min() >= 0 and ids.max() < 64 * 128
    vy, vx = ids // 128, ids % 128
    in_patch = (vy >= 16) & (vy < 32) & (vx >= 32) & (vx < 48)
    n_uni = int(n * frac)
    # the uniform share lands in the patch about as often as its area
    assert abs(in_patch[:n_uni].mean() - 1 / 32) < 0.02
    assert in_patch[n_uni:].all()


def test_weighted_draws_stay_in_weighted_patches():
    g = torch.Generator().manual_seed(1)
    em = torch.zeros((4, 5))
    em[0, 4] = 2.0
    em[3, 1] = 1.0
    ids = tsampler.sample_pixels(g, em, (60, 80), 3000,
                                 uniform_fraction=0.0).numpy()
    py, px = ids // 80 // 15, ids % 80 // 16
    hot = ((py == 0) & (px == 4)) | ((py == 3) & (px == 1))
    assert hot.all()
    # probabilities proportional to the error: 2:1
    share = ((py == 0) & (px == 4)).mean()
    assert abs(share - 2 / 3) < 0.04
    # every pixel of a weighted patch can be drawn (offsets uniform inside)
    sel = ids[(py == 0) & (px == 4)]
    assert len(np.unique(sel // 80)) == 15 and len(np.unique(sel % 80)) == 16


def test_high_error_patch_oversampled_as_in_jax():
    em = np.full((4, 4), 1e-6, np.float32)
    em[1, 2] = 10.0                     # rows 16..31, cols 32..47
    ids_j = np.asarray(jsampler.sample_pixels(
        jax.random.key(1), jnp.asarray(em), (64, 64), 4000,
        uniform_fraction=0.25))
    ids_t = tsampler.sample_pixels(torch.Generator().manual_seed(1),
                                   torch.as_tensor(em), (64, 64), 4000,
                                   uniform_fraction=0.25).numpy()

    def share(ids):
        vy, vx = ids // 64, ids % 64
        return ((vy >= 16) & (vy < 32) & (vx >= 32) & (vx < 48)).mean()

    assert share(ids_t) > 0.5
    assert abs(share(ids_t) - share(ids_j)) < 0.05
