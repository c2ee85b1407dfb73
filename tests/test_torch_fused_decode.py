"""Port parity: the plain fused corner decode of bnv_fusion_tpu_torch against
the JAX package's Pallas kernel (interpret mode on CPU), on the same numpy
inputs and weights.

Weights: the port's seeded init with non-zero biases (bias_std 0.1), so a
decode that dropped a bias or read it from the wrong place would be off by
~1e-3 here.  Tolerance: atol 1e-4 * voxel_size on outputs of magnitude
~voxel_size * |alpha| (~1e-2): both sides compute the same float32
products, in another order (observed ~3e-9).  The CUDA kernel is held
against the plain version on the card by chip_smoke.py, at the same
relative bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import nn as jnn
from bnv_fusion_tpu.kernels import fused_corner_decode as jax_fused
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch.kernels import fused_decode as tfd

VOXEL = 0.02
ATOL = 1e-4 * VOXEL


def _inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    local = (rng.rand(n, 8, 3) * 2 - 1).astype(np.float32)
    feats = rng.randn(n, 8, 8).astype(np.float32)
    tw = rng.rand(n, 8).astype(np.float32)
    return local, feats, tw / tw.sum(-1, keepdims=True)


def _params_np():
    return jax.tree.map(lambda x: x.numpy(), tnn.init_model(3, bias_std=0.1))


@pytest.mark.parametrize("wrapper", [tfd.fused_corner_decode_torch,
                                     tfd.fused_corner_decode],
                         ids=["plain", "wrapper_on_cpu"])
def test_plain_matches_pallas_interpret(wrapper):
    params_np = _params_np()
    local, feats, tw = _inputs(2048)
    vs = VOXEL
    ref = np.asarray(jax_fused(jax.tree.map(jnp.asarray, params_np),
                               jnp.asarray(local), jnp.asarray(feats),
                               jnp.asarray(tw), vs, interpret=True))
    out = wrapper(tnn.params_from_numpy(params_np), torch.as_tensor(local),
                  torch.as_tensor(feats), torch.as_tensor(tw), vs)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_available_for_tcnn_topology():
    assert tfd.fused_decode_available(tnn.params_from_numpy(
        jax.tree.map(np.asarray, jnn.init_model(jax.random.key(3)))))
    assert not tfd.fused_decode_available(tnn.init_model(0, n_hidden=4))
    # the kernel is built for the configs' latent width 8 only
    assert not tfd.fused_decode_available(tnn.init_model(0, feat_dims=16))

