"""Port parity: the port's FusedMLP and its plain version (fused_mlp_torch)
against the JAX package's FusedMLP, whose Pallas kernel runs in interpret
mode on the CPU (as tests/test_fused_mlp.py runs it), on the same numpy
inputs and weights.

Weights: the port's seeded init with non-zero biases (bias_std 0.1), handed
to JAX as numpy.  Tolerance: atol 2e-5, rtol 1e-5, tests/test_fused_mlp.py's
own: both sides take the same float32 products, summed in another order, on
outputs of magnitude ~1.  The CUDA kernel is held against the plain version
on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu.kernels.fused_mlp import FusedMLP as JFusedMLP
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch.kernels import fused_mlp as tfm

ATOL, RTOL = 2e-5, 1e-5


def _params_np(seed):
    return jax.tree.map(lambda x: x.numpy(),
                        tnn.init_model(seed, bias_std=0.1))


@pytest.mark.parametrize("net,shape,block_m", [
    ("encoder", (3000, 6), 512),
    ("encoder", (7, 11, 6), 256),
    ("decoder", (1500, 17), 512),
], ids=["encoder_3000", "encoder_batched", "decoder_1500"])
@pytest.mark.parametrize("wrapper", ["FusedMLP", "fused_mlp_torch"])
def test_port_matches_pallas_interpret(net, shape, block_m, wrapper):
    prm = _params_np(0)[net]
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    ref = np.asarray(JFusedMLP(jax.tree.map(jnp.asarray, prm),
                               block_m=block_m)(jnp.asarray(x)))
    tprm = tnn.params_from_numpy(prm)
    fn = (tfm.FusedMLP(tprm) if wrapper == "FusedMLP"
          else lambda v: tfm.fused_mlp_torch(tprm, v))
    out = fn(torch.as_tensor(x)).numpy()
    assert out.shape == ref.shape == shape[:-1] + (prm["w_out"].shape[1],)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_kernel_layout_and_topology_checks():
    """The packed layout holds every weight once (w_out/b_out padded to the
    kernel's output width); topologies the kernel lacks raise ValueError, and
    a device that is neither CPU nor CUDA raises too."""
    p = tnn.init_model(0, bias_std=0.1)
    packed = tfm.pack_params(p["encoder"], "cpu")
    assert packed.numel() == 6 * 64 + 64 + 2 * (64 * 64 + 64) + 64 * 8 + 8
    np.testing.assert_array_equal(packed[:6 * 64].numpy(),
                                  p["encoder"]["w0"].numpy().reshape(-1))
    dec = tfm.pack_params(p["decoder"], "cpu")
    tail = dec[-(64 * 1 + 1):].numpy()      # dout 1 keeps width 1
    np.testing.assert_array_equal(tail[:64],
                                  p["decoder"]["w_out"].numpy().reshape(-1))
    assert tfm.mlp_dims(p["decoder"]) == (17, 1)
    for bad in (tnn.init_model(0, n_hidden=4)["encoder"],
                tnn.init_model(0, hidden=32)["encoder"],
                tnn.init_model(0, feat_dims=20)["encoder"]):
        with pytest.raises(ValueError):
            tfm.mlp_dims(bad)
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.fused_mlp(p["encoder"], torch.empty((4, 6), device="meta"))
    # the plain version takes any topology on the CPU
    deep = tnn.init_model(0, n_hidden=4)["encoder"]
    x = torch.randn(5, 6)
    torch.testing.assert_close(tfm.FusedMLP(deep)(x),
                               tnn.mlp_apply(deep, x))
