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
from bnv_fusion_tpu_torch.kernels import mlp_tc

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



# --- the tensor-core kernel's packing and arithmetic (csrc/fused_decode.cu)

def _unfragment(frag, k):
    """Invert mlp_tc.tc_fragments from PTX's B-fragment table of
    mma.m16n8k8 .tf32 (b0 = B[t][g], b1 = B[t+4][g], lane = 4g + t):
    [k/8, 8, 32, 4] -> (hi, lo), each [k, 64]."""
    frag = np.asarray(frag).reshape(k // 8, 8, 32, 4)
    hi, lo = np.zeros((k, 64), np.float32), np.zeros((k, 64), np.float32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in range(k // 8):
            for n in range(8):
                b = frag[j, n, lane]
                hi[8 * j + t, 8 * n + g], hi[8 * j + t + 4, 8 * n + g] = b[:2]
                lo[8 * j + t, 8 * n + g], lo[8 * j + t + 4, 8 * n + g] = b[2:]
    return hi, lo


def _unpack(packed):
    """The packed flat tensor -> [(hi, lo) of the three layers], biases."""
    packed = np.asarray(packed)
    layers, off = [], 0
    for k in (24, 64, 64):
        layers.append(_unfragment(packed[off:off + k * 64 * 2], k))
        off += k * 64 * 2
    b = [packed[off + 64 * i:off + 64 * (i + 1)] for i in range(4)]
    return layers, b[0], b[1], b[2], b[3], packed[off + 256]


def test_tc_packing_round_trips():
    dec = tnn.init_model(5, bias_std=0.1)["decoder"]
    layers, b0, b1, b2, wo, bo = _unpack(tfd.pack_decoder_tc(dec))
    perm = [8 * (i // 8) + mlp_tc.PERM[i % 8] for i in range(64)]
    inv = np.argsort(perm)
    w0l = layers[0][0].astype(np.float64) + layers[0][1]
    for name, (hi, lo), rows in (("w1", layers[1], inv), ("w2", layers[2], inv)):
        w = dec[name].numpy()
        # TF32 keeps 11 significant bits, so hi + lo carries ~22 of f32's 24
        np.testing.assert_array_less(
            np.abs(hi.astype(np.float64) + lo - w[perm]),
            2.0 ** -21 * np.abs(w[perm]) + 1e-30)
        # hi and lo are TF32 values: their low 13 mantissa bits are zero
        assert not (hi.view(np.int32) & 0x1FFF).any()
        assert not (lo.view(np.int32) & 0x1FFF).any()
        # undoing the permutation gives the layer back
        np.testing.assert_allclose((hi.astype(np.float64) + lo)[rows], w,
                                   rtol=2.0 ** -21, atol=0)
    w0 = dec["w0"].numpy()
    for row, src in enumerate(tfd.W0_ROWS):
        if src < 0:
            assert not w0l[row].any()
        else:
            np.testing.assert_allclose(w0l[row], w0[src], rtol=2.0 ** -21,
                                       atol=0)
    assert sorted(r for r in tfd.W0_ROWS if r >= 0) == list(range(17))
    for got, name in ((b0, "b0"), (b1, "b1"), (b2, "b2"), (wo, "w_out")):
        np.testing.assert_array_equal(got, dec[name].numpy().reshape(-1))
    assert bo == dec["b_out"].numpy()[0]


def _tf32(x):
    b = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((b + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


def _emulate_kernel(packed, local, feats, tw, voxel_size, perm=mlp_tc.PERM):
    """numpy model of the kernel's arithmetic through the packed weights:
    layer 0's inputs in the kernel's column order, each operand split into
    TF32 hi/lo, products lo*hi + hi*lo + hi*hi (exact in f32, summed here
    in float64 and rounded to f32 per layer), and each layer's
    accumulators read as the next layer's A operand: logical column
    8j + kk of the A fragment is output column 8j + perm[kk]."""
    layers, b0, b1, b2, wo, bo = _unpack(packed)
    n = local.shape[0]
    l = local.reshape(n * 8, 3)
    f = feats.reshape(n * 8, 8)
    cols = {}
    for t in range(4):
        cols[t], cols[t + 4] = f[:, t], f[:, t + 4]
        z = np.zeros(n * 8, np.float32)
        cols[8 + t] = l[:, t] if t < 3 else z
        cols[12 + t] = np.sin(l[:, t]) if t < 3 else z
        cols[16 + t] = np.cos(l[:, t]) if t < 3 else z
        cols[20 + t] = z
    a = np.stack([cols[c] for c in range(24)], 1).astype(np.float32)
    physical = [8 * (i // 8) + perm[i % 8] for i in range(64)]
    h = None
    for (whi, wlo), b in zip(layers, (b0, b1, b2)):
        if h is not None:
            a = h[:, physical]
        ahi = _tf32(a)
        alo = _tf32(a - ahi)
        y = (b.astype(np.float64) + alo.astype(np.float64) @ whi
             + ahi.astype(np.float64) @ wlo + ahi.astype(np.float64) @ whi)
        h = np.maximum(y.astype(np.float32), 0)
    alpha = (h @ wo + bo).reshape(n, 8)
    return np.sum(alpha * voxel_size * tw, -1)


def test_tc_arithmetic_emulation_matches_pallas_interpret():
    params_np = _params_np()
    local, feats, tw = _inputs(2048, seed=4)
    ref = np.asarray(jax_fused(jax.tree.map(jnp.asarray, params_np),
                               jnp.asarray(local), jnp.asarray(feats),
                               jnp.asarray(tw), VOXEL, interpret=True))
    packed = tfd.pack_decoder_tc(tnn.params_from_numpy(params_np)["decoder"])
    out = _emulate_kernel(packed.numpy(), local, feats, tw, VOXEL)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # the model has teeth: reading the accumulators through the inverse
    # permutation instead misses the bound by far
    bad = _emulate_kernel(packed.numpy(), local, feats, tw, VOXEL,
                          perm=tuple(int(i) for i in np.argsort(mlp_tc.PERM)))
    assert np.abs(bad - ref).max() > 100 * ATOL


def test_packing_fills_whole_float4s():
    """The packed layout is the three layers' hi/lo fragments, then b0, b1,
    b2, w_out (64 each) and b_out, zero-padded to a multiple of 4 floats:
    csrc/fused_decode.cu copies it to shared memory as float4s."""
    dec = tnn.init_model(6, bias_std=0.1)["decoder"]
    packed = tfd.pack_decoder_tc(dec)
    body = (24 + 64 + 64) * 64 * 2 + 4 * 64 + 1
    assert packed.dtype == torch.float32 and packed.dim() == 1
    assert packed.numel() == body + (-body % 4) and packed.numel() % 4 == 0
    assert not packed[body:].any()


def test_cpu_wrapper_takes_plain_path_with_packed_weights():
    """A caller that packs once (the mesh path) passes ``packed``; on CPU
    tensors the wrapper still runs the plain version, bit for bit."""
    params = tnn.params_from_numpy(_params_np())
    local, feats, tw = (torch.as_tensor(x) for x in _inputs(256, seed=7))
    packed = tfd.pack_decoder_tc(params["decoder"])
    got = tfd.fused_corner_decode(params, local, feats, tw, VOXEL,
                                  packed=packed)
    want = tfd.fused_corner_decode_torch(params, local, feats, tw, VOXEL)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
