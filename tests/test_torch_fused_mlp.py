"""Port parity: the port's FusedMLP and its plain version (fused_mlp_torch)
against the JAX package's FusedMLP, whose Pallas kernel runs in interpret
mode on the CPU (as tests/test_fused_mlp.py runs it), on the same numpy
inputs and weights; and the tensor-core kernel's weight packing and 3xTF32
arithmetic (csrc/fused_mlp.cu), modelled in numpy through the packed
weights.

Weights: the port's seeded init with non-zero biases (bias_std 0.1), handed
to JAX as numpy.  Tolerance: atol 2e-5, rtol 1e-5, tests/test_fused_mlp.py's
own: both sides take the same float32 products, summed in another order, on
outputs of magnitude ~1.  The CUDA kernel is held against the plain version
on the card by chip_smoke.py (atol = rtol = 1e-4), at the same six
(din, dout) as the packing tests here; its wrapper checks there that the
packed size equals the built library's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu.kernels.fused_mlp import FusedMLP as JFusedMLP
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch.kernels import fused_mlp as tfm
from bnv_fusion_tpu_torch.kernels import mlp_tc

ATOL, RTOL = 2e-5, 1e-5
SMOKE_TOL = 1e-4          # chip_smoke.py's MLP_ATOL = MLP_RTOL


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


# --- the tensor-core kernel's packing and arithmetic (csrc/fused_mlp.cu)

def _layout(din, dout):
    """csrc/fused_mlp.cu's packed layout, in floats: KS0 = ceil(din/8)
    k-steps of layer 0, NT = ceil(dout/8) n-tiles of the output layer
    (0 for dout = 1: w_out's 64 floats for the FMA output layer); the
    fragments of w0, w1, w2, w_out, then b0, b1, b2, b_out (8 * NT, or 1),
    zero-padded to whole float4s."""
    ks0 = -(-din // 8)
    nt = 0 if dout == 1 else -(-dout // 8)
    frag = 8 * 32 * 4                   # floats per k-step of 8 n-tiles
    off = {"w0": 0, "w1": ks0 * frag}
    off["w2"] = off["w1"] + 8 * frag
    off["wo"] = off["w2"] + 8 * frag
    off["b0"] = off["wo"] + (nt * frag if nt else 64)
    off["b1"], off["b2"] = off["b0"] + 64, off["b0"] + 128
    off["bo"] = off["b0"] + 192
    body = off["bo"] + (8 * nt if nt else 1)
    return ks0, nt, off, body, body + (-body % 4)


def _unfragment(frag, k, n):
    """Invert mlp_tc.tc_fragments from PTX's B-fragment table of
    mma.m16n8k8 .tf32 (b0 = B[t][g], b1 = B[t+4][g], lane = 4g + t):
    [k/8, n/8, 32, 4] -> (hi, lo), each [k, n]."""
    frag = np.asarray(frag).reshape(k // 8, n // 8, 32, 4)
    hi, lo = np.zeros((k, n), np.float32), np.zeros((k, n), np.float32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in range(k // 8):
            for c in range(n // 8):
                b = frag[j, c, lane]
                hi[8 * j + t, 8 * c + g], hi[8 * j + t + 4, 8 * c + g] = b[:2]
                lo[8 * j + t, 8 * c + g], lo[8 * j + t + 4, 8 * c + g] = b[2:]
    return hi, lo


def _unpack(packed, din, dout):
    """The packed flat tensor -> [(hi, lo) per tensor-core layer], w_out
    of the FMA output layer (None for dout >= 2), [b0, b1, b2, b_out]."""
    ks0, nt, off, _, _ = _layout(din, dout)
    packed = np.asarray(packed)
    shapes = [("w0", 8 * ks0, 64), ("w1", 64, 64), ("w2", 64, 64)]
    if nt:
        shapes.append(("wo", 64, 8 * nt))
    layers = [_unfragment(packed[off[name]:off[name] + k * n * 2], k, n)
              for name, k, n in shapes]
    wo = None if nt else packed[off["wo"]:off["wo"] + 64]
    biases = [packed[off[b]:off[b] + 64] for b in ("b0", "b1", "b2")]
    biases.append(packed[off["bo"]:off["bo"] + (8 * nt if nt else 1)])
    return layers, wo, biases


def _mlp_np(din, dout, seed):
    """A din -> 64 x 3 -> dout MLP of the port's init, biases N(0, 0.1^2)."""
    return tnn._init_mlp(np.random.RandomState(seed),
                         [din, 64, 64, 64, dout], 0.1)


PACK_DIMS = [(6, 8), (17, 1), (1, 1), (32, 16), (9, 2), (12, 9)]


@pytest.mark.parametrize("din,dout", PACK_DIMS,
                         ids=[f"{a}to{b}" for a, b in PACK_DIMS])
def test_tc_packing_round_trips(din, dout):
    prm = _mlp_np(din, dout, seed=din * 100 + dout)
    packed = tfm.pack_params(tnn.params_from_numpy(prm), "cpu")
    ks0, nt, off, body, size = _layout(din, dout)
    assert packed.dtype == torch.float32 and packed.dim() == 1
    assert packed.numel() == size and size % 4 == 0
    assert not packed[body:].any()
    assert tfm.tiles(din, dout) == (ks0, nt)
    layers, wo, biases = _unpack(packed.numpy(), din, dout)
    perm = [8 * (i // 8) + mlp_tc.PERM[i % 8] for i in range(64)]
    wo_pad = np.zeros((64, 8 * max(nt, 1)), np.float32)
    wo_pad[:, :dout] = prm["w_out"]
    w0_pad = np.zeros((8 * ks0, 64), np.float32)
    w0_pad[:din] = prm["w0"]
    # w0 in input-column order (zero rows past din); w1, w2, w_out with
    # rows permuted by PERM inside each block of 8 (w_out's columns padded)
    want = [w0_pad, prm["w1"][perm], prm["w2"][perm]]
    if nt:
        want.append(wo_pad[perm])
    for (hi, lo), w in zip(layers, want):
        # TF32 keeps 11 significant bits, so hi + lo carries ~22 of f32's 24
        np.testing.assert_array_less(
            np.abs(hi.astype(np.float64) + lo - w),
            2.0 ** -21 * np.abs(w) + 1e-30)
        # hi and lo are TF32 values: their low 13 mantissa bits are zero
        assert not (hi.view(np.int32) & 0x1FFF).any()
        assert not (lo.view(np.int32) & 0x1FFF).any()
        # the padding rows and columns are zero
        assert not hi[w == 0].any() and not lo[w == 0].any()
    assert not layers[0][0][din:].any()
    if nt:
        assert not layers[3][0][:, dout:].any()
        assert not biases[3][dout:].any()
    else:
        np.testing.assert_array_equal(wo, prm["w_out"].reshape(-1))
    for got, name in zip(biases, ("b0", "b1", "b2", "b_out")):
        np.testing.assert_array_equal(got[:prm[name].size],
                                      prm[name].reshape(-1))


def _tf32(x):
    b = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((b + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


def _emulate_kernel(packed, x, din, dout, perm=mlp_tc.PERM, passes=3):
    """numpy model of the kernel's arithmetic through the packed weights:
    layer 0's A operand is the input in its column order (zero past din);
    each operand split into TF32 hi/lo, products lo*hi + hi*lo + hi*hi
    (passes=3; passes=1 is one TF32 product hi*hi), exact in f32, summed
    here in float64 and rounded to f32 per layer; each later layer's A
    operand is the previous layer's accumulators, logical column 8j + kk
    being output column 8j + perm[kk].  For dout = 1 the output layer is
    f32 FMAs over the accumulators' own columns."""
    layers, wo, biases = _unpack(packed, din, dout)
    ks0 = -(-din // 8)
    a = np.zeros((x.shape[0], 8 * ks0), np.float32)
    a[:, :din] = x
    physical = [8 * (i // 8) + perm[i % 8] for i in range(64)]
    h = None
    for i, ((whi, wlo), b) in enumerate(zip(layers, biases)):
        if h is not None:
            a = h[:, physical]
        ahi = _tf32(a)
        alo = _tf32(a - ahi)
        y = b.astype(np.float64) + ahi.astype(np.float64) @ whi
        if passes == 3:
            y += alo.astype(np.float64) @ whi + ahi.astype(np.float64) @ wlo
        y = y.astype(np.float32)
        h = np.maximum(y, 0) if i < 3 else y
    if wo is None:
        return h[:, :dout]
    return (h.astype(np.float64) @ wo[:, None] + biases[3]).astype(np.float32)


@pytest.mark.parametrize("net,rows", [("encoder", 3000), ("decoder", 1500)])
def test_tc_arithmetic_emulation_matches_pallas_interpret(net, rows):
    prm = _params_np(0)[net]
    din, dout = prm["w0"].shape[0], prm["w_out"].shape[1]
    x = np.random.RandomState(2).randn(rows, din).astype(np.float32)
    ref = np.asarray(JFusedMLP(jax.tree.map(jnp.asarray, prm),
                               block_m=512)(jnp.asarray(x)))
    packed = tfm.pack_params(tnn.params_from_numpy(prm), "cpu").numpy()
    out = _emulate_kernel(packed, x, din, dout)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    # the model has teeth: reading the accumulators through the inverse
    # permutation misses the bound by far
    bad = _emulate_kernel(packed, x, din, dout,
                          perm=tuple(int(i) for i in np.argsort(mlp_tc.PERM)))
    assert np.abs(bad - ref).max() > 100 * ATOL
    # one TF32 pass misses chip_smoke.py's bound: hence 3xTF32
    one = _emulate_kernel(packed, x, din, dout, passes=1)
    assert (np.abs(one - ref) > SMOKE_TOL + SMOKE_TOL * np.abs(ref)).any()


def test_cpu_wrapper_takes_plain_path_with_packed_weights():
    """FusedMLP passes its packed weights; on CPU tensors fused_mlp still
    runs the plain version, bit for bit."""
    prm = tnn.params_from_numpy(_params_np(0)["encoder"])
    x = torch.as_tensor(np.random.RandomState(3).randn(257, 6)
                        .astype(np.float32))
    got = tfm.fused_mlp(prm, x, packed=tfm.pack_params(prm, "cpu"))
    want = tfm.fused_mlp_torch(prm, x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_layout_and_topology_checks():
    """The packed layout holds every weight once, w0's fragments in input
    order and the decoder's w_out (dout 1, FMA output layer) as it is, at
    the offsets of csrc/fused_mlp.cu; topologies the kernel lacks raise
    ValueError, and a device that is neither CPU nor CUDA raises too."""
    p = tnn.init_model(0, bias_std=0.1)
    packed = tfm.pack_params(p["encoder"], "cpu")
    _, _, off, body, size = _layout(6, 8)
    assert packed.numel() == size == body == (
        8 * 64 * 2 + 2 * 64 * 64 * 2 + 64 * 8 * 2 + 3 * 64 + 8)
    hi, lo = _unfragment(packed[:off["w1"]].numpy(), 8, 64)
    np.testing.assert_allclose(hi[:6].astype(np.float64) + lo[:6],
                               p["encoder"]["w0"].numpy(), rtol=2.0 ** -21,
                               atol=0)
    dec = tfm.pack_params(p["decoder"], "cpu")
    _, _, off, _, size = _layout(17, 1)
    assert dec.numel() == size
    np.testing.assert_array_equal(dec[off["wo"]:off["wo"] + 64].numpy(),
                                  p["decoder"]["w_out"].numpy().reshape(-1))
    assert dec[off["bo"]] == p["decoder"]["b_out"][0]
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
