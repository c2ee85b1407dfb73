"""Port parity: the fuse front's encoder (kernels/fused_encode.py).

The plain version (``fused_encode_sorted_torch``) against the JAX
package's ``fusion._encode_sorted_fm`` frame by frame, on the same numpy
points and weights; its channel order (f * 8 + p) against a float64 numpy
encoder of each corner's input; and csrc/fused_encode.cu's register
mapping (which lane builds which row and column of layer 0's A operand,
which accumulator lands in which channel, the chunk and step masks),
modelled in numpy over the 3xTF32 arithmetic that
tests/test_torch_fused_mlp.py models for the same packed weights, and
over the bfloat16 variant's one TF32 pass on rounded operands.  The
kernel itself runs only on a card: tests/test_torch_fused_encode_cuda.py
and chip_smoke.py hold it against the plain version there.

Points: voxel coordinates in [0, 40) with a share on integer coordinates
(where floor and ceil coincide, so corners collapse), unit normals, and
invalid entries zeroed as the fuse front's stage-1 sort leaves them.
Tolerance: tests/test_torch_fused_mlp.py's (atol 2e-5, rtol 1e-5): the
same float32 products summed in another order; BF16_TOL for the bfloat16
variant.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import fusion as jfusion
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import voxel as tvoxel
from bnv_fusion_tpu_torch.kernels import _build
from bnv_fusion_tpu_torch.kernels import fused_encode as tfe
from bnv_fusion_tpu_torch.kernels import mlp_tc
from bnv_fusion_tpu_torch.kernels.fused_mlp import pack_params
from tests.test_torch_fused_mlp import SMOKE_TOL, _emulate_kernel

ATOL, RTOL = 2e-5, 1e-5
# the bfloat16 variant against the plain bfloat16 encoder, elementwise: a
# hidden activation's rounding flipped by one bfloat16 ulp (2^-8 of it),
# carried through the later layers, where a few such flips can meet in one
# output (~9e-3 at most in this model, 1.6e-2 on an H100 at K=16 x 307,200
# points); chip_smoke.py and the card's test hold the kernel to it
BF16_TOL = 2.0 ** -5


def _params_np(seed=0):
    return jax.tree.map(lambda x: x.numpy(),
                        tnn.init_model(seed, bias_std=0.1))


def _points(k, n, seed, invalid_frames=()):
    """Sorted-front-like inputs [k, n]: coordinates, normals, validity;
    invalid entries zeroed, a fifth of the coordinates on integers, a few
    valid entries with zero coordinates and normals."""
    rs = np.random.RandomState(seed)
    coords = rs.uniform(0, 40, (k, n, 3)).astype(np.float32)
    snap = rs.rand(k, n, 3) < 0.2
    coords[snap] = np.round(coords[snap])
    nrm = rs.randn(k, n, 3)
    normals = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
               ).astype(np.float32)
    valid = rs.rand(k, n) < 0.75
    for f in invalid_frames:
        valid[f] = False
    coords[~valid] = 0.0
    normals[~valid] = 0.0
    zero = valid & (rs.rand(k, n) < 0.02)
    coords[zero] = 0.0
    normals[zero] = 0.0
    return coords, normals, valid


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("k,n,invalid_frames", [(1, 333, ()),
                                                (3, 517, (1,))],
                         ids=["K1", "K3_one_frame_invalid"])
def test_plain_matches_jax(k, n, invalid_frames):
    prm = _params_np()
    coords, normals, valid = _points(k, n, seed=k,
                                     invalid_frames=invalid_frames)
    jprm = jax.tree.map(jnp.asarray, prm)
    ref = np.stack([np.asarray(jfusion._encode_sorted_fm(
        jprm, jnp.asarray(coords[f]), jnp.asarray(normals[f]),
        jnp.asarray(valid[f]), jnp.float32)) for f in range(k)])
    got = tfe.fused_encode_sorted_torch(tnn.params_from_numpy(prm),
                                        *_torch(coords, normals, valid))
    assert got.shape == ref.shape == (k, 64, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert not got.numpy()[:, :, ~valid.any(0)].any()
    for f in invalid_frames:
        assert not got[f].any()


def _encoder64(enc, x):
    h = x.astype(np.float64)
    for i in range(3):
        h = np.maximum(h @ enc[f"w{i}"] + enc[f"b{i}"], 0.0)
    return h @ enc["w_out"] + enc["b_out"]


def test_channel_order_is_feature_major_corner_minor():
    """Channel f * 8 + p of point i is feature f of corner p's input: the
    offset from corner p (floor or ceil per axis by voxel._CORNER_PATTERN)
    and the normal, through a float64 encoder; zero where invalid."""
    prm = _params_np(1)
    coords, normals, valid = _points(2, 101, seed=7)
    got = tfe.fused_encode_sorted_torch(tnn.params_from_numpy(prm),
                                        *_torch(coords, normals, valid))
    got = got.numpy().reshape(2, 8, 8, 101)          # [K, f, p, N]
    pat = tvoxel._CORNER_PATTERN.astype(bool)
    for p in range(8):
        corner = np.where(pat[p], np.ceil(coords), np.floor(coords))
        x = np.concatenate([coords - corner, normals], axis=-1)
        want = _encoder64(prm["encoder"], x)          # [K, N, F]
        want = np.where(valid[..., None], want, 0.0).transpose(0, 2, 1)
        np.testing.assert_allclose(got[:, :, p, :], want, atol=ATOL,
                                   rtol=RTOL)


# --- csrc/fused_encode.cu's register mapping, in numpy

CHUNK, STEP = 32, 4          # points per warp chunk, per step (2 tiles)


def _ceil_bits():
    pat = tvoxel._CORNER_PATTERN
    return sum(int(pat[p, d]) << (3 * p + d) for p in range(8)
               for d in range(3))


def _kernel_model(packed, coords, normals, valid, passes=3,
                  lane_cols=lambda t: (t, t + 4), round_a=None):
    """numpy model of csrc/fused_encode.cu.  Per frame, chunks of 32
    points; per chunk without a valid point, zeros; per step of 4 points
    with one, two 16-row tiles: lane (g, t) writes rows g + 8h (point
    2m + h of the step, corner g) at columns t and t + 4 (``lane_cols``):
    the offset along axis t from corner g's floor or ceil (t = 3: the
    normal's x) and the normal's y, z (t < 2).  The tiles' rows go
    through the packed weights' 3xTF32 arithmetic
    (test_torch_fused_mlp._emulate_kernel); accumulator column 2t + e of
    row g + 8h lands in channel (2t + e) * 8 + g of that point, zero where
    the point is invalid.  ``round_a``: the bfloat16 variant's rounding
    of every layer's A operand (_emulate_kernel)."""
    k, n = valid.shape
    bits = _ceil_bits()
    tiles, where = [], []
    out = np.zeros((k, 64, n), np.float32)
    for f in range(k):
        for c0 in range(0, n, CHUNK):
            m = min(CHUNK, n - c0)
            vm = np.zeros(CHUNK, bool)
            vm[:m] = valid[f, c0:c0 + m]
            for q0 in range(0, CHUNK, STEP):
                if not vm[q0:q0 + STEP].any():
                    continue
                for mt in range(2):
                    a = np.zeros((16, 8), np.float32)
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        for h in range(2):
                            q = q0 + 2 * mt + h
                            cp = coords[f, c0 + q] if q < m else np.zeros(3)
                            nr = normals[f, c0 + q] if q < m else np.zeros(3)
                            if t < 3:
                                c = np.float32(cp[t])
                                x0 = c - (np.ceil(c) if (bits >> (3 * g + t))
                                          & 1 else np.floor(c))
                            else:
                                x0 = nr[0]
                            x1 = nr[t + 1] if t < 2 else 0.0
                            c_lo, c_hi = lane_cols(t)
                            a[g + 8 * h, c_lo], a[g + 8 * h, c_hi] = x0, x1
                    tiles.append(a)
                    where.append((f, c0, q0 + 2 * mt, vm))
    if not tiles:
        return out
    x = np.concatenate(tiles)
    y = _emulate_kernel(packed, x[:, :6], 6, 8, passes=passes,
                        round_a=round_a)
    for i, (f, c0, q2, vm) in enumerate(where):
        tile = y[16 * i:16 * i + 16]
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for h in range(2):
                q = q2 + h
                if c0 + q >= n or not vm[q]:
                    continue
                for e in range(2):
                    out[f, (2 * t + e) * 8 + g, c0 + q] = tile[g + 8 * h,
                                                               2 * t + e]
    return out


def test_kernel_model_matches_plain():
    """The register mapping reproduces the plain version at a ragged N
    (chunks and steps past the frame's end), with a frame without valid
    points and a chunk whose tail steps have none; the model has teeth:
    lanes that swap their two columns, or one TF32 pass, miss."""
    prm = _params_np(2)
    coords, normals, valid = _points(3, 70, seed=11, invalid_frames=(2,))
    valid[0, 40:] = False                  # a partly valid chunk
    coords[~valid] = 0.0
    normals[~valid] = 0.0
    tprm = tnn.params_from_numpy(prm)
    want = tfe.fused_encode_sorted_torch(
        tprm, *_torch(coords, normals, valid)).numpy()
    packed = tfe.pack_encoder(tprm["encoder"], torch.float32, "cpu").numpy()
    got = _kernel_model(packed, coords, normals, valid)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    swapped = _kernel_model(packed, coords, normals, valid,
                            lane_cols=lambda t: (t + 4, t))
    assert np.abs(swapped - want).max() > 100 * ATOL
    one = _kernel_model(packed, coords, normals, valid, passes=1)
    assert (np.abs(one - want) > SMOKE_TOL + SMOKE_TOL * np.abs(want)).any()


def _bf16(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def test_kernel_model_bf16_matches_plain():
    """The bfloat16 variant (model.fuse_dtype=bfloat16): inputs and hidden
    activations rounded to bfloat16, weights packed from their bfloat16
    values, one TF32 pass.  Every product is exact, so it computes the
    plain bfloat16 encoder up to the order of the float32 sums, which can
    flip a hidden activation's rounding by one bfloat16 ulp: each output
    within BF16_TOL, and on average within a hundredth of what bfloat16
    operands move the float32 encoder (~1e-4 here).  The model has teeth:
    rounding the inputs alone, or three passes of the float32 packing,
    miss the mean by far."""
    prm = _params_np(4)
    coords, normals, valid = _points(3, 700, seed=13, invalid_frames=(1,))
    tprm = tnn.params_from_numpy(prm)
    pts = _torch(coords, normals, valid)
    want = tfe.fused_encode_sorted_torch(tprm, *pts, torch.bfloat16).numpy()
    f32 = tfe.fused_encode_sorted_torch(tprm, *pts).numpy()
    moved = np.abs(want - f32).mean()
    packed = tfe.pack_encoder(tprm["encoder"], torch.bfloat16, "cpu").numpy()
    got = _kernel_model(packed, coords, normals, valid, passes=1,
                        round_a=_bf16)
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)
    assert np.abs(got - want).mean() <= 1e-2 * moved
    first = iter([True])
    inputs_only = _kernel_model(
        packed, coords, normals, valid, passes=1,
        round_a=lambda a: _bf16(a) if next(first, False) else a)
    assert np.abs(inputs_only - want).mean() > 0.1 * moved
    packed32 = tfe.pack_encoder(tprm["encoder"], torch.float32,
                                "cpu").numpy()
    f32_model = _kernel_model(packed32, coords, normals, valid)
    assert np.abs(f32_model - want).mean() > 0.1 * moved


def test_wrapper_routes_and_checks():
    """CPU tensors take the plain version in either compute dtype (no
    launch counted); a device that is neither CPU nor CUDA raises; the
    kernel's topology check refuses other encoders; pack_encoder is
    fused_mlp.pack_params of the weights rounded to the compute dtype
    (biases as they are), packed once per weight set and again after an
    in-place change; permute_rows equals the index form."""
    prm = tnn.params_from_numpy(_params_np(3))
    pts = _torch(*_points(2, 50, seed=5))
    _build.LAUNCHES.clear()
    for dt in (torch.float32, torch.bfloat16):
        got = tfe.fused_encode_sorted(prm, *pts, compute_dtype=dt)
        torch.testing.assert_close(
            got, tfe.fused_encode_sorted_torch(prm, *pts, dt), rtol=0, atol=0)
    assert _build.LAUNCHES["fused_encode"] == 0
    meta = [t.to("meta") for t in pts]
    with pytest.raises(ValueError, match="unsupported device"):
        tfe.fused_encode_sorted(prm, *meta)
    for bad in (tnn.init_model(0, feat_dims=16), tnn.init_model(0, hidden=32)):
        with pytest.raises(ValueError):
            tfe.check_encoder(bad["encoder"])
        with pytest.raises(ValueError):
            tfe.pack_encoder(bad["encoder"], torch.float32, "cpu")
    enc = {k: v.clone() for k, v in prm["encoder"].items()}
    for dt in (torch.float32, torch.bfloat16):
        packed = tfe.pack_encoder(enc, dt, "cpu")
        assert tfe.pack_encoder(enc, dt, "cpu") is packed
        rounded = {k: tnn.round_to(v, dt) if k.startswith("w") else v
                   for k, v in enc.items()}
        assert torch.equal(packed, pack_params(rounded, "cpu"))
    assert not torch.equal(tfe.pack_encoder(enc, torch.float32, "cpu"),
                           tfe.pack_encoder(enc, torch.bfloat16, "cpu"))
    before = tfe.pack_encoder(enc, torch.float32, "cpu")
    enc["w1"].mul_(2.0)
    after = tfe.pack_encoder(enc, torch.float32, "cpu")
    assert after is not before
    assert torch.equal(after, pack_params(enc, "cpu"))
    w = torch.randn(64, 8)
    perm = torch.tensor([8 * (i // 8) + mlp_tc.PERM[i % 8]
                         for i in range(64)])
    assert torch.equal(mlp_tc.permute_rows(w), w[perm])


def test_roofline_reader():
    """benchmark/metrics/fused_encode.roofline.py: the least time of each
    frame's encode (operations on its points inside, 8 corners each, at
    the dense TF32 peak, against their 6 input and 64 output floats and
    the weights at HBM bandwidth) over the kernel's device time; None
    where the trace holds no launch of the kernel (a parent without it)."""
    import importlib.util
    import os
    from types import SimpleNamespace

    from benchmark import rooflines
    from benchmark.trace import Timeline

    path = os.path.join(os.path.dirname(__file__), "..", "benchmark",
                        "metrics", "fused_encode.roofline.py")
    spec = importlib.util.spec_from_file_location("fused_encode_roofline",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    net = {"feature_dims": 8, "hidden": 64, "hidden_layers": 3,
           "pointnet_in": 6, "pe_fns": 1}
    stats = [{"inside": 192000}, {"inside": 0}]
    host = [("bench.window", 0.0, 5000.0)]
    dev = [("void (anonymous namespace)::fused_encode_kernel(float const*)",
            100.0, 1100.0), ("tile_sums_kernel", 1200.0, 1300.0)]

    def ctx(events):
        return SimpleNamespace(
            counters={"frame_stats": stats}, rooflines=rooflines,
            timeline=Timeline(host, events),
            run=SimpleNamespace(config={"network": net}))

    weights = 9088 + 3 * 64 + 8
    want = (192000 * 8 * 2 * 9088 / rooflines.PEAK_FLOPS +
            4.0 * weights / rooflines.PEAK_BYTES) / 1e-3
    assert mod.read(ctx(dev)) == pytest.approx(100.0 * want)
    assert mod.read(ctx(dev[1:])) is None
