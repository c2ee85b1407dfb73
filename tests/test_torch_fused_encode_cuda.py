"""The fused-encode kernel (csrc/fused_encode.cu) against its plain version
on an NVIDIA card; every test here skips without one.

On the card (the repository's conftest imports JAX, which that machine
lacks, so it is left out):

    python -m pytest -m cuda --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_fused_encode_cuda.py

Tolerance: chip_smoke.py's MLP_ATOL = MLP_RTOL = 1e-4, the kernel's
3xTF32 products (each operand's hi/lo split drops ~2^-22 of it) summed in
another order than cuBLAS's float32 products.  The bfloat16 variant is
held to BF16_TOL elementwise and to a hundredth of the bfloat16 operands'
own effect on average (tests/test_torch_fused_encode.py's model of it).
No JAX here: the plain version is held against the JAX package in
tests/test_torch_fused_encode.py.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ATOL = RTOL = 1e-4
BF16_TOL = 2.0 ** -5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode "
                    "(the plain version's CPU tests are in "
                    "tests/test_torch_fused_encode.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _points(k, n, seed, dev):
    """Sorted-front-like inputs: frame 0 valid on its head (the front sorts
    invalid points last), frame 1 without a valid point, the others valid
    at random; a fifth of the coordinates on integers; invalid entries
    zeroed."""
    rs = np.random.RandomState(seed)
    coords = rs.uniform(0, 250, (k, n, 3)).astype(np.float32)
    snap = rs.rand(k, n, 3) < 0.2
    coords[snap] = np.round(coords[snap])
    nrm = rs.randn(k, n, 3)
    normals = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
               ).astype(np.float32)
    valid = rs.rand(k, n) < 0.7
    valid[0] = np.arange(n) < int(0.62 * n)
    valid[1] = False
    coords[~valid] = 0.0
    normals[~valid] = 0.0
    return [torch.as_tensor(a, device=dev) for a in (coords, normals, valid)]


def test_kernel_matches_plain(cuda):
    from bnv_fusion_tpu_torch import nn as bnn
    from bnv_fusion_tpu_torch.kernels import (_build, fused_encode_sorted,
                                              fused_encode_sorted_torch)

    params = bnn.init_model(0, device=cuda, bias_std=0.1)
    for n in (32 * 100 + 17, 5, 32):
        pts = _points(3, n, seed=n, dev=cuda)
        _build.LAUNCHES.clear()
        got = fused_encode_sorted(params, *pts)
        assert _build.LAUNCHES["fused_encode"] == 1
        want = fused_encode_sorted_torch(params, *pts)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (3, 64, n)
        err = (got - want).abs()
        assert bool((err <= ATOL + RTOL * want.abs()).all()), \
            f"N={n}: max abs err {float(err.max()):.3e}"
        assert not got[1].any()
        assert not got[:, :, ~pts[2].any(0)].any()
    # two launches, the same bits
    again = fused_encode_sorted(params, *pts)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_bf16_kernel_matches_plain_bf16(cuda):
    """Under a bfloat16 compute dtype the kernel launches (one TF32 pass on
    bfloat16-rounded operands) and gives the plain bfloat16 encoder: within
    BF16_TOL everywhere, and on average within a hundredth of how far the
    bfloat16 operands move the float32 encoder; identical bits twice."""
    from bnv_fusion_tpu_torch import nn as bnn
    from bnv_fusion_tpu_torch.kernels import (_build, fused_encode_sorted,
                                              fused_encode_sorted_torch)

    params = bnn.init_model(0, device=cuda, bias_std=0.1)
    bf16 = torch.bfloat16
    pts = _points(4, 32 * 3000 + 9, seed=3, dev=cuda)
    _build.LAUNCHES.clear()
    got = fused_encode_sorted(params, *pts, compute_dtype=bf16)
    assert _build.LAUNCHES["fused_encode"] == 1
    want = fused_encode_sorted_torch(params, *pts, bf16)
    f32 = fused_encode_sorted_torch(params, *pts)
    err = (got - want).abs()
    assert bool((err <= BF16_TOL + BF16_TOL * want.abs()).all()), \
        f"max abs err {float(err.max()):.3e}"
    moved = float((want - f32).abs().mean())
    assert float(err.mean()) <= 1e-2 * moved, (float(err.mean()), moved)
    assert not got[1].any()
    again = fused_encode_sorted(params, *pts, compute_dtype=bf16)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _fuse_tables(extra=(), plain=False):
    """One K=4 update through NeuralMap (a frame of zero depth among them,
    N = 4,800 points a frame): (fused_encode launches, the table's keys,
    features, weights and hits ordered by key, the encoder's largest
    output magnitude where ``plain``).  ``plain`` routes the front's
    encoder to the plain version."""
    from bnv_fusion_tpu_torch import fusion, tables
    from bnv_fusion_tpu_torch import nn as bnn
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.datasets.synth_scene import \
        SyntheticDemoDataset
    from bnv_fusion_tpu_torch.kernels import _build, fused_encode_sorted_torch
    from bnv_fusion_tpu_torch.pipeline import NeuralMap

    over = ["device_type=cuda", "dataset.img_res=[60,80]",
            "dataset.num_images=4", "model.voxel_size=0.03",
            "model.integrate_batch_size=4", "model.min_pts_in_grid=0"]
    over += list(extra)
    ds = SyntheticDemoDataset(load_config(over), "val")
    frames = [ds[i] for i in range(4)]
    frames[1] = dict(frames[1], depth=np.zeros_like(frames[1]["depth"]))
    params = bnn.init_model(0, bias_std=0.1)
    nm = NeuralMap(ds.dimensions, load_config(over), params)
    _build.LAUNCHES.clear()
    kernel = fusion.fused_encode_sorted
    top = [0.0]

    def plain_encode(*args):
        out = fused_encode_sorted_torch(*args)
        top[0] = max(top[0], float(out.abs().max()))
        return out

    if plain:
        fusion.fused_encode_sorted = plain_encode
    try:
        nm.integrate_batch(frames)
    finally:
        fusion.fused_encode_sorted = kernel
    torch.cuda.synchronize()
    keys, feats, w, h, _ = tables.active_entries(nm.table)
    order = np.lexsort(keys.T[::-1])
    return (_build.LAUNCHES["fused_encode"],
            [a[order] for a in (keys, feats, w, h)], top[0])


def test_front_chunks_and_invalid_frame(cuda):
    """With stage 2 in exact float32 (fuse_sort_bf16=false): the kernel
    launches once per front chunk, fuse_front_chunks=2 gives the same
    table bit for bit, and the table is the plain encoder's within the
    tolerance (keys, weights and hits exact)."""
    exact = ["model.fuse_sort_bf16=false"]
    n1, one, _ = _fuse_tables(exact)
    n2, two, _ = _fuse_tables(exact + ["model.fuse_front_chunks=2"])
    n0, plain, _ = _fuse_tables(exact, plain=True)
    assert (n1, n2, n0) == (1, 2, 0)
    assert len(one[0]) > 0
    for a, b in zip(one, two):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    for i in (0, 2, 3):
        assert np.array_equal(one[i], plain[i])
    np.testing.assert_allclose(one[1], plain[1], atol=ATOL, rtol=RTOL)


def test_sort_bf16_table_matches_plain(cuda):
    """At the configs' default fuse_sort_bf16=true: stage 2 rounds each
    cell's partial sum to bfloat16, and a last-bit difference of the
    kernel's 3xTF32 features from cuBLAS's can round one to the
    neighbouring value, one bfloat16 ulp (at most 2^-7 of it) away.  A
    voxel's feature is its cells' rounded partial sums over its weight,
    and a partial sum is at most its points' count times the encoder's
    largest output M, so the table is the plain encoder's within
    2^-7 M + ATOL (keys, weights and hits exact), and nearly every feature
    is equal bit for bit."""
    n1, one, _ = _fuse_tables(["model.fuse_sort_bf16=true"])
    n0, plain, top = _fuse_tables(["model.fuse_sort_bf16=true"], plain=True)
    assert (n1, n0) == (1, 0)
    assert len(one[0]) > 0 and top > 0
    for i in (0, 2, 3):
        assert np.array_equal(one[i], plain[i])
    np.testing.assert_allclose(one[1], plain[1], atol=2.0 ** -7 * top + ATOL,
                               rtol=RTOL)
    assert np.mean(one[1] == plain[1]) >= 0.99
