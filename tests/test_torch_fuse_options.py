"""Port parity of the fuse path's options: the corner algorithm
(``fuse_frame_sorted``, the ``fuse_frame`` dispatcher), ``sort1_gather``
(the port's one stage-1 sort against both of JAX's), ``front_chunks`` and the bfloat16 encoder (``fuse_dtype``), against the JAX
package on the same numpy points and weights, and against the port's own
default where the option promises identical bits.

Frames: the analytic synthetic scene at 60x80, voxel 0.03, points
back-projected once by the JAX package and fed to both.  Tables are compared
BY VOXEL KEY: keys, weights and hits exactly.  Feature tolerances:
* the batched front with direct segment sums (seg-reduce, exact f32):
  atol 2e-5, the two sides summing in different orders (over these 4
  frames 6 of 120,896 features differ by 1.05e-5; tests/test_torch_fusion.py
  holds 3 frames to 1e-5);
* the per-frame cumsum fronts (cell and corner): atol 2e-3, the
  mean-centered cumsum's cancellation noise (tests/test_torch_fusion.py);
* bfloat16 operands: a last-bit difference of an f32 product can round an
  activation to the neighbouring bf16 value (2**-8 relative) on one side,
  so features are held to 2**-6 * max|feature| against JAX, and to the
  JAX package's bf16 budget, atol = rtol = 0.02, against float32
  (tests/test_batch_integrate.py:190-193).  The whole bf16 effect is about
  2**-8 relative, so a loose bound alone would also pass a version that
  rounds the products or skips a layer's rounding: beside it, at least 90%
  of the features must lie within 1e-3 relative of JAX's (97% do here;
  the per-frame cumsum front's own noise keeps f32 at 98%), where
  products rounded to bf16 and plain f32 reach under 30%.  The MLP alone
  is held tighter: 99.9% of its outputs within 1e-5 relative of a numpy
  model of operand rounding and of JAX's bf16 MLP.  The JAX package's bf16
  feature-major encoder (the batched front) does not run on the CPU
  backend (XLA: "Unsupported element type for DotThunk: BF16 x BF16 =
  F32"), so bf16 is held against JAX through the per-frame front.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import fusion as jfusion
from bnv_fusion_tpu import pipeline as jpipe
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu import voxel as jvoxel
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import \
    SyntheticDemoDataset as JDataset
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import tables as ttables

VOXEL = 0.03
MIN_PTS = 2
MU, MUC = 16384, 8192
CAP = 1 << 16


@pytest.fixture(scope="module")
def scene():
    cfg = jload_config(["dataset.img_res=[60,80]", "dataset.num_images=6",
                        f"model.voxel_size={VOXEL}"])
    ds = JDataset(cfg, "val")
    frames = [ds[i] for i in range(4)]
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(0, bias_std=0.1))
    pts = [jax.tree.map(np.asarray, jpipe._frame_points(
        jnp.asarray(f["depth"]), jnp.asarray(f["T_wc"]),
        jnp.asarray(f["intr_mat"]))) for f in frames]
    pw, nw, va = (np.stack([p[j] for p in pts]) for j in range(3))
    mn, mx, n_xyz = jvoxel.get_world_range(ds.dimensions, VOXEL)
    return dict(params=params, pw=pw, nw=nw, va=va, mn=mn, mx=mx,
                n_xyz=n_xyz)


def _by_key(table, entries):
    keys, feats, w, h, _ = entries(table)
    order = np.lexsort(keys.T[::-1])
    return keys[order], feats[order], w[order], h[order]


def _jax_table(s, fn, **kw):
    table = jtables.create_table(8, CAP, n_xyz=s["n_xyz"])
    params = jax.tree.map(jnp.asarray, s["params"])
    bounds = (jnp.asarray(s["mn"]), jnp.asarray(s["mx"]))
    if fn == "merged":
        table, _ = jax.jit(partial(
            jfusion.fuse_frames_merged, voxel_size=VOXEL,
            min_pts_in_grid=MIN_PTS, max_unique=MU, max_unique_cells=MUC,
            **kw))(table, params, jnp.asarray(s["pw"]), jnp.asarray(s["nw"]),
                   jnp.asarray(s["va"]), *bounds)
    else:
        step = jax.jit(partial(fn, voxel_size=VOXEL, min_pts_in_grid=MIN_PTS,
                               **kw))
        for k in range(s["pw"].shape[0]):
            table, _ = step(table, params, jnp.asarray(s["pw"][k]),
                            jnp.asarray(s["nw"][k]), jnp.asarray(s["va"][k]),
                            *bounds)
    assert int(table.overflow) == 0
    return _by_key(table, jtables.active_entries)


def _torch_table(s, fn, **kw):
    table = ttables.create_table(8, CAP, n_xyz=s["n_xyz"])
    params = tnn.params_from_numpy(s["params"])
    t = torch.as_tensor
    bounds = (t(s["mn"]), t(s["mx"]), VOXEL, MIN_PTS)
    if fn == "merged":
        tfusion.fuse_frames_merged(table, params, t(s["pw"]), t(s["nw"]),
                                   t(s["va"]), *bounds, max_unique=MU,
                                   max_unique_cells=MUC, **kw)
    else:
        for k in range(s["pw"].shape[0]):
            fn(table, params, t(s["pw"][k]), t(s["nw"][k]), t(s["va"][k]),
               *bounds, **kw)
    assert int(table.overflow) == 0
    return _by_key(table, ttables.active_entries)


def _assert_tables(a, b, atol, rtol=0.0):
    """Keys, weights and hits exact; features within atol + rtol |b|."""
    assert len(a[0]) > 1000
    for x, y in zip(a[:1] + a[2:], b[:1] + b[2:]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(a[1], b[1], atol=atol, rtol=rtol)


def _share_close(a, b, rtol, atol=0.0) -> float:
    """Share of the entries of a within atol + rtol |b| of b."""
    return float(np.mean(np.abs(a - b) <= atol + rtol * np.abs(b)))


BF16_SHARE, BF16_RTOL, BF16_ATOL = 0.9, 1e-3, 1e-6


def _assert_bf16_tables(t, j):
    """bf16 tables against JAX's: keys, weights, hits exact, every feature
    within 2**-6 max|feature| and >= 90% within 1e-3 relative."""
    _assert_tables(t, j, 2.0 ** -6 * np.abs(j[1]).max())
    share = _share_close(t[1], j[1], BF16_RTOL, BF16_ATOL)
    assert share >= BF16_SHARE, share


_MLP = tnn.mlp_apply      # the port's MLP, taken before any monkeypatch


def _mlp_products_rounded(params, x, compute_dtype=torch.float32):
    """A wrong bf16 MLP: torch's bf16 matmul, which rounds every product
    (layer output) to bf16 as well as the operands."""
    if compute_dtype == torch.float32:
        return _MLP(params, x)
    n_hidden = sum(1 for k in params if k.startswith("w") and k != "w_out")
    h = x.to(torch.bfloat16)
    for i in range(n_hidden):
        h = torch.relu(h @ params[f"w{i}"].to(torch.bfloat16) +
                       params[f"b{i}"]).to(torch.bfloat16)
    return (h @ params["w_out"].to(torch.bfloat16)).float() + params["b_out"]


def _bits_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fuse_frame_sorted_matches_jax(scene, dtype):
    """The corner-keyed one-stage sort, frame by frame."""
    j = _jax_table(scene, jfusion.fuse_frame_sorted, max_unique=MU,
                   compute_dtype=jnp.dtype(dtype))
    t = _torch_table(scene, tfusion.fuse_frame_sorted, max_unique=MU,
                     compute_dtype=getattr(torch, dtype))
    if dtype == "float32":
        _assert_tables(t, j, 2e-3)
    else:
        _assert_bf16_tables(t, j)


@pytest.mark.parametrize("algorithm", ["cell", "corner"])
def test_fuse_frame_dispatcher_matches_jax(scene, algorithm):
    """fuse_frame routes by algorithm exactly as the JAX package does, and
    both algorithms fuse the same voxels, weights and hits."""
    kw = dict(max_unique=MU, algorithm=algorithm, max_unique_cells=MUC)
    j = _jax_table(scene, jfusion.fuse_frame, **kw)
    t = _torch_table(scene, tfusion.fuse_frame, **kw)
    _assert_tables(t, j, 2e-3)
    other = _torch_table(scene, tfusion.fuse_frame, max_unique=MU,
                         max_unique_cells=MUC,
                         algorithm="corner" if algorithm == "cell" else "cell")
    _assert_tables(t, other, 2e-3)


def test_make_fuse_frame_fn_is_fuse_frame(scene):
    """The plain step make_fuse_frame_fn builds equals fuse_frame bit for
    bit, on the dense table and on the hash table (fuse_frame's hash
    branch)."""
    step = tfusion.make_fuse_frame_fn(VOXEL, MIN_PTS)
    a = _torch_table(scene, lambda tb, p, *r, **kw: step(tb, p, *r[:5]))
    b = _torch_table(scene, tfusion.fuse_frame, max_unique=1 << 19)
    _bits_equal(a, b)
    t = torch.as_tensor
    params = tnn.params_from_numpy(scene["params"])
    hashed = []
    for fn in (step, tfusion.fuse_frame):
        table = ttables.create_table(8, CAP)
        fn(table, params, t(scene["pw"][0]), t(scene["nw"][0]),
           t(scene["va"][0]), t(scene["mn"]), t(scene["mx"]), *(
               (VOXEL, MIN_PTS) if fn is tfusion.fuse_frame else ()))
        hashed.append(_by_key(table, ttables.active_entries))
    assert len(hashed[0][0]) > 1000
    _bits_equal(*hashed)


def test_sort1_gather_is_bit_identical(scene):
    """The JAX package's fuse_sort1_gather picks between two stage-1 sorts
    with identical bits; the port keeps one (the faster on the H100).  JAX's
    two sorts equal each other bit for bit, and the port's one sort agrees
    with JAX's sort1_gather route within the front's tolerance (batched
    front 2e-5, per-frame front 2e-3)."""
    for mode in ("interpret", False):
        kw = dict(seg_kernel=mode, sort_bf16=False)
        j = _jax_table(scene, "merged", sort1_gather=True, **kw)
        _bits_equal(j, _jax_table(scene, "merged", **kw))
        _assert_tables(_torch_table(scene, "merged", seg_kernel=mode), j,
                       2e-5 if mode == "interpret" else 2e-3)


@pytest.mark.parametrize("mode", ["interpret", False])
def test_front_chunks_is_bit_identical(scene, mode):
    """front_chunks=2 and 4 over K=4 frames equal front_chunks=1 bit for
    bit; against JAX's front_chunks=2 within the front's tolerance; a
    chunk count that does not divide K raises ValueError."""
    base = _torch_table(scene, "merged", seg_kernel=mode)
    for n in (2, 4):
        _bits_equal(_torch_table(scene, "merged", seg_kernel=mode,
                                 front_chunks=n), base)
    j = _jax_table(scene, "merged", seg_kernel=mode, front_chunks=2,
                   sort_bf16=False)
    _assert_tables(base, j, 2e-5 if mode == "interpret" else 2e-3)
    with pytest.raises(ValueError, match="must divide"):
        _torch_table(scene, "merged", seg_kernel=mode, front_chunks=3)


def test_bfloat16_fuse_matches_jax(scene, monkeypatch):
    """compute_dtype=bfloat16: keys, weights and hits exact against JAX
    (per-frame front) and against float32 (batched front); features within
    2**-6 x max|feature| of JAX with >= 90% within 1e-3 relative, and
    within the bf16 budget of float32.  The float32 fuse and one whose bf16
    matmul rounds the products miss the 90%."""
    j = _jax_table(scene, "merged", compute_dtype=jnp.bfloat16,
                   seg_kernel=False)
    t = _torch_table(scene, "merged", compute_dtype=torch.bfloat16,
                     seg_kernel=False)
    _assert_bf16_tables(t, j)
    f32_front = _torch_table(scene, "merged", seg_kernel=False)
    assert _share_close(f32_front[1], j[1], BF16_RTOL, BF16_ATOL) < 0.5
    with monkeypatch.context() as mp:
        mp.setattr(tnn, "mlp_apply", _mlp_products_rounded)
        wrong = _torch_table(scene, "merged", compute_dtype=torch.bfloat16,
                             seg_kernel=False)
    assert _share_close(wrong[1], j[1], BF16_RTOL, BF16_ATOL) < 0.5
    kw = dict(seg_kernel="interpret", sort_bf16=False)
    t = _torch_table(scene, "merged", compute_dtype=torch.bfloat16, **kw)
    f32 = _torch_table(scene, "merged", **kw)
    _assert_tables(t, f32, 0.02, rtol=0.02)
    assert not np.array_equal(t[1], f32[1])


def test_bfloat16_rounds_operands_not_products():
    """nn.mlp_apply in bfloat16 rounds each operand and multiplies in f32
    (the JAX package's preferred_element_type=float32).  Against a numpy
    model of that and against JAX's bf16 MLP: >= 99.9% of the outputs
    within 1e-5 relative, all within 2**-6 max|out|.  Rounding the products
    (torch's bf16 matmul), leaving one layer unrounded, and plain f32 each
    bring under half of the outputs within 1e-5 relative of the model."""
    from bnv_fusion_tpu import nn as jnn

    params = tnn.init_model(3, bias_std=0.1)["encoder"]
    x = torch.as_tensor(np.random.RandomState(0).randn(500, 6)
                        .astype(np.float32))
    out = tnn.mlp_apply(params, x, torch.bfloat16).numpy()

    def r(a):
        return torch.as_tensor(a).to(torch.bfloat16).to(torch.float32).numpy()

    p = {k: v.numpy() for k, v in params.items()}

    def model(skip=None):
        """Operand rounding in numpy; layer ``skip`` left unrounded."""
        h = r(x.numpy())
        for i in range(3):
            w = p[f"w{i}"] if i == skip else r(p[f"w{i}"])
            h = np.maximum(h.astype(np.float64) @ w + p[f"b{i}"],
                           0).astype(np.float32)
            h = h if i == skip else r(h)
        return h.astype(np.float64) @ r(p["w_out"]) + p["b_out"]

    want = model()
    jout = np.asarray(jnn.mlp_apply(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x.numpy()), jnp.bfloat16))
    for got in (out, jout):
        np.testing.assert_allclose(got, want,
                                   atol=2.0 ** -6 * np.abs(want).max(), rtol=0)
        assert _share_close(got, want, 1e-5) >= 0.999
    assert _share_close(out, jout, 1e-5) >= 0.999
    wrong = {"products rounded": _mlp_products_rounded(
                 params, x, torch.bfloat16).numpy(),
             "float32": tnn.mlp_apply(params, x).numpy(),
             **{f"layer {i} unrounded": model(skip=i) for i in range(3)}}
    for name, w in wrong.items():
        assert _share_close(w, want, 1e-5) < 0.5, name


@pytest.mark.parametrize("algorithm", ["cell", "corner"])
def test_cumsum_front_differs_only_by_rounding(scene, algorithm, monkeypatch):
    """The per-frame fronts' 2e-3 budget is their mean-centered f32
    cumsum's rounding and nothing else: with the cumsum (and the table's
    features) in float64, the same code gives the batched front's direct
    f32 segment sums within 1e-5 (1.7e-7 here), where the f32 cumsum
    misses 1e-5 (2.5e-4 cell, 1.2e-4 corner)."""
    kw = dict(max_unique=MU, algorithm=algorithm, max_unique_cells=MUC)
    direct = _torch_table(scene, "merged", seg_kernel="interpret")
    f32 = _torch_table(scene, tfusion.fuse_frame, **kw)
    cumsum, create = tfusion._cumsum_rows, ttables.create_table

    def create64(*a, **k):
        table = create(*a, **k)
        table.features = table.features.double()
        return table

    monkeypatch.setattr(tfusion, "_cumsum_rows",
                        lambda x: cumsum(x.double()))
    monkeypatch.setattr(ttables, "create_table", create64)
    f64 = _torch_table(scene, tfusion.fuse_frame, **kw)
    assert f64[1].dtype == np.float64
    _assert_tables(f64, direct, 1e-5)
    _assert_tables(f32, direct, 2e-3)
    assert np.abs(f32[1] - direct[1]).max() > 1e-5
