"""Port parity: local fusion and the TSDF prior of bnv_fusion_tpu_torch against
the JAX package, on the same numpy frames, points and weights.

Frames come from the analytic synthetic scene at 60x80 with voxel 0.03 (so
the scene's planes do not sit on voxel boundaries, where a 1-ulp difference
in the two frameworks' matrix products could move a point across a cell
face).  Tables are compared BY VOXEL KEY: keys, weights and hit counts
exactly.  Feature tolerances, by reduction path:
* batched front with direct segment sums (seg-reduce), exact f32: atol
  1e-5 (the two sides sum in different orders; features are O(1));
* per-frame front (mean-centered cumsum + difference, the path "auto" takes
  on CPU): atol 2e-3, the cancellation noise the JAX package documents for
  this path (tests/test_batch_integrate.py:256-259) — each side carries its
  own, in its own cumsum order;
* with ``fuse_sort_bf16`` the stage-2 partial sums are rounded to bfloat16
  on both sides; a last-bit difference before that rounding can move a
  partial sum by one bf16 step (2**-8 relative), so features are held to
  2**-7 * max|feature|.
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
from bnv_fusion_tpu import tsdf as jtsdf
from bnv_fusion_tpu import voxel as jvoxel
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import \
    SyntheticDemoDataset as JDataset
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import pipeline as tpipe
from bnv_fusion_tpu_torch import tables as ttables
from bnv_fusion_tpu_torch import tsdf as ttsdf
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.datasets.synth_scene import \
    SyntheticDemoDataset as TDataset

VOXEL = 0.03
MIN_PTS = 2
MU, MUC = 16384, 8192         # compaction widths (no overflow at 60x80)
CAP = 1 << 16
OVERRIDES = ["dataset.img_res=[60,80]", "dataset.num_images=6",
             f"model.voxel_size={VOXEL}"]


@pytest.fixture(scope="module")
def scene():
    cfg = jload_config(OVERRIDES)
    jds = JDataset(cfg, "val")
    tds = TDataset(tload_config(OVERRIDES), "val")
    frames = [jds[i] for i in range(3)]
    for i, f in enumerate(frames):   # the port's dataset copy renders the same
        g = tds[i]
        np.testing.assert_array_equal(g["depth"], f["depth"])
        np.testing.assert_array_equal(g["T_wc"], f["T_wc"])
    # non-zero biases (the init_model default zeroes them), so a dropped or
    # misplaced encoder bias shows in the fused features
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(0, bias_std=0.1))
    pts = [jax.tree.map(np.asarray, jpipe._frame_points(
        jnp.asarray(f["depth"]), jnp.asarray(f["T_wc"]),
        jnp.asarray(f["intr_mat"]))) for f in frames]
    pw, nw, va = (np.stack([p[j] for p in pts]) for j in range(3))
    mn, mx, n_xyz = jvoxel.get_world_range(jds.dimensions, VOXEL)
    return dict(frames=frames, params=params, pw=pw, nw=nw, va=va, mn=mn,
                mx=mx, n_xyz=n_xyz, dims=jds.dimensions)


def _by_key(keys, feats, w, h):
    order = np.lexsort(keys.T[::-1])
    return keys[order], feats[order], w[order], h[order]


def _jax_fuse(s, mode, sort_bf16):
    table = jtables.create_table(8, CAP, n_xyz=s["n_xyz"])
    params = jax.tree.map(jnp.asarray, s["params"])
    args = (jnp.asarray(s["mn"]), jnp.asarray(s["mx"]))
    if mode == "per_frame":
        fn = jax.jit(partial(jfusion.fuse_frame_cellsort, voxel_size=VOXEL,
                             min_pts_in_grid=MIN_PTS, max_unique=MU,
                             max_unique_cells=MUC))
        for k in range(s["pw"].shape[0]):
            table, _ = fn(table, params, jnp.asarray(s["pw"][k]),
                          jnp.asarray(s["nw"][k]), jnp.asarray(s["va"][k]),
                          *args)
    else:
        fn = jax.jit(partial(jfusion.fuse_frames_merged, voxel_size=VOXEL,
                             min_pts_in_grid=MIN_PTS, max_unique=MU,
                             max_unique_cells=MUC, seg_kernel=mode,
                             sort_bf16=sort_bf16))
        table, _ = fn(table, params, jnp.asarray(s["pw"]),
                      jnp.asarray(s["nw"]), jnp.asarray(s["va"]), *args)
    assert int(table.overflow) == 0
    keys, feats, w, h, _ = jtables.active_entries(table)
    return _by_key(keys, feats, w, h)


def _torch_fuse(s, mode, sort_bf16):
    table = ttables.create_table(8, CAP, n_xyz=s["n_xyz"])
    params = tnn.params_from_numpy(s["params"])
    t = torch.as_tensor
    args = (t(s["mn"]), t(s["mx"]), VOXEL, MIN_PTS)
    if mode == "per_frame":
        for k in range(s["pw"].shape[0]):
            tfusion.fuse_frame_cellsort(
                table, params, t(s["pw"][k]), t(s["nw"][k]), t(s["va"][k]),
                *args, max_unique=MU, max_unique_cells=MUC)
    else:
        tfusion.fuse_frames_merged(
            table, params, t(s["pw"]), t(s["nw"]), t(s["va"]), *args,
            max_unique=MU, max_unique_cells=MUC, seg_kernel=mode,
            sort_bf16=sort_bf16)
    assert int(table.overflow) == 0
    keys, feats, w, h, _ = ttables.active_entries(table)
    return _by_key(keys, feats, w, h)


@pytest.mark.parametrize("mode,sort_bf16", [
    ("interpret", False),      # batched front, plain seg-reduce / Pallas
    (False, False),            # "auto" on CPU: per-frame cumsum front
    ("interpret", True),       # + bf16 stage-2 partial sums (the default)
    ("per_frame", False),      # fuse_frame_cellsort, one frame at a time
])
def test_fused_tables_match_jax(scene, mode, sort_bf16):
    jk, jf, jw, jh = _jax_fuse(scene, mode, sort_bf16)
    tk, tf, tw, th = _torch_fuse(scene, mode, sort_bf16)
    assert len(jk) > 1000
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(th, jh)
    if sort_bf16:
        atol = 2.0 ** -7 * np.abs(jf).max()
    else:
        atol = 1e-5 if mode == "interpret" else 2e-3
    np.testing.assert_allclose(tf, jf, atol=atol, rtol=0)


def test_frame_points_match_jax(scene):
    """Back-projection + normals + the normal flip; points within 1e-6 m
    (last-bit differences of the two frameworks' matrix products)."""
    f = scene["frames"][0]
    t = torch.as_tensor
    pw, nw, va = tpipe._frame_points(t(f["depth"]), t(f["T_wc"]),
                                     t(f["intr_mat"]))
    np.testing.assert_array_equal(va.numpy(), scene["va"][0])
    np.testing.assert_allclose(pw.numpy(), scene["pw"][0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(nw.numpy(), scene["nw"][0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("windowed", [False, True], ids=["full", "windowed"])
def test_tsdf_prior_matches_jax(scene, windowed):
    """Dense prior over 3 frames at obs_weight 4 (the tsdf_every cadence),
    then prepare_sdf_delta.  A voxel whose projection lands within float
    noise of a pixel boundary may round to the neighbouring pixel on one
    side only, so at most 0.1% of voxels may differ; the rest agree within
    1e-5 (normalized units)."""
    vs_t = 0.025
    jvol, _ = jtsdf.create_tsdf_volume(scene["dims"], vs_t)
    tvol, _ = ttsdf.create_tsdf_volume(scene["dims"], vs_t)
    intr0 = scene["frames"][0]["intr_mat"]
    window = jtsdf.frustum_window_shape(
        intr0, scene["frames"][0]["depth"].shape, 0.8, vs_t, jvol.sdf.shape)
    assert window == ttsdf.frustum_window_shape(
        intr0, scene["frames"][0]["depth"].shape, 0.8, vs_t, jvol.sdf.shape)
    assert np.prod(window) < np.prod(jvol.sdf.shape)
    for f in scene["frames"]:
        d, T, K = f["depth"], f["T_wc"], f["intr_mat"]
        if windowed:
            jvol = jax.jit(partial(jtsdf.integrate_windowed, voxel_size=vs_t,
                                   window=window, max_depth=0.8,
                                   obs_weight=4.0))(
                jvol, jnp.asarray(d), jnp.asarray(K), jnp.asarray(T))
            ttsdf.integrate_windowed(tvol, torch.as_tensor(d),
                                     torch.as_tensor(K), torch.as_tensor(T),
                                     vs_t, window, 0.8, obs_weight=4.0)
        else:
            jvol = jtsdf.integrate(jvol, jnp.asarray(d), jnp.asarray(K),
                                   jnp.asarray(T), vs_t, obs_weight=4.0)
            ttsdf.integrate(tvol, torch.as_tensor(d), torch.as_tensor(K),
                            torch.as_tensor(T), vs_t, obs_weight=4.0)
    jd = np.asarray(jtsdf.prepare_sdf_delta(jvol, vs_t, 0.1, 0.1))
    td = ttsdf.prepare_sdf_delta(tvol, vs_t, 0.1, 0.1).numpy()
    jw, tw = np.asarray(jvol.weight), tvol.weight.numpy()
    assert (jw > 0).sum() > 1000
    bad = (np.abs(jd - td) > 1e-5) | (jw != tw)
    assert bad.mean() <= 1e-3, bad.sum()


def test_voxel_math_and_lookups_match_jax(scene):
    """Corner enumeration, trilinear weights, local offsets, flat-id round
    trips and the dense-table lookups (both forms) on the fused table."""
    from bnv_fusion_tpu import table_dense as jtd
    from bnv_fusion_tpu_torch import table_dense as ttd
    from bnv_fusion_tpu_torch import voxel as tvoxel

    rng = np.random.RandomState(5)
    coords = (rng.rand(4000, 3) * np.asarray(scene["n_xyz"])).astype(
        np.float32)
    coords[:50] = np.floor(coords[:50])      # integer coords: collapsed corners
    jc = jvoxel.corner_neighbors(jnp.asarray(coords))
    tc = tvoxel.corner_neighbors(torch.as_tensor(coords))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(
        tvoxel.trilinear_weights(torch.as_tensor(coords), tc).numpy(),
        np.asarray(jvoxel.trilinear_weights(jnp.asarray(coords), jc)),
        rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tvoxel.local_offsets(torch.as_tensor(coords), tc).numpy(),
        np.asarray(jvoxel.local_offsets(jnp.asarray(coords), jc)))
    flat = tvoxel.flatten_coords(tc.reshape(-1, 3).long(), scene["n_xyz"])
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jvoxel.flatten_coords(
            jc.reshape(-1, 3), jnp.asarray(scene["n_xyz"]))))
    np.testing.assert_array_equal(
        tvoxel.unflatten_ids(flat, scene["n_xyz"]).numpy(),
        np.asarray(jvoxel.unflatten_ids(jnp.asarray(flat.numpy()),
                                        jnp.asarray(scene["n_xyz"]))))

    jtable = jtables.create_table(8, CAP, n_xyz=scene["n_xyz"])
    jtable, _ = jax.jit(partial(
        jfusion.fuse_frames_merged, voxel_size=VOXEL, min_pts_in_grid=MIN_PTS,
        max_unique=MU, max_unique_cells=MUC))(
        jtable, jax.tree.map(jnp.asarray, scene["params"]),
        jnp.asarray(scene["pw"]), jnp.asarray(scene["nw"]),
        jnp.asarray(scene["va"]), jnp.asarray(scene["mn"]),
        jnp.asarray(scene["mx"]))
    keys, feats, w, h, _ = jtables.active_entries(jtable)
    ttable = ttd.load_entries(scene["n_xyz"], CAP, keys, feats, w, h)
    q = tc.reshape(-1, 3)
    js, jf = jtd.lookup(jtable, jnp.asarray(q.numpy()))
    ts, tf = ttd.lookup(ttable, q)
    assert np.asarray(jf).sum() > 0
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    inside = torch.all((q >= 0) & (q < torch.as_tensor(scene["n_xyz"])), -1)
    ts3, tf3 = ttd.lookup_coords3(ttable, q[:, 0], q[:, 1], q[:, 2], inside)
    np.testing.assert_array_equal(ts3.numpy(), ts.numpy())
    np.testing.assert_array_equal(tf3.numpy(), tf.numpy())


def test_sample_pdf_matches_jax():
    from bnv_fusion_tpu import render as jrender
    from bnv_fusion_tpu_torch import render as trender

    rng = np.random.RandomState(2)
    bins = np.sort(rng.rand(64, 17).astype(np.float32), axis=-1)
    weights = rng.rand(64, 16).astype(np.float32)
    ref = np.asarray(jrender.sample_pdf(None, jnp.asarray(bins),
                                        jnp.asarray(weights), 24, det=True))
    out = trender.sample_pdf(torch.as_tensor(bins), torch.as_tensor(weights),
                             24)
    # the CDF is a float32 cumsum over 16 bins, summed in another order
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)


def test_create_table_routes_dense_only():
    """Only grids below DENSE_MAP_MAX_VOXELS get the dense table; a bigger
    one routes to blocks and no bounds to the hash table, as in the JAX
    package (tests/test_torch_table_blocks.py holds the policy)."""
    t = ttables.create_table(8, 16, n_xyz=(10, 10, 10))
    assert t.n_voxels == 1000 and hasattr(t, "slot_map")
    assert not hasattr(ttables.create_table(8, 16), "n_xyz")
    big = ttables.create_table(8, 16, n_xyz=(1024, 1024, 1024))
    assert not hasattr(big, "slot_map") and big.n_voxels == 1024 ** 3
