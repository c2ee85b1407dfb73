"""Port parity of the offline fuse -> refine flow: the pieces the refiner
adds (grid_transform, the noisy-depth TSDF prior, DepthNoiseSimulator),
saved maps read across the two packages, and the port's test.py ->
train.py refiner CLI end to end on the CPU.

Operating point: 60x80 frames of the synthetic demo scene, voxel 0.05
(the e2e parity test's: no back-projected point lies within float noise of
a voxel face there), min_pts_in_grid 0, 200 rays in chunks of 100.
Tolerances: tables exact by voxel key; the noisy-depth prior, whose voxel
centres are projected through a 3x3 product that may differ in the last
bit between the frameworks and then rounded to a pixel, within 1e-6 (metric)
on all but 0.1% of voxels (observed: every voxel within 2.4e-7);
grid_transform within 1e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import geometry as jgeo
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu import tsdf as jtsdf
from bnv_fusion_tpu import voxel as jvx
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.pipeline import NeuralMap as JNeuralMap
from bnv_fusion_tpu_torch import geometry as tgeo
from bnv_fusion_tpu_torch import mesh as tmesh
from bnv_fusion_tpu_torch import tables as ttables
from bnv_fusion_tpu_torch import test as ttest
from bnv_fusion_tpu_torch import train as ttrain
from bnv_fusion_tpu_torch import tsdf as ttsdf
from bnv_fusion_tpu_torch import voxel as tvx
from bnv_fusion_tpu_torch.checkpoint import load_state, save_state
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu_torch.models.fusion_refiner import FusionRefiner
from bnv_fusion_tpu_torch.nn import init_model
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

VOXEL = 0.05
OVERRIDES = ["dataset.img_res=[60,80]", "dataset.num_images=4",
             f"model.voxel_size={VOXEL}", "model.min_pts_in_grid=0",
             "model.table_capacity=65536", "dataset.num_pixels=200",
             "model.train_ray_splits=100"]
PRIOR_ATOL, PRIOR_BUDGET = 1e-6, 1e-3


def _params_np():
    return {n: {k: v.numpy() for k, v in p.items()}
            for n, p in init_model(0, bias_std=0.1).items()}


def _by_key(keys, *cols):
    order = np.lexsort(np.asarray(keys).T[::-1])
    return [np.asarray(keys)[order]] + [np.asarray(c)[order] for c in cols]


def _assert_tables_equal(a, b):
    for x, y, what in zip(_by_key(*a), _by_key(*b),
                          ("keys", "features", "weights", "hits")):
        np.testing.assert_array_equal(x, y, err_msg=what)


def test_grid_transform_matches_jax():
    rng = np.random.RandomState(0)
    src = rng.randn(7, 9, 5).astype(np.float32)
    kw = dict(src_min=np.float32(-0.3), src_voxel=np.float32(0.1),
              dst_min=np.array([-0.5, -0.2, -0.35], np.float32),
              dst_voxel=np.array([0.07, 0.13, 0.05], np.float32),
              dst_shape=(12, 8, 10))
    ref = np.asarray(jvx.grid_transform(jnp.asarray(src), **kw))
    out = tvx.grid_transform(torch.as_tensor(src), **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_depth_noise_simulator_bit_equal():
    depth = np.random.RandomState(1).uniform(0.3, 3.0, (60, 80))
    depth[::7, ::5] = 0.0
    depth = depth.astype(np.float32)
    a, b = tgeo.DepthNoiseSimulator(seed=3), jgeo.DepthNoiseSimulator(seed=3)
    for _ in range(2):
        np.testing.assert_array_equal(a.simulate(depth), b.simulate(depth))


def _noisy_prior_jax(ds, seed, voxel, dst_shape):
    """The JAX refiner's noisy-depth prior (fusion_refiner.py:56-96),
    normalized as it installs it."""
    sim = jgeo.DepthNoiseSimulator(seed=seed)
    mn, _, n_xyz = jvx.get_world_range(ds.dimensions, voxel)
    frames = [ds[i] for i in range(len(ds))]
    sdf, w = jtsdf.accumulate_tsdf_window(
        [sim.simulate(np.asarray(f["depth"], np.float32)) for f in frames],
        [f["T_wc"] for f in frames], [f["intr_mat"] for f in frames],
        mn, tuple(int(x) for x in n_xyz), voxel)
    metric = np.asarray(sdf)
    ratio = ((np.asarray(metric.shape, np.float64) - 1.0) /
             np.maximum(np.asarray(dst_shape, np.float64) - 1.0, 1.0))
    metric = np.asarray(jvx.grid_transform(
        jnp.asarray(metric, jnp.float32), src_min=jnp.zeros(3, jnp.float32),
        src_voxel=jnp.ones(3, jnp.float32), dst_min=jnp.zeros(3, jnp.float32),
        dst_voxel=jnp.asarray(ratio, jnp.float32), dst_shape=dst_shape))
    return np.asarray(sdf), np.asarray(w), metric / (0.025 * 5.0)


def test_accumulate_tsdf_window_matches_jax():
    cfg = tload_config(OVERRIDES + ["device_type=cpu"])
    ds = SyntheticDemoDataset(cfg, "val")
    sim = tgeo.DepthNoiseSimulator(seed=0)
    mn, _, n_xyz = tvx.get_world_range(ds.dimensions, VOXEL)
    frames = [ds[i] for i in range(len(ds))]
    sdf, w = ttsdf.accumulate_tsdf_window(
        [sim.simulate(np.asarray(f["depth"], np.float32)) for f in frames],
        [f["T_wc"] for f in frames], [f["intr_mat"] for f in frames],
        mn, tuple(int(x) for x in n_xyz), VOXEL)
    jsdf, jw, _ = _noisy_prior_jax(ds, 0, VOXEL, (4, 4, 4))
    assert jw.max() == len(frames) and (jw > 0).mean() > 0.02
    bad = np.abs(sdf.numpy() - jsdf) > PRIOR_ATOL
    assert bad.mean() <= PRIOR_BUDGET, bad.sum()
    assert np.mean(w.numpy() != jw) <= PRIOR_BUDGET


@pytest.fixture(scope="module")
def offline_run(tmp_path_factory):
    """The port's test.main at the operating point, then its refiner."""
    out = tmp_path_factory.mktemp("offline")
    save_state(str(out / "weights.npz"), {"params": _params_np()})
    common = OVERRIDES + ["device_type=cpu", f"output_dir={out}",
                          f"trainer.checkpoint={out / 'weights.npz'}"]
    assert ttest.main(common) == 0
    fused = ttest.run(common)
    prefix = fused["prefix"]
    refined = ttrain.run(
        common + ["model=fusion_refiner_model", "trainer.max_epochs=1",
                     f"model.sparse_volume_path={prefix}_sparse_volume.npz",
                     f"model.tsdf_prior_path={prefix}_tsdf.npy"])
    return dict(out=out, fused=fused, refined=refined, prefix=prefix)


def test_offline_cli_flow_writes_refined_map(offline_run):
    fused, refined = offline_run["fused"], offline_run["refined"]
    prefix = offline_run["prefix"]
    for suffix in (".ply", "_sparse_volume.npz", "_tsdf.npy"):
        assert os.path.exists(prefix + suffix), suffix
    rmap = refined["refiner"].nmap
    wd = refined["out_dir"]
    m = tmesh.load_ply(os.path.join(wd, "refined_0.ply"))
    assert len(m.vertices) > 0 and np.all(np.isfinite(m.vertices))
    assert os.path.exists(os.path.join(wd, "refined_sparse_volume.npz"))
    assert len(rmap.optimize_losses) == len(rmap.frames) == 4
    assert np.all(np.isfinite(rmap.optimize_losses))
    saved = load_state(prefix + "_sparse_volume.npz")
    rk = ttables.active_entries(rmap.table, with_features=False)[0]
    np.testing.assert_array_equal(_by_key(rk)[0],
                                  _by_key(saved["active_coordinates"])[0])
    # the prior came in as saved (metric -> normalized)
    np.testing.assert_allclose(
        rmap.tsdf_vol.sdf.numpy(),
        np.load(prefix + "_tsdf.npy") / np.float32(0.125), atol=1e-6)
    assert len(fused["nmap"].stats) == 4
    assert fused["nmap"].overflow == 0 == rmap.overflow


def test_port_map_loads_in_jax_and_back(offline_run, tmp_path):
    tnm, prefix = offline_run["fused"]["nmap"], offline_run["prefix"]
    params = _params_np()
    jcfg = jload_config(OVERRIDES)
    jnm = JNeuralMap(tnm.dimensions, jcfg, params)
    jnm.load_map(prefix)
    jk, jf, jw, jh, _ = jtables.active_entries(jnm.table)
    tk, tf, tw, th, _ = ttables.active_entries(tnm.table)
    assert len(tk) > 1000
    _assert_tables_equal((jk, jf, jw, jh), (tk, tf, tw, th))
    np.testing.assert_allclose(np.asarray(jnm.tsdf_vol.sdf),
                               tnm.tsdf_vol.sdf.numpy(), atol=1e-6)

    # the reverse: a map fused and saved by the JAX package
    ds = SyntheticDemoDataset(tload_config(OVERRIDES), "val")
    jnm2 = JNeuralMap(ds.dimensions, jcfg, params)
    for i in range(2):
        jnm2.integrate(ds[i])
    jprefix = str(tmp_path / "jax_map")
    jnm2.save(jprefix)
    tnm2 = TNeuralMap(ds.dimensions,
                      tload_config(OVERRIDES + ["device_type=cpu"]), params)
    tnm2.load_map(jprefix)
    _assert_tables_equal(jtables.active_entries(jnm2.table)[:4],
                         ttables.active_entries(tnm2.table)[:4])
    np.testing.assert_allclose(tnm2.tsdf_vol.sdf.numpy(),
                               np.asarray(jnm2.tsdf_vol.sdf), atol=1e-6)
    assert float(tnm2.tsdf_vol.weight.min()) == 1.0


def _refiner(extra, tmp_path, iters=1):
    cfg = tload_config(OVERRIDES + ["device_type=cpu",
                                    "model=fusion_refiner_model"] + extra)
    ds = SyntheticDemoDataset(cfg, "val")
    ref = FusionRefiner(cfg, _params_np())
    ref.run(ds, str(tmp_path / "refine"), n_epochs=1, iters_per_epoch=iters)
    return ref, ds


def test_refiner_resamples_mismatched_prior(tmp_path):
    """A prior saved at another resolution is resampled trilinearly with
    align_corners=True semantics: a linear ramp stays an exact ramp."""
    src = (np.arange(5, dtype=np.float32)[:, None, None] *
           np.ones((5, 7, 9), np.float32))
    path = str(tmp_path / "coarse_tsdf.npy")
    np.save(path, src)
    ref, _ = _refiner([f"model.tsdf_prior_path={path}"], tmp_path)
    metric = ref.nmap.tsdf_vol.sdf.numpy() * 0.125
    dx = metric.shape[0]
    np.testing.assert_allclose(metric[:, 1, 1],
                               np.arange(dx) * (5 - 1) / (dx - 1), atol=1e-4)
    assert float(ref.nmap.tsdf_vol.weight.min()) == 1.0


def test_refiner_noisy_depth_prior_matches_jax(tmp_path):
    ref, ds = _refiner(["model.prior_from_noisy_depth=true"], tmp_path)
    got = ref.nmap.tsdf_vol.sdf.numpy()
    *_, want = _noisy_prior_jax(ds, 12345, VOXEL, got.shape)
    bad = np.abs(got - want) > PRIOR_ATOL / 0.125
    assert bad.mean() <= PRIOR_BUDGET, bad.sum()
