"""Port parity of the whole slice: NeuralMap of both packages on the same tiny
synthetic stream and weights, plus the port's run_e2e CLI and its guards.

Operating point: 60x80 frames, 4 of them, K=2 frames per table update,
voxel 0.05: each package back-projects the frames itself, and the two
frameworks' 3x3 matrix products differ in the last bit, so a point that lies
within float noise of a voxel face can land in another cell on one side.
The synthetic stream has whole pixel rows on such faces at some voxel sizes
(0.03 and 0.04 among them); at 0.05 none of its points is that close.
min_pts_in_grid 0 (at this resolution no voxel
reaches the default weight of 8, and the mesh gate would drop them all),
200 rays in chunks of 100, 2 global steps.  Fusion takes the batched
front with the plain segmented reduce and exact-f32 partial sums
(use_seg_reduce_kernel=interpret, fuse_sort_bf16=false): the path the CUDA
kernel runs on the card, at the settings where both packages sum each
segment directly.  The cumsum front's float noise (tests/test_torch_fusion.py)
would be amplified here, because an untrained decoder's level set is
flat and moves far for a small change of the latents.

Checked: equal active voxel keys after fusion; before_optim meshes whose
mutual F-score at voxel/4 is >= 0.99 (the decode differs only in float
rounding, which moves vertices by far less than voxel/4); a map saved by the
port is read back by the JAX package's NeuralMap.load_map.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import nn as jnn
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu.pipeline import NeuralMap as JNeuralMap
from bnv_fusion_tpu_torch import evaluation, mesh as tmesh
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import run_e2e
from bnv_fusion_tpu_torch import tables as ttables
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

VOXEL = 0.05
OVERRIDES = ["dataset.img_res=[60,80]", "dataset.num_images=4",
             f"model.voxel_size={VOXEL}", "model.integrate_batch_size=2",
             "dataset.num_pixels=200", "model.train_ray_splits=100",
             "trainer.global_steps=2", "model.min_pts_in_grid=0",
             "model.table_capacity=65536",
             "model.use_seg_reduce_kernel=interpret",
             "model.fuse_sort_bf16=false"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def maps():
    jcfg = jload_config(OVERRIDES)
    tcfg = tload_config(OVERRIDES + ["device_type=cpu"])
    ds = SyntheticDemoDataset(jcfg, "val")
    frames = [ds[i] for i in range(len(ds))]
    params = jax.tree.map(np.asarray, jnn.init_model(jax.random.key(0)))
    jnm = JNeuralMap(ds.dimensions, jcfg, params)
    tnm = TNeuralMap(ds.dimensions, tcfg, params)
    for i in range(0, len(frames), 2):
        jnm.integrate_batch(frames[i:i + 2])
        tnm.integrate_batch(frames[i:i + 2])
    # untrained weights decode an SDF of one sign almost everywhere; shift
    # the decoder's output bias by the median decoded value at the voxel
    # centers so the level set crosses the map (same weights on both sides)
    keys = ttables.active_entries(tnm.table, with_features=False)[0]
    with torch.no_grad():
        sdf = tfusion.decode_points(
            tnm.table.features, tnm.table, tnm.params,
            torch.as_tensor(keys + 0.5, dtype=torch.float32), tnm.bound_min,
            VOXEL, 0, is_coords=True)
    params["decoder"]["b_out"] = params["decoder"]["b_out"] - \
        np.float32(np.median(sdf.numpy()) / VOXEL)
    tnm.params["decoder"]["b_out"] = torch.as_tensor(
        params["decoder"]["b_out"])
    return dict(jnm=jnm, tnm=tnm, ds=ds, params=params, jcfg=jcfg)


def _sorted_keys(k):
    return k[np.lexsort(k.T[::-1])]


def test_fused_keys_and_before_optim_mesh_match_jax(maps):
    jnm, tnm = maps["jnm"], maps["tnm"]
    jk = jtables.active_entries(jnm.table, with_features=False)[0]
    tk = ttables.active_entries(tnm.table, with_features=False)[0]
    assert len(jk) > 1000
    np.testing.assert_array_equal(_sorted_keys(tk), _sorted_keys(jk))
    assert tnm.overflow == 0 == jnm.overflow

    jmesh, tmesh_ = jnm.extract_mesh(), tnm.extract_mesh()
    assert jmesh is not None and tmesh_ is not None
    pj = tmesh.sample_surface(tmesh.Mesh(np.asarray(jmesh.vertices),
                                         np.asarray(jmesh.faces)), 20000, 0)
    pt = tmesh.sample_surface(tmesh_, 20000, 0)
    res = evaluation.fscore_points(pt, pj, VOXEL / 4)
    assert res["fscore"] >= 0.99, res


def test_per_frame_integrate_matches_jax(maps):
    """NeuralMap.integrate (the K=1 flush of run_e2e): keys and the TSDF
    prior after one frame."""
    jcfg = maps["jcfg"]
    tcfg = tload_config(OVERRIDES + ["device_type=cpu"])
    frame = maps["ds"][1]
    jnm = JNeuralMap(maps["ds"].dimensions, jcfg, maps["params"])
    tnm = TNeuralMap(maps["ds"].dimensions, tcfg, maps["params"])
    jnm.integrate(frame)
    tnm.integrate(frame)
    jk = jtables.active_entries(jnm.table, with_features=False)[0]
    tk = ttables.active_entries(tnm.table, with_features=False)[0]
    assert len(jk) > 500
    np.testing.assert_array_equal(_sorted_keys(tk), _sorted_keys(jk))
    np.testing.assert_allclose(tnm.tsdf_vol.sdf.numpy(),
                               np.asarray(jnm.tsdf_vol.sdf), atol=1e-5)


def test_raw_depth_staging_matches_jax(maps):
    """uint16 sensor depth (dataset.stage_raw_depth) -> metric depth, as
    integrate_batch stages it: bit-identical."""
    cfg = jload_config(OVERRIDES + ["dataset.stage_raw_depth=true"])
    frames = [SyntheticDemoDataset(cfg, "val")[i] for i in range(2)]
    jnm, tnm = maps["jnm"], maps["tnm"]
    staged = jnm._stack_batch(frames)
    tstaged = tnm._stack_batch(frames)
    np.testing.assert_array_equal(tstaged["raw"], staged["raw"])
    jd = np.asarray(jnm._convert_raw_depth(jax.numpy.asarray(staged["raw"]),
                                           staged["scale"]))
    td = tnm._convert_raw_depth(tstaged["raw"], tstaged["scale"]).numpy()
    np.testing.assert_array_equal(td, jd)


def test_port_saved_map_loads_in_jax(maps, tmp_path):
    tnm = maps["tnm"]
    tnm.optimize(n_iters=2)
    assert len(tnm.optimize_losses) == 2
    assert np.all(np.isfinite(tnm.optimize_losses))
    prefix = str(tmp_path / "final")
    tnm.save(prefix)
    jnm2 = JNeuralMap(maps["ds"].dimensions, maps["jcfg"], maps["params"])
    jnm2.load_map(prefix)
    jk, jf, jw, jh, _ = jtables.active_entries(jnm2.table)
    tk, tf, tw, th, _ = ttables.active_entries(tnm.table)
    oj, ot = np.lexsort(jk.T[::-1]), np.lexsort(tk.T[::-1])
    np.testing.assert_array_equal(jk[oj], tk[ot])
    np.testing.assert_array_equal(jf[oj], tf[ot])
    np.testing.assert_array_equal(jw[oj], tw[ot])
    np.testing.assert_array_equal(jh[oj], th[ot])
    np.testing.assert_allclose(
        np.asarray(jnm2.tsdf_vol.sdf), tnm.tsdf_vol.sdf.numpy(), atol=1e-6)


def test_run_e2e_cli_writes_outputs(tmp_path):
    """The port's entry point end to end on the CPU: meshes, map and the
    F-score report."""
    out = run_e2e.run(OVERRIDES + ["device_type=cpu",
                                   f"output_dir={tmp_path}"])
    wd = out["working_dir"]
    for name in ("before_optim.ply", "final.ply", "final_sparse_volume.npz",
                 "final_tsdf.npy"):
        assert os.path.exists(os.path.join(wd, name)), name
    m = tmesh.load_ply(os.path.join(wd, "final.ply"))
    assert len(m.vertices) > 0 and np.all(np.isfinite(m.vertices))
    assert set(out["fscores"]) == {0.025, 0.01}


def test_cuda_device_type_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tload_config(OVERRIDES + ["device_type=cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TNeuralMap(np.array([2.6, 2.6, 1.6], np.float32), cfg,
                   run_e2e.load_params(cfg))
    cfg = tload_config(OVERRIDES)          # the repo default, device_type=tpu
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TNeuralMap(np.array([2.6, 2.6, 1.6], np.float32), cfg,
                   run_e2e.load_params(cfg))


@pytest.mark.parametrize("override,error,match", [
    ("trainer.fuse_devices=2", ValueError, "requested 2 devices, have 1"),
    ("trainer.optimize_devices=2", ValueError, "requested 2 devices, have 1"),
    ("trainer.pretrain_devices=2", ValueError, "requested 2 devices, have 1"),
    ("model.table_layout=spatial", ValueError,
     r"needs trainer\.fuse_devices > 1")])
def test_unsupported_options_raise(override, error, match):
    """A device count above 1 without a process group of that size raises
    the launcher's ValueError (it names torchrun); the region-sharded
    layout on one device raises the JAX package's ValueError."""
    cfg = tload_config(OVERRIDES + ["device_type=cpu", override])
    with pytest.raises(error, match=match) as info:
        TNeuralMap(np.array([2.6, 2.6, 1.6], np.float32), cfg,
                   run_e2e.load_params(cfg))
    if "_devices" in override:
        assert "torchrun --nproc_per_node=2" in str(info.value)


@pytest.mark.parametrize("override", [
    "model.table_layout=dense", "trainer.fuse_devices=all",
    "trainer.fuse_devices=0", "trainer.optimize_devices=all",
    "trainer.pretrain_devices=all"])
def test_single_device_values_run(override):
    """Values the JAX package runs on one device run the single-device path
    here at a world of 1: any table layout but spatial as auto, and a
    device count of all / 0 as the world size."""
    cfg = tload_config(OVERRIDES + ["device_type=cpu", override])
    ds = SyntheticDemoDataset(jload_config(OVERRIDES), "val")
    nm = TNeuralMap(ds.dimensions, cfg, run_e2e.load_params(cfg))
    assert nm._fuse_devices == nm._optimize_devices == 1
    assert nm._group is None
    nm.integrate_batch([ds[0], ds[1]])
    nm.optimize(1)
    assert int(nm.table.n_alloc) > 0 and len(nm.optimize_losses) == 1
    assert np.isfinite(nm.optimize_losses).all()


# the model and trainer options of the dense single-device path, each alone
# and all together (with the fused decode off, so mesh_decode_layout=fm is
# the layout the mesh takes on the card too)
OPTIONS = {
    "optim_dtype": ["model.optim_dtype=bfloat16"],
    "fuse_color": ["model.fuse_color=true", "dataset.load_color=true"],
    "error_guided_sampling": ["model.error_guided_sampling=true"],
    "optim_early_stop": ["trainer.optim_early_stop=true",
                         "trainer.optim_es_patience=1",
                         "trainer.global_steps=12"],
    "decode_layout": ["model.decode_layout=fm"],
    "mesh_decode_layout": ["model.mesh_decode_layout=fm"],
}
OPTIONS["all"] = [o for v in OPTIONS.values() for o in v]


@pytest.mark.parametrize("name", list(OPTIONS))
def test_run_e2e_with_option(name, tmp_path):
    """run_e2e on the CPU with each ported option: finite losses and
    latents, non-empty PLYs (coloured under fuse_color), the error maps
    and early-stop count where they apply."""
    out = run_e2e.run(OVERRIDES + OPTIONS[name] + [
        "device_type=cpu", "model.use_fused_decode_kernel=false",
        "model.mesh_decode_batch=16384", f"output_dir={tmp_path}"])
    nm, wd = out["nmap"], out["working_dir"]
    assert np.all(np.isfinite(nm.optimize_losses))
    assert len(nm.optimize_losses) == nm.last_optimize_iters > 0
    assert torch.isfinite(nm.table.features).all()
    for ply in ("before_optim.ply", "final.ply"):
        m = tmesh.load_ply(os.path.join(wd, ply))
        assert len(m.vertices) > 0 and len(m.faces) > 0
        assert np.all(np.isfinite(m.vertices))
        assert (m.colors is not None) == ("model.fuse_color=true"
                                          in OPTIONS[name])
    if "model.error_guided_sampling=true" in OPTIONS[name]:
        assert nm.error_maps and all(tuple(v.shape) == (3, 5)
                                     for v in nm.error_maps.values())
    if "trainer.optim_early_stop=true" in OPTIONS[name]:
        assert nm.last_optimize_iters <= 12 and \
            nm.last_optimize_iters % 4 == 0


def test_fuse_color_frame_with_only_an_img_path_raises(tmp_path):
    """A fuse_color frame whose colour is only an img_path is decoded (the
    colours themselves are held in tests/test_torch_datasets.py); a file
    that is no readable image raises the codec's ValueError."""
    cfg = tload_config(OVERRIDES + ["device_type=cpu", "model.fuse_color=true"])
    frame = dict(SyntheticDemoDataset(jload_config(OVERRIDES), "val")[0])
    frame.pop("rgb", None)
    img = tmp_path / "frame.png"
    img.write_bytes(b"\x89PNG\r\n")
    frame["img_path"] = str(img)
    nm = TNeuralMap(np.array([2.6, 2.6, 1.6], np.float32), cfg,
                    run_e2e.load_params(cfg))
    for fuse in (nm.integrate, lambda f: nm.integrate_batch([f, f])):
        with pytest.raises(ValueError, match="PNG"):
            fuse(frame)


def test_port_runs_without_jax():
    """Import the port and fuse a tiny frame in a fresh interpreter where
    importing jax (or flax/optax/sklearn/yaml/cv2/PIL/imageio/torchvision/
    open3d/trimesh/the JAX package) fails; import every reader, the codec,
    the profiling tools and the six scripts, read a canonical frame with
    its colour that the port itself wrote, and fuse and mesh on the block
    table and block-major prior and fuse into the hash table."""
    code = r"""
import builtins, os, sys
blocked = ("jax", "jaxlib", "flax", "optax", "sklearn", "yaml", "cv2",
           "bnv_fusion_tpu", "PIL", "imageio", "torchvision", "open3d",
           "trimesh")
real_import = builtins.__import__
def guarded(name, *a, **k):
    if name.split(".")[0] in blocked:
        raise ImportError("blocked: " + name)
    return real_import(name, *a, **k)
builtins.__import__ = guarded
import numpy as np, torch
from bnv_fusion_tpu_torch import fusion, tables, table_dense, nn, mesh
from bnv_fusion_tpu_torch.config import load_config
from bnv_fusion_tpu_torch.datasets import get_dataset
from bnv_fusion_tpu_torch.pipeline import _frame_points
import bnv_fusion_tpu_torch.run_e2e, bnv_fusion_tpu_torch.kernels
import bnv_fusion_tpu_torch.train, bnv_fusion_tpu_torch.test
import bnv_fusion_tpu_torch.models.local_point_fusion
import bnv_fusion_tpu_torch.models.fusion_refiner
import bnv_fusion_tpu_torch.dense_grid, bnv_fusion_tpu_torch.utils.vis
import bnv_fusion_tpu_torch.incremental_mesh
import bnv_fusion_tpu_torch.utils.live_viewer
import bnv_fusion_tpu_torch.parallel.dryrun
from bnv_fusion_tpu_torch.parallel import launch, make_mesh
assert make_mesh().size == 1 and launch.is_main_process()
from bnv_fusion_tpu_torch.kernels.fused_mlp import FusedMLP
from bnv_fusion_tpu_torch.models import get_model
assert get_model("lit_fusion_pointnet") and get_model("lit_fusion_refiner")
enc = nn.init_model(0)["encoder"]
assert FusedMLP(enc)(torch.ones(3, 6)).shape == (3, 8)
cfg = load_config(["dataset.img_res=[30,40]", "dataset.num_images=2"])
f = get_dataset(cfg, "val")[0]
t = torch.as_tensor
pw, nw, va = _frame_points(t(f["depth"]), t(f["T_wc"]), t(f["intr_mat"]))
table = tables.create_table(8, 4096, n_xyz=(70, 70, 45))
fusion.fuse_frame_cellsort(table, nn.init_model(0), pw, nw, va,
                           t([-1.34, -1.34, -0.84]), t([1.34, 1.34, 0.84]),
                           0.04, 1, max_unique=4096, max_unique_cells=2048)
assert int(table.n_alloc) > 0
g, c = fusion.frame_width_counts(pw, va, t([-1.34, -1.34, -0.84]),
                                 t([1.34, 1.34, 0.84]), 0.04, (70, 70, 45),
                                 70 * 70 * 45)
assert 0 < int(g) <= int(c)
corner = tables.create_table(8, 4096, n_xyz=(70, 70, 45))
fusion.fuse_frame(corner, nn.init_model(0), pw, nw, va,
                  t([-1.34, -1.34, -0.84]), t([1.34, 1.34, 0.84]), 0.04, 1,
                  compute_dtype=torch.bfloat16, max_unique=8192,
                  algorithm="corner")
assert int(tables.occupancy(corner)) == int(c)
slots, ok = tables.insert(corner, t([[1, 2, 3], [1, 2, 3]]),
                          t([True, True]))
assert bool(ok.all()) and int(slots[0]) == int(slots[1])
assert len(mesh.cell_owner_voxel(np.zeros((2, 3), np.int64))) == 2
# the model and trainer options: optimize and mesh with all six on
from bnv_fusion_tpu_torch.pipeline import NeuralMap
ocfg = load_config(["device_type=cpu", "dataset.img_res=[30,40]",
                    "dataset.num_images=2", "dataset.load_color=true",
                    "model.voxel_size=0.08", "model.min_pts_in_grid=0",
                    "model.table_capacity=16384", "dataset.num_pixels=64",
                    "model.train_ray_splits=32", "model.fuse_color=true",
                    "model.optim_dtype=bfloat16",
                    "model.error_guided_sampling=true",
                    "trainer.optim_early_stop=true",
                    "model.decode_layout=fm", "model.mesh_decode_layout=fm"])
ods = get_dataset(ocfg, "val")
onm = NeuralMap(ods.dimensions, ocfg, nn.init_model(0))
onm.integrate_batch([ods[0], ods[1]])
onm.optimize(8)
assert onm.error_maps and len(onm.optimize_losses) == onm.last_optimize_iters
om = onm.extract_mesh()
assert om is None or om.colors.shape == om.vertices.shape
g = fusion.sdf_gradient(onm.table.features, onm.table, onm.params,
                        t([[0.0, 0.0, 0.0]]), onm.bound_min, 0.08, 0,
                        layout="fm")
assert g.shape == (1, 3)
# the real-data path: readers, codec, profiling and scripts, then one
# canonical frame written by the port and read back with its colour
import tempfile
from bnv_fusion_tpu_torch.datasets import (canonical, scannet, arkit,
                                           synthetic_idr, arkitscenes,
                                           refiner, fusion_windows)
from bnv_fusion_tpu_torch.utils import image_io, profiling, motion
from bnv_fusion_tpu_torch.scripts import (compute_chamfer, evaluate_bnvf,
                                          generate_fusion_data, run_inference,
                                          run_rgbd_integration, demo)
tmp = tempfile.mkdtemp()
of = ods[0]
image_io.write_png(os.path.join(tmp, "c.png"),
                   np.clip(of["rgb"], 0, 255).astype(np.uint8))
generate_fusion_data.write_canonical(
    os.path.join(tmp, "scene"),
    [(os.path.join(tmp, "c.png"), (of["depth"] * 1000).astype(np.uint16),
      of["T_wc"], of["intr_mat"])], ods.dimensions)
ccfg = load_config(["dataset=fusion_inference_dataset", f"data_dir={tmp}",
                    "dataset.scan_id=scene", "dataset.load_color=true"])
cf = get_dataset(ccfg, "val")[0]
assert cf["rgb"].shape == (30, 40, 3) and cf["rgb"].std() > 1.0
# the big-scene layouts: a block-major prior with a block table, and the
# hash table of unbounded scenes
from bnv_fusion_tpu_torch import table, table_blocks, tsdf
bcfg = load_config(["device_type=cpu", "dataset.img_res=[30,40]",
                    "dataset.num_images=2", "model.voxel_size=0.08",
                    "model.min_pts_in_grid=0", "model.table_capacity=16384",
                    "model.tsdf_layout=blocks"])
tables.DENSE_MAP_MAX_VOXELS = 1000      # route this small grid to blocks
bnm = NeuralMap(ods.dimensions, bcfg, nn.init_model(0))
bnm.integrate_batch([ods[0], ods[1]])
assert isinstance(bnm.table, table_blocks.BlockIndexedTable)
assert isinstance(bnm.tsdf_vol, tsdf.TSDFVolumeBM)
assert int(bnm.table.n_alloc) > 0 and bnm.extract_mesh() is not None
hashed = tables.create_table(8, 1 << 14)
fusion.fuse_frame(hashed, nn.init_model(0), pw, nw, va,
                  t([-1.34, -1.34, -0.84]), t([1.34, 1.34, 0.84]), 0.04, 1)
assert isinstance(hashed, table.SparseVoxelTable)
assert int(tables.occupancy(hashed)) > 0
assert not any(m.split(".")[0] in blocked for m in sys.modules)
print("ok")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stdout + res.stderr
