"""The region-sharded map (model.table_layout=spatial) through NeuralMap and
the entry points: 4 gloo ranks on the CPU (parallel.dryrun.run_ranks, one
process each) against the port's single-device NeuralMap, the JAX package's
spatial NeuralMap on make_mesh(4, axis_name="sp") of the conftest's
virtual devices for a grid that needs padding, and run_e2e under torchrun
on 2 ranks.  Counterparts of tests/test_spatial.py's NeuralMap tests
(:115, :188, :208) at its sizes, on nn.init_model(1, bias_std=0.1)
weights (seed 1's decoder has zero crossings on these frames, so the mesh
checks are not vacuous; the JAX tests take the reference checkpoint).

Tolerances: keys, weights and hits exact (integer counts, integer bumps).
The spatial fuse runs the DP fuse's front on each rank's point shard and
merges the same partials, so its latents equal the DP map's (trainer.
fuse_devices=4, dense layout) bit for bit; against the single map they
differ by the per-frame cumsum front's rounding, whose float32 prefix sums
run over other rows in a shard than in the whole frame (3.6e-3 at a
count-1 voxel of latents up to 5 here): held at tests/test_spatial.py:
159's own tolerance, rtol 5e-3 and atol 1e-3, and after the two optimize
steps at atol 1e-3 + 2 * steps * lr (each Adam step moves a latent by at
most ~lr, so two trajectories part by at most that where their gradients'
signs differ), as tests/test_torch_parallel_launch.py holds the DP run.
Meshes: the JAX test's F-score > 0.995 at 0.01 m between the spatial and
the single map; a spatial and a single map loaded from the same saved
files mesh to the same triangles exactly.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.parallel.spatial import spatial_active_entries as jentries
from bnv_fusion_tpu.pipeline import NeuralMap as JNeuralMap
from bnv_fusion_tpu_torch import checkpoint, evaluation
from bnv_fusion_tpu_torch import mesh as tmesh
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import run_e2e
from bnv_fusion_tpu_torch import tables as ttables
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.parallel import dryrun
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
SEED = 1
FEAT_ATOL, FEAT_RTOL = 1e-3, 5e-3
N_ITERS, LR = 2, 1e-3
OPT_ATOL = FEAT_ATOL + 2 * N_ITERS * LR
# tests/test_spatial.py:131's overrides
OVERRIDES = ["model.voxel_size=0.05", "dataset.num_pixels=128",
             "model.train_ray_splits=64", "model.table_capacity=16384",
             "model.min_pts_in_grid=1", "model.parallel_ray_chunks=false",
             "model.fuse_sort_bf16=false"]
SPATIAL = ["model.table_layout=spatial"]
DIMS = np.full(3, 2.0, np.float32)
# 1.94 m at 0.05 m: 41^3 voxels, which 4 ranks do not divide
PAD_DIMS = np.full(3, 1.94, np.float32)
# the SKILL.md CPU smoke's sizes
SMOKE = ["device_type=cpu", "dataset.img_res=[60,80]", "dataset.num_images=4",
         "model.voxel_size=0.05", "model.integrate_batch_size=2",
         "dataset.num_pixels=200", "model.train_ray_splits=100",
         "trainer.global_steps=2", "model.min_pts_in_grid=0"]


def _params():
    return jax.tree.map(lambda x: x.numpy(),
                        tnn.init_model(SEED, bias_std=0.1))


def _nm_frames(rng, n=2):
    """tests/test_spatial.py:96's frames: a smooth slanted plane."""
    frames = []
    for i in range(n):
        h, w = 48, 64
        xx = np.linspace(0.0, 0.25, w, dtype=np.float32)[None, :]
        depth = (1.0 + xx + 0.01 * rng.rand(h, w)).astype(np.float32)
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, 3] = [0, 0, -1.2 + 0.05 * i]
        intr = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]],
                        np.float32)
        frames.append({"depth": depth, "T_wc": T_wc, "intr_mat": intr,
                       "frame_id": i})
    return frames


def _by_key(keys, *cols):
    o = np.lexsort(np.asarray(keys).T)
    return (np.asarray(keys)[o],) + tuple(np.asarray(c)[o] for c in cols)


def _entries(nm):
    return _by_key(*ttables.active_entries(nm.table)[:4])


def _triangles(vertices, faces):
    """A mesh's triangles as sorted rows of their 9 coordinates."""
    tri = np.sort(np.asarray(vertices)[np.asarray(faces)].reshape(-1, 9),
                  axis=0)
    return tri[np.lexsort(tri.T[::-1])]


def _case_inputs(name, overrides, dims, frames, n_iters):
    return {f"{name}/overrides": np.array(overrides),
            f"{name}/dims": dims,
            f"{name}/depth": np.stack([f["depth"] for f in frames]),
            f"{name}/T_wc": np.stack([f["T_wc"] for f in frames]),
            f"{name}/intr": np.stack([f["intr_mat"] for f in frames]),
            f"{name}/n_iters": np.array(n_iters)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = _params()
    frames = _nm_frames(np.random.RandomState(3))
    tmp = tmp_path_factory.mktemp("spatial")
    # the single-device map: fuse -> optimize -> mesh, saved; and a fresh
    # single map loaded from those files
    one = TNeuralMap(DIMS, tload_config(OVERRIDES + ["device_type=cpu"]),
                     params)
    for f in frames:
        one.integrate(f)
    fused = _entries(one)
    one.optimize(N_ITERS)
    mesh = one.extract_mesh()
    prefix = str(tmp / "single" / "scene")
    os.makedirs(os.path.dirname(prefix))
    one.save(prefix)
    loaded = TNeuralMap(DIMS, tload_config(OVERRIDES + ["device_type=cpu"]),
                        params)
    loaded.load_map(prefix)

    inp = {f"params/{net}/{k}": v for net, d in params.items()
           for k, v in d.items()}
    inp.update(_case_inputs("sp_nm", OVERRIDES + SPATIAL, DIMS, frames,
                            N_ITERS))
    inp.update({"sp_nm/save_dir": np.array(str(tmp / "saved")),
                "sp_nm/load_prefix": np.array(prefix)})
    inp.update(_case_inputs("sp_nm:pad", OVERRIDES + SPATIAL, PAD_DIMS,
                            frames, 1))
    inp.update(_case_inputs("sp_refuse", OVERRIDES + SPATIAL, DIMS, frames,
                            0))
    inp.update(_case_inputs("nm_fuse", OVERRIDES, DIMS, frames, 0))
    res = dryrun.run_ranks(RANKS, ["sp_nm", "sp_nm:pad", "sp_refuse",
                                   "nm_fuse"], inp, str(tmp / "ranks"))
    return dict(res=res, params=params, frames=frames, tmp=tmp,
                prefix=prefix, fused=fused, final=_entries(one), mesh=mesh,
                loaded_mesh=loaded.extract_mesh())


def test_neural_map_spatial_matches_single(world):
    """model.table_layout=spatial with trainer.fuse_devices=4 through fuse
    -> optimize(2) -> extract_mesh against the single-device NeuralMap:
    the same key set, weights and hits exact, latents at the DP bounds,
    and meshes that coincide (tests/test_spatial.py:115)."""
    r = world["res"][0]
    for pre, want, atol in (("sp_nm/fused/", world["fused"], FEAT_ATOL),
                            ("sp_nm/", world["final"], OPT_ATOL)):
        sk, sf, sw, sh = want
        assert len(sk) > 1000
        np.testing.assert_array_equal(r[pre + "keys"], sk)
        np.testing.assert_array_equal(r[pre + "weights"], sw)
        np.testing.assert_array_equal(r[pre + "hits"], sh)
        np.testing.assert_allclose(r[pre + "feats"], sf, atol=atol,
                                   rtol=FEAT_RTOL)
    for k in ("keys", "feats", "weights", "hits"):   # the DP map's bits
        np.testing.assert_array_equal(r["sp_nm/fused/" + k],
                                      r["nm_fuse/" + k])
    assert int(r["sp_nm/overflow"]) == 0
    assert np.all(np.isfinite(r["sp_nm/losses"]))
    assert len(r["sp_nm/losses"]) == N_ITERS
    m1, v2 = world["mesh"], r["sp_nm/mesh/vertices"]
    assert m1 is not None and len(m1.vertices) > 1000 and len(v2) > 1000
    res = evaluation.fscore_points(v2, np.asarray(m1.vertices), 0.01)
    assert res["fscore"] > 0.995, res


def test_spatial_map_loaded_from_single_volume_meshes_exactly(world):
    """A spatial map load_map-ed from the single map's saved files holds
    its entries by key, bit for bit, and meshes to the same triangles as a
    single map loaded from them (the JAX package's spatial load reads every
    feature back from the wrong row, ROADMAP Queue 3)."""
    r = world["res"][0]
    d = checkpoint.load_state(world["prefix"] + "_sparse_volume.npz")
    sk, sf, sw, sh = _by_key(d["active_coordinates"], d["features"],
                             d["weights"], d["num_hits"])
    np.testing.assert_array_equal(r["sp_nm/loaded/keys"], sk)
    np.testing.assert_array_equal(r["sp_nm/loaded/feats"], sf)
    np.testing.assert_array_equal(r["sp_nm/loaded/weights"], sw)
    np.testing.assert_array_equal(r["sp_nm/loaded/hits"], sh)
    want = world["loaded_mesh"]
    assert want is not None and len(want.faces) > 1000
    np.testing.assert_array_equal(
        _triangles(r["sp_nm/loaded/mesh/vertices"],
                   r["sp_nm/loaded/mesh/faces"]),
        _triangles(want.vertices, want.faces))
    # the loaded shards hold their slabs' entries
    counts = [int(rr["sp_nm/loaded/shard/n_alloc"]) for rr in world["res"]]
    assert sum(counts) == len(sk) and min(counts) >= 0


def test_spatial_save_roundtrip(world):
    """NeuralMap.save on the spatial map: every rank gathers, rank 0 alone
    writes, and the file holds the map's entries (the single map's key
    set)."""
    saved = world["tmp"] / "saved"
    assert sorted(os.listdir(saved / "r0")) == [
        "scene_sparse_volume.npz", "scene_tsdf.npy"]
    for rank in range(1, RANKS):
        assert os.listdir(saved / f"r{rank}") == []
    d = checkpoint.load_state(str(saved / "r0" / "scene_sparse_volume.npz"))
    k, f, w, h = _by_key(d["active_coordinates"], d["features"],
                         d["weights"], d["num_hits"])
    r = world["res"][0]
    np.testing.assert_array_equal(k, r["sp_nm/keys"])
    np.testing.assert_array_equal(f, r["sp_nm/feats"])
    np.testing.assert_array_equal(w, r["sp_nm/weights"])
    np.testing.assert_array_equal(h, r["sp_nm/hits"])
    np.testing.assert_array_equal(k, world["final"][0])
    assert np.all(np.isfinite(f))
    np.testing.assert_array_equal(
        np.load(str(saved / "r0" / "scene_tsdf.npy")),
        np.load(world["prefix"] + "_tsdf.npy"))


def test_spatial_incremental_mesh_matches_full(world):
    """extract_mesh_incremental on the spatial map: the event after the
    optimize re-decodes the changed voxels and welds the same surface as a
    full extract_mesh (tests/test_spatial.py:208's check); one more event
    with nothing changed re-decodes nothing and returns the same mesh."""
    r = world["res"][0]
    assert len(r["sp_nm/inc0/vertices"]) > 0
    changed, redecoded, eligible = r["sp_nm/inc1/stats"]
    assert 0 < changed <= redecoded <= eligible
    inc, full = r["sp_nm/inc1/vertices"], r["sp_nm/mesh/vertices"]
    assert len(inc) == len(full) > 1000
    a = {tuple(v) for v in np.round(inc, 4)}
    b = {tuple(v) for v in np.round(full, 4)}
    assert len(a & b) >= 0.99 * len(a), (len(a & b), len(a))
    assert list(r["sp_nm/inc2/stats"][:2]) == [0, 0]
    np.testing.assert_array_equal(r["sp_nm/inc2/vertices"], inc)
    np.testing.assert_array_equal(r["sp_nm/inc2/faces"],
                                  r["sp_nm/inc1/faces"])


def test_padded_grid_matches_jax_spatial_neural_map(world):
    """A grid whose voxel count 4 ranks do not divide (41^3): the minor
    axis padded to 44 as the JAX package pads it, and the fused map's key
    set, weights and hits equal to the JAX package's spatial NeuralMap's
    (features at the DP bound)."""
    r = world["res"][0]
    cfg = jload_config(OVERRIDES + SPATIAL + ["trainer.fuse_devices=4"])
    jnm = JNeuralMap(PAD_DIMS, cfg, jax.tree.map(jnp.asarray,
                                                 world["params"]))
    for f in world["frames"]:
        jnm.integrate(f)
    assert tuple(np.asarray(jnm.n_xyz)) == (41, 41, 44)
    np.testing.assert_array_equal(r["sp_nm:pad/n_xyz"], [41, 41, 44])
    jk, jf, jw, jh = _by_key(*jentries(jnm.table, RANKS))
    assert len(jk) > 1000
    np.testing.assert_array_equal(r["sp_nm:pad/fused/keys"], jk)
    np.testing.assert_array_equal(r["sp_nm:pad/fused/weights"], jw)
    np.testing.assert_array_equal(r["sp_nm:pad/fused/hits"], jh)
    np.testing.assert_allclose(r["sp_nm:pad/fused/feats"], jf,
                               atol=FEAT_ATOL, rtol=FEAT_RTOL)
    for rank, rr in enumerate(world["res"]):
        assert int(rr["sp_nm:pad/shard/slot_map_len"]) == 41 * 41 * 44 // 4
        # capacity 16384 divides by 4 already
        assert int(rr["sp_nm:pad/shard/rows"]) == 16384 // 4


@pytest.mark.parametrize("case", ["sp_nm", "sp_nm:pad"])
def test_replicated_results_bit_identical(world, case):
    """Every rank's replicated results (gathered entries, losses, meshes)
    are the same bits."""
    res = world["res"]
    keys = [k for k in res[0] if k.startswith(case + "/") and
            "/shard/" not in k]
    assert any(k.endswith("mesh/vertices") for k in keys)
    for r in res[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)


def test_spatial_layout_refusals(world):
    """model.table_layout=spatial raises the JAX package's ValueError at
    trainer.fuse_devices=1, and with trainer.optimize_devices above 1 (on
    4 ranks)."""
    cfg = tload_config(OVERRIDES + SPATIAL + ["device_type=cpu"])
    with pytest.raises(ValueError, match="needs trainer.fuse_devices > 1"):
        TNeuralMap(DIMS, cfg, world["params"])
    for r in world["res"]:
        assert "cannot be combined with model.table_layout=spatial" in \
            str(r["sp_refuse/error"])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _volume(path):
    d = checkpoint.load_state(path)
    return _by_key(d["active_coordinates"], d["features"], d["weights"],
                   d["num_hits"])


def test_torchrun_spatial_run_e2e(tmp_path):
    """run_e2e under torchrun on 2 gloo ranks with
    model.table_layout=spatial and trainer.fuse_devices=all: it ends (every
    rank enters the collective meshes and save), rank 0 alone reports and
    writes a non-empty final.ply, and the map equals a single-process
    run's by key (latents within the DP run's bound, module docstring)."""
    sp_dir, one_dir = tmp_path / "sp", tmp_path / "one"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "bnv_fusion_tpu_torch.run_e2e",
           *SMOKE, "model.table_layout=spatial", "trainer.fuse_devices=all",
           f"output_dir={sp_dir}"]
    res = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=600, cwd=str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-5000:]
    assert res.stdout.count("speed on global fusion") == 1, res.stdout
    wd = sp_dir / "run_e2e" / "synthetic_demo"
    m = tmesh.load_ply(str(wd / "final.ply"))
    assert len(m.vertices) > 0 and len(m.faces) > 0

    run_e2e.run(SMOKE + [f"output_dir={one_dir}"])
    sk, sf, sw, sh = _volume(str(wd / "final_sparse_volume.npz"))
    ok, of, ow, oh = _volume(str(one_dir / "run_e2e" / "synthetic_demo" /
                                 "final_sparse_volume.npz"))
    assert len(ok) > 100
    np.testing.assert_array_equal(sk, ok)
    np.testing.assert_array_equal(sw, ow)
    np.testing.assert_array_equal(sh, oh)
    np.testing.assert_allclose(sf, of, atol=FEAT_ATOL + 2 * 2 * LR,
                               rtol=FEAT_RTOL)
