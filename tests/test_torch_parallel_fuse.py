"""Port parity of the data-parallel fuse: 4 gloo ranks on the CPU
(bnv_fusion_tpu_torch.parallel, one process each) against the JAX package's
sharded fuse on make_mesh(4) of the conftest's 8 virtual devices, and
NeuralMap under trainer.fuse_devices=4 against the port's single-device
NeuralMap.  Counterparts of tests/test_parallel.py's mesh, sharded-fuse,
NeuralMap DP-fuse and compacted-collective tests (:32, :37, :288, :339).

The ranks are spawned once for the file (parallel.dryrun.run_ranks: a
file:// rendezvous, one thread each) on the same numpy inputs and
nn.init_model(seed, bias_std=0.1) weights the JAX side gets.  Tables are
compared by voxel key.  Tolerances: keys, weights and hits exact (integer
counts merged through exact int sums on both sides); features atol 2e-3,
the tolerance tests/test_torch_fusion.py holds the per-frame cumsum front
to (each rank's shard runs that front, whose mean-centred cumsum cancels
to ~1e-4 here).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu.parallel import make_mesh as jmake_mesh
from bnv_fusion_tpu.parallel import make_sharded_fuse_frame as jdp_fuse
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.parallel import dryrun, make_mesh
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

RANKS = 4
VOXEL, MIN_PTS = 0.1, 2
FEAT_ATOL = 2e-3
TRAFFIC = dict(capacity=65536, n_xyz=48, max_unique=128, n=512)
NM_OVERRIDES = ["model.voxel_size=0.05", "model.table_capacity=16384",
                "model.min_pts_in_grid=1", "model.fuse_sort_bf16=false"]


def _params():
    return jax.tree.map(lambda x: x.numpy(), tnn.init_model(0, bias_std=0.1))


def _scene(rng, n=512):
    """tests/test_parallel.py's scene: points in a 1.2 m cube, unit
    normals."""
    pts = (rng.rand(n, 3).astype(np.float32) * 1.2 - 0.6)
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return (np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32), pts,
            normals)


def _frames(rng, k=2, h=48, w=64):
    """tests/test_parallel.py's frames: a noisy plane 1-1.3 m away."""
    out = []
    for i in range(k):
        depth = (1.0 + 0.3 * rng.rand(h, w)).astype(np.float32)
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, 3] = [0, 0, -1.2]
        intr = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]],
                        np.float32)
        out.append({"depth": depth, "T_wc": T_wc, "intr_mat": intr,
                    "frame_id": i})
    return out


def _by_key(keys, feats, w, h):
    o = np.lexsort(np.asarray(keys).T)
    return (np.asarray(keys)[o], np.asarray(feats)[o], np.asarray(w)[o],
            np.asarray(h)[o])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = _params()
    bmin, bmax, pts, normals = _scene(np.random.RandomState(0))
    frames = _frames(np.random.RandomState(7))
    inp = {f"params/{net}/{k}": v for net, d in params.items()
           for k, v in d.items()}
    inp.update({"fuse/pts": pts, "fuse/normals": normals,
                "fuse/valid": np.ones(len(pts), bool),
                "fuse/bound_min": bmin, "fuse/bound_max": bmax,
                "fuse/n_xyz": np.array([24, 24, 24]),
                "fuse/capacity": np.array(4096),
                "fuse/cfg": np.array([VOXEL, MIN_PTS, 1 << 17])})
    tr = TRAFFIC
    inp.update({"fuse:traffic/pts": np.zeros((tr["n"], 3), np.float32),
                "fuse:traffic/normals": np.ones((tr["n"], 3), np.float32),
                "fuse:traffic/valid": np.ones(tr["n"], bool),
                "fuse:traffic/bound_min": bmin,
                "fuse:traffic/bound_max": bmax,
                "fuse:traffic/n_xyz": np.full(3, tr["n_xyz"]),
                "fuse:traffic/capacity": np.array(tr["capacity"]),
                "fuse:traffic/cfg": np.array([VOXEL, MIN_PTS,
                                              tr["max_unique"]])})
    inp.update({"nm_fuse/overrides": np.array(NM_OVERRIDES),
                "nm_fuse/dims": np.full(3, 2.0, np.float32),
                "nm_fuse/depth": np.stack([f["depth"] for f in frames]),
                "nm_fuse/T_wc": np.stack([f["T_wc"] for f in frames]),
                "nm_fuse/intr": np.stack([f["intr_mat"] for f in frames])})
    res = dryrun.run_ranks(RANKS, ["fuse", "fuse:traffic", "nm_fuse"], inp,
                           str(tmp_path_factory.mktemp("ranks")))
    return dict(res=res, params=params, scene=(bmin, bmax, pts, normals),
                frames=frames)


def test_mesh_has_4_ranks(world):
    """make_mesh(4) in each of the 4 ranks: size 4, ranks 0-3; in this one
    process (no process group) the world is one rank and 4 raises."""
    res = world["res"]
    assert [int(r["group/size"]) for r in res] == [RANKS] * RANKS
    assert [int(r["group/rank"]) for r in res] == list(range(RANKS))
    assert make_mesh().size == 1
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=4"):
        make_mesh(4)


def test_sharded_fuse_matches_jax_sharded_fuse(world):
    bmin, bmax, pts, normals = world["scene"]
    jparams = jax.tree.map(jnp.asarray, world["params"])
    t = jtables.create_table(8, 4096, n_xyz=[24, 24, 24])
    step = jdp_fuse(jmake_mesh(RANKS), jparams, VOXEL, MIN_PTS,
                    example_table=t)
    t, stats = step(t, jnp.asarray(pts), jnp.asarray(normals),
                    jnp.ones((len(pts),), bool), jnp.asarray(bmin),
                    jnp.asarray(bmax))
    jk, jf, jw, jh = _by_key(*jtables.active_entries(t)[:4])
    r = world["res"][0]
    assert len(jk) > 100
    np.testing.assert_array_equal(r["fuse/keys"], jk)
    np.testing.assert_array_equal(r["fuse/weights"], jw)
    np.testing.assert_array_equal(r["fuse/hits"], jh)
    assert jh.sum() > 0
    np.testing.assert_allclose(r["fuse/feats"], jf, atol=FEAT_ATOL, rtol=0)
    np.testing.assert_allclose(r["fuse/stats/n_avg_pts"],
                               float(stats.n_avg_pts), rtol=1e-6)
    assert int(r["fuse/raw/overflow"]) == int(np.asarray(t.overflow)) == 0


@pytest.mark.parametrize("case", ["fuse", "fuse:traffic", "nm_fuse"])
def test_replicas_bit_identical(world, case):
    """Every rank's whole table (slot map, slot keys, features, weights,
    hits, counters) and stats are the same bits."""
    res = world["res"]
    keys = [k for k in res[0] if k.startswith(case + "/")]
    assert any("/raw/" in k for k in keys)
    for r in res[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)


def test_neural_map_dp_fuse_matches_single(world):
    """NeuralMap with trainer.fuse_devices=4 (integrate_batches: frame by
    frame through the sharded step) against the port's single-device
    NeuralMap (the K-merge) on the same frames, by key."""
    cfg = tload_config(NM_OVERRIDES + ["device_type=cpu"])
    nm = TNeuralMap(np.full(3, 2.0, np.float32), cfg, world["params"])
    nm.integrate_batches([world["frames"]])
    sk, sf, sw, sh = _by_key(*_active(nm))
    r = world["res"][0]
    assert int(r["nm_fuse/overflow"]) == nm.overflow == 0
    assert len(sk) > 100
    np.testing.assert_array_equal(r["nm_fuse/keys"], sk)
    np.testing.assert_array_equal(r["nm_fuse/weights"], sw)
    np.testing.assert_array_equal(r["nm_fuse/hits"], sh)
    np.testing.assert_allclose(r["nm_fuse/feats"], sf, atol=FEAT_ATOL,
                               rtol=0)


def _active(nm):
    from bnv_fusion_tpu_torch import tables as ttables

    return ttables.active_entries(nm.table)[:4]


def test_sharded_fuse_collectives_are_compacted(world):
    """Every collective of one sharded fuse moves at most D x U x F
    elements (the compacted partials), none is capacity- or
    n_voxel-sized, and the keys, counts and sums are all-gathered."""
    r = world["res"][0]
    ops = list(r["fuse:traffic/traffic/ops"])
    elems = r["fuse:traffic/traffic/elements"]
    shapes = [tuple(json.loads(s)) for s in r["fuse:traffic/traffic/shapes"]]
    budget = RANKS * TRAFFIC["max_unique"] * 8
    n_vox = TRAFFIC["n_xyz"] ** 3
    assert ops, "no collectives recorded"
    for op, n, shape in zip(ops, elems, shapes):
        assert n <= budget, f"{op} moves {n} elements {shape} > {budget}"
        assert TRAFFIC["capacity"] not in shape and n_vox not in shape, \
            f"{op} operand {shape} is capacity-/n_voxel-sized"
    gathered = [s for op, s in zip(ops, shapes) if op == "all_gather"]
    assert len(gathered) >= 3, gathered
    assert max(elems) == budget       # the feature sums: [D, U, F]


def test_fuse_devices_count_must_match_the_world():
    """Without a process group, trainer.fuse_devices=all runs one device
    and 4 raises the launcher's ValueError."""
    base = NM_OVERRIDES + ["device_type=cpu"]
    nm = TNeuralMap(np.full(3, 2.0, np.float32),
                    tload_config(base + ["trainer.fuse_devices=all"]),
                    _params())
    assert nm._fuse_devices == 1 and nm._group is None
    with pytest.raises(ValueError, match="requested 4 devices, have 1"):
        TNeuralMap(np.full(3, 2.0, np.float32),
                   tload_config(base + ["trainer.fuse_devices=4"]), _params())


def test_sharded_fuse_table_layouts(world):
    """The sharded fuse takes the slot-map tables, dense and blocks (here
    in this one process: a world of 1), with equal results by key, and
    refuses the hash table with the JAX package's ValueError."""
    import torch

    from bnv_fusion_tpu_torch import nn as bnn
    from bnv_fusion_tpu_torch import table_blocks, tables
    from bnv_fusion_tpu_torch.parallel import make_sharded_fuse_frame

    bmin, bmax, pts, normals = world["scene"]
    params = bnn.params_from_numpy(world["params"])
    t = torch.as_tensor
    got = []
    for table in (tables.create_table(8, 4096, n_xyz=(24, 24, 24)),
                  table_blocks.create_block_table((24, 24, 24), 4096, 8)):
        step = make_sharded_fuse_frame(make_mesh(), params, VOXEL, MIN_PTS,
                                       table)
        step(table, t(pts), t(normals), t(np.ones(len(pts), bool)), t(bmin),
             t(bmax))
        got.append(_by_key(*tables.active_entries(table)[:4]))
    r = world["res"][0]
    np.testing.assert_array_equal(got[0][0], r["fuse/keys"])
    # the block table lists the voxels that hold a fused observation; the
    # dense one also those allocated and dropped under min_pts (weight 0)
    kept = got[0][2] > 0
    for a, b in zip(got[0], got[1]):
        np.testing.assert_array_equal(a[kept], b)
    with pytest.raises(ValueError, match="slot-map table"):
        make_sharded_fuse_frame(make_mesh(), params, VOXEL, MIN_PTS,
                                tables.create_table(8, 4096))
