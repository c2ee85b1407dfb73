"""Port parity of the region-sharded map's library (parallel/spatial.py): 4
gloo ranks on the CPU (bnv_fusion_tpu_torch.parallel, one process each)
against the JAX package's spatial fuse and decode on make_mesh(4,
axis_name="sp") of the conftest's virtual devices, and against the port's
single-device fuse, decode and optimize step.  Counterparts of
tests/test_spatial.py's library tests (:37, :72) at its sizes (N_XYZ 24^3,
capacity 4096, max_unique 2048), plus the optimize step, the shards'
sizes and the collectives.

The ranks are spawned once for the file (parallel.dryrun.run_ranks: a
file:// rendezvous, one thread each) on the same numpy inputs and
nn.init_model(seed, bias_std=0.1) weights the JAX side gets.  Tables are
compared by voxel key.  Tolerances:
* fuse: keys, weights, hits, per-shard n_alloc and each key's (shard,
  local slot) exact (integer counts merged through exact int sums on every
  side); features atol 2e-3, the DP fuse's bound
  (tests/test_torch_parallel_fuse.py): each rank's shard runs the
  per-frame cumsum front, whose mean-centred cumsum cancels to ~1e-4 here;
* decode on the same entries: the port's single decode exactly (each
  corner row is assembled by adding one value to zeros), the JAX spatial
  decode within 1e-5 (float32 MLPs in two frameworks);
* optimize on injected draws: the first loss exactly (its forward reads
  the same assembled rows), the bumped weights exactly, the first step's
  gradient (read back from the first moment, mu = (1 - b1) g) within
  1e-5 * max|g|: each shard sort-reduces its gradient rows among other rows
  than one device does, so the sums round apart.  So the latents are held
  as tests/test_torch_parallel_optimize.py holds the DP step's: after the
  first Adam step within its slope lr * eps / (|g| + eps)^2 times the
  gradient difference plus 2 ulp (a fixed 1e-6 does not hold where
  |g| ~ eps: the step g / (|g| + eps) turns a 1e-9 difference of g into
  1e-4 of the latent), after the second within 2e-3, with the losses
  within rtol 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu.parallel.mesh import make_mesh as jmake_mesh
from bnv_fusion_tpu.parallel.spatial import (
    create_spatial_table as jcreate, make_spatial_decode as jdecode,
    make_spatial_fuse_frame as jfuse, spatial_active_entries as jentries)
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import optimize as topt
from bnv_fusion_tpu_torch import table_dense as ttd
from bnv_fusion_tpu_torch import tables as ttables
from bnv_fusion_tpu_torch.parallel import dryrun

RANKS = 4
N_XYZ = (24, 24, 24)
N_VOX = 24 ** 3
CAP = 4096
MAX_UNIQUE = 2048
VOXEL, MIN_PTS = 0.1, 2
FEAT_ATOL = 2e-3
TRAFFIC = dict(capacity=65536, n_xyz=48, max_unique=128, n=512)
# the optimize step (tests/test_torch_parallel_optimize.py's point)
IT = dict(vs=0.1, min_pts=1, units=2, trunc=0.1, ray_max=2.0, n_rays=128,
          splits=64, iters=2, lr=1e-3)


def _params():
    return jax.tree.map(lambda x: x.numpy(), tnn.init_model(0, bias_std=0.1))


def _scene(rng, n=512):
    """tests/test_spatial.py's scene: points in a 1.2 m cube, unit
    normals."""
    pts = (rng.rand(n, 3).astype(np.float32) * 1.2 - 0.6)
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return (np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32), pts,
            normals)


def _by_key(keys, *cols):
    o = np.lexsort(np.asarray(keys).T)
    return (np.asarray(keys)[o],) + tuple(np.asarray(c)[o] for c in cols)


def _single_fuse(params, scene, min_pts):
    """The port's single-device fuse of the scene into a dense table."""
    bmin, bmax, pts, normals = scene
    table = ttables.create_table(8, CAP, n_xyz=N_XYZ)
    t = torch.as_tensor
    stats = tfusion.fuse_frame_cellsort(
        table, tnn.params_from_numpy(params), t(pts), t(normals),
        torch.ones(len(pts), dtype=torch.bool), t(bmin), t(bmax), VOXEL,
        min_pts, max_unique=MAX_UNIQUE)
    return table, stats


def _frame(rng, h=48, w=64):
    depth = (1.0 + 0.3 * rng.rand(h, w)).astype(np.float32)
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [0, 0, -1.2]
    intr = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]],
                    np.float32)
    return depth, T_wc, intr


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = _params()
    scene = _scene(np.random.RandomState(0))
    bmin, bmax, pts, normals = scene
    inp = {f"params/{net}/{k}": v for net, d in params.items()
           for k, v in d.items()}
    inp.update({"sp_fuse/pts": pts, "sp_fuse/normals": normals,
                "sp_fuse/valid": np.ones(len(pts), bool),
                "sp_fuse/bound_min": bmin, "sp_fuse/bound_max": bmax,
                "sp_fuse/n_xyz": np.array(N_XYZ), "sp_fuse/capacity":
                np.array(CAP), "sp_fuse/cfg": np.array([VOXEL, MIN_PTS,
                                                        MAX_UNIQUE])})
    tr = TRAFFIC
    inp.update({"sp_fuse:traffic/pts": np.zeros((tr["n"], 3), np.float32),
                "sp_fuse:traffic/normals": np.ones((tr["n"], 3), np.float32),
                "sp_fuse:traffic/valid": np.ones(tr["n"], bool),
                "sp_fuse:traffic/bound_min": bmin,
                "sp_fuse:traffic/bound_max": bmax,
                "sp_fuse:traffic/n_xyz": np.full(3, tr["n_xyz"]),
                "sp_fuse:traffic/capacity": np.array(tr["capacity"]),
                "sp_fuse:traffic/cfg": np.array([VOXEL, MIN_PTS,
                                                 tr["max_unique"]])})
    # the entries the decode and the optimize read: a single fuse of a
    # denser scene (tests/test_spatial.py:72's), min_pts 1
    dscene = _scene(np.random.RandomState(1), 1024)
    table, _ = _single_fuse(params, dscene, 1)
    keys, feats, w, h, _ = ttables.active_entries(table)
    tab = {"keys": keys, "feats": feats, "weights": w, "hits": h,
           "n_xyz": np.array(N_XYZ), "capacity": np.array(CAP)}
    rng = np.random.RandomState(2)
    # queries in the cells of fused points, and weights of which 90% pass
    # min_pts 1, so that the decode mask takes both branches
    q = ((dscene[2][rng.choice(len(dscene[2]), 256, False)] - bmin) / VOXEL
         + rng.uniform(-0.3, 0.3, (256, 3))).astype(np.float32)
    dtab = dict(tab, weights=np.where(rng.rand(len(w)) < 0.1, 0.5,
                                      1.5).astype(np.float32))
    inp.update({f"sp_decode/{k}": v for k, v in dtab.items()})
    inp.update({"sp_decode/q": q, "sp_decode/cfg": np.array([VOXEL, 1])})
    depth, T_wc, intr = _frame(rng)
    nf, nc = IT["units"] * 2, int(IT["ray_max"] * 5)
    n_chunks = IT["n_rays"] // IT["splits"]
    draws = dict(
        pixel_ids=np.stack([rng.choice(depth.size, IT["n_rays"], False)
                            for _ in range(IT["iters"])]),
        uniforms_fine=rng.rand(IT["iters"], n_chunks, IT["splits"],
                               nf).astype(np.float32),
        uniforms_coarse=rng.rand(IT["iters"], n_chunks, IT["splits"],
                                 nc).astype(np.float32))
    inp.update({f"sp_optimize/{k}": v for k, v in tab.items()})
    inp.update({f"sp_optimize/{k}": v for k, v in draws.items()})
    inp.update({"sp_optimize/depth": depth, "sp_optimize/T_wc": T_wc,
                "sp_optimize/intr": intr, "sp_optimize/bound_min": bmin,
                "sp_optimize/cfg": np.array(
                    [IT[k] for k in ("vs", "min_pts", "units", "trunc",
                                     "ray_max", "n_rays", "splits", "lr")])})
    res = dryrun.run_ranks(
        RANKS, ["sp_fuse", "sp_fuse:traffic", "sp_decode", "sp_optimize"],
        inp, str(tmp_path_factory.mktemp("ranks")))
    return dict(res=res, params=params, scene=scene, table=table, q=q,
                dec_weights=dtab["weights"], frame=(depth, T_wc, intr),
                draws=draws)


def _shard_slots(res, prefix):
    """{global flat id: (shard, local slot)} from every rank's slot list."""
    out = {}
    for r, rr in enumerate(res):
        for slot, f in enumerate(rr[f"{prefix}shard/flat"]):
            out[int(f)] = (r, slot)
    return out


def test_spatial_fuse_matches_jax_spatial_fuse(world):
    bmin, bmax, pts, normals = world["scene"]
    jparams = jax.tree.map(jnp.asarray, world["params"])
    mesh = jmake_mesh(RANKS, axis_name="sp")
    t = jcreate(mesh, list(N_XYZ), CAP, 8)
    step = jfuse(mesh, jparams, VOXEL, MIN_PTS, max_unique=MAX_UNIQUE)
    t, stats = step(t, jnp.asarray(pts), jnp.asarray(normals),
                    jnp.ones((len(pts),), bool), jnp.asarray(bmin),
                    jnp.asarray(bmax))
    jk, jf, jw, jh = _by_key(*jentries(t, RANKS))
    res = world["res"]
    r = res[0]
    assert len(jk) > 100 and jh.sum() > 0
    np.testing.assert_array_equal(r["sp_fuse/keys"], jk)
    np.testing.assert_array_equal(r["sp_fuse/weights"], jw)
    np.testing.assert_array_equal(r["sp_fuse/hits"], jh)
    np.testing.assert_allclose(r["sp_fuse/feats"], jf, atol=FEAT_ATOL,
                               rtol=0)
    # per-shard allocation: n_alloc, and each voxel's (shard, local slot)
    np.testing.assert_array_equal(
        [int(rr["sp_fuse/shard/n_alloc"]) for rr in res],
        np.asarray(t.n_alloc))
    slot_map = np.asarray(t.slot_map)
    flat = np.nonzero(slot_map >= 0)[0]
    want = {int(f): (int(f) // (N_VOX // RANKS), int(slot_map[f]))
            for f in flat}
    assert _shard_slots(res, "sp_fuse/") == want
    np.testing.assert_allclose(r["sp_fuse/stats/n_avg_pts"],
                               float(stats.n_avg_pts), rtol=1e-6)
    assert float(r["sp_fuse/stats/n_touched"]) == float(stats.n_touched)
    assert int(np.sum(np.asarray(t.overflow))) == 0
    assert all(int(rr["sp_fuse/shard/overflow"]) == 0 for rr in res)


def test_spatial_fuse_matches_single_fuse(world):
    """The spatial fuse against the port's single-device fuse, by key."""
    table, stats = _single_fuse(world["params"], world["scene"], MIN_PTS)
    sk, sf, sw, sh = _by_key(*ttables.active_entries(table)[:4])
    r = world["res"][0]
    np.testing.assert_array_equal(r["sp_fuse/keys"], sk)
    np.testing.assert_array_equal(r["sp_fuse/weights"], sw)
    np.testing.assert_array_equal(r["sp_fuse/hits"], sh)
    np.testing.assert_allclose(r["sp_fuse/feats"], sf, atol=FEAT_ATOL,
                               rtol=0)
    assert float(r["sp_fuse/stats/n_touched"]) == float(stats.n_touched)
    assert float(r["sp_fuse/stats/n_valid_pts"]) == float(stats.n_valid_pts)


def _jax_spatial_table(mesh, keys, feats, weights, hits):
    """The JAX package's spatial table holding these entries, each in the
    shard that owns its key at the next local slot, in row order (the
    order load_spatial_entries takes)."""
    t = jcreate(mesh, list(N_XYZ), CAP, 8)
    nv, cs = N_VOX // RANKS, CAP // RANKS
    slot_map = np.full(N_VOX, -1, np.int32)
    f_ = np.zeros((CAP, 8), np.float32)
    w_ = np.zeros(CAP, np.float32)
    h_ = np.zeros(CAP, np.float32)
    n_alloc = np.zeros(RANKS, np.int32)
    k = np.asarray(keys, np.int64)
    flat = k[:, 0] * N_XYZ[1] * N_XYZ[2] + k[:, 1] * N_XYZ[2] + k[:, 2]
    for i, f in enumerate(flat):
        sh = f // nv
        slot = n_alloc[sh]
        n_alloc[sh] += 1
        slot_map[f] = slot
        row = sh * cs + slot
        f_[row], w_[row], h_[row] = feats[i], weights[i], hits[i]

    def put(a, like):
        return jax.device_put(a, like.sharding)

    return t.replace(slot_map=put(slot_map, t.slot_map),
                     features=put(f_, t.features),
                     weights=put(w_, t.weights),
                     num_hits=put(h_, t.num_hits),
                     n_alloc=put(n_alloc, t.n_alloc))


def test_spatial_decode_matches_jax_and_single(world):
    """The spatial decode of the same entries: the JAX package's
    make_spatial_decode within 1e-5, the port's single-device decode
    exactly, in the rows and the fm layout."""
    keys, feats, _, h, _ = ttables.active_entries(world["table"])
    w = world["dec_weights"]
    q = world["q"]
    r = world["res"][0]
    mesh = jmake_mesh(RANKS, axis_name="sp")
    jt = _jax_spatial_table(mesh, keys, feats, w, h)
    jparams = jax.tree.map(jnp.asarray, world["params"])
    jsdf = np.asarray(jdecode(mesh, jparams, VOXEL, 1)(jt, jnp.asarray(q)))
    masked = jsdf == np.float32(VOXEL)
    assert 0.1 < masked.mean() < 0.9, masked.mean()   # both branches
    np.testing.assert_allclose(r["sp_decode/sdf_rows"], jsdf, atol=1e-5,
                               rtol=0)
    single = ttd.load_entries(N_XYZ, CAP, keys, feats, w, h)
    tparams = tnn.params_from_numpy(world["params"])
    for layout in ("rows", "fm"):
        want = tfusion.decode_points(
            single.features, single, tparams, torch.as_tensor(q), None,
            VOXEL, 1, is_coords=True, layout=layout).numpy()
        np.testing.assert_array_equal(r[f"sp_decode/sdf_{layout}"], want)
    # the loaded shards hold the entries, by key
    k2, f2, w2, h2 = _by_key(keys, feats, w, h)
    np.testing.assert_array_equal(r["sp_decode/keys"], k2)
    np.testing.assert_array_equal(r["sp_decode/feats"], f2)
    np.testing.assert_array_equal(r["sp_decode/weights"], w2)
    np.testing.assert_array_equal(r["sp_decode/hits"], h2)


def _first_adam_ok(tf, sf, tgrad, sgrad):
    near0 = np.where(np.sign(tgrad) == np.sign(sgrad),
                     np.minimum(np.abs(tgrad), np.abs(sgrad)), 0.0)
    slope = IT["lr"] * 1e-8 / (near0 + 1e-8) ** 2
    bound = slope * np.abs(tgrad - sgrad) + 1e-9 + 2.4e-7 * np.abs(sf)
    assert np.all(np.abs(tf - sf) <= bound)


def test_spatial_optimize_matches_single_step(world):
    """optimize.make_optimize_step on OwnerRows against the plain step on
    the same entries and injected draws (by key): the first loss to the
    last bit, bumped weights exact, the first gradient and latents as the
    module docstring says, then the second iteration."""
    keys, feats, w, h, _ = ttables.active_entries(world["table"])
    table = ttd.load_entries(N_XYZ, CAP, keys, feats, w, h)
    step = topt.make_optimize_step(
        tnn.params_from_numpy(world["params"]), voxel_size=IT["vs"],
        min_pts_in_grid=IT["min_pts"], truncated_units=IT["units"],
        truncated_dist=IT["trunc"], ray_max_dist=IT["ray_max"],
        n_rays=IT["n_rays"], train_ray_splits=IT["splits"], lr=IT["lr"])
    state = topt.init_optim_state(table)
    depth, T_wc, intr = (torch.as_tensor(a) for a in world["frame"])
    d = world["draws"]
    r = world["res"][0]
    t = torch.as_tensor
    losses = []
    for i in range(IT["iters"]):
        uni = [(t(f), t(k)) for f, k in zip(d["uniforms_fine"][i],
                                            d["uniforms_coarse"][i])]
        state, loss = step(state, table, depth, T_wc, intr,
                           t(np.full(3, -1.0, np.float32)), N_XYZ, None,
                           pixel_ids=t(d["pixel_ids"][i]), uniforms=uni)
        losses.append(float(loss))
        table.features, table.weights = state.features, state.weights
        if i == 0:
            sk, sf, sw, _ = _by_key(*ttables.active_entries(table)[:4])
            _, smu = _by_key(*ttables.active_entries(table)[:1],
                             state.mu[:len(sk)].numpy())
            np.testing.assert_array_equal(r["sp_optimize/first/keys"], sk)
            np.testing.assert_array_equal(r["sp_optimize/first/weights"], sw)
            assert (sw > w[np.lexsort(keys.T)]).any()     # the bumps landed
            sgrad, tgrad = smu / 0.1, r["sp_optimize/first/mu"] / 0.1
            assert np.abs(sgrad).max() > 0
            assert np.abs(tgrad - sgrad).max() <= 1e-5 * np.abs(sgrad).max()
            _first_adam_ok(r["sp_optimize/first/feats"], sf, tgrad, sgrad)
    assert losses[0] == float(r["sp_optimize/losses"][0])
    np.testing.assert_allclose(r["sp_optimize/losses"], losses, rtol=1e-6)
    sk, sf, sw, sh = _by_key(*ttables.active_entries(table)[:4])
    np.testing.assert_array_equal(r["sp_optimize/keys"], sk)
    np.testing.assert_array_equal(r["sp_optimize/weights"], sw)
    np.testing.assert_array_equal(r["sp_optimize/hits"], sh)
    np.testing.assert_allclose(r["sp_optimize/feats"], sf, atol=2e-3, rtol=0)
    assert np.abs(sf - feats[np.lexsort(keys.T)]).max() > 1e-4   # it moved


@pytest.mark.parametrize("case", ["sp_fuse", "sp_fuse:traffic", "sp_decode",
                                  "sp_optimize"])
def test_replicated_results_bit_identical(world, case):
    """Every rank's replicated results (the gathered entries, the stats,
    the decodes and losses) are the same bits; each rank's shard differs."""
    res = world["res"]
    keys = [k for k in res[0] if k.startswith(case + "/") and
            "/shard/" not in k and "/traffic/" not in k]
    assert any(k.endswith("/keys") for k in keys)
    for r in res[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
    flats = [r[f"{case}/shard/flat"] for r in res]
    assert sum(len(f) for f in flats) == len(res[0][f"{case}/keys"])


def test_each_shard_holds_its_slab(world):
    """Each rank's slot map has n_vox / 4 entries and its value rows
    capacity / 4, and every voxel it holds lies in its slab."""
    nv = N_VOX // RANKS
    for case in ("sp_fuse", "sp_decode", "sp_optimize"):
        for rank, r in enumerate(world["res"]):
            assert int(r[f"{case}/shard/slot_map_len"]) == nv
            assert int(r[f"{case}/shard/rows"]) == CAP // RANKS
            f = r[f"{case}/shard/flat"]
            assert np.all((f >= rank * nv) & (f < (rank + 1) * nv))
    r = world["res"][0]
    n = TRAFFIC["n_xyz"] ** 3
    assert int(r["sp_fuse:traffic/shard/slot_map_len"]) == n // RANKS
    assert int(r["sp_fuse:traffic/shard/rows"]) == \
        TRAFFIC["capacity"] // RANKS


def _traffic(r, case):
    return (list(r[f"{case}/traffic/ops"]), r[f"{case}/traffic/elements"],
            [tuple(json.loads(s)) for s in r[f"{case}/traffic/shapes"]])


def test_spatial_collectives_are_compacted(world):
    """The fuse's collectives move the compacted partials (at most
    D x U x F elements; none n_voxel- or capacity-sized); the decode's and
    the optimize's all-reduces are sized by the corners they assemble
    ([8M, 2] owned and weight, [8M, F] rows), not by the capacity."""
    r = world["res"][0]
    ops, elems, shapes = _traffic(r, "sp_fuse:traffic")
    budget = RANKS * TRAFFIC["max_unique"] * 8
    assert ops
    for op, n, shape in zip(ops, elems, shapes):
        assert n <= budget, f"{op} moves {n} elements {shape} > {budget}"
        assert TRAFFIC["capacity"] not in shape and \
            TRAFFIC["capacity"] // RANKS not in shape and \
            TRAFFIC["n_xyz"] ** 3 not in shape, (op, shape)
    assert sum(op == "all_gather" for op in ops) == 3
    assert max(elems) == budget       # the feature sums: [D, U, F]

    ops, elems, shapes = _traffic(r, "sp_decode")    # the fm decode
    k = 8 * len(world["q"])
    assert ops == ["all_reduce_sum"] * 2
    assert sorted(shapes) == [(k, 2), (k, 8)]

    ops, elems, shapes = _traffic(r, "sp_optimize")  # one iteration
    nf, nc = IT["units"] * 2, int(IT["ray_max"] * 5)
    k = IT["splits"] * (nf + nc) * 8
    n_chunks = IT["n_rays"] // IT["splits"]
    assert ops == ["all_reduce_sum"] * (2 * n_chunks)
    assert sorted(shapes) == [(k, 2)] * n_chunks + [(k, 8)] * n_chunks
    assert all(CAP // RANKS not in s and CAP not in s for s in shapes)
