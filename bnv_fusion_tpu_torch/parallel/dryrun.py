"""Multi-rank dry run of the multi-device steps on gloo ranks on the CPU.

Counterpart of ``dryrun_multichip`` (__graft_entry__.py:46), which runs the
JAX package's sharded steps on a virtual CPU mesh:

    python -m bnv_fusion_tpu_torch.parallel.dryrun --ranks 4

spawns that many processes, brings up a gloo group among them through a
``file://`` rendezvous, and runs one step of each DP function on tiny
shapes: the sharded fuse, the ray-DP optimize iteration and the older
optimize step, ``NeuralMap.optimize`` through the ray-DP path, and the
pretrain step; and the region-sharded map (``parallel/spatial.py``): its
fuse, decode and optimize step, and ``NeuralMap`` under
``model.table_layout=spatial`` through fuse -> optimize -> mesh (the
counterpart of __graft_entry__.py:198-233).  Each rank writes its results;
the run fails unless every rank's replicated results are bit-identical and
finite (a spatial case's per-shard arrays, under ``shard/``, differ by
design and are left out).

``run_ranks`` is the machinery: the same named cases on caller-given numpy
inputs (``<case>/<name>`` keys in one ``.npz``, the weights under
``params/<net>/<name>``), one result ``.npz`` per rank.  The parity tests
spawn the ranks through it, so the rank side imports only the port.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

Arrays = Dict[str, np.ndarray]


# ---------------------------------------------------------------------------
# rank-side cases: (group, inputs of this case) -> numpy results
# ---------------------------------------------------------------------------

def _params_np(inp: Arrays) -> Dict[str, Dict[str, np.ndarray]]:
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in inp.items():
        if k.startswith("params/"):
            _, net, name = k.split("/")
            tree.setdefault(net, {})[name] = v
    return tree


def _params(inp: Arrays):
    from bnv_fusion_tpu_torch import nn as bnn

    return bnn.params_from_numpy(_params_np(inp))


def _table_state(table, prefix: str = "") -> Arrays:
    """Every tensor of a table (for the replica check) and its active
    entries sorted by key (for the parity checks)."""
    from bnv_fusion_tpu_torch import tables as tbl

    out = {f"{prefix}raw/{k}": v.cpu().numpy() for k, v in vars(table).items()
           if isinstance(v, torch.Tensor)}
    keys, feats, w, h, _ = tbl.active_entries(table)
    o = np.lexsort(np.asarray(keys).T)
    out.update({f"{prefix}keys": np.asarray(keys)[o],
                f"{prefix}feats": np.asarray(feats)[o],
                f"{prefix}weights": np.asarray(w)[o],
                f"{prefix}hits": np.asarray(h)[o]})
    return out


def _load_table(c: Arrays):
    from bnv_fusion_tpu_torch import table_dense

    return table_dense.load_entries(
        tuple(int(v) for v in c["n_xyz"]), int(c["capacity"]), c["keys"],
        c["feats"], c["weights"], c["hits"])


def _traffic(group) -> Arrays:
    return {"traffic/ops": np.asarray([t[0] for t in group.traffic]),
            "traffic/elements": np.asarray([t[1] for t in group.traffic],
                                           np.int64),
            "traffic/shapes": np.asarray([json.dumps(t[2])
                                          for t in group.traffic])}


def _spatial_state(group, table, prefix: str = "") -> Arrays:
    """A region-sharded table's entries gathered on every rank, sorted by
    key (replicated), and this rank's shard under ``shard/``: its n_alloc,
    its slot map's and value rows' lengths, the global flat id of each of
    its slots in slot order, and its overflow."""
    from bnv_fusion_tpu_torch.parallel import spatial

    keys, feats, w, h = spatial.spatial_active_entries(group, table)
    o = np.lexsort(keys.T)
    n = int(table.n_alloc)
    return {f"{prefix}keys": keys[o], f"{prefix}feats": feats[o],
            f"{prefix}weights": w[o], f"{prefix}hits": h[o],
            f"{prefix}shard/n_alloc": np.asarray(n),
            f"{prefix}shard/slot_map_len": np.asarray(table.slot_map.numel()),
            f"{prefix}shard/rows": np.asarray(table.features.shape[0]),
            f"{prefix}shard/flat": table.slot_flat[:n].numpy().astype(
                np.int64) + table.lo,
            f"{prefix}shard/overflow": table.overflow.numpy()}


def _load_spatial(group, c: Arrays):
    from bnv_fusion_tpu_torch.parallel import spatial

    like = spatial.create_spatial_table(
        group, tuple(int(v) for v in c["n_xyz"]), int(c["capacity"]),
        c["feats"].shape[1], "cpu")
    return spatial.load_spatial_entries(group, like, c["keys"], c["feats"],
                                        c["weights"], c["hits"])


def case_sp_fuse(group, c: Arrays) -> Arrays:
    """``make_spatial_fuse_frame`` once on (pts, normals, valid) into an
    empty region-sharded table of ``n_xyz`` / ``capacity``; ``cfg`` =
    (voxel size, min_pts, max_unique)."""
    from bnv_fusion_tpu_torch.parallel import spatial

    vs, min_pts, max_unique = c["cfg"]
    table = spatial.create_spatial_table(
        group, tuple(int(v) for v in c["n_xyz"]), int(c["capacity"]), 8,
        "cpu")
    step = spatial.make_spatial_fuse_frame(group, _params(c), float(vs),
                                           int(min_pts),
                                           max_unique=int(max_unique))
    group.traffic.clear()
    t = torch.as_tensor
    stats = step(table, t(c["pts"]), t(c["normals"]), t(c["valid"]),
                 t(c["bound_min"]), t(c["bound_max"]))
    out = _traffic(group)
    out.update(_spatial_state(group, table))
    out.update({f"stats/{k}": v.numpy() for k, v in stats._asdict().items()})
    return out


def case_sp_decode(group, c: Arrays) -> Arrays:
    """``make_spatial_decode`` of the voxel coords ``q`` on the entries
    (keys, feats, weights, hits) loaded into a region-sharded table, in the
    rows and the fm layout; ``cfg`` = (voxel size, min_pts)."""
    from bnv_fusion_tpu_torch.parallel import spatial

    vs, min_pts = c["cfg"]
    table = _load_spatial(group, c)
    q = torch.as_tensor(c["q"])
    out: Arrays = {}
    for layout in ("rows", "fm"):
        group.traffic.clear()
        dec = spatial.make_spatial_decode(group, _params(c), float(vs),
                                          int(min_pts), layout=layout)
        out[f"sdf_{layout}"] = dec(table, q).numpy()
    out.update(_traffic(group))
    out.update(_spatial_state(group, table))
    return out


def case_sp_optimize(group, c: Arrays) -> Arrays:
    """``optimize.make_optimize_step`` on ``spatial.OwnerRows`` for
    len(pixel_ids) iterations on the loaded entries with the injected
    pixels and per-chunk uniforms (the single step's draws); ``cfg`` =
    (voxel size, min_pts, truncated_units, truncated_dist, ray_max_dist,
    n_rays, splits, lr).  The entries after the first iteration (and its
    Adam first moment) and the last, the losses, and the collectives of the
    last iteration."""
    from bnv_fusion_tpu_torch import optimize
    from bnv_fusion_tpu_torch.parallel import spatial

    vs, min_pts, units, trunc, ray_max, n_rays, splits, lr = c["cfg"]
    table = _load_spatial(group, c)
    step = optimize.make_optimize_step(
        _params(c), voxel_size=float(vs), min_pts_in_grid=int(min_pts),
        truncated_units=int(units), truncated_dist=float(trunc),
        ray_max_dist=float(ray_max), n_rays=int(n_rays),
        train_ray_splits=int(splits), lr=float(lr),
        rows=spatial.OwnerRows(group))
    state = optimize.init_optim_state(table)
    t = torch.as_tensor
    losses, out = [], {}
    for i in range(len(c["pixel_ids"])):
        uni = [(t(f), t(k)) for f, k in zip(c["uniforms_fine"][i],
                                            c["uniforms_coarse"][i])]
        group.traffic.clear()
        state, loss = step(state, table, t(c["depth"]), t(c["T_wc"]),
                           t(c["intr"]), t(c["bound_min"]),
                           tuple(int(v) for v in c["n_xyz"]), None,
                           pixel_ids=t(c["pixel_ids"][i]), uniforms=uni)
        losses.append(loss.numpy())
        table.features, table.weights = state.features, state.weights
        if i == 0:
            out.update(_spatial_state(group, table, "first/"))
            table.features = state.mu      # the first moment, by key
            out["first/mu"] = _spatial_state(group, table)["feats"]
            table.features = state.features
    out.update(_traffic(group))
    out.update(_spatial_state(group, table))
    out["losses"] = np.stack(losses)
    return out


def _mesh_arrays(m, prefix: str) -> Arrays:
    if m is None:
        return {f"{prefix}vertices": np.zeros((0, 3), np.float32),
                f"{prefix}faces": np.zeros((0, 3), np.int64)}
    return {f"{prefix}vertices": np.asarray(m.vertices),
            f"{prefix}faces": np.asarray(m.faces)}


def case_sp_nm(group, c: Arrays) -> Arrays:
    """``NeuralMap`` under ``model.table_layout=spatial`` and
    ``trainer.fuse_devices`` = the world size: the frames fused one by one,
    an incremental mesh, ``optimize(n_iters)``, the incremental mesh again
    (and once more with nothing changed), ``extract_mesh``, and ``save``
    into ``save_dir``/r<rank>; then, given ``load_prefix``, a fresh
    spatial map ``load_map``-ed from it and meshed."""
    nm = _neural_map(group, c, "trainer.fuse_devices")
    for f in _frames(c):
        nm.integrate(f)
    out = {"n_xyz": np.asarray(nm.n_xyz), "overflow": np.asarray(nm.overflow)}
    out.update(_spatial_state(group, nm.table, "fused/"))
    out.update(_mesh_arrays(nm.extract_mesh_incremental(), "inc0/"))
    nm.optimize(int(c["n_iters"]))
    out["losses"] = np.asarray(nm.optimize_losses, np.float32)
    for i in (1, 2):
        out.update(_mesh_arrays(nm.extract_mesh_incremental(), f"inc{i}/"))
        out[f"inc{i}/stats"] = np.asarray(
            [nm.inc_mesher.last_stats[k]
             for k in ("changed", "redecoded", "eligible")])
    out.update(_mesh_arrays(nm.extract_mesh(), "mesh/"))
    out.update(_spatial_state(group, nm.table))
    if "save_dir" in c:
        d = os.path.join(str(c["save_dir"]), f"r{group.rank}")
        os.makedirs(d, exist_ok=True)
        nm.save(os.path.join(d, "scene"))
    if "load_prefix" in c:
        lm = _neural_map(group, c, "trainer.fuse_devices")
        lm.load_map(str(c["load_prefix"]))
        out.update(_spatial_state(group, lm.table, "loaded/"))
        out.update(_mesh_arrays(lm.extract_mesh(), "loaded/mesh/"))
    return out


def case_sp_refuse(group, c: Arrays) -> Arrays:
    """The ``ValueError`` of ``NeuralMap`` under
    ``model.table_layout=spatial`` with ``trainer.optimize_devices`` = the
    world size as well (the ray-DP optimize cannot share the ranks)."""
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.pipeline import NeuralMap

    cfg = load_config([str(o) for o in c["overrides"]] + [
        "device_type=cpu", f"trainer.fuse_devices={group.size}",
        f"trainer.optimize_devices={group.size}"])
    try:
        NeuralMap(c["dims"], cfg, _params(c))
    except ValueError as e:
        return {"error": np.asarray(str(e))}
    return {"error": np.asarray("")}


def case_fuse(group, c: Arrays) -> Arrays:
    """``make_sharded_fuse_frame`` once on (pts, normals, valid) into an
    empty dense table of ``n_xyz`` / ``capacity``; ``cfg`` = (voxel size,
    min_pts, max_unique)."""
    from bnv_fusion_tpu_torch import tables as tbl
    from bnv_fusion_tpu_torch.parallel import dp

    vs, min_pts, max_unique = c["cfg"]
    params = _params(c)
    table = tbl.create_table(8, int(c["capacity"]),
                             n_xyz=tuple(int(v) for v in c["n_xyz"]))
    step = dp.make_sharded_fuse_frame(group, params, float(vs), int(min_pts),
                                      table, max_unique=int(max_unique))
    group.traffic.clear()
    t = torch.as_tensor
    stats = step(table, t(c["pts"]), t(c["normals"]), t(c["valid"]),
                 t(c["bound_min"]), t(c["bound_max"]))
    out = _table_state(table)
    out.update({f"stats/{k}": v.numpy() for k, v in stats._asdict().items()})
    out.update(_traffic(group))
    return out


def _frames(c: Arrays) -> List[dict]:
    return [{"depth": d, "T_wc": p, "intr_mat": k, "frame_id": i}
            for i, (d, p, k) in enumerate(zip(c["depth"], c["T_wc"],
                                              c["intr"]))]


def _neural_map(group, c: Arrays, knob: str):
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.pipeline import NeuralMap

    cfg = load_config([str(o) for o in c["overrides"]] +
                      ["device_type=cpu", f"{knob}={group.size}"])
    return NeuralMap(c["dims"], cfg, _params(c))


def case_nm_fuse(group, c: Arrays) -> Arrays:
    """``NeuralMap.integrate_batches`` under ``trainer.fuse_devices`` = the
    world size (the frames of one batch)."""
    nm = _neural_map(group, c, "trainer.fuse_devices")
    nm.integrate_batches([_frames(c)])
    out = _table_state(nm.table)
    out["overflow"] = np.asarray(nm.overflow)
    return out


def case_nm_optimize(group, c: Arrays) -> Arrays:
    """``NeuralMap.optimize(n_iters)`` under ``trainer.optimize_devices`` =
    the world size, after fusing the frames one by one."""
    nm = _neural_map(group, c, "trainer.optimize_devices")
    for f in _frames(c):
        nm.integrate(f)
    nm.optimize(int(c["n_iters"]))
    return {"features": nm.table.features.numpy(),
            "weights": nm.table.weights.numpy(),
            "losses": np.asarray(nm.optimize_losses, np.float32)}


def case_optimize_iter(group, c: Arrays) -> Arrays:
    """``make_sharded_optimize_iter`` for len(pixel_ids) iterations on the
    injected pixels and per-chunk uniforms; ``cfg`` = (voxel size, min_pts,
    truncated_units, truncated_dist, ray_max_dist, n_rays, splits, lr,
    lr_scale)."""
    from bnv_fusion_tpu_torch import optimize
    from bnv_fusion_tpu_torch.parallel import dp

    vs, min_pts, units, trunc, ray_max, n_rays, splits, lr, lr_scale = \
        c["cfg"]
    table = _load_table(c)
    step = dp.make_sharded_optimize_iter(
        group, _params(c), float(vs), int(min_pts), int(units), float(trunc),
        float(ray_max), int(n_rays), int(splits), table, lr=float(lr))
    state = optimize.init_optim_state(table)
    t = torch.as_tensor
    delta = t(c["delta"]) if "delta" in c else None
    losses = []
    for i in range(len(c["pixel_ids"])):
        uni = [(t(f), t(k)) for f, k in zip(c["uniforms_fine"][i],
                                            c["uniforms_coarse"][i])]
        state, loss = step(state, table, t(c["depth"]), t(c["T_wc"]),
                           t(c["intr"]), t(c["bound_min"]),
                           tuple(int(v) for v in c["n_xyz"]), delta,
                           pixel_ids=t(c["pixel_ids"][i]), uniforms=uni,
                           lr_scale=float(lr_scale))
        losses.append(float(loss))
        if i == 0:
            out = {"first/features": state.features.numpy().copy(),
                   "first/weights": state.weights.numpy().copy(),
                   "first/mu": state.mu.numpy().copy()}
    out.update({"losses": np.asarray(losses, np.float32),
                "features": state.features.numpy(),
                "weights": state.weights.numpy()})
    return out


def case_optimize_step(group, c: Arrays) -> Arrays:
    """``make_sharded_optimize_step`` once on the rays, each rank on its
    row of the per-rank uniforms; ``cfg`` = (voxel size, min_pts,
    truncated_units, truncated_dist, ray_max_dist, lr)."""
    from bnv_fusion_tpu_torch import optimize, render
    from bnv_fusion_tpu_torch.parallel import dp

    vs, min_pts, units, trunc, ray_max, lr = c["cfg"]
    table = _load_table(c)
    step = dp.make_sharded_optimize_step(
        group, _params(c), float(vs), int(min_pts), int(units), float(trunc),
        float(ray_max), table, lr=float(lr))
    t = torch.as_tensor
    rays = render.Rays(uv=t(c["uv"]), gt_pts=t(c["gt_pts"]),
                       mask=t(c["mask"]), neighbor_pts=t(c["neighbor_pts"]),
                       neighbor_masks=t(c["neighbor_masks"]),
                       T_wc=t(c["T_wc"]), intr=t(c["intr"]))
    state = optimize.init_optim_state(table)
    state, loss = step(state, table, rays, t(c["bound_min"]),
                       tuple(int(v) for v in c["n_xyz"]), None,
                       uniforms=(t(c["uniforms_fine"][group.rank]),
                                 t(c["uniforms_coarse"][group.rank])))
    return {"loss": np.asarray(float(loss), np.float32),
            "features": state.features.numpy(),
            "weights": state.weights.numpy(), "mu": state.mu.numpy()}


def _flat_params(params) -> Arrays:
    return {f"params/{net}/{k}": v.detach().numpy().copy()
            for net, d in params.items() for k, v in d.items()}


def case_pretrain(group, c: Arrays) -> Arrays:
    """``make_sharded_pretrain_step`` over the batches (steps on the leading
    axis) with Adam at lr and a staircase decay (``cfg`` = lr, step_size,
    gamma, reg_weight), the trainer's optimizer; the weights after the
    first and the last step."""
    from bnv_fusion_tpu_torch.models.local_point_fusion import _leaves
    from bnv_fusion_tpu_torch.parallel import dp

    lr, step_size, gamma, reg = c["cfg"]
    params = _params(c)
    for p in _leaves(params):
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(_leaves(params)), lr=float(lr),
                           betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.StepLR(opt, int(step_size), float(gamma))
    step = dp.make_sharded_pretrain_step(group, opt, reg_weight=float(reg))
    t = torch.as_tensor
    out: Arrays = {}
    losses, bce, regs = [], [], []
    for i in range(len(c["input_pts"])):
        loss, logs = step(params, t(c["input_pts"][i]), t(c["n_keep"][i]),
                          t(c["training_pts"][i]), t(c["gt"][i]))
        sched.step()
        losses.append(float(loss))
        bce.append(float(logs["bce_loss"]))
        regs.append(float(logs["reg_loss"]))
        if i == 0:
            out.update({f"first/{k}": v
                        for k, v in _flat_params(params).items()})
    out.update({f"last/{k}": v for k, v in _flat_params(params).items()})
    out.update({"losses": np.asarray(losses, np.float32),
                "bce_loss": np.asarray(bce, np.float32),
                "reg_loss": np.asarray(regs, np.float32)})
    return out


def case_trainer(group, c: Arrays) -> Arrays:
    """``FusionPointNetTrainer.train_step`` under
    ``trainer.pretrain_devices`` = the world size, on one global batch."""
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.models.local_point_fusion import \
        FusionPointNetTrainer

    cfg = load_config(["model=fusion_pointnet_model",
                       "dataset=synthetic_patches", "device_type=cpu",
                       f"trainer.pretrain_devices={group.size}"])
    tr = FusionPointNetTrainer(cfg, params=_params_np(c))
    batch = {k: c[k] for k in ("input_pts", "training_pts", "gt")}
    loss, logs = tr.train_step(batch, n_keep=c["n_keep"])
    out = _flat_params(tr.params)
    out.update({"loss": np.asarray(loss, np.float32),
                "bce_loss": np.asarray(logs["bce_loss"], np.float32)})
    return out


CASES: Dict[str, Callable] = {
    "fuse": case_fuse, "nm_fuse": case_nm_fuse,
    "nm_optimize": case_nm_optimize, "optimize_iter": case_optimize_iter,
    "optimize_step": case_optimize_step, "pretrain": case_pretrain,
    "trainer": case_trainer, "sp_fuse": case_sp_fuse,
    "sp_decode": case_sp_decode, "sp_optimize": case_sp_optimize,
    "sp_nm": case_sp_nm, "sp_refuse": case_sp_refuse,
}


def _case_fn(name: str) -> Callable:
    """A case by name; ``<case>:<tag>`` runs ``<case>`` on its own inputs."""
    return CASES[name.split(":")[0]]


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def _worker(rank: int, world: int, workdir: str, cases: Sequence[str]):
    torch.set_num_threads(1)
    from bnv_fusion_tpu_torch.parallel import launch, make_mesh

    launch.initialize(f"file://{os.path.join(workdir, 'pg')}", world, rank,
                      device="cpu")
    group = make_mesh(world)
    with np.load(os.path.join(workdir, "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    out: Arrays = {"group/size": np.asarray(group.size),
                   "group/rank": np.asarray(group.rank)}
    for name in cases:
        pre = f"{name}/"
        c = {k[len(pre):]: v for k, v in inputs.items() if k.startswith(pre)}
        for k, v in inputs.items():     # shared weights, unless the case
            if k.startswith("params/"):     # brings its own
                c.setdefault(k, v)
        for k, v in _case_fn(name)(group, c).items():
            out[f"{name}/{k}"] = np.asarray(v)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    launch.shutdown()


def run_ranks(n: int, cases: Sequence[str], inputs: Arrays, workdir: str,
              timeout: float = 600.0) -> List[Arrays]:
    """Run the named ``cases`` in ``n`` gloo ranks (one process each) on
    ``inputs``; returns each rank's results, keyed ``<case>/<name>``.  A
    case name ``a:b`` runs case ``a`` on the inputs under ``a:b/``.
    Raises with the ranks' output if any rank fails."""
    os.makedirs(workdir, exist_ok=True)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    env = dict(os.environ)
    # the caller's path first (a test may shadow modules there); the ranks
    # run in workdir, so the caller's directory is not on their path
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (env.get("PYTHONPATH"), _REPO) if p)
    env["OMP_NUM_THREADS"] = "1"
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    pg = os.path.join(workdir, "pg")      # a stale rendezvous file would
    if os.path.exists(pg):                 # join the ranks to an old run
        os.remove(pg)
    with contextlib.ExitStack() as stack:
        logs = [stack.enter_context(open(
            os.path.join(workdir, f"rank{r}.log"), "w+")) for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "bnv_fusion_tpu_torch.parallel.dryrun",
             "--worker", str(r), "--ranks", str(n), "--dir", workdir,
             "--cases", ",".join(cases)],
            env=env, cwd=workdir, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]
        deadline = time.time() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.time(), 1.0))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
    if failed:
        raise RuntimeError(f"ranks {failed} of {n} failed:\n" + "\n".join(
            f"--- rank {r} ---\n{texts[r][-4000:]}" for r in failed))
    results = []
    for r in range(n):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as z:
            results.append({k: z[k] for k in z.files})
    return results


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _plane_frames(rng, k: int, h: int = 24, w: int = 32):
    depth = (1.0 + 0.3 * rng.rand(k, h, w)).astype(np.float32)
    T_wc = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    T_wc[:, :3, 3] = [0.0, 0.0, -1.2]
    intr = np.tile(np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]],
                            np.float32), (k, 1, 1))
    return depth, T_wc, intr


def tiny_inputs(n: int, seed: int = 0) -> Arrays:
    """Seeded numpy inputs for every case at tiny shapes, ``n`` ranks."""
    from bnv_fusion_tpu_torch import nn as bnn
    from bnv_fusion_tpu_torch import tables as tbl

    rng = np.random.RandomState(seed)
    params = bnn.init_model(seed, bias_std=0.1)
    inp: Arrays = {f"params/{net}/{k}": v.numpy()
                   for net, d in params.items() for k, v in d.items()}
    bmin, bmax = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    pts = (rng.rand(64 * n, 3) * 1.2 - 0.6).astype(np.float32)
    nrm = rng.randn(64 * n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    inp.update({"fuse/pts": pts, "fuse/normals": nrm,
                "fuse/valid": np.ones(len(pts), bool),
                "fuse/bound_min": bmin, "fuse/bound_max": bmax,
                "fuse/n_xyz": np.array([24, 24, 24]),
                "fuse/capacity": np.array(4096),
                "fuse/cfg": np.array([0.1, 1, 1 << 17], np.float64)})
    depth, T_wc, intr = _plane_frames(rng, 2)
    nm = {"overrides": np.array(["model.voxel_size=0.05",
                                 "dataset.num_pixels=64",
                                 f"model.train_ray_splits={8 * n}",
                                 "model.table_capacity=16384",
                                 "model.min_pts_in_grid=1",
                                 "model.parallel_ray_chunks=false"]),
          "dims": np.full(3, 2.0, np.float32), "depth": depth,
          "T_wc": T_wc, "intr": intr, "n_iters": np.array(2)}
    for case in ("nm_fuse", "nm_optimize"):
        inp.update({f"{case}/{k}": v for k, v in nm.items()})
    sp_nm = dict(nm, overrides=np.append(nm["overrides"],
                                         "model.table_layout=spatial"))
    for case in ("sp_nm", "sp_refuse"):
        inp.update({f"{case}/{k}": v for k, v in sp_nm.items()})
    inp.update({f"sp_fuse/{k[len('fuse/'):]}": v for k, v in inp.items()
                if k.startswith("fuse/")})

    # a fused table for the optimize steps
    table = tbl.create_table(8, 4096, n_xyz=(24, 24, 24))
    from bnv_fusion_tpu_torch import fusion

    fusion.fuse_frame_cellsort(table, params, torch.as_tensor(pts),
        torch.as_tensor(nrm), torch.ones(len(pts), dtype=torch.bool),
        torch.as_tensor(bmin), torch.as_tensor(bmax), 0.1, 1)
    keys, feats, w, h, _ = tbl.active_entries(table)
    tab = {"keys": keys, "feats": feats, "weights": w, "hits": h,
           "n_xyz": np.array([24, 24, 24]), "capacity": np.array(4096),
           "bound_min": bmin}
    n_rays, splits, nf, nc = 16 * n, 8 * n, 4, 10
    it = dict(tab, depth=depth[0], T_wc=T_wc[0], intr=intr[0],
              pixel_ids=np.stack([rng.choice(depth[0].size, n_rays, False)
                                  for _ in range(2)]),
              uniforms_fine=rng.rand(2, n_rays // splits, splits,
                                     nf).astype(np.float32),
              uniforms_coarse=rng.rand(2, n_rays // splits, splits,
                                       nc).astype(np.float32),
              cfg=np.array([0.1, 1, 2, 0.1, 2.0, n_rays, splits, 1e-3, 1.0]))
    inp.update({f"optimize_iter/{k}": v for k, v in it.items()})
    inp.update({f"sp_optimize/{k}": v for k, v in it.items()})
    inp["sp_optimize/cfg"] = it["cfg"][:-1]
    inp.update({f"sp_decode/{k}": v for k, v in tab.items()})
    inp.update({"sp_decode/q": (rng.rand(256, 3) * 20 + 1).astype(
        np.float32), "sp_decode/cfg": np.array([0.1, 1])})
    gt = (rng.rand(n_rays, 3) * 0.8 - 0.4).astype(np.float32)
    st = dict(tab, uv=(rng.rand(n_rays, 2) * 24).astype(np.float32),
              gt_pts=gt, mask=np.ones(n_rays, np.float32),
              neighbor_pts=gt[:, None, :], neighbor_masks=np.ones(
                  (n_rays, 1), np.float32), T_wc=T_wc[0], intr=intr[0],
              uniforms_fine=rng.rand(n, n_rays // n, nf).astype(np.float32),
              uniforms_coarse=rng.rand(n, n_rays // n, nc).astype(np.float32),
              cfg=np.array([0.1, 0, 2, 0.1, 2.0, 1e-3]))
    inp.update({f"optimize_step/{k}": v for k, v in st.items()})
    b, npts, q = 4 * n, 16, 12
    pt = {"input_pts": rng.randn(2, b, npts, 6).astype(np.float32),
          "n_keep": rng.randint(4, npts, size=(2, b)),
          "training_pts": (rng.rand(2, b, q, 3) * 2 - 1).astype(np.float32),
          "gt": (rng.rand(2, b, q) - 0.5).astype(np.float32),
          "cfg": np.array([1e-3, 10, 0.5, 1e-3])}
    inp.update({f"pretrain/{k}": v for k, v in pt.items()})
    inp.update({f"trainer/{k}": v[0] for k, v in pt.items() if k != "cfg"})
    return inp


def dryrun_multichip(n: int = 4, workdir: str | None = None) -> Dict:
    """One step of each DP and spatial function in ``n`` gloo ranks on the
    CPU; raises unless every rank ran, every result is finite and the
    replicated results (all but the spatial cases' ``shard/`` arrays) are
    bit-identical across the ranks, and the spatial map refuses the ray-DP
    optimize.  Returns a summary."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks(n, list(CASES), tiny_inputs(n), workdir or tmp)
    for k, v in res[0].items():
        if v.dtype.kind == "f" and not np.all(np.isfinite(v)):
            raise AssertionError(f"{k}: non-finite values")
        if k == "group/rank" or "/shard/" in k:
            continue
        for r in range(1, n):
            if not np.array_equal(v, res[r][k]):
                raise AssertionError(f"{k}: rank {r} differs from rank 0")
    if "cannot be combined" not in str(res[0]["sp_refuse/error"]):
        raise AssertionError("the spatial map took the ray-DP optimize")
    return {"ranks": n, "cases": list(CASES), "seconds": time.time() - t0,
            "fuse_voxels": int(len(res[0]["fuse/keys"])),
            "spatial_voxels": int(len(res[0]["sp_nm/keys"])),
            "spatial_losses": res[0]["sp_nm/losses"].tolist(),
            "spatial_mesh_vertices": int(len(res[0]["sp_nm/mesh/vertices"])),
            "optimize_iter_losses": res[0]["optimize_iter/losses"].tolist(),
            "pretrain_losses": res[0]["pretrain/losses"].tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cases", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        _worker(args.worker, args.ranks, args.dir, args.cases.split(","))
        return 0
    print(json.dumps(dryrun_multichip(args.ranks)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
