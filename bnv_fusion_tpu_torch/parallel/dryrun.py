"""Multi-rank dry run of the data-parallel steps on gloo ranks on the CPU.

Counterpart of ``dryrun_multichip`` (__graft_entry__.py:46), which runs the
JAX package's sharded steps on a virtual CPU mesh:

    python -m bnv_fusion_tpu_torch.parallel.dryrun --ranks 4

spawns that many processes, brings up a gloo group among them through a
``file://`` rendezvous, and runs one step of each DP function on tiny
shapes: the sharded fuse, the ray-DP optimize iteration and the older
optimize step, ``NeuralMap.optimize`` through the ray-DP path, and the
pretrain step.  Each rank writes its results; the run fails unless every
rank's replicated state is bit-identical and finite.

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
    "trainer": case_trainer,
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
    """One step of each DP function in ``n`` gloo ranks on the CPU; raises
    unless every rank ran, every result is finite and the replicated
    results are bit-identical across the ranks.  Returns a summary."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks(n, list(CASES), tiny_inputs(n), workdir or tmp)
    for k, v in res[0].items():
        if v.dtype.kind == "f" and not np.all(np.isfinite(v)):
            raise AssertionError(f"{k}: non-finite values")
        if k == "group/rank":
            continue
        for r in range(1, n):
            if not np.array_equal(v, res[r][k]):
                raise AssertionError(f"{k}: rank {r} differs from rank 0")
    return {"ranks": n, "cases": list(CASES), "seconds": time.time() - t0,
            "fuse_voxels": int(len(res[0]["fuse/keys"])),
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
