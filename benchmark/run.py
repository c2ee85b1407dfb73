#!/usr/bin/env python3
"""Benchmark of bnv_fusion_tpu_torch on NVIDIA cards: one cell, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``benchmark/configs/<config>.json``: the system's config
overrides and the sizes they state) and a traffic mix
(``benchmark/traffic/<traffic>.json``: scene, camera path, frames and the
loop, ``mode``).  Set-up makes the weights and the frames from the seed on
the card, builds the map and runs the loop once through, so that nothing
compiles in the window; then the window runs whole units (scans, jobs or
events, by the mix's mode) until ``--seconds`` have passed, and ends in a
device sync.  With ``--trace 1`` one unit runs under ``torch.profiler`` and
the cell's per-layer metrics are read from it by the small readers in
``benchmark/metrics/<name>.py``.  Either way, once the window has closed the
plain reference (``benchmark/reference/``) works the outputs of the window's
last unit out again from the same frames and weights, and each compared
number is held against its limit (``benchmark/limits/<workload>.json``).

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``); the numbers compared close standard
error.  Without a CUDA card, with fewer cards than the cell asks for, or
with JAX loaded once the window has closed, it prints no result and exits
with 2, 3 or 4.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
# the system's kernel caches stay inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import rooflines, trace  # noqa: E402
from benchmark.reference import fusion as ref_fusion  # noqa: E402
from benchmark.reference import render as ref_render  # noqa: E402
from benchmark.traffic import generator  # noqa: E402
from benchmark.weights import make_params  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "bnv_fusion_tpu")


def load_json(*parts) -> Dict[str, Any]:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def bench_with_parked() -> Dict[str, Any]:
    """BENCHMARK.json with the cells it does not enrol yet added
    (``tests/parked.json``: refine and demo, whose runs on the card spread
    wider than a bound may, and the house scans, calibrated for a later
    enrolment), so that their loops stay tested and calibrated."""
    bench = load_json(ROOT, "BENCHMARK.json")
    for k, v in load_json(HERE, "tests", "parked.json").items():
        bench[k] = bench[k] + v
    return bench


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None):
    """(the whole benchmark, the cell, its configuration, its traffic mix)
    by the names in BENCHMARK.json (or in ``bench``, a benchmark of the same
    form: the tests' cells that BENCHMARK.json does not enrol)."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (bench, cell, load_json(ROOT, config["file"]),
            load_json(HERE, "traffic", cell["traffic"] + ".json"))


def jax_modules() -> List[str]:
    """Loaded top-level modules that belong to JAX or to the JAX package,
    compared as whole top-level names."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# one run of a cell
# ---------------------------------------------------------------------------

class Run:
    """What one run knows: the cell, the seed, the device, the weights, the
    frames, the system's config, and (traced) the spans and counters."""

    def __init__(self, workload: str, seed: int, traced: bool,
                 device: str = "cuda", config_patch: Optional[Dict] = None,
                 traffic_patch: Optional[Dict] = None,
                 extra_overrides: Optional[List[str]] = None,
                 bench: Optional[Dict[str, Any]] = None):
        from bnv_fusion_tpu_torch.config import load_config

        self.bench, self.cell, self.config, self.traffic = load_cell(workload,
                                                                     bench)
        self.config = dict(self.config, **(config_patch or {}))
        self.traffic = dict(self.traffic, **(traffic_patch or {}))
        self.workload, self.seed, self.traced = workload, int(seed), traced
        self.device = torch.device(device)
        _, _, s_map, s_jobs = generator.sub_seeds(seed, 4)
        self.job_seed = s_jobs
        self.cfg = load_config(
            list(self.config["overrides"]) + list(self.traffic["overrides"]) +
            [f"trainer.seed={s_map}", f"device_type={self.device.type}"] +
            list(extra_overrides or []))
        m = self.cfg.model
        self.voxel_size = float(m.voxel_size)
        self.ray_max = float(m.ray_tracer.ray_max_dist)
        self.min_pts = int(m.min_pts_in_grid)
        self.skip = int(getattr(self.cfg.dataset, "skip_images", 1)) or 1
        self.img_res = tuple(int(v) for v in self.cfg.dataset.img_res)
        self.params = make_params(self.config["network"], seed, self.device)
        fr = generator.make_frames(self.traffic, self.img_res,
                                   self.config["focal_per_width"], seed,
                                   self.device)
        self.raw, self.T_wc, self.intr = fr["raw"], fr["T_wc"], fr["intr"]
        # metric depth as a reader hands it over (host float32)
        self.depth = self.raw.astype(np.float32) / np.float32(1000.0)
        self.dimensions = np.asarray(self.traffic["scene"]["dimensions"],
                                     np.float32)
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, Any] = {}

    # -- the system's inputs ------------------------------------------------

    def frame(self, i: int) -> Dict[str, Any]:
        """Frame ``i`` of the mix as the system's readers give it."""
        k = i % len(self.raw)
        return {"frame_id": i, "depth": self.depth[k],
                "depth_raw": self.raw[k], "depth_scale": 1000.0,
                "T_wc": self.T_wc[k], "intr_mat": self.intr}

    def new_map(self):
        from bnv_fusion_tpu_torch.pipeline import NeuralMap

        return NeuralMap(self.dimensions, self.cfg, self.params,
                         os.path.join(CACHE, "work"))

    @property
    def batch_k(self) -> int:
        return int(self.cfg.model.integrate_batch_size)

    def fuse(self, nmap, frames: List[Dict[str, Any]]):
        """One table update, as the system's online loop makes it."""
        if len(frames) == 1:
            nmap.integrate(frames[0])
        else:
            nmap.integrate_batch(frames)

    # -- timing --------------------------------------------------------------

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        """A layer's span in the traced run: a profiler range, timed on the
        host clock from a synced start to a synced end; nothing otherwise."""
        if not self.traced:
            yield
            return
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench." + name):
            yield
            self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def count(self, name: str, value):
        self.counters[name] = self.counters.get(name, 0) + value

    # -- reference inputs ----------------------------------------------------

    def ref_depth(self, i: int, staged_raw: bool) -> torch.Tensor:
        """Frame ``i``'s depth on the device as the system's path sees it:
        the uint16 frame converted there (and cut at ray_max) on the K-frame
        path, the reader's float frame on the per-frame path."""
        k = i % len(self.raw)
        if staged_raw:
            d = torch.as_tensor(self.raw[k].astype(np.int32),
                                device=self.device).to(torch.float32) / \
                float(np.float32(1000.0))
            return torch.where(d < self.ray_max, d,
                               torch.zeros((), device=self.device))
        return torch.as_tensor(self.depth[k], device=self.device)

    def ref_pose(self, i: int):
        k = i % len(self.raw)
        return (torch.as_tensor(self.T_wc[k], device=self.device),
                torch.as_tensor(self.intr, device=self.device))

    def ref_params(self):
        return ref_fusion.tensors(self.params, self.device)

    def reference_map(self, groups: List[List[int]]):
        """The plain map and prior after the given table updates (lists of
        frame indices), with each frame's counts for the roofline readers.
        The prior's updates follow the layout that the configuration routes
        it to (``ref_fusion.prior_is_blocks``)."""
        m = self.cfg.model
        staged = self.batch_k > 1
        every = int(getattr(m, "tsdf_every", 1)) if staged else 1
        grid = ref_fusion.Grid(self.dimensions, self.voxel_size,
                               self.device)
        dmap = ref_fusion.SparseMap(
            grid, int(self.config["network"]["feature_dims"]), self.device)
        tsdf_vs = float(m.tsdf_voxel_size)
        blocks = ref_fusion.prior_is_blocks(
            str(getattr(m, "tsdf_layout", "auto")), self.dimensions, tsdf_vs)
        prior = ref_fusion.Prior(
            self.dimensions, tsdf_vs, self.device,
            windowed=not blocks and bool(getattr(m, "tsdf_frustum_window",
                                                 True)))
        params = self.ref_params()
        stats = []
        for g in groups:
            merged = staged and len(g) > 1
            pts = []
            for i in g:
                T, intr = self.ref_pose(i)
                pts.append(ref_fusion.frame_points(
                    self.ref_depth(i, merged), T, intr))
            stats += dmap.fuse(params, pts, self.min_pts)
            del pts
            w = every if merged else 1
            for j in range(0, len(g), w):
                T, intr = self.ref_pose(g[j])
                prior.integrate(self.ref_depth(g[j], merged), intr, T,
                                float(w), self.ray_max)
        return grid, dmap, prior, stats

    def optimizer(self, grid):
        m = self.cfg.model
        vs = float(self.voxel_size)
        tu = int(m.ray_tracer.truncated_units)
        ray_max = self.ray_max
        return ref_render.Optimizer(grid, self.ref_params(), {
            "ray_max_dist": ray_max,
            "n_rays": int(self.cfg.dataset.num_pixels),
            "ray_splits": int(m.train_ray_splits),
            "n_fine": int(getattr(m.ray_tracer, "n_fine", 0) or 0) or tu * 2,
            "n_coarse": (int(getattr(m.ray_tracer, "n_coarse", 0) or 0)
                         or int(ray_max * 5)),
            "truncated_dist": self.truncated_dist,
            "min_pts_in_grid": self.min_pts,
            "iters_per_launch": int(getattr(m, "optim_iters_per_launch", 4)),
            "lr": 1e-3})

    @property
    def truncated_dist(self) -> float:
        m = self.cfg.model
        return min(int(m.ray_tracer.truncated_units) *
                   float(self.voxel_size) * 0.5, 0.1)

    def delta(self, prior_sdf: torch.Tensor) -> torch.Tensor:
        m = self.cfg.model
        return ref_render.prior_delta(prior_sdf, float(m.tsdf_voxel_size),
                                      self.truncated_dist,
                                      float(m.sdf_delta_weight))

    def dense_from(self, grid, snap: Dict[str, torch.Tensor]):
        """A map the system holds ({flat, F, W}) on the reference's dense
        grids, for the stages followed from the system's own state."""
        F = torch.zeros((grid.n_vox, snap["F"].shape[1]), device=self.device)
        W = torch.zeros((grid.n_vox,), device=self.device)
        alloc = torch.zeros((grid.n_vox,), dtype=torch.bool,
                            device=self.device)
        F[snap["flat"]] = snap["F"]
        W[snap["flat"]] = snap["W"]
        alloc[snap["flat"]] = True
        return F, W, alloc


BLOCK = 4   # a block table's and a block-major prior's block edge


def _coords(ids: torch.Tensor, dims) -> torch.Tensor:
    """x-major flat ids over a grid of ``dims`` -> [N, 3] coordinates."""
    _, dy, dz = dims
    return torch.stack([ids // (dy * dz), (ids // dz) % dy, ids % dz], -1)


def _flat(c: torch.Tensor, dims) -> torch.Tensor:
    """[..., 3] coordinates -> x-major flat ids over a grid of ``dims``."""
    _, dy, dz = dims
    return (c[..., 0] * dy + c[..., 1]) * dz + c[..., 2]


def _block_grid(n_xyz) -> tuple:
    return tuple(-(-int(n) // BLOCK) for n in n_xyz)


def _table_entries(t) -> Dict[str, torch.Tensor]:
    """The allocated entries of a slot-map table: the voxel id (``flat``,
    x-major as the reference's ``Grid.flat``), latents, weights and hits of
    each.  A dense table's are its first ``n_alloc`` slots, in slot order.
    A block table's are every slot of each allocated block (``blocks``,
    ascending; its 64 slots at block slot x 64 + the voxel's x-major offset
    in the block) whose voxel lies inside the grid."""
    if not hasattr(t, "block_map"):
        n = int(t.n_alloc)
        return {"flat": t.slot_flat[:n].long().clone(),
                "F": t.features[:n].clone(), "W": t.weights[:n].clone(),
                "H": t.num_hits[:n].clone()}
    grid = _block_grid(t.n_xyz)
    if int(np.prod(grid)) != t.block_map.shape[0]:
        raise ValueError(f"block map of {t.block_map.shape[0]} entries over "
                         f"a {grid} block grid")
    blocks = torch.nonzero(t.block_map >= 0).squeeze(1)
    local = torch.arange(BLOCK ** 3, device=blocks.device)
    slots = t.block_map[blocks].long()[:, None] * BLOCK ** 3 + local
    vox = (_coords(blocks, grid)[:, None, :] * BLOCK +
           _coords(local, (BLOCK,) * 3)[None])                   # [A, 64, 3]
    inside = torch.all(vox < torch.as_tensor(t.n_xyz, device=vox.device), -1)
    slots = slots[inside]
    return {"flat": _flat(vox[inside], t.n_xyz),
            "F": t.features[slots].clone(), "W": t.weights[slots].clone(),
            "H": t.num_hits[slots].clone(), "blocks": blocks}


def _bricks_dense(x: torch.Tensor, nb_xyz, vol_dim) -> torch.Tensor:
    """A block-major prior's [n_blocks, 64] bricks as [X, Y, Z], cropped to
    ``vol_dim``."""
    nbx, nby, nbz = nb_xyz
    x = x.reshape(nbx, nby, nbz, BLOCK, BLOCK, BLOCK).permute(0, 3, 1, 4, 2, 5)
    x = x.reshape(nbx * BLOCK, nby * BLOCK, nbz * BLOCK)
    dx, dy, dz = vol_dim
    return x[:dx, :dy, :dz].clone()


def table_snapshot(nmap) -> Dict[str, torch.Tensor]:
    """The allocated entries of the system's map (``_table_entries``) and
    its prior as a dense [X, Y, Z] grid, on the device."""
    snap = _table_entries(nmap.table)
    vol = nmap.tsdf_vol
    if vol.sdf.dim() == 2:
        snap["prior_bricks"] = vol.sdf.shape[0]
        snap["prior_sdf"], snap["prior_w"] = (
            _bricks_dense(x, vol.nb_xyz, vol.vol_dim)
            for x in (vol.sdf, vol.weight))
    else:
        snap["prior_sdf"] = vol.sdf.clone()
        snap["prior_w"] = vol.weight.clone()
    return snap


def compare_map(snap: Dict[str, torch.Tensor], dmap,
                prior) -> Dict[str, float]:
    """The system's map against the plain one (``map_mismatch``, exact):
    on a dense table, voxels allocated on one side only or whose weight or
    hits differ; on a block table, blocks allocated on one side only (the
    reference's are the blocks that hold a voxel it allocated) and in-grid
    slots of the allocated blocks whose weight or hits differ (0 where the
    reference allocated nothing).  The widest latent gap over the voxels
    with weight as a share of the reference latents' RMS, and its RMS.
    Prior voxels whose TSDF or weight differ (exact)."""
    flat = snap["flat"]
    held, ref_F, ref_W, ref_H = dmap.lookup(flat)
    differ = int((ref_W != snap["W"]).sum()) + int((ref_H != snap["H"]).sum())
    if "blocks" in snap:
        n_xyz = dmap.grid.n_xyz
        ref_blocks = torch.unique(_flat(_coords(dmap.ids, n_xyz) // BLOCK,
                                        _block_grid(n_xyz)))
        sys_blocks = snap["blocks"]
        structure = int((~torch.isin(sys_blocks, ref_blocks)).sum()) + \
            int((~torch.isin(ref_blocks, sys_blocks)).sum()) + differ
    else:
        only_sys = int((~held).sum())
        structure = only_sys + (len(dmap.ids) - (len(flat) - only_sys)) + \
            differ
    keep = (snap["W"] > 0) & (ref_W > 0)
    ref_f = ref_F[keep]
    rms = torch.sqrt(torch.mean(ref_f.double() ** 2))
    gap = (torch.abs(snap["F"][keep] - ref_f).max().double() / rms
           if len(ref_f) else torch.tensor(float("inf")))
    rms_gap = (torch.sqrt(torch.mean((snap["F"][keep] - ref_f).double() ** 2))
               / rms if len(ref_f) else torch.tensor(float("inf")))
    prior_bad = int(((prior.sdf != snap["prior_sdf"]) |
                     (prior.weight != snap["prior_w"])).sum())
    out = {"map_mismatch": float(structure), "latent_gap": float(gap),
           "latent_rms_gap": float(rms_gap),
           "prior_mismatch": float(prior_bad)}
    # the layouts read, not compared
    if "blocks" in snap:
        out["table_blocks"] = float(len(snap["blocks"]))
    if "prior_bricks" in snap:
        out["prior_bricks"] = float(snap["prior_bricks"])
    return out


def loss_gap(sys_losses, ref_losses) -> float:
    """Widest gap between the system's per-iteration losses and the
    reference's, as a share of the reference's."""
    a = np.asarray(sys_losses, np.float64)
    b = np.asarray(ref_losses, np.float64)
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return float("inf")
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def change_gap(snap: Dict[str, torch.Tensor], F_ref: torch.Tensor,
               F0_ref: torch.Tensor) -> float:
    """RMS over the system's voxels of the gap between its optimized
    latents and the reference's, as a share of the RMS of the reference's
    change over the optimize."""
    flat = snap["flat"]
    d = (snap["F"] - F_ref[flat]).double()
    ch = (F_ref[flat] - F0_ref[flat]).double()
    den = torch.sqrt(torch.mean(ch ** 2))
    return float(torch.sqrt(torch.mean(d ** 2)) / den) if den > 0 \
        else float("inf")


# ---------------------------------------------------------------------------
# the loops (a mix's ``mode``)
# ---------------------------------------------------------------------------

class Stream:
    """Scans of the mix's frames, each fused into an emptied map, K frames
    per table update (the configuration's integrate_batch_size).  Unit: one
    scan.  fuse_fps = frames fused / window."""

    def __init__(self, run: Run):
        self.run = run
        k = run.batch_k
        n = len(run.raw)
        self.groups = [list(range(i, min(i + k, n))) for i in range(0, n, k)]
        self.frames = [run.frame(i) for i in range(n)]
        self.nmap = None

    def _scan(self):
        run = self.run
        self.nmap = None
        with run.span("new_map"):
            self.nmap = run.new_map()
        marks = []
        for g in self.groups:
            with run.span("fuse"):
                run.fuse(self.nmap, [self.frames[i] for i in g])
            marks.append(self.nmap.table.overflow.clone())
        return marks

    def setup(self):
        self._scan()
        self.run.sync()

    def window(self, seconds: float, units: Optional[int] = None):
        run = self.run
        marks, t0 = [], time.perf_counter()
        self.unit_s = []
        while True:
            tu = time.perf_counter()
            marks.append(self._scan())
            self.unit_s.append(time.perf_counter() - tu)
            if (units is not None and len(marks) >= units) or \
                    (units is None and time.perf_counter() - t0 >= seconds):
                break
        run.sync()
        wall = time.perf_counter() - t0
        n = len(self.frames)
        failed = 0
        for scan in marks:
            prev = 0
            for g, m in zip(self.groups, scan):
                if int(m) > prev:
                    failed += len(g)
                prev = int(m)
        run.count("frames", n * len(marks))
        self.attempted, self.failed = n * len(marks), failed
        return wall, {"fuse_fps": n * len(marks) / wall}

    def outputs(self):
        self.snap = table_snapshot(self.nmap)
        self.nmap = None

    def check(self) -> Dict[str, float]:
        run = self.run
        grid, dmap, prior, stats = run.reference_map(self.groups)
        run.counters["frame_stats"] = stats
        return compare_map(self.snap, dmap, prior)


class Refine:
    """A scan fused once in set-up; each job restores that map, optimizes
    2 x frames x skip iterations (the reference's formula) and extracts the
    final mesh (post-processed as the online run does).  Unit: one job.
    refine_s = window / jobs."""

    def __init__(self, run: Run):
        self.run = run
        k = run.batch_k
        n = len(run.raw)
        self.groups = [list(range(i, min(i + k, n))) for i in range(0, n, k)]
        self.n_iters = 2 * n * run.skip
        self.jobs = 0

    def setup(self):
        run = self.run
        self.nmap = run.new_map()
        for g in self.groups:
            run.fuse(self.nmap, [run.frame(i) for i in g])
        self.start = table_snapshot(self.nmap)
        self.F0 = self.nmap.table.features.clone()
        self.W0 = self.nmap.table.weights.clone()
        self._job(0)
        run.sync()

    def _job(self, j: int) -> bool:
        from bnv_fusion_tpu_torch import mesh as mesh_mod

        run, nmap = self.run, self.nmap
        with run.span("restore"):
            nmap.table.features = self.F0.clone()
            nmap.table.weights = self.W0.clone()
            # the restored map is a new key set to the mesh-lattice prefetch
            nmap._fuse_epoch += 1
        nmap.generator.manual_seed((run.job_seed + j) % (1 << 32))
        self.gen_state = nmap.generator.get_state()
        with run.span("optimize"):
            nmap.optimize(n_iters=self.n_iters, last_frame=-1)
        with run.span("mesh"):
            self.mesh = nmap.extract_mesh()
            final = (None if self.mesh is None else mesh_mod.post_process_mesh(
                self.mesh, vertex_threshold=nmap.voxel_size / 4))
        run.count("iterations", nmap.last_optimize_iters)
        self.losses = list(nmap.optimize_losses)
        return (final is not None and len(final.faces) > 0 and
                bool(np.all(np.isfinite(self.losses))))

    def window(self, seconds: float, units: Optional[int] = None):
        run = self.run
        ok, t0 = [], time.perf_counter()
        self.unit_s = []
        while True:
            self.jobs += 1
            tu = time.perf_counter()
            ok.append(self._job(self.jobs))
            self.unit_s.append(time.perf_counter() - tu)
            if (units is not None and len(ok) >= units) or \
                    (units is None and time.perf_counter() - t0 >= seconds):
                break
        run.sync()
        wall = time.perf_counter() - t0
        run.count("jobs", len(ok))
        self.attempted, self.failed = len(ok), ok.count(False)
        return wall, {"refine_s": wall / len(ok)}

    def outputs(self):
        self.final = table_snapshot(self.nmap)
        self.overflow = int(self.nmap.overflow)
        self.nmap = None

    def check(self) -> Dict[str, float]:
        run = self.run
        grid, dmap, prior, _ = run.reference_map(self.groups)
        out = compare_map(self.start, dmap, prior)
        # the job from the reference's own fused map and prior
        frames = []
        for i in range(len(run.raw)):
            T, intr = run.ref_pose(i)
            frames.append((run.ref_depth(i, run.batch_k > 1), T, intr))
        F, W, alloc = dmap.dense()
        del dmap
        F0 = F.clone()
        ref_losses = run.optimizer(grid).run(
            F, W, alloc, run.delta(prior.sdf), frames, self.gen_state,
            self.n_iters)
        out["loss_gap"] = loss_gap(self.losses, ref_losses)
        out["change_gap"] = change_gap(self.final, F, F0)
        del F, W, alloc, F0
        out.update(mesh_check(run, grid, self.final, self.mesh))
        return out


def mesh_check(run: Run, grid, snap, mesh) -> Dict[str, float]:
    """The mesh against the reference's SDF of the system's map as it was
    meshed (the mesh stage followed from the system's own state)."""
    if mesh is None or not len(mesh.vertices):
        return {"mesh_sdf_gap": float("inf"), "mesh_off_edge": float("inf"),
                "mesh_sdf_gap_raw": float("inf"), "mesh_vertices": 0.0}
    F, W, alloc = run.dense_from(grid, snap)
    r = ref_render.mesh_sdf_gap(
        mesh.vertices, grid, run.ref_params(), F, W, alloc,
        run.delta(snap["prior_sdf"]), run.min_pts,
        int(getattr(run.cfg.model, "mesh_lattice_scale", 2)))
    return {"mesh_sdf_gap": r["gap"], "mesh_off_edge": float(r["off_edge"]),
            "mesh_sdf_gap_raw": r["gap_raw"],
            "mesh_vertices": float(len(mesh.vertices))}


class Demo:
    """Sessions of the live user: the mix's frames fused frame by frame into
    one growing map, ``session_frames`` of them (the pan once round), then
    a new map; every ``optim_interval`` frames an event optimizes over the
    last ``optim_interval`` frames and refreshes the incremental mesh.  A
    session's map and frame pool grow with it and are freed with it, so
    the peak does not grow with the work a window holds.  Set-up runs
    through the first ``warmup_events`` events.  Unit: one event (the
    frames before it included); a session's event at its first frame (one
    frame, one iteration) runs but is not counted.  event_s = counted
    event time / counted events."""

    def __init__(self, run: Run):
        self.run = run
        self.interval = int(run.cfg.model.optim_interval)
        self.session = int(run.traffic["session_frames"])
        self.i = -1

    def _step(self) -> Optional[bool]:
        """Fuse the next frame; run the event when one is due.  Returns
        whether a counted event succeeded, or None without one."""
        run = self.run
        if self.i >= self.session:
            self.nmap = None
            with run.span("new_map"):
                self.nmap = run.new_map()
            self.i, self.overflow = -1, 0
        nmap = self.nmap
        self.i += 1
        with run.span("fuse"):
            run.fuse(nmap, [run.frame(self.i)])
        if self.i % self.interval:
            return None
        run.sync()
        counted = self.i > 0
        if counted:
            self.snap = table_snapshot(nmap)
            self.snap_n = len(nmap.frames)
            self.gen_state = nmap.generator.get_state()
        t0 = time.perf_counter()
        n_iters = min(len(nmap.frames), self.interval) * run.skip
        with run.span("optimize"):
            nmap.optimize(n_iters=n_iters,
                          last_frame=max(0, len(nmap.frames) - self.interval))
        with run.span("inc_mesh"):
            mesh = nmap.extract_mesh_incremental()
        run.sync()
        if not counted:
            return None
        self.n_iters, self.mesh = n_iters, mesh
        self.unit_s.append(time.perf_counter() - t0)
        self.event_s += self.unit_s[-1]
        st = nmap.inc_mesher.last_stats
        run.count("iterations", nmap.last_optimize_iters)
        run.count("redecoded", st["redecoded"])
        run.count("eligible", st["eligible"])
        self.losses = list(nmap.optimize_losses)
        over = int(nmap.table.overflow)
        ok = (mesh is not None and over == self.overflow and
              bool(np.all(np.isfinite(self.losses))))
        self.overflow = over
        return ok

    def setup(self):
        self.nmap = self.run.new_map()
        self.event_s, self.overflow, self.unit_s = 0.0, 0, []
        warm = int(self.run.traffic["warmup_events"])
        while warm:
            if self._step() is not None:
                warm -= 1
        self.run.sync()

    def window(self, seconds: float, units: Optional[int] = None):
        run = self.run
        run.counters.clear()
        self.event_s, self.unit_s = 0.0, []
        ok, t0 = [], time.perf_counter()
        while True:
            r = self._step()
            if r is None:
                continue
            ok.append(r)
            if (units is not None and len(ok) >= units) or \
                    (units is None and time.perf_counter() - t0 >= seconds):
                break
        run.sync()
        wall = time.perf_counter() - t0
        run.count("events", len(ok))
        self.attempted, self.failed = len(ok), ok.count(False)
        return wall, {"event_s": self.event_s / len(ok)}

    def outputs(self):
        self.final = table_snapshot(self.nmap)
        self.nmap = None

    def check(self) -> Dict[str, float]:
        """The last event from the system's map as the event found it (the
        fusion before it is the per-frame fusion that arkit's stream cell
        checks from the frames): its optimize, then its mesh."""
        run = self.run
        grid = ref_fusion.Grid(run.dimensions, run.voxel_size, run.device)
        F, W, alloc = run.dense_from(grid, self.snap)
        lo = max(0, self.snap_n - self.interval)
        frames = []
        for i in range(lo, self.snap_n):
            T, intr = run.ref_pose(i)
            frames.append((run.ref_depth(i, False), T, intr))
        F0 = F.clone()
        ref_losses = run.optimizer(grid).run(
            F, W, alloc, run.delta(self.snap["prior_sdf"]), frames,
            self.gen_state, self.n_iters)
        out = {"loss_gap": loss_gap(self.losses, ref_losses),
               "change_gap": change_gap(self.final, F, F0)}
        del F, W, alloc, F0
        out.update(mesh_check(run, grid, self.final, self.mesh))
        return out


MODES = {"stream": Stream, "refine": Refine, "demo": Demo}


# ---------------------------------------------------------------------------
# metrics, checks and the result line
# ---------------------------------------------------------------------------

def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def base_name(name: str, known, sep: str) -> str:
    """The number or reader a metric of BENCHMARK.json comes from: its own
    name where ``known`` has it, or else the name it extends by
    ``<sep><cells>`` (``fuse_fps_k1``, ``fuse.ms_per_frame.k1``: the same
    quantity in cells that report it under a name of their own)."""
    if name in known:
        return name
    stem = name.rpartition(sep)[0]
    if stem in known:
        return stem
    raise KeyError(f"metric {name!r}: neither it nor {stem!r} is among "
                   f"{sorted(known)}")


def readers() -> List[str]:
    """The per-layer readers, ``benchmark/metrics/<name>.py``."""
    return [f[:-3] for f in os.listdir(os.path.join(HERE, "metrics"))
            if f.endswith(".py") and not f.startswith("_")]


def read_metric(name: str, ctx) -> Optional[float]:
    """The ``read(ctx)`` of the reader that ``name`` resolves to
    (``base_name``): a number, or None where the run has nothing for it to
    read."""
    name = base_name(name, readers(), ".")
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else None


class Context:
    """What a per-layer metric reader sees: the run (config, traffic, the
    system's config), its spans and counters, and the traced unit's device
    timeline."""

    def __init__(self, run: Run, timeline):
        self.run, self.timeline = run, timeline
        self.spans, self.counters = run.spans, run.counters
        self.rooflines = rooflines


def reference_check(mode) -> Dict[str, float]:
    """The mode's comparison with the plain reference, under PyTorch's
    deterministic algorithms: on the card the reference's scatter-adds
    (``index_add_``) then sum in a fixed order, so that its readings repeat
    bit for bit from run to run (with atomic adds they differ in the last
    bits)."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return mode.check()
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", **patches) -> Dict[str, Any]:
    """One run of one cell; returns the result object (``checks`` last).
    ``patches`` (``config_patch``, ``traffic_patch``, ``extra_overrides``,
    ``bench``) shrink a cell for the CPU tests, switch on a control or name
    a cell BENCHMARK.json does not enrol."""
    run = Run(workload, seed, traced, device, **patches)
    mode = MODES[run.traffic["mode"]](run)
    mode.setup()
    run.sync()
    t_window = time.perf_counter()
    timeline = None
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if traced:
        run.spans.clear()
        run.counters.clear()
        with trace.Recorder(device) as rec:
            with torch.profiler.record_function("bench.window"):
                wall, e2e = mode.window(seconds, units=1)
        timeline = rec.timeline()
    else:
        wall, e2e = mode.window(seconds)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    found = jax_modules()
    mode.outputs()
    if device == "cuda":
        torch.cuda.empty_cache()
    limits = load_json(HERE, "limits", workload + ".json")["checks"]
    values = reference_check(mode)
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics: Dict[str, Dict[str, Any]] = {}
    if traced:
        ctx = Context(run, timeline)
        for m in run.bench["per_layer"]:
            if applies(m, workload):
                v = read_metric(m["name"], ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e["peak_mem_gib"] = peak / float(1 << 30)
        e2e["setup_s"] = t_window - _T_START
        for m in run.bench["end_to_end"]:
            if applies(m, workload):
                key = base_name(m["name"], e2e, "_")
                metrics[m["name"]] = {"value": e2e[key], "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": int(run.cell["chips"]), "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {"correct": correct,
                              "attempted": mode.attempted,
                              "failed": mode.failed, "metrics": metrics,
                              "device": dev}
    if traced:
        dev["busy_s"] = timeline.busy_s
        dev["window_s"] = timeline.window_s
        result["breakdown"] = timeline.breakdown()
    result["jax_modules"] = found
    result["unit_s"] = mode.unit_s
    result["readings"] = values
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, cell, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; this benchmark measures the card "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = result.pop("jax_modules")
    result.pop("readings")
    print("units (s): " + " ".join(f"{v:.4f}" for v in result.pop("unit_s")),
          file=sys.stderr)
    if found:
        print(f"benchmark: JAX modules loaded in the measuring process: "
              f"{found}", file=sys.stderr)
        return 4
    limit = power_limit()
    if limit:
        print(f"card: {limit}", file=sys.stderr)
        result["device"]["power"] = limit
    checks = result.pop("checks")
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
