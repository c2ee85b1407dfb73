"""NeuralMap: the online bi-level fusion pipeline (integrate / optimize / mesh).

Counterpart of bnv_fusion_tpu/pipeline.py:36-1546 (with demo mode's
incremental mesh, :1398-1496), with the data-parallel fuse and optimize of
``trainer.fuse_devices`` / ``optimize_devices`` over a ``torch.distributed``
process group (``parallel/``).  The table routes as
``tables.create_table`` does (dense, or blocks for big grids), or under
``model.table_layout=spatial`` is region-sharded over the
``trainer.fuse_devices`` ranks (``parallel/spatial.py``: each rank holds
one slab of the map, and decode, optimize, mesh and save meet in
collectives, so every rank calls them).  The TSDF prior is dense or, for
big scenes (``model.tsdf_layout``), block-major with frustum-exact sparse
updates, replicated on every rank.  PyTorch runs eagerly, so the JAX
package's jit caches have no counterpart, and a width change (``_widen``)
needs no rebuild.  The device
comes from the config's ``device_type``: ``tpu`` (the repo default, meaning
"the accelerator") and ``cuda`` select CUDA and raise where there is none;
``cpu`` is for tests.  Option values the layout or the process group
cannot serve raise ``ValueError`` (``check_supported``).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bnv_fusion_tpu_torch import checkpoint as ckpt_io
from bnv_fusion_tpu_torch import fusion, geometry, mesh as mesh_mod
from bnv_fusion_tpu_torch import nn as bnn
from bnv_fusion_tpu_torch import optimize, sampler, table_blocks, tsdf
from bnv_fusion_tpu_torch import tables as tbl
from bnv_fusion_tpu_torch import voxel as vx
from bnv_fusion_tpu_torch.kernels import fused_decode
from bnv_fusion_tpu_torch.utils import image_io, profiling

log = logging.getLogger(__name__)


def resolve_device(device_type) -> torch.device:
    """Config ``device_type`` -> torch device (tpu/cuda/gpu = CUDA)."""
    dt = str(device_type).lower()
    if dt in ("tpu", "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device_type={device_type} asks for the "
                               "accelerator, but CUDA is not available")
        return torch.device("cuda")
    if dt == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device_type {device_type!r} (tpu|cuda|cpu)")


def check_supported(config) -> None:
    """Raise ``ValueError`` for the option values this run cannot serve:
    ``trainer.*_devices`` counts the process group cannot
    (``parallel.resolve_count``), and ``model.table_layout=spatial`` with
    ``trainer.fuse_devices`` below 2 or with ``optimize_devices`` above 1,
    as the JAX package refuses them (pipeline.py:138-140, :1116-1121; it
    refuses the second when the optimize starts, the port before the
    fuse).  Every other ``model.table_layout`` runs as ``auto``, as in the
    JAX package."""
    from bnv_fusion_tpu_torch.parallel import resolve_count

    m, t = config.model, config.trainer
    n = {name: resolve_count(getattr(t, name, 1), f"trainer.{name}")
         for name in ("fuse_devices", "optimize_devices",
                      "pretrain_devices")}
    if str(getattr(m, "table_layout", "auto")) != "spatial":
        return
    if n["fuse_devices"] <= 1:
        raise ValueError("model.table_layout=spatial needs "
                         "trainer.fuse_devices > 1")
    if n["optimize_devices"] > 1:
        raise ValueError(
            "trainer.optimize_devices > 1 (ray DP) cannot be combined "
            "with model.table_layout=spatial — the spatial layout already "
            "owns the device mesh; spatial maps optimize through the "
            "single-program step on owner-assembled rows")


def _frame_points(depth, T_wc, intr):
    """Back-project one raw frame to oriented world points [H*W, 3].

    The camera-facing normals are negated: the pretrained encoder's decoded
    SDF is positive opposite the input normal, and the pipeline needs SDF
    positive on the camera side (the reference carries the same flip)."""
    xyz_cam = geometry.depth_to_xyz(depth, intr)
    valid = (depth > 0).reshape(-1)
    normals_cam = geometry.normals_from_depth(depth, intr, mask=depth > 0)
    pts_w = geometry.transform_points(T_wc, xyz_cam.reshape(-1, 3))
    normals_w = -geometry.rotate_vectors(T_wc, normals_cam.reshape(-1, 3))
    return pts_w, normals_w, valid


class NeuralMap:
    def __init__(self, dimensions: np.ndarray, config, params: Dict[str, Any],
                 working_dir: str = ".", capacity: Optional[int] = None):
        check_supported(config)
        m = config.model
        self.config = config
        self.device = resolve_device(getattr(config, "device_type", "tpu"))
        # trainer.fuse_devices / optimize_devices > 1: the DP paths over the
        # process group (parallel/dp.py); "all" / 0 = the world size
        from bnv_fusion_tpu_torch import parallel

        self._fuse_devices = parallel.resolve_count(
            getattr(config.trainer, "fuse_devices", 1))
        self._optimize_devices = parallel.resolve_count(
            getattr(config.trainer, "optimize_devices", 1))
        self._group = (parallel.make_mesh() if max(self._fuse_devices,
                                                   self._optimize_devices) > 1
                       else None)
        self.params = bnn.params_from_numpy(
            _to_numpy_tree(params), self.device)
        self.working_dir = working_dir
        self.voxel_size = float(m.voxel_size)
        self.feat_dims = int(m.feature_vector_size)
        self.min_pts_in_grid = int(m.min_pts_in_grid)
        self.ray_max_dist = float(m.ray_tracer.ray_max_dist)
        self.truncated_units = int(m.ray_tracer.truncated_units)
        self.truncated_dist = min(
            self.truncated_units * self.voxel_size * 0.5, 0.1)
        self.sdf_delta_weight = float(m.sdf_delta_weight)
        self.train_ray_splits = int(m.train_ray_splits)
        self.sampling_size = int(config.dataset.num_pixels)
        self.dimensions = np.asarray(dimensions, np.float32)

        min_c, max_c, n_xyz = vx.get_world_range(self.dimensions,
                                                 self.voxel_size)
        self.bound_min = torch.as_tensor(min_c, device=self.device)
        self.bound_max = torch.as_tensor(max_c, device=self.device)
        self.n_xyz = tuple(int(v) for v in n_xyz)
        if capacity is None:
            capacity = int(getattr(m, "table_capacity", 1 << 21))
        # model.table_layout=spatial: the map region-sharded over the
        # trainer.fuse_devices ranks (check_supported asks for > 1), with
        # the grid's minor axis padded so that n_vox divides them (the
        # padded voxels lie beyond bound_max and are never observed) and
        # the capacity rounded up to a multiple of them, as in the JAX
        # package; decode, optimize and mesh read through OwnerRows
        self._spatial = str(getattr(m, "table_layout", "auto")) == "spatial"
        self._rows = None
        if self._spatial:
            from bnv_fusion_tpu_torch.parallel import spatial

            d = self._fuse_devices
            nx, ny, nz = self.n_xyz
            if (nx * ny * nz) % d:
                nz = -(-nz // d) * d
            self.n_xyz = (nx, ny, nz)
            capacity = -(-int(capacity) // d) * d
            self.table = spatial.create_spatial_table(
                self._group, self.n_xyz, capacity, self.feat_dims,
                self.device)
            self._rows = spatial.OwnerRows(self._group)
        else:
            self.table = tbl.create_table(self.feat_dims, capacity,
                                          n_xyz=self.n_xyz,
                                          device=self.device)

        self.tsdf_voxel_size = float(getattr(m, "tsdf_voxel_size", 0.025))
        # model.fuse_color: an RGB running mean in the prior, read by
        # extract_mesh for vertex colours (geometry is unaffected)
        self.fuse_color = bool(getattr(m, "fuse_color", False))
        # prior layout: dense [X, Y, Z] for small scenes; block-major bricks
        # with frustum-exact sparse updates (tsdf.integrate_blocks) under
        # model.tsdf_layout=blocks, or under auto from 8M prior voxels
        create = (tsdf.create_tsdf_volume_bm
                  if tsdf.is_block_major(
                      str(getattr(m, "tsdf_layout", "auto")),
                      self.dimensions, self.tsdf_voxel_size)
                  else tsdf.create_tsdf_volume)
        self.tsdf_vol, _ = create(self.dimensions, self.tsdf_voxel_size,
                                  device=self.device,
                                  with_color=self.fuse_color)

        # compaction widths: ints from the config, or "auto" = sized from an
        # occupancy probe of the first batch (fusion.frame_width_counts) with
        # model.width_margin headroom, widened when overflow still appears
        # (read from a lagged copy of the counter, _note_overflow)
        mu = getattr(m, "max_unique_per_frame", 1 << 17)
        muc = getattr(m, "max_unique_cells_per_frame", None)
        self._auto_widths = (str(mu).lower() == "auto" or
                             str(muc).lower() == "auto")
        self._width_margin = float(getattr(m, "width_margin", 1.5))
        self._widths = None if self._auto_widths else (
            int(mu), int(muc) if muc else None)
        mub = getattr(m, "max_unique_per_batch", None)
        # "auto" = 2 x max_unique_per_frame, derived in fuse_frames_merged
        self._mu_batch = (int(mub) if mub and str(mub).lower() != "auto"
                          else None)
        self._overflow_seen = 0
        self._overflow_lag: List[Any] = []
        self._last_staged_dev: Optional[tuple] = None

        self.frames: List[Dict[str, Any]] = []
        # fuse epoch: bumped whenever the key set may change; a mesh-lattice
        # prefetch is valid only for the epoch it was taken at
        self._fuse_epoch = 0
        self._mesh_prefetch: Optional[Dict[str, Any]] = None
        self._window: Optional[tuple] = None
        self._window_intr: Optional[np.ndarray] = None
        self._window_built = False
        self._max_blocks: Optional[int] = None
        self.generator = torch.Generator().manual_seed(
            int(getattr(config.trainer, "seed", 0)))
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else None)
        self.timer = profiling.PhaseTimer(["local", "global", "mesh",
                                           "inc_mesh"], sync=sync)
        self.optimize_losses: List[float] = []
        self.last_optimize_iters = 0
        # model.error_guided_sampling: one patch error map per frame, keyed
        # by the frame's index in self.frames and kept across optimize calls;
        # the pixels are drawn on the maps' device by _pixel_generator
        self.error_maps: Dict[int, torch.Tensor] = {}
        self._pixel_generator: Optional[torch.Generator] = None
        # per-frame mean points per touched voxel, kept on the device until
        # read (fetching each would sync every frame)
        self._pending_stats: List[torch.Tensor] = []
        self._optim_step = None
        self._optim_lr = None
        # demo mode: the incremental mesher and its device snapshot of
        # (weights, num_hits, features) rows at the last committed event
        self.inc_mesher = None
        self._inc_prev: Optional[tuple] = None

    # ------------------------------------------------------------------
    # local fusion
    # ------------------------------------------------------------------

    def _width_values(self) -> tuple:
        """(max_unique_per_frame, max_unique_cells_per_frame), resolved."""
        if self._widths is None:
            raise RuntimeError(
                "auto compaction widths not sized yet — the first "
                "integrate/integrate_batch call probes them")
        return self._widths

    @staticmethod
    def _next_pow2(x: int) -> int:
        return 1 << max(int(x) - 1, 1).bit_length()

    def _probe_width_counts(self, depths, T_wcs, intrs):
        """Occupancy of a frame batch on the device: per-frame (unique cell
        groups, unique corner voxels), two int32 [K] tensors."""
        g, c = [], []
        for d, t, i in zip(depths, T_wcs, intrs):
            pts_w, _, valid = _frame_points(d, t, i)
            gi, ci = fusion.frame_width_counts(
                pts_w, valid, self.bound_min, self.bound_max,
                self.voxel_size, self.n_xyz, self.table.n_voxels)
            g.append(gi)
            c.append(ci)
        return torch.stack(g), torch.stack(c)

    def _size_widths(self, depths, T_wcs, intrs):
        """Set the widths from a probe of this batch and width_margin:
        cells -> the next power of two, corner voxels -> a multiple of 4096
        capped at 8 x cells."""
        g, c = self._probe_width_counts(depths, T_wcs, intrs)
        g_max, c_max = int(g.max()), int(c.max())
        m = self._width_margin
        u_cell = self._next_pow2(max(int(g_max * m), 4096))
        mu = min(-(-int(c_max * m) // 4096) * 4096, 8 * u_cell)
        self._widths = (mu, u_cell)
        log.info(f"auto widths: probed g_max={g_max} c_max={c_max} over "
                 f"{len(g)} frames -> max_unique_per_frame={mu} "
                 f"cells={u_cell}")

    def _overflow_counter(self) -> torch.Tensor:
        """The table's overflow counter on the device; under the spatial
        layout each shard counts its own drops, summed over the ranks here
        (so every rank widens alike)."""
        if self._spatial:
            return self._group.all_reduce(self.table.overflow)
        return self.table.overflow

    def _overflow_copy(self):
        """A copy of the overflow counter as it stands in the queue now:
        the table is written in place, so a later read of the live counter
        would see later drops.  On CUDA the copy lands in pinned host memory
        behind an event, so reading it later waits only for that event."""
        c = self._overflow_counter()
        if c.device.type != "cuda":
            return c.clone(), None
        host = torch.empty((), dtype=c.dtype, pin_memory=True)
        host.copy_(c, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _note_overflow(self, flush: bool = False):
        """Lag-checked overflow monitor (auto widths only): queue a copy of
        the counter and read those >= 2 batches old, whose work the device
        has already done.  On growth, widen the widths (``_widen``)."""
        if not self._auto_widths:
            return
        self._overflow_lag.append(self._overflow_copy())
        depth = 0 if flush else 2
        while len(self._overflow_lag) > depth:
            val, ev = self._overflow_lag.pop(0)
            if ev is not None:
                ev.synchronize()
            if int(val) > self._overflow_seen:
                self._overflow_seen = int(val)
                self._widen()

    def _widen(self):
        """Overflow despite the probe: re-probe the latest staged batch and
        grow the widths to max(probe x margin, 1.5 x the current ones)."""
        cur_mu, cur_cell = self._widths
        new_mu, new_cell = int(cur_mu * 1.5), self._next_pow2(cur_cell + 1)
        if self._last_staged_dev is not None:
            g, c = self._probe_width_counts(*self._last_staged_dev)
            m = self._width_margin
            new_cell = max(new_cell, self._next_pow2(int(int(g.max()) * m)))
            new_mu = max(new_mu, -(-int(int(c.max()) * m) // 4096) * 4096)
        new_mu = min(-(-new_mu // 4096) * 4096, 8 * new_cell)
        log.warning(f"table overflow {self._overflow_seen} with widths "
                    f"({cur_mu}, {cur_cell}) — widening to ({new_mu}, "
                    f"{new_cell})")
        self._widths = (new_mu, new_cell)
        # the queued copies (and the cumulative counter) record drops under
        # the old widths: fast-forward so they cannot widen a second time
        self._overflow_lag.clear()
        self._overflow_seen = max(self._overflow_seen, self.overflow)

    def _model_dtype(self, name: str) -> torch.dtype:
        """An operand precision of the config's model: ``fuse_dtype`` (the
        encoder's) or ``optim_dtype`` (the render loss's decoder)."""
        return (torch.bfloat16 if str(getattr(self.config.model, name,
                                              "float32")) == "bfloat16"
                else torch.float32)

    def _tsdf_window_for(self, frame) -> tuple | None:
        """Frustum window for the TSDF prior when it pays (the frustum
        covers < 70% of the prior grid), sized from this frame's
        intrinsics; ``_check_window_intr`` guards later frames."""
        if frame is None or not bool(getattr(self.config.model,
                                             "tsdf_frustum_window", True)):
            return None
        if isinstance(self.tsdf_vol, tsdf.TSDFVolumeBM):
            return None  # block volumes take frustum-exact sparse updates
        intr = np.asarray(frame["intr_mat"], np.float32)
        hw = np.asarray(frame["depth"]).shape
        shape = tuple(self.tsdf_vol.sdf.shape)
        window = tsdf.frustum_window_shape(intr, hw, self.ray_max_dist,
                                           self.tsdf_voxel_size, shape)
        if np.prod(window) >= 0.7 * np.prod(shape):
            return None
        self._window_intr = intr
        return window

    def _check_window_intr(self, frames):
        """Drop the frustum window if intrinsics drift from the ones it (or
        the block budget) was sized for; the block budget is sized again
        from the next frame."""
        if self._window_intr is None:
            return
        for f in frames:
            intr = np.asarray(f["intr_mat"], np.float32)
            if np.abs(intr - self._window_intr).max() > \
                    1e-2 * max(self._window_intr[0, 0],
                               self._window_intr[1, 1]):
                self._window_intr = None
                self._window = None
                self._max_blocks = None
                return

    def _tsdf_max_blocks(self, frame0) -> Optional[int]:
        """Active-block budget of the block-major prior, sized from this
        frame's intrinsics (``tsdf.frustum_max_blocks``); drift is guarded
        like the window's."""
        if not isinstance(self.tsdf_vol, tsdf.TSDFVolumeBM):
            return None
        intr = np.asarray(frame0["intr_mat"], np.float32)
        self._window_intr = intr
        return tsdf.frustum_max_blocks(
            intr, np.asarray(frame0["depth"]).shape, self.ray_max_dist,
            self.tsdf_voxel_size, self.tsdf_vol.nb_xyz)

    def _ensure_window(self, frame0):
        if not self._window_built:
            self._window = self._tsdf_window_for(frame0)
            self._window_built = True
        if self._max_blocks is None:
            self._max_blocks = self._tsdf_max_blocks(frame0)

    def _integrate_prior(self, depth, T_wc, intr, obs_weight: float = 1.0,
                         rgb=None):
        if self._max_blocks is not None:
            tsdf.integrate_blocks(self.tsdf_vol, depth, intr, T_wc,
                                  self.tsdf_voxel_size, self._max_blocks,
                                  self.ray_max_dist, obs_weight=obs_weight,
                                  rgb=rgb)
        elif self._window is not None:
            tsdf.integrate_windowed(self.tsdf_vol, depth, intr, T_wc,
                                    self.tsdf_voxel_size, self._window,
                                    self.ray_max_dist, obs_weight=obs_weight,
                                    rgb=rgb)
        else:
            tsdf.integrate(self.tsdf_vol, depth, intr, T_wc,
                           self.tsdf_voxel_size, obs_weight=obs_weight,
                           rgb=rgb)

    @staticmethod
    def _frame_rgb(frame) -> np.ndarray:
        """A frame's colour [H, W, 3] (0-255): inline ``rgb``, or else its
        ``img_path`` decoded and area-resized to the depth's size, as the
        JAX package does with cv2.  uint8 stays uint8, so that it crosses
        to the device at a quarter of the bytes, and anything else becomes
        float32 (``_rgb_tensor`` makes both float32 on the device, the JAX
        package's values)."""
        if frame.get("rgb") is not None:
            rgb = np.asarray(frame["rgb"])
            return rgb if rgb.dtype == np.uint8 else rgb.astype(np.float32)
        path = frame.get("img_path")
        if path and os.path.exists(path):
            return image_io.read_color(path, np.shape(frame["depth"]))
        raise ValueError(
            "model.fuse_color is on but the frame carries neither 'rgb' nor "
            "a readable 'img_path'")

    @property
    def stats(self) -> List[float]:
        """Mean points per touched voxel of every fused frame, in order."""
        if not self._pending_stats:
            return []
        return torch.cat(self._pending_stats).cpu().tolist()

    @property
    def overflow(self) -> int:
        """Voxels/cells dropped by the static compaction widths (0 = every
        observation landed); under the spatial layout the shards' counts
        summed by one all-reduce, so every rank must read it."""
        return int(self._overflow_counter())

    @property
    def mesh_is_collective(self) -> bool:
        """True under the spatial layout: ``extract_mesh``,
        ``extract_mesh_incremental`` and ``save`` meet the other ranks in
        collectives, so every rank calls them (rank 0 alone writes)."""
        return self._spatial

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _rgb_tensor(self, rgb: np.ndarray) -> torch.Tensor:
        """Host colour (uint8 or float32) -> float32 on the device."""
        return torch.as_tensor(rgb, device=self.device).to(torch.float32)

    def _fuse_one(self, depth, T_wc, intr, rgb=None) -> fusion.FrameStats:
        """The per-frame step: ``fusion.fuse_frame`` by
        ``model.fuse_algorithm`` and ``fuse_dtype``, then the prior (and its
        colour, given ``rgb``) at obs_weight 1."""
        max_unique, mu_cells = self._width_values()
        with profiling.span("fuse.points"):
            pts_w, normals_w, valid = _frame_points(depth, T_wc, intr)
        stats = fusion.fuse_frame(
            self.table, self.params, pts_w, normals_w, valid, self.bound_min,
            self.bound_max, self.voxel_size, self.min_pts_in_grid,
            compute_dtype=self._model_dtype("fuse_dtype"),
            max_unique=max_unique,
            algorithm=str(getattr(self.config.model, "fuse_algorithm",
                                  "cell")),
            max_unique_cells=mu_cells)
        with profiling.span("fuse.prior"):
            self._integrate_prior(depth, T_wc, intr, rgb=rgb)
        return stats

    def _fuse_sharded(self, depth, T_wc, intr, rgb=None) -> fusion.FrameStats:
        """The per-frame step under ``trainer.fuse_devices`` > 1: the
        frame's points (padded with valid=False rows to a multiple of the
        group's size) through ``parallel.dp.make_sharded_fuse_frame`` (or,
        under the spatial layout, ``parallel.spatial.
        make_spatial_fuse_frame``) at the current widths, then the prior
        (and its colour) through the single-device route, replicated on
        every rank."""
        from bnv_fusion_tpu_torch.parallel import dp, spatial

        max_unique, mu_cells = self._width_values()
        kw = dict(max_unique=max_unique, max_unique_cells=mu_cells,
                  compute_dtype=self._model_dtype("fuse_dtype"))
        if self._spatial:
            step = spatial.make_spatial_fuse_frame(
                self._group, self.params, self.voxel_size,
                self.min_pts_in_grid, **kw)
        else:
            step = dp.make_sharded_fuse_frame(
                self._group, self.params, self.voxel_size,
                self.min_pts_in_grid, self.table, **kw)
        with profiling.span("fuse.points"):
            pts_w, normals_w, valid = _frame_points(depth, T_wc, intr)
        pad = -pts_w.shape[0] % self._fuse_devices
        if pad:
            pts_w = torch.cat([pts_w, pts_w.new_zeros((pad, 3))])
            normals_w = torch.cat([normals_w, normals_w.new_zeros((pad, 3))])
            valid = torch.cat([valid, valid.new_zeros((pad,))])
        stats = step(self.table, pts_w, normals_w, valid, self.bound_min,
                     self.bound_max)
        with profiling.span("fuse.prior"):
            self._integrate_prior(depth, T_wc, intr, rgb=rgb)
        return stats

    def integrate(self, frame: Dict[str, Any]):
        """Fuse one frame and keep its depth + pose for the optimization ray
        pool (through the points-sharded DP or spatial step when
        ``trainer.fuse_devices`` > 1).  Frames with NaN poses are
        skipped."""
        if np.any(np.isnan(np.asarray(frame["T_wc"]))):
            return None
        with profiling.span("fuse"):
            self._integrate(frame)

    def _integrate(self, frame: Dict[str, Any]):
        """``integrate``'s work, inside its ``fuse`` span."""
        self._check_window_intr([frame])
        self._ensure_window(frame)
        with profiling.span("fuse.stage"):
            depth = self._tensor(frame["depth"])
            T_wc = self._tensor(frame["T_wc"])
            intr = self._tensor(frame["intr_mat"])
            rgb = (self._rgb_tensor(self._frame_rgb(frame)) if self.fuse_color
                   else None)
        if self._auto_widths:
            staged = (depth[None], T_wc[None], intr[None])
            if self._widths is None:
                self._size_widths(*staged)
            self._last_staged_dev = staged
        fuse = self._fuse_sharded if self._fuse_devices > 1 else self._fuse_one
        stats = fuse(depth, T_wc, intr, rgb)
        with profiling.span("fuse.overflow"):
            self._note_overflow()
        self._pending_stats.append(stats.n_avg_pts.reshape(1))
        self._fuse_epoch += 1
        self.frames.append({"depth": depth, "T_wc": T_wc, "intr": intr,
                            "frame_id": frame.get("frame_id")})

    def _stack_batch(self, keep: List[Dict[str, Any]], rgb_every: int = 1):
        """Host numpy stacking of a frame batch (uint16 raw depth when every
        frame carries it; under ``model.fuse_color`` the colour of every
        ``rgb_every``-th frame, the frames the prior reads)."""
        out = {}
        if all(f.get("depth_raw") is not None for f in keep):
            scales = {float(f.get("depth_scale", 1000.0)) for f in keep}
            if len(scales) != 1:
                raise ValueError("mixed depth_scale within one batch")
            out["raw"] = np.stack(
                [np.asarray(f["depth_raw"], np.uint16) for f in keep])
            out["scale"] = next(iter(scales))
        else:
            out["depth"] = np.stack(
                [np.asarray(f["depth"], np.float32) for f in keep])
        out["T_wc"] = np.stack([np.asarray(f["T_wc"], np.float32) for f in keep])
        out["intr"] = np.stack(
            [np.asarray(f["intr_mat"], np.float32) for f in keep])
        if self.fuse_color:
            out["rgb"] = np.stack([self._frame_rgb(f)
                                   for f in keep[::rgb_every]])
        return out

    def _convert_raw_depth(self, raw: np.ndarray, scale: float) -> torch.Tensor:
        """uint16 sensor depth -> metric f32 on the device (/scale, zero at
        >= max_depth)."""
        d = self._tensor(raw.astype(np.int32), torch.int32).to(torch.float32) \
            / float(np.float32(scale))
        return torch.where(d < self.ray_max_dist, d,
                           torch.zeros((), device=self.device))

    def _seg_kernel(self):
        """model.use_seg_reduce_kernel: auto = the batched kernel path on
        CUDA and the per-frame cumsum path on CPU; interpret = the batched
        path with the plain seg-reduce; true/false force it."""
        sk = str(getattr(self.config.model, "use_seg_reduce_kernel",
                         "auto")).lower()
        if sk == "auto":
            return self.device.type == "cuda"
        if sk == "interpret":
            return "interpret"
        return sk in ("true", "1")

    def integrate_batch(self, frames: List[Dict[str, Any]]):
        """Fuse K frames with one table update (fusion.fuse_frames_merged);
        the TSDF prior takes every ``model.tsdf_every``-th frame at
        obs_weight = tsdf_every (with its ``rgb`` under
        ``model.fuse_color``).  With ``model.fuse_batch_merge=false`` or a
        ``fuse_algorithm`` other than ``cell*`` the frames run the per-frame
        step one by one instead, the prior on every frame at obs_weight 1
        (``tsdf_every`` does not apply there, as in the JAX package).
        ``model.fuse_sort1_gather`` is accepted and changes nothing: the JAX
        package's option picks between two stage-1 sorts with identical
        bits, and the port keeps the faster (``fusion._cellsort_sort1``).
        Under ``trainer.fuse_devices`` > 1 the frames go through
        ``integrate`` one by one, without the K-merge, as in the JAX
        package."""
        if self._fuse_devices > 1:
            for f in frames:
                self.integrate(f)
            return
        keep = [f for f in frames
                if not np.any(np.isnan(np.asarray(f["T_wc"])))]
        if not keep:
            return
        with profiling.span("fuse"):
            self._integrate_batch(keep)

    def _integrate_batch(self, keep: List[Dict[str, Any]]):
        """``integrate_batch``'s work on the frames it keeps, inside its
        ``fuse`` span."""
        self._check_window_intr(keep)
        self._ensure_window(keep[0])
        m = self.config.model
        algorithm = str(getattr(m, "fuse_algorithm", "cell"))
        merged = (bool(getattr(m, "fuse_batch_merge", True)) and
                  algorithm.startswith("cell"))
        every = int(getattr(m, "tsdf_every", 1)) if merged else 1
        with profiling.span("fuse.stage"):
            staged = self._stack_batch(keep, rgb_every=every)
            if "raw" in staged:
                depths = self._convert_raw_depth(staged["raw"],
                                                 staged["scale"])
            else:
                depths = self._tensor(staged["depth"])
            T_wcs = self._tensor(staged["T_wc"])
            intrs = self._tensor(staged["intr"])
            rgbs = (self._rgb_tensor(staged["rgb"]) if "rgb" in staged
                    else [None] * len(keep))
        if self._auto_widths:
            if self._widths is None:
                self._size_widths(depths, T_wcs, intrs)
            self._last_staged_dev = (depths, T_wcs, intrs)
        if not merged:
            n_avg = torch.cat([
                self._fuse_one(d, t, i, c).n_avg_pts.reshape(1)
                for d, t, i, c in zip(depths, T_wcs, intrs, rgbs)])
        else:
            with profiling.span("fuse.points"):
                pts = [_frame_points(d, t, i)
                       for d, t, i in zip(depths, T_wcs, intrs)]
                pts_w, normals_w, valid = (torch.stack([p[j] for p in pts])
                                           for j in range(3))
                del pts
            max_unique, mu_cells = self._width_values()
            n_avg = fusion.fuse_frames_merged(
                self.table, self.params, pts_w, normals_w, valid,
                self.bound_min, self.bound_max, self.voxel_size,
                self.min_pts_in_grid, max_unique=max_unique,
                max_unique_cells=mu_cells, max_unique_batch=self._mu_batch,
                seg_kernel=self._seg_kernel(),
                sort_bf16=bool(getattr(m, "fuse_sort_bf16", False)),
                compute_dtype=self._model_dtype("fuse_dtype"),
                front_chunks=int(getattr(m, "fuse_front_chunks", 1))
            ).n_avg_pts.reshape(-1)
            del pts_w, normals_w, valid
            with profiling.span("fuse.prior"):
                for j in range(0, len(keep), every):
                    self._integrate_prior(depths[j], T_wcs[j], intrs[j],
                                          obs_weight=float(every),
                                          rgb=rgbs[j // every])
        with profiling.span("fuse.overflow"):
            self._note_overflow()
        self._pending_stats.append(n_avg)
        self._fuse_epoch += 1
        for f, d, t, i in zip(keep, depths, T_wcs, intrs):
            self.frames.append({"depth": d, "T_wc": t, "intr": i,
                                "frame_id": f.get("frame_id")})

    def integrate_batches(self, batches: List[List[Dict[str, Any]]]):
        """Fuse several K-frame batches by sequential ``integrate_batch``
        calls (the JAX package's entry point, which bench.py times).  The
        JAX package stacks the next batch on a host thread meanwhile; on the
        H100 that moved no time the spread resolves, so the port does not."""
        for b in batches:
            self.integrate_batch(b)

    # ------------------------------------------------------------------
    # global fusion
    # ------------------------------------------------------------------

    def optimize(self, n_iters: int, last_frame: int = -1, lr: float = 1e-3,
                 frame_order: str | None = None):
        """Render-loss optimization of the latents (Adam on the table's
        features, count_optim bumps on its weights), written back to the
        table at the end.  ``frame_order``: "random" draws frames i.i.d.,
        "epoch" sweeps the pool in order; None reads
        ``trainer.optim_frame_order``.  Iterations run in launch groups of
        ``model.optim_iters_per_launch``.  ``model.optim_dtype`` rounds the
        loss's decoder operands (the latents and Adam stay float32);
        ``model.error_guided_sampling`` draws half the rays from each frame's
        error map, which every group reads as it stood before the group;
        ``trainer.optim_early_stop`` treats ``n_iters`` as a ceiling
        (``optimize.EarlyStop``).  Per-iteration losses land in
        ``self.optimize_losses``, the count in ``self.last_optimize_iters``.
        Under ``trainer.optimize_devices`` > 1 each iteration is the ray-DP
        step (``parallel.dp.make_sharded_optimize_iter``: the sequential
        chunk schedule, whatever ``model.parallel_ray_chunks`` says) on the
        same frames, pixels and uniforms as one device draws for the seed;
        error-guided sampling is refused there, as in the JAX package.
        Under the spatial layout every rank runs the single-device step on
        its shard, with the corner rows assembled over the ranks
        (``parallel.spatial.OwnerRows``), on the same draws."""
        if not self.frames:
            return
        m, tr = self.config.model, self.config.trainer
        if frame_order is None:
            frame_order = str(getattr(tr, "optim_frame_order", "random"))
        error_guided = bool(getattr(m, "error_guided_sampling", False))
        if error_guided and self._optimize_devices > 1:
            raise ValueError(
                "error_guided_sampling is not supported with "
                "trainer.optimize_devices > 1 (the per-frame error maps are "
                "host state); set one or the other")
        # the mesh lattice builds on the host while the optimize runs; the
        # next extract_mesh takes it if no frame was fused since
        self.prefetch_mesh_lattice()
        if self._optim_step is None or self._optim_lr != lr:
            self._optim_lr = lr
            self._optim_step = self.make_optim_step(lr)
        if error_guided and self._pixel_generator is None:
            self._pixel_generator = torch.Generator(
                device=self.device).manual_seed(int(torch.randint(
                    0, 2 ** 31 - 1, (1,), generator=self.generator)))
        sdf_delta = tsdf.prepare_sdf_delta(
            self.tsdf_vol, self.tsdf_voxel_size, self.truncated_dist,
            self.sdf_delta_weight)
        state = optimize.init_optim_state(self.table)
        lo = 0 if last_frame < 0 else max(0, last_frame)
        frame_pool = self.frames[lo:]
        group = int(getattr(m, "optim_iters_per_launch", 4))
        stop = (optimize.EarlyStop(float(getattr(tr, "optim_es_rel", 0.005)),
                                   int(getattr(tr, "optim_es_patience", 3)))
                if bool(getattr(tr, "optim_early_stop", False)) else None)
        rng = np.random.RandomState(int(torch.randint(
            0, 2 ** 31 - 1, (1,), generator=self.generator)))
        lr_scales = self._optim_lr_scales(n_iters)
        losses = []
        done = 0
        while done < int(n_iters):
            k = min(group, int(n_iters) - done)
            if frame_order == "epoch":
                fis = (done + np.arange(k)) % len(frame_pool)
            else:
                fis = rng.randint(0, len(frame_pool), size=k)
            if error_guided:
                # the maps as they stand before the group: a frame drawn
                # twice in it reads this map both times, and its later
                # update is the one kept (the JAX package's launch group)
                maps = [self._error_map(lo + int(fi), frame_pool[fi]["depth"])
                        for fi in fis]
            group_losses = []
            for j, fi in enumerate(fis):
                f = frame_pool[fi]
                guided = (dict(error_map=maps[j],
                               pixel_generator=self._pixel_generator)
                          if error_guided else {})
                out = self._optim_step(
                    state, self.table, f["depth"], f["T_wc"], f["intr"],
                    self.bound_min, self.n_xyz, sdf_delta,
                    generator=self.generator,
                    lr_scale=float(lr_scales[done + j]), **guided)
                state, loss = out[0], out[1]
                if error_guided:
                    self.error_maps[lo + int(fi)] = out[2]
                group_losses.append(loss)
            losses.extend(group_losses)
            done += k
            if stop is not None and k == group and stop.update(group_losses):
                break
        self.last_optimize_iters = done
        self.optimize_losses = torch.stack(losses).cpu().tolist()
        self.table.features = state.features
        self.table.weights = state.weights

    def make_optim_step(self, lr: float):
        """The optimize step (``optimize.make_optimize_step``; under
        ``trainer.optimize_devices`` > 1 the ray-DP
        ``parallel.dp.make_sharded_optimize_iter``; under the spatial
        layout on ``parallel.spatial.OwnerRows``) at ``lr`` with this
        map's geometry and the config's model options."""
        m = self.config.model
        if self._optimize_devices > 1:
            from bnv_fusion_tpu_torch.parallel import dp

            return dp.make_sharded_optimize_iter(
                self._group, self.params, self.voxel_size,
                self.min_pts_in_grid, self.truncated_units,
                self.truncated_dist, self.ray_max_dist,
                n_rays=self.sampling_size,
                train_ray_splits=self.train_ray_splits, lr=lr,
                neighbor_kernel=int(getattr(m, "neighbor_kernel", 3)),
                n_fine=int(getattr(m.ray_tracer, "n_fine", 0) or 0),
                n_coarse=int(getattr(m.ray_tracer, "n_coarse", 0) or 0),
                compute_dtype=self._model_dtype("optim_dtype"),
                grad_scatter=str(getattr(m, "grad_scatter", "sortreduce")))
        return optimize.make_optimize_step(
            self.params, voxel_size=self.voxel_size,
            min_pts_in_grid=self.min_pts_in_grid,
            truncated_units=self.truncated_units,
            truncated_dist=self.truncated_dist,
            ray_max_dist=self.ray_max_dist, n_rays=self.sampling_size,
            train_ray_splits=self.train_ray_splits, lr=lr,
            compute_dtype=self._model_dtype("optim_dtype"),
            neighbor_kernel=int(getattr(m, "neighbor_kernel", 3)),
            error_guided=bool(getattr(m, "error_guided_sampling", False)),
            decode_layout=str(getattr(m, "decode_layout", "rows")),
            parallel_chunks=bool(getattr(m, "parallel_ray_chunks", False)),
            n_fine=int(getattr(m.ray_tracer, "n_fine", 0) or 0),
            n_coarse=int(getattr(m.ray_tracer, "n_coarse", 0) or 0),
            grad_scatter=str(getattr(m, "grad_scatter", "sortreduce")),
            rows=self._rows)

    def _error_map(self, i: int, depth: torch.Tensor) -> torch.Tensor:
        """Frame ``i``'s error map, made uniform at its first use."""
        if i not in self.error_maps:
            self.error_maps[i] = sampler.create_error_maps(
                1, tuple(depth.shape),
                int(getattr(self.config.model, "error_patch", 16)),
                device=self.device)[0]
        return self.error_maps[i]

    def _optim_lr_scales(self, n_iters: int) -> np.ndarray:
        """Per-iteration lr multipliers (``trainer.optim_lr_schedule``):
        const, or cosine/linear decay to ``optim_lr_end_frac``."""
        sched = str(getattr(self.config.trainer, "optim_lr_schedule", "const"))
        n = max(int(n_iters), 1)
        if sched == "const":
            return np.ones(n, np.float32)
        end = float(getattr(self.config.trainer, "optim_lr_end_frac", 0.1))
        t = np.arange(n, dtype=np.float32) / max(n - 1, 1)
        if sched == "cosine":
            s = end + (1.0 - end) * 0.5 * (1.0 + np.cos(np.pi * t))
        elif sched == "linear":
            s = 1.0 + (end - 1.0) * t
        else:
            raise ValueError(f"unknown trainer.optim_lr_schedule: {sched!r} "
                             "(const | cosine | linear)")
        return s.astype(np.float32)

    # ------------------------------------------------------------------
    # meshing / io
    # ------------------------------------------------------------------

    def _mesh_decoder(self, use_delta: bool):
        """decode_fn(coords [B, 3] voxel coords) -> SDF [B] f32 on the
        device, NaN where a corner lacks weight, rounded through
        ``model.mesh_fetch_dtype``.  With ``model.use_fused_decode_kernel``
        on CUDA it runs the fused decode kernel, on the decoder packed once
        here (the weights are fixed while meshing); otherwise the plain
        decode in ``model.mesh_decode_layout`` (null: ``decode_layout``).
        Both mesh paths decode through this; under the spatial layout on
        owner-assembled rows (``parallel.spatial.OwnerRows``), so every
        rank must call it on the same batches."""
        m = self.config.model
        use_fused = (self.device.type != "cpu" and
                     bool(getattr(m, "use_fused_decode_kernel", False)))
        # the mesh decode's layout; the fused kernel keeps its own
        layout = str(getattr(m, "mesh_decode_layout", None)
                     or getattr(m, "decode_layout", "rows") or "rows")
        fetch_dt = {"float32": torch.float32, "float16": torch.float16,
                    "bfloat16": torch.bfloat16}[
            str(getattr(m, "mesh_fetch_dtype", "float32"))]
        sdf_delta = tsdf.prepare_sdf_delta(
            self.tsdf_vol, self.tsdf_voxel_size, self.truncated_dist,
            self.sdf_delta_weight) if use_delta else None
        packed = None
        if use_fused and fused_decode.fused_decode_available(self.params):
            with torch.no_grad():
                packed = fused_decode.pack_decoder_tc(self.params["decoder"])

        def decode_fn(coords) -> torch.Tensor:
            coords = torch.as_tensor(coords, device=self.device)
            with torch.no_grad():
                out = fusion.decode_points(
                    self.table.features, self.table, self.params, coords,
                    self.bound_min, self.voxel_size, self.min_pts_in_grid,
                    sdf_delta=sdf_delta, n_xyz=self.n_xyz, is_coords=True,
                    use_fused_kernel=use_fused, masked_fill=float("nan"),
                    layout=layout, packed_decoder=packed, rows=self._rows)
            return out.to(fetch_dt).to(torch.float32)

        return decode_fn, sdf_delta

    def _active_entries(self, with_features: bool = True):
        """Host (keys, features or None, weights, hits) of the allocated
        voxels: ``tables.active_entries`` in slot order, or under the
        spatial layout every shard's, gathered on every rank in flat-id
        order (``parallel.spatial.spatial_active_entries``)."""
        if self._spatial:
            from bnv_fusion_tpu_torch.parallel import spatial

            return spatial.spatial_active_entries(self._group, self.table,
                                                  with_features)
        return tbl.active_entries(self.table, with_features)[:4]

    def _mesh_decode_batch(self) -> int:
        """Lattice points per decode batch, for both mesh paths."""
        return int(getattr(self.config.model, "mesh_decode_batch", 1 << 18))

    def _mesh_weights(self, weights: np.ndarray,
                      hits: np.ndarray) -> np.ndarray:
        """Fusion weights as both mesh paths gate them: a voxel meshes where
        this is >= ``min_pts_in_grid``.  Under
        ``model.mesh_require_observation`` a voxel without a fused
        observation (hits 0) gets -inf, so it never meshes.  (The JAX
        package's incremental path gives it 0, which still meshes when
        ``min_pts_in_grid`` is 0, unlike its ``extract_mesh``.)"""
        if not bool(getattr(self.config.model, "mesh_require_observation",
                            False)):
            return weights
        return np.where(hits > 0, weights,
                        np.float32(-np.inf)).astype(weights.dtype)

    def prefetch_mesh_lattice(self):
        """Start building the mesh sample lattice of every allocated voxel
        on a host thread, to overlap the optimize that follows (``optimize``
        calls this first).  The key set does not change while optimizing,
        and every lattice cell has one owner voxel
        (``mesh.cell_owner_voxel``), so ``extract_mesh`` filters this
        superset to its post-optimize gate and meshes exactly what the
        in-line build would.  The slot keys come to the host here, on the
        caller's thread: a copy issued from the worker would queue behind
        the optimize launches.  The worker runs numpy and the native
        lattice builder only.  A no-op with ``model.mesh_prefetch=false``,
        when a prefetch of this fuse epoch exists, on a table without
        ``slot_flat`` (a block table: ``extract_mesh`` builds in line) or
        under the spatial layout, as in the JAX package."""
        m = self.config.model
        if not bool(getattr(m, "mesh_prefetch", True)) or self._spatial or \
                not hasattr(self.table, "slot_flat"):
            return
        scale = int(getattr(m, "mesh_lattice_scale", 2))
        pf = self._mesh_prefetch
        if pf is not None and pf["epoch"] == self._fuse_epoch and \
                pf["scale"] == scale:
            return
        n = int(self.table.n_alloc)
        if n == 0:
            self._mesh_prefetch = None
            return
        flat = self.table.slot_flat[:n].cpu().numpy().astype(np.int64)
        _, ny, nz = self.n_xyz
        box: Dict[str, Any] = {"epoch": self._fuse_epoch, "scale": scale,
                               "n": n}

        def work():
            try:
                keys = np.stack([flat // (ny * nz), (flat // nz) % ny,
                                 flat % nz], axis=-1).astype(np.int32)
                lattice = mesh_mod.build_sample_lattice(keys, scale)
                # every cell -> its owner voxel's ROW, so the gate filters
                # the cells with one gather
                owner = mesh_mod.cell_owner_voxel(lattice[2], scale)
                kk = mesh_mod.coord_key3(keys)
                order = np.argsort(kk)
                pos = np.searchsorted(kk[order], mesh_mod.coord_key3(owner))
                box["owner_rows"] = order[np.clip(pos, 0, n - 1)]
                box["lattice"] = lattice
            except Exception as e:  # re-raised where the lattice is read
                box["error"] = e

        box["thread"] = threading.Thread(target=work, daemon=True)
        box["thread"].start()
        self._mesh_prefetch = box

    def _prefetched_lattice(self):
        """The prefetch box (lattice, owner rows, n) if it is still valid:
        taken at this fuse epoch and lattice scale, with
        ``model.mesh_prefetch`` on.  Else None.  Waits for the worker, and
        raises what it raised."""
        box = self._mesh_prefetch
        m = self.config.model
        if box is None or box["epoch"] != self._fuse_epoch or \
                not bool(getattr(m, "mesh_prefetch", True)) or \
                box["scale"] != int(getattr(m, "mesh_lattice_scale", 2)):
            return None
        box["thread"].join()
        if "error" in box:
            raise RuntimeError("the mesh-lattice prefetch failed") \
                from box["error"]
        if int(self.table.n_alloc) != box["n"]:
            return None
        return box

    def extract_mesh(self, use_delta: bool = True,
                     batch_size: int | None = None
                     ) -> Optional[mesh_mod.Mesh]:
        """Decode the SDF on the half-voxel lattice of the voxels with real
        fusion weight (and, with ``model.mesh_require_observation``, a fused
        observation) and run marching tetrahedra on the host.  A valid
        prefetched lattice (``prefetch_mesh_lattice``) is filtered to the
        same gate, through the same ``_mesh_weights``, in place of the
        in-line build.  Under ``model.fuse_color`` the vertices take their
        colours from the prior (``tsdf.sample_color``).  Under the spatial
        layout every rank meshes (the keys from
        ``parallel.spatial.spatial_active_entries``, no prefetch)."""
        m = self.config.model
        if batch_size is None:
            batch_size = self._mesh_decode_batch()
        box = None if self._spatial else self._prefetched_lattice()
        lattice = active = None
        if box is not None:
            n = box["n"]
            gate = self._mesh_weights(
                self.table.weights[:n].cpu().numpy(),
                self.table.num_hits[:n].cpu().numpy()) >= self.min_pts_in_grid
            if not gate.any():
                return None
            points, corner_idx, cells = box["lattice"]
            sel = gate[box["owner_rows"]]
            lattice = (points, corner_idx[sel], cells[sel])
        else:
            keys, _, weights, hits = self._active_entries(
                with_features=False)
            active = keys[self._mesh_weights(weights, hits) >=
                          self.min_pts_in_grid]
            if len(active) == 0:
                return None
            active = active.astype(np.int32)
        decode, _ = self._mesh_decoder(use_delta)
        mesh = mesh_mod.extract_mesh(
            lambda batch: decode(batch).cpu().numpy(), active,
            self.bound_min.cpu().numpy(), self.voxel_size,
            batch_size=batch_size, mask_sentinel=True,
            lattice_scale=int(getattr(m, "mesh_lattice_scale", 2)),
            lattice=lattice)
        if mesh is not None and self.fuse_color and len(mesh.vertices):
            colors = tsdf.sample_color(
                self.tsdf_vol, torch.as_tensor(mesh.vertices,
                                               device=self.device),
                self.tsdf_voxel_size)
            mesh = mesh._replace(colors=colors.cpu().numpy())
        return mesh

    def _inc_changed_mask(self, slots: np.ndarray):
        """(latent-change mask [len(slots)] bool on the host, device
        snapshot) over the slot ids ``active_entries`` returned.

        The table's (weights, num_hits, features) rows at those slots are
        diffed on the device against the snapshot of the last committed
        event and only the mask is fetched.  Fusion and optimization write
        the table in place, so the snapshot holds clones of the rows that
        can carry state (rows [:n_alloc] of a dense table, the allocated
        blocks' [:n_alloc * 64] of a block table), never references.  The
        mask is all True at the first call and for slots past the snapshot
        (a new voxel flips its corners' decode sentinel even where its
        values match).  The caller commits the snapshot once the mesher's
        update has succeeded.  (The JAX package diffs rows [:n_alloc] on a
        block table too, where n_alloc counts blocks: a mask of the wrong
        length, ROADMAP Queue 3.)"""
        t = self.table
        n = int(t.n_alloc)
        if isinstance(t, table_blocks.BlockIndexedTable):
            n *= table_blocks.BLOCK_SLOTS
        rows = (t.weights[:n], t.num_hits[:n], t.features[:n])
        snap = tuple(r.clone() for r in rows)
        prev = self._inc_prev
        if prev is None:
            return np.ones(len(slots), bool), snap
        s = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        k = prev[0].shape[0]
        sp = torch.clamp(s, max=max(k - 1, 0))
        changed = torch.ones(len(slots), dtype=torch.bool, device=self.device)
        if k:
            changed = (s >= k) | (rows[0][s] != prev[0][sp]) | \
                (rows[1][s] != prev[1][sp]) | \
                (rows[2][s] != prev[2][sp]).any(dim=-1)
        return changed.cpu().numpy(), snap

    def incremental_mesh_inputs(self):
        """What the incremental mesher reads: (decode_fn, active voxel keys
        [n, 3] int32, their ``_mesh_weights``, the prior in decode units on
        the host, and their slot ids, or under the spatial layout their
        features [n, F]: the keys then come from every shard, in flat-id
        order, and the mesher diffs the latents on the host by voxel
        key)."""
        decode, sdf_delta = self._mesh_decoder(True)
        if self._spatial:
            keys, last, weights, hits = self._active_entries()
        else:
            keys, _, weights, hits, last = tbl.active_entries(
                self.table, with_features=False)
        return (decode, keys.astype(np.int32),
                self._mesh_weights(weights, hits), sdf_delta.cpu().numpy(),
                last)

    def extract_mesh_incremental(self) -> Optional[mesh_mod.Mesh]:
        """Demo-mode mesh: only voxels whose latents or TSDF-prior cells
        changed since the last call are decoded again (the reference's
        VolumeList mesh cache).  Change detection is exact: a per-row diff
        on the device plus a dilated diff of the dense prior
        (``model.incremental_delta_tol`` bounds how small a prior move still
        re-meshes; 0.0 = every change).  Under the spatial layout the
        latents are diffed on the host by voxel key (the gathered entries;
        the JAX package does the same), and every rank meshes.
        ``self.inc_mesher.last_stats`` counts the re-decoded and eligible
        voxels."""
        from bnv_fusion_tpu_torch.incremental_mesh import IncrementalMesher

        if self.inc_mesher is None:
            self.inc_mesher = IncrementalMesher(
                self.bound_min.cpu().numpy(), self.voxel_size,
                batch_size=self._mesh_decode_batch(),
                n_xyz=np.asarray(self.n_xyz),
                delta_tol=float(getattr(self.config.model,
                                        "incremental_delta_tol", 0.0)),
                device=self.device)
        decode, keys, weights, delta, last = self.incremental_mesh_inputs()
        if self._spatial:
            mesh = self.inc_mesher.update(
                decode, keys, weights, last, min_weight=self.min_pts_in_grid,
                sdf_delta=delta)
        else:
            changed_rows, snap = self._inc_changed_mask(last)
            mesh = self.inc_mesher.update(
                decode, keys, weights, None, min_weight=self.min_pts_in_grid,
                sdf_delta=delta, changed_rows=changed_rows)
            self._inc_prev = snap  # committed only after a successful update
        return mesh if len(mesh.vertices) else None

    def save(self, path_prefix: str):
        """``<prefix>_sparse_volume.npz`` (the JAX package's format) and
        ``<prefix>_tsdf.npy`` (metric prior).  Under the spatial layout
        every rank gathers the entries, and rank 0 alone writes."""
        keys, feats, weights, hits = self._active_entries()
        if self._spatial and self._group.rank != 0:
            return
        ckpt_io.save_state(path_prefix + "_sparse_volume.npz", {
            "active_coordinates": keys,
            "features": feats,
            "weights": weights,
            "num_hits": hits,
            "dimensions": self.dimensions,
            "voxel_size": np.float32(self.voxel_size),
        })
        np.save(path_prefix + "_tsdf.npy",
                tsdf.as_dense(self.tsdf_vol).sdf.cpu().numpy() *
                (self.tsdf_voxel_size * 5))

    def load_volume(self, path: str):
        """Replace the table by the entries of a saved
        ``*_sparse_volume.npz`` (either package's).  Under the spatial
        layout each rank keeps the entries its slab owns
        (``parallel.spatial.load_spatial_entries``; the JAX package loads an
        unsharded table there, whose features its spatial readers then read
        at the wrong rows, ROADMAP Queue 3)."""
        data = ckpt_io.load_state(path)
        entries = (data["active_coordinates"], data["features"],
                   data["weights"], data["num_hits"])
        if self._spatial:
            from bnv_fusion_tpu_torch.parallel import spatial

            self.table = spatial.load_spatial_entries(
                self._group, self.table, *entries)
        else:
            self.table = tbl.load_entries(self.table, *entries)
        # a new key set: a lattice prefetched from the old table is stale
        # even where the counts match (the JAX package does not bump here)
        self._fuse_epoch += 1

    def prior_shape(self) -> tuple:
        """The prior's dense grid shape [X, Y, Z], in either layout."""
        vol = self.tsdf_vol
        return (tuple(vol.vol_dim) if isinstance(vol, tsdf.TSDFVolumeBM)
                else tuple(vol.sdf.shape))

    def set_tsdf_prior(self, metric: np.ndarray):
        """Install a dense metric TSDF prior of the volume's grid shape
        (normalized by tsdf_voxel_size * 5, weight 1 everywhere); a
        block-major volume stores it through ``tsdf.dense_to_bm``."""
        normalized = np.asarray(metric, np.float32) / \
            np.float32(self.tsdf_voxel_size * 5.0)
        if normalized.shape != self.prior_shape():
            raise ValueError(
                f"tsdf prior shape {normalized.shape} != volume "
                f"{self.prior_shape()}")
        sdf = torch.as_tensor(normalized, device=self.device)
        if isinstance(self.tsdf_vol, tsdf.TSDFVolumeBM):
            sdf = tsdf.dense_to_bm(self.tsdf_vol, sdf)
        self.tsdf_vol.sdf = sdf
        self.tsdf_vol.weight = torch.ones_like(self.tsdf_vol.weight)

    def load_map(self, path_prefix: str):
        """Resume a saved map: sparse volume + TSDF prior (the counterpart
        of ``save``)."""
        self.load_volume(path_prefix + "_sparse_volume.npz")
        self.set_tsdf_prior(np.load(path_prefix + "_tsdf.npy"))


def _to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
