"""Analytic synthetic scenes: posed depth streams with exact ground truth.

Numpy copy of bnv_fusion_tpu/datasets/synth_scene.py:1-392 (host code,
identical frames), importing the port's mesh and voxel modules.

The reference evaluates on external datasets (3D Scene, ICL-NUIM, ScanNet,
ARKit) that are not vendored with the repo; this module provides a fully
self-contained substitute for tests, demos and benchmarking: an analytic SDF
scene (spheres + axis-aligned box room/floor), exact ray-traced depth maps
from a circular camera path, and a ground-truth mesh extracted from the
analytic SDF — so end-to-end reconstruction quality (F-score) is measurable
without any downloads.  Frame layout matches what the pipeline consumes:
(depth [H, W] float32 metric, T_wc [4, 4], intr [3, 3]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from bnv_fusion_tpu_torch.datasets.registry import register
from bnv_fusion_tpu_torch.mesh import Mesh, marching_tetrahedra, merge_vertices


@dataclass
class SphereObj:
    center: np.ndarray
    radius: float


@dataclass
class BoxObj:
    center: np.ndarray
    half_extent: np.ndarray


@dataclass
class SceneSpec:
    spheres: List[SphereObj] = field(default_factory=list)
    boxes: List[BoxObj] = field(default_factory=list)
    # rooms: inverted boxes — solid is OUTSIDE the box (walls seen from inside)
    rooms: List[BoxObj] = field(default_factory=list)

    @staticmethod
    def _box_sdf(pts, b: BoxObj):
        q = np.abs(pts - b.center) - b.half_extent
        outside = np.linalg.norm(np.maximum(q, 0), axis=-1)
        inside = np.minimum(np.max(q, axis=-1), 0.0)
        return outside + inside

    def sdf(self, pts: np.ndarray) -> np.ndarray:
        vals = [np.full(len(pts), np.inf, np.float32)]
        for s in self.spheres:
            vals.append(np.linalg.norm(pts - s.center, axis=-1) - s.radius)
        for b in self.boxes:
            vals.append(self._box_sdf(pts, b))
        for r in self.rooms:
            vals.append(-self._box_sdf(pts, r))
        return np.min(np.stack(vals, -1), -1).astype(np.float32)


def default_scene() -> SceneSpec:
    """A sphere and a box on a ground slab — the demo/benchmark scene."""
    return SceneSpec(
        spheres=[SphereObj(np.array([0.0, 0.0, 0.3], np.float32), 0.35)],
        boxes=[
            BoxObj(np.array([0.55, -0.4, 0.15], np.float32),
                   np.array([0.18, 0.22, 0.15], np.float32)),
            BoxObj(np.array([0.0, 0.0, -0.05], np.float32),
                   np.array([1.2, 1.2, 0.05], np.float32)),  # ground slab
        ])


def room_scene() -> SceneSpec:
    """An inside-out room with furniture — the ICL-NUIM living-room analog
    (cameras INSIDE the geometry, walls seen from within)."""
    return SceneSpec(
        rooms=[BoxObj(np.array([0.0, 0.0, 0.65], np.float32),
                      np.array([1.5, 1.2, 0.75], np.float32))],
        boxes=[
            BoxObj(np.array([0.8, -0.5, 0.25], np.float32),
                   np.array([0.35, 0.25, 0.25], np.float32)),   # "sofa"
            BoxObj(np.array([-0.7, 0.5, 0.2], np.float32),
                   np.array([0.3, 0.2, 0.2], np.float32)),      # "table"
        ],
        spheres=[SphereObj(np.array([-0.6, -0.6, 0.25], np.float32), 0.22)],
    )


def _ray_box_inside(o, d, b: BoxObj):
    """First exit intersection with a box seen from INSIDE (room walls)."""
    lo = b.center - b.half_extent
    hi = b.center + b.half_extent
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (lo - o) / d
        t1 = (hi - o) / d
    tmax = np.nanmin(np.maximum(t0, t1), axis=-1)
    return np.where(tmax > 1e-6, tmax, np.inf)


def look_at_pose(eye: np.ndarray, target: np.ndarray,
                 up: Optional[np.ndarray] = None) -> np.ndarray:
    """OpenCV camera convention: +z forward, +x right, +y down.  Returns T_wc."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    world_up = np.array([0.0, 0.0, 1.0]) if up is None else np.asarray(up)
    x = np.cross(z, -world_up)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def _ray_sphere(o, d, s: SphereObj):
    oc = o - s.center
    a = (d * d).sum(-1)
    b = 2 * (d * oc).sum(-1)
    c = (oc * oc).sum() - s.radius ** 2
    disc = b * b - 4 * a * c
    t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), np.inf)
    return np.where((disc > 0) & (t > 1e-6), t, np.inf)


def _ray_box(o, d, b: BoxObj):
    lo = b.center - b.half_extent
    hi = b.center + b.half_extent
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (lo - o) / d
        t1 = (hi - o) / d
    tmin = np.nanmax(np.minimum(t0, t1), axis=-1)
    tmax = np.nanmin(np.maximum(t0, t1), axis=-1)
    hit = (tmax > np.maximum(tmin, 0))
    t = np.where(tmin > 1e-6, tmin, np.inf)
    return np.where(hit, t, np.inf)


def render_depth(scene: SceneSpec, T_wc: np.ndarray, intr: np.ndarray,
                 img_res: Tuple[int, int], max_depth: float = 10.0
                 ) -> np.ndarray:
    """Exact ray-traced depth map [H, W] (0 = no hit), z-depth convention."""
    h, w = img_res
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    dirs_c = np.stack([(uu - intr[0, 2]) / intr[0, 0],
                       (vv - intr[1, 2]) / intr[1, 1],
                       np.ones_like(uu)], axis=-1).reshape(-1, 3)
    dirs_w = dirs_c @ T_wc[:3, :3].T
    o = T_wc[:3, 3]
    t = np.full(len(dirs_w), np.inf, np.float32)
    for s in scene.spheres:
        t = np.minimum(t, _ray_sphere(o, dirs_w, s))
    for b in scene.boxes:
        t = np.minimum(t, _ray_box(o, dirs_w, b))
    for r in scene.rooms:
        t = np.minimum(t, _ray_box_inside(o, dirs_w, r))
    # t is in units of the unnormalized direction (z_cam = 1) == z-depth
    depth = np.where(np.isfinite(t) & (t < max_depth), t, 0.0)
    return depth.reshape(h, w).astype(np.float32)


def procedural_albedo(pts_w: np.ndarray) -> np.ndarray:
    """Deterministic smooth RGB (0-255) from world position — gives the
    analytic scenes a color channel so RGB fusion is testable without
    image assets."""
    return (127.5 * (1.0 + np.sin(pts_w * np.array([5.0, 7.0, 11.0])))
            ).astype(np.float32)


def render_color(depth: np.ndarray, T_wc: np.ndarray, intr: np.ndarray
                 ) -> np.ndarray:
    """Procedural RGB image [H, W, 3] for a rendered depth map (0 where no
    hit)."""
    h, w = depth.shape
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    dirs_c = np.stack([(uu - intr[0, 2]) / intr[0, 0],
                       (vv - intr[1, 2]) / intr[1, 1],
                       np.ones_like(uu)], axis=-1)
    pts_c = dirs_c * depth[..., None]
    pts_w = pts_c @ T_wc[:3, :3].T + T_wc[:3, 3]
    rgb = procedural_albedo(pts_w.reshape(-1, 3)).reshape(h, w, 3)
    return np.where(depth[..., None] > 0, rgb, 0.0).astype(np.float32)


def gt_mesh(scene: SceneSpec, bounds: float = 1.3, resolution: int = 192
            ) -> Mesh:
    """Ground-truth mesh from the analytic SDF (marching tetrahedra)."""
    step = 2 * bounds / resolution
    r = np.arange(resolution)
    origins = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    lin = -bounds + np.arange(resolution + 1) * step
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    grid_sdf = scene.sdf(
        np.stack([gx, gy, gz], -1).reshape(-1, 3)).reshape(
            resolution + 1, resolution + 1, resolution + 1)
    corner_off = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                           for z in (0, 1)])
    cell_sdf = np.stack(
        [grid_sdf[origins[:, 0] + dx, origins[:, 1] + dy, origins[:, 2] + dz]
         for dx, dy, dz in corner_off], axis=-1)
    crossing = (cell_sdf.min(1) < 0) & (cell_sdf.max(1) > 0)
    out = marching_tetrahedra(origins[crossing], cell_sdf[crossing])
    verts = out.vertices * step - bounds
    return merge_vertices(Mesh(verts.astype(np.float32), out.faces),
                          step * 1e-3)


@register("synthetic_fusion_frames")
class SyntheticFusionFramesDataset:
    """Multi-view end-to-end training data (the FusionDataset role, reference
    src/datasets/fusion_dataset.py:61-300): per frame, a world oriented point
    cloud plus world query points with exact SDF supervision.

    Feeds the ``training_global`` branch of the pretraining trainer.
    """

    def __init__(self, cfg, stage: str = "train"):
        self.base = SyntheticDemoDataset(cfg, stage)
        d = cfg.dataset
        self.n_training_pts = int(getattr(d, "n_training_pts", 2048))
        self.voxel_size = float(cfg.model.voxel_size)
        import bnv_fusion_tpu_torch.voxel as vx

        mn, mx, n_xyz = vx.get_world_range(self.base.dimensions,
                                           self.voxel_size)
        self.bound_min, self.bound_max, self.n_xyz = mn, mx, n_xyz
        self.dimensions = self.base.dimensions
        self.seed = 0 if stage == "train" else 77777

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int):
        rng = np.random.RandomState(self.seed + idx)
        pts_w, normals_w, valid = self.base.frame_pointcloud(idx)
        input_pts = np.concatenate([pts_w, normals_w], -1)
        # queries near the observed surface + uniform in bounds
        q = self.n_training_pts
        sel = rng.choice(np.nonzero(valid)[0], q // 2)
        near = pts_w[sel] + rng.randn(q // 2, 3).astype(np.float32) * \
            (2 * self.voxel_size)
        uniform = rng.uniform(self.bound_min, self.bound_max,
                              (q - q // 2, 3)).astype(np.float32)
        training_pts = np.concatenate([near, uniform], 0)
        gt = np.clip(self.base.scene.sdf(training_pts),
                     -1.0, 1.0).astype(np.float32)
        return {
            "input_pts": input_pts,
            "valid": valid,
            "training_pts": training_pts,
            "gt": gt,
            "bound_min": self.bound_min,
            "bound_max": self.bound_max,
        }


@register("synthetic_demo")
class SyntheticDemoDataset:
    """Posed depth stream of the analytic demo scene.

    Registered like the reference's dataset readers so the e2e entry point
    runs with zero external data: ``dataset=synthetic_demo``.
    """

    def __init__(self, cfg, stage: str = "val"):
        d = cfg.dataset
        self.scene = default_scene()
        self.img_res = tuple(d.img_res)
        self.n_frames = int(getattr(d, "num_images", 60))
        self.max_depth = float(cfg.model.ray_tracer.ray_max_dist)
        h, w = self.img_res
        f = 0.75 * w
        self.intr = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                             np.float32)
        self.dimensions = np.array([2.6, 2.6, 1.6], np.float32)
        self.scan_id = getattr(d, "scan_id", "synthetic_demo")
        self.load_color = bool(getattr(d, "load_color", False))
        # sensor-parity mode: quantize rendered depth to uint16 millimeters
        # (the reference's datasets are uint16 PNG) and let the pipeline
        # stage the raw array + convert on device
        self.stage_raw_depth = bool(getattr(d, "stage_raw_depth", False))
        radius, height = 1.6, 1.0
        self.poses = []
        for i in range(self.n_frames):
            ang = 2 * np.pi * i / self.n_frames
            eye = np.array([radius * np.cos(ang), radius * np.sin(ang),
                            height])
            self.poses.append(
                look_at_pose(eye, np.array([0.0, 0.0, 0.15])))

    def __len__(self):
        return self.n_frames

    def __getitem__(self, idx: int):
        T_wc = self.poses[idx]
        depth = render_depth(self.scene, T_wc, self.intr, self.img_res,
                             self.max_depth)
        frame = {
            "frame_id": idx,
            "scene_id": self.scan_id,
            "depth": depth,
            "T_wc": T_wc,
            "intr_mat": self.intr,
        }
        if self.stage_raw_depth:
            raw = np.round(depth * 1000.0).astype(np.uint16)
            frame["depth_raw"] = raw
            frame["depth_scale"] = 1000.0
            frame["depth"] = raw.astype(np.float32) / 1000.0
        if self.load_color:
            frame["rgb"] = render_color(frame["depth"], T_wc, self.intr)
        return frame

    def gt_mesh(self, resolution: int = 192) -> Mesh:
        return gt_mesh(self.scene, resolution=resolution)

    # pose generation hook for subclasses
    def _make_poses(self):
        raise NotImplementedError

    def frame_pointcloud(self, idx: int):
        """(pts_w [N,3], normals_w [N,3], valid [N]) for one frame (host)."""
        f = self[idx]
        depth, T_wc, intr = f["depth"], f["T_wc"], f["intr_mat"]
        h, w = depth.shape
        uu, vv = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        z = depth
        x = (uu - intr[0, 2]) / intr[0, 0] * z
        y = (vv - intr[1, 2]) / intr[1, 1] * z
        cam = np.stack([x, y, z], -1).reshape(-1, 3)
        pts_w = cam @ T_wc[:3, :3].T + T_wc[:3, 3]
        # analytic normals from the scene SDF (finite differences)
        eps = 1e-3
        d0 = self.scene.sdf(pts_w)
        g = np.stack([self.scene.sdf(pts_w + np.array([eps, 0, 0])) - d0,
                      self.scene.sdf(pts_w + np.array([0, eps, 0])) - d0,
                      self.scene.sdf(pts_w + np.array([0, 0, eps])) - d0],
                     -1) / eps
        g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9)
        valid = (depth > 0).reshape(-1)
        return pts_w.astype(np.float32), g.astype(np.float32), valid

    def gt_observed_points(self, n: int = 100000, seed: int = 0) -> np.ndarray:
        """Exact ground-truth surface points restricted to OBSERVED surface.

        Evaluating completeness against the full analytic mesh would penalize
        surface no camera ever sees (e.g. the underside of the ground slab);
        the union of back-projected depth pixels is the observable ground
        truth, and it is exact for this analytic renderer.
        """
        rng = np.random.RandomState(seed)
        pts = []
        per_frame = max(1, n // self.n_frames)
        h, w = self.img_res
        for idx in range(self.n_frames):
            f = self[idx]
            depth, T_wc, intr = f["depth"], f["T_wc"], f["intr_mat"]
            v, u = np.nonzero(depth > 0)
            if len(v) == 0:
                continue
            sel = rng.choice(len(v), min(per_frame, len(v)), replace=False)
            v, u = v[sel], u[sel]
            z = depth[v, u]
            x = (u - intr[0, 2]) / intr[0, 0] * z
            y = (v - intr[1, 2]) / intr[1, 1] * z
            cam = np.stack([x, y, z], -1)
            pts.append(cam @ T_wc[:3, :3].T + T_wc[:3, 3])
        return np.concatenate(pts, 0).astype(np.float32)


@register("synthetic_room")
class SyntheticRoomDataset(SyntheticDemoDataset):
    """Inside-out room capture — the ICL-NUIM living-room analog: the camera
    pans from inside the room, walls/floor/ceiling seen from within plus
    furniture-scale objects."""

    def __init__(self, cfg, stage: str = "val"):
        super().__init__(cfg, stage)
        self.scene = room_scene()
        self.dimensions = np.array([3.2, 2.6, 1.7], np.float32)
        self.scan_id = getattr(cfg.dataset, "scan_id", "synthetic_room")
        self.poses = []
        for i in range(self.n_frames):
            ang = 2 * np.pi * i / self.n_frames
            # small inner circle, looking outward at the walls
            eye = np.array([0.35 * np.cos(ang), 0.3 * np.sin(ang), 0.8])
            target = np.array([1.4 * np.cos(ang), 1.1 * np.sin(ang), 0.55])
            self.poses.append(look_at_pose(eye, target))
