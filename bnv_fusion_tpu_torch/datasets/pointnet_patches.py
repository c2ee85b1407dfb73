"""Local-patch datasets for embedding pretraining ("fusion_pointnet_dataset").

Copy of bnv_fusion_tpu/datasets/pointnet_patches.py:38-146 (numpy only, so
the same ``RandomState`` streams give bit-identical items).  Each sample is
a local oriented point set in normalized voxel units plus query points with
ground-truth SDF.  Two providers, both registered:
* ``FusionPointNetDataset`` reads the reference's pickle layout when that
  (non-vendored) data exists;
* ``SyntheticPatchDataset`` generates analytic local patches (planes,
  spheres, corners) with exact SDF, so pretraining needs no download.
  Where a drawn primitive leaves no surface point inside the patch cube
  (7 of the first 4096 training items), the JAX package's item raises
  ``ValueError``; here the item draws the next primitive from its stream,
  so every other item stays bit-identical.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from bnv_fusion_tpu_torch.datasets.registry import register


def _resize_input_pts(pts: np.ndarray, n: int, rng) -> np.ndarray:
    """Random up/down-sample to n points (reference
    fusion_pointnet_dataset.py:61-70)."""
    if len(pts) >= n:
        idx = rng.choice(len(pts), n, replace=False)
    else:
        idx = rng.choice(len(pts), n, replace=True)
    return pts[idx]


@register("fusion_pointnet_dataset")
class FusionPointNetDataset:
    def __init__(self, cfg, stage: str):
        d = cfg.dataset
        self.stage = stage
        self.n_local_samples = int(getattr(d, "n_local_samples", 64))
        root = os.path.join(d.data_dir, getattr(d, "subdomain", "patches"),
                            stage)
        self.files = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.endswith(".pkl"))
        self.rng = np.random.RandomState(0)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        with open(self.files[idx], "rb") as f:
            data = pickle.load(f)
        input_pts = _resize_input_pts(
            np.asarray(data["input_pts"], np.float32),
            self.n_local_samples, self.rng)
        return {
            "input_pts": input_pts,
            "training_pts": np.asarray(data["training_pts"], np.float32),
            "gt": np.asarray(data["gt_sdf"], np.float32),
            "center": np.asarray(data.get("center", np.zeros(3)), np.float32),
        }


@register("synthetic_patches")
class SyntheticPatchDataset:
    """Analytic local surface patches in normalized voxel units.

    A patch is a randomly posed primitive surface cut to the [-1, 1] local
    cube: oriented samples on the surface (input), plus query points with
    exact SDF (supervision).  Matches the tensor contract of the reference
    training step (local_point_fusion.py:397-460).
    """

    def __init__(self, cfg, stage: str):
        d = cfg.dataset
        self.n_local_samples = int(getattr(d, "n_local_samples", 64))
        self.n_training_pts = int(getattr(d, "n_training_pts", 256))
        self.size = int(getattr(d, "num_patches", 4096))
        self.seed = 0 if stage == "train" else 10_000_000

    def __len__(self):
        return self.size

    def _primitive(self, rng):
        kind = rng.randint(3)
        if kind == 0:  # plane with random normal/offset
            n = rng.randn(3)
            n /= np.linalg.norm(n)
            off = rng.uniform(-0.4, 0.4)
            return lambda p: p @ n - off
        if kind == 1:  # sphere (radius in voxel units)
            c = rng.uniform(-0.5, 0.5, 3)
            r = rng.uniform(1.0, 4.0)
            sign = rng.choice([-1.0, 1.0])  # concave or convex
            c = c - sign * r * (c / (np.linalg.norm(c) + 1e-6))
            return lambda p: sign * (np.linalg.norm(p - c, axis=-1) - r)
        # corner: max of two planes
        n1, n2 = rng.randn(3), rng.randn(3)
        n1 /= np.linalg.norm(n1)
        n2 /= np.linalg.norm(n2)
        o1, o2 = rng.uniform(-0.3, 0.3, 2)
        return lambda p: np.maximum(p @ n1 - o1, p @ n2 - o2)

    def _sample_surface(self, sdf_fn, rng, n):
        """Project random points to the zero set via SDF descent with
        finite-difference normals."""
        pts = rng.uniform(-1, 1, (n * 4, 3)).astype(np.float32)
        eps = 1e-3
        for _ in range(8):
            d = sdf_fn(pts)
            g = np.stack([
                sdf_fn(pts + np.array([eps, 0, 0])) - d,
                sdf_fn(pts + np.array([0, eps, 0])) - d,
                sdf_fn(pts + np.array([0, 0, eps])) - d], -1) / eps
            g /= np.linalg.norm(g, axis=-1, keepdims=True) + 1e-9
            pts = pts - d[:, None] * g
        d = np.abs(sdf_fn(pts))
        keep = (d < 1e-3) & np.all(np.abs(pts) < 1.0, axis=-1)
        pts, g = pts[keep], g[keep]
        if len(pts) < n:
            reps = int(np.ceil(n / max(len(pts), 1)))
            pts = np.tile(pts, (reps, 1))[:n]
            g = np.tile(g, (reps, 1))[:n]
        return pts[:n], g[:n]

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.RandomState(self.seed + idx)
        while True:
            sdf_fn = self._primitive(rng)
            surf, normals = self._sample_surface(sdf_fn, rng,
                                                 self.n_local_samples)
            if len(surf):
                break
            # the primitive misses the [-1, 1] cube: draw another from the
            # same stream (the JAX package raises here instead)
        input_pts = np.concatenate([surf, normals], -1).astype(np.float32)
        q = rng.uniform(-1, 1, (self.n_training_pts, 3)).astype(np.float32)
        # bias half the queries near the surface (reference patches do this)
        q[: self.n_training_pts // 2] = (
            surf[rng.randint(len(surf), size=self.n_training_pts // 2)] +
            rng.randn(self.n_training_pts // 2, 3).astype(np.float32) * 0.3)
        gt = np.clip(sdf_fn(q), -1.0, 1.0).astype(np.float32)
        return {
            "input_pts": input_pts,
            "training_pts": q,
            "gt": gt,
            "center": np.zeros(3, np.float32),
        }
