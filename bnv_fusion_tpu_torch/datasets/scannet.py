"""ScanNet frames/ layout reader ("fusion_inference_dataset_scannet").

Counterpart of bnv_fusion_tpu/datasets/scannet.py:20-83: reads the raw
``frames/{color,depth,pose}`` export, applies the scene's axis-align matrix
from the meta .txt, and recentres poses by the GT mesh AABB so the volume is
origin-centred.
"""

from __future__ import annotations

import os

import numpy as np

from bnv_fusion_tpu_torch.datasets.canonical import load_depth_png
from bnv_fusion_tpu_torch.datasets.registry import register
from bnv_fusion_tpu_torch.mesh import load_ply


def read_meta_axis_align(path: str) -> np.ndarray:
    """Parse axisAlignment from a ScanNet meta file (identity without
    one)."""
    with open(path, "r") as f:
        for line in f:
            if line.startswith("axisAlignment"):
                vals = [float(x) for x in line.split("=")[1].split()]
                return np.asarray(vals, np.float32).reshape(4, 4)
    return np.eye(4, dtype=np.float32)


def read_matrix(path: str) -> np.ndarray:
    with open(path, "r") as f:
        rows = [[float(x) for x in line.split()] for line in f if line.strip()]
    return np.asarray(rows, np.float32)


@register("fusion_inference_dataset_scannet")
class FusionInferenceDatasetScanNet:
    def __init__(self, cfg, stage: str = "val"):
        d = cfg.dataset
        self.scan_id = d.scan_id
        self.max_depth = float(cfg.model.ray_tracer.ray_max_dist)
        self.downsample_scale = float(getattr(d, "downsample_scale", 0.0))
        root = os.path.join(d.data_dir, self.scan_id)
        frame_dir = os.path.join(root, "frames")
        n = len(os.listdir(os.path.join(frame_dir, "color")))
        skip = int(getattr(d, "skip_images", 1)) or 1
        self.frame_ids = list(range(0, n, skip))

        axis_align = read_meta_axis_align(
            os.path.join(root, f"{self.scan_id}.txt"))
        gt = load_ply(os.path.join(root, f"{self.scan_id}_vh_clean_2.ply"))
        verts = gt.vertices @ axis_align[:3, :3].T + axis_align[:3, 3]
        max_pts, min_pts = verts.max(0), verts.min(0)
        center = (min_pts + max_pts) / 2
        self.dimensions = np.asarray(max_pts - min_pts, np.float32)
        recenter = np.eye(4, dtype=np.float32)
        recenter[:3, 3] = -center
        self.axis_align_mat = recenter @ axis_align
        self.frame_dir = frame_dir

    def __len__(self):
        return len(self.frame_ids)

    def __getitem__(self, idx: int):
        i = self.frame_ids[idx]
        depth = load_depth_png(
            os.path.join(self.frame_dir, "depth", f"{i}.png"),
            1000.0, self.max_depth, self.downsample_scale)
        T_cw = read_matrix(os.path.join(self.frame_dir, "pose", f"{i}.txt"))
        T_wc = self.axis_align_mat @ np.linalg.inv(T_cw)
        intr = read_matrix(os.path.join(
            self.frame_dir, "intrinsic", "intrinsic_depth.txt"))[:3, :3]
        if self.downsample_scale and self.downsample_scale > 0:
            intr = intr.copy()
            intr[:2, :3] *= self.downsample_scale
        return {
            "frame_id": i,
            "scene_id": self.scan_id,
            "depth": depth,
            "T_wc": T_wc.astype(np.float32),
            "intr_mat": intr.astype(np.float32),
        }
