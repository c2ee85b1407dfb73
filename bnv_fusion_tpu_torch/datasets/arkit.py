"""ARKit ("3D Scanner App") dump reader ("fusion_inference_dataset_arkit").

Counterpart of bnv_fusion_tpu/datasets/arkit.py:23-83: per-frame
``depth_*.png`` (mm), ``conf_*.png`` confidence masks, ``frame_*.json`` with
ARKit poses (graphics-convention axes flipped to CV) and hi-res intrinsics
scaled by 1/7.5 to the depth resolution; scene bounds from the app's rough
``export.obj``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from bnv_fusion_tpu_torch.datasets.canonical import load_depth_png
from bnv_fusion_tpu_torch.datasets.registry import register
from bnv_fusion_tpu_torch.utils import image_io


def load_obj_vertices(path: str) -> np.ndarray:
    verts = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.asarray(verts, np.float32)


@register("fusion_inference_dataset_arkit")
class FusionInferenceDatasetARKit:
    INTR_SCALE = 1 / 7.5  # hi-res RGB intrinsics -> low-res depth

    def __init__(self, cfg, stage: str = "val"):
        d = cfg.dataset
        self.scan_id = d.scan_id
        self.max_depth = float(cfg.model.ray_tracer.ray_max_dist)
        self.confidence_level = int(getattr(d, "confidence_level", 2))
        self.downsample_scale = float(getattr(d, "downsample_scale", 0.0))
        self.seq_dir = os.path.join(d.data_dir, self.scan_id)

        verts = load_obj_vertices(os.path.join(self.seq_dir, "export.obj"))
        max_pts, min_pts = verts.max(0), verts.min(0)
        self.dimensions = np.asarray(max_pts - min_pts, np.float32)
        self.axis_align_mat = np.eye(4, dtype=np.float32)
        self.axis_align_mat[:3, 3] = -(min_pts + max_pts) / 2

        names = [f.split("_")[1].split(".")[0]
                 for f in os.listdir(self.seq_dir) if f.startswith("depth_")]
        skip = int(getattr(d, "skip_images", 1)) or 1
        self.names = sorted(names, key=int)[::skip]

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx: int):
        name = self.names[idx]
        depth = load_depth_png(
            os.path.join(self.seq_dir, f"depth_{name}.png"),
            1000.0, self.max_depth, self.downsample_scale)
        # a missing confidence file means no mask (cv2.imread -> None)
        conf_path = os.path.join(self.seq_dir, f"conf_{name}.png")
        if os.path.exists(conf_path):
            conf = image_io.read_png(conf_path)
            mask = conf >= self.confidence_level
            depth = depth * mask.astype(np.float32)
        with open(os.path.join(self.seq_dir, f"frame_{name}.json")) as f:
            cam = json.load(f)
        T_wc = np.asarray(cam["cameraPoseARFrame"], np.float32).reshape(4, 4)
        # ARKit graphics convention -> CV: flip y and z axes
        T_align = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
        T_wc = self.axis_align_mat @ T_wc @ T_align
        intr = np.asarray(cam["intrinsics"], np.float32).reshape(3, 3)
        intr[:2, :3] *= self.INTR_SCALE
        if self.downsample_scale and self.downsample_scale > 0:
            intr[:2, :3] *= self.downsample_scale
        return {
            "frame_id": idx,
            "scene_id": self.scan_id,
            "depth": depth,
            "T_wc": T_wc,
            "intr_mat": intr,
        }
