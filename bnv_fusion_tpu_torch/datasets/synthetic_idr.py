"""IDR-convention synthetic reader ("fusion_inference_dataset_synthetic").

Counterpart of bnv_fusion_tpu/datasets/synthetic_idr.py:19-54: cameras in
a ``cameras_sphere.npz`` (world_mat/scale_mat products decomposed into K
and pose by ``geometry.load_K_Rt_from_P``), ``{:03d}.png`` depths, scene
dimensions from the scale factor.
"""

from __future__ import annotations

import os

import numpy as np

from bnv_fusion_tpu_torch.datasets.canonical import load_depth_png
from bnv_fusion_tpu_torch.datasets.registry import register
from bnv_fusion_tpu_torch.geometry import load_K_Rt_from_P


@register("fusion_inference_dataset_synthetic")
class FusionInferenceDatasetSynthetic:
    def __init__(self, cfg, stage: str = "val"):
        d = cfg.dataset
        self.scan_id = d.scan_id
        self.max_depth = float(cfg.model.ray_tracer.ray_max_dist)
        self.downsample_scale = float(getattr(d, "downsample_scale", 0.0))
        root = os.path.join(d.data_dir, self.scan_id)
        n = len(os.listdir(os.path.join(root, "image")))
        skip = int(getattr(d, "skip_images", 1)) or 1
        cams = np.load(os.path.join(root, "cameras_sphere.npz"))
        dim = float(2 * cams["scale_factor_0"])
        self.dimensions = np.asarray([dim, dim, dim], np.float32)
        self.root = root
        self.frames = []
        for i in range(0, n, skip):
            P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
            intr, pose = load_K_Rt_from_P(P)
            self.frames.append((i, intr[:3, :3].astype(np.float32),
                                pose.astype(np.float32)))

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx: int):
        i, intr, T_wc = self.frames[idx]
        depth = load_depth_png(
            os.path.join(self.root, "depth", "{:03d}.png".format(i)),
            1000.0, self.max_depth, self.downsample_scale)
        return {
            "frame_id": i,
            "scene_id": self.scan_id,
            "depth": depth,
            "T_wc": T_wc,
            "intr_mat": intr,
        }
