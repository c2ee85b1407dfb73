"""Canonical preprocessed layout reader ("fusion_inference_dataset").

Counterpart of bnv_fusion_tpu/datasets/canonical.py:25-112: the
reference's preprocessed scene layout ``{scan}/image/{i}.jpg, depth/{i}.png,
pose/T_wc_{i}.txt, pose/intr_mat_{i}.txt, pose/dimensions.txt`` with
millimetre depth PNGs.  Images go through ``utils.image_io`` in place of
cv2, with cv2's results.

Readers return raw host arrays (depth, pose, intrinsics); back-projection
and normals run on the device inside the fuse step.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from bnv_fusion_tpu_torch.datasets.registry import register
from bnv_fusion_tpu_torch.utils import image_io


def depth_png_to_metric(raw: np.ndarray, depth_scale: float = 1000.0,
                        max_depth: float | None = None,
                        downsample_scale: float = 0.0) -> np.ndarray:
    """Sensor depth (e.g. uint16 mm) -> metric float32, downsampled by
    cv2's nearest rule when asked, far pixels zeroed."""
    depth = raw.astype(np.float32) / depth_scale
    if downsample_scale and downsample_scale > 0:
        h, w = depth.shape
        depth = image_io.resize_nearest(
            depth, (int(w * downsample_scale), int(h * downsample_scale)))
    if max_depth is not None:
        depth = np.where(depth < max_depth, depth, 0.0)
    return depth


def load_depth_png(path: str, depth_scale: float = 1000.0,
                   max_depth: float | None = None,
                   downsample_scale: float = 0.0) -> np.ndarray:
    """mm PNG -> metric float32 depth, invalid/far pixels zeroed."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return depth_png_to_metric(image_io.read_png(path), depth_scale,
                               max_depth, downsample_scale)


def load_matrix_txt(path: str) -> np.ndarray:
    with open(path, "r") as f:
        vals = [float(t) for t in f.read().split()]
    n = int(round(len(vals) ** 0.5))
    return np.asarray(vals, np.float32).reshape(n, n)


@register("fusion_inference_dataset")
class FusionInferenceDataset:
    def __init__(self, cfg, stage: str = "val"):
        d = cfg.dataset
        self.scan_id = d.scan_id
        self.max_depth = float(cfg.model.ray_tracer.ray_max_dist)
        self.depth_scale = float(getattr(d, "depth_scale", 1000.0))
        self.downsample_scale = float(getattr(d, "downsample_scale", 0.0))
        self.load_color = bool(getattr(d, "load_color", False))
        # stage sensor-native uint16 depth beside the metric f32 (the
        # pipeline moves the raw array and converts on the device)
        self.stage_raw_depth = bool(getattr(d, "stage_raw_depth", False))
        root = os.path.join(d.data_dir, self.scan_id)
        dim_path = os.path.join(root, "pose", "dimensions.txt")
        with open(dim_path, "r") as f:
            line = f.read().splitlines()[0].split(" ")
            self.dimensions = np.asarray([float(x) for x in line], np.float32)
        n = len(os.listdir(os.path.join(root, "image")))
        # as in the JAX package, skip_images is stored but not applied here
        # (ROADMAP Queue 3)
        self.skip = int(getattr(d, "skip_images", 1)) or 1
        self.frame_ids = list(range(0, n))
        self.root = root

    def __len__(self):
        return len(self.frame_ids)

    def __getitem__(self, idx: int) -> Dict:
        i = self.frame_ids[idx]
        depth_path = os.path.join(self.root, "depth", f"{i}.png")
        if not os.path.exists(depth_path):
            raise FileNotFoundError(depth_path)
        raw = image_io.read_png(depth_path)   # read once for both outputs
        depth = depth_png_to_metric(raw, self.depth_scale, self.max_depth,
                                    self.downsample_scale)
        T_wc = load_matrix_txt(
            os.path.join(self.root, "pose", f"T_wc_{i}.txt"))
        intr = load_matrix_txt(
            os.path.join(self.root, "pose", f"intr_mat_{i}.txt"))[:3, :3]
        if self.downsample_scale and self.downsample_scale > 0:
            intr = intr.copy()
            intr[:2, :3] *= self.downsample_scale
        frame = {
            "frame_id": i,
            "scene_id": self.scan_id,
            "depth": depth,
            "T_wc": T_wc,
            "intr_mat": intr,
            "img_path": os.path.join(self.root, "image", f"{i}.jpg"),
        }
        if self.stage_raw_depth:
            if self.downsample_scale and self.downsample_scale > 0:
                hh, ww = raw.shape
                raw = image_io.resize_nearest(
                    raw, (int(ww * self.downsample_scale),
                          int(hh * self.downsample_scale)))
            frame["depth_raw"] = raw.astype(np.uint16)
            frame["depth_scale"] = self.depth_scale
        if self.load_color and os.path.exists(frame["img_path"]):
            frame["rgb"] = image_io.read_color(
                frame["img_path"], depth.shape).astype(np.float32)
        return frame
