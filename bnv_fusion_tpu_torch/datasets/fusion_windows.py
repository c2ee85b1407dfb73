"""Multi-view training dataset with noisy-depth accumulated-TSDF supervision.

Counterpart of bnv_fusion_tpu/datasets/fusion_windows.py:27-129 ("fusion_dataset"):
every item is a WINDOW of max_neighbor_images+1 consecutive frames (random
stride 1 or 2, clipped at sequence ends).  Per frame the depth is degraded
by the sensor noise model (train/val only); the noisy depths are
accumulated into a dense world-grid TSDF at the model voxel size
(``tsdf.accumulate_tsdf_window``: per-frame TSDFs averaged over the frames
that observe a voxel, unobserved = +5 voxels), while ray ground truth
(gt_pts) comes from the CLEAN depth.  Host arrays throughout (the TSDF on
the CPU), one seed per stage and item as in the JAX package.

Returns (frame, rays) dicts.  The base posed-RGBD stream is any registered
reader (``dataset.base``, default the analytic synthetic scene).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from bnv_fusion_tpu_torch import geometry, tsdf, voxel as vx
from bnv_fusion_tpu_torch.datasets.registry import register, get_dataset_cls


@register("fusion_dataset")
class FusionWindowsDataset:
    def __init__(self, cfg, stage: str = "train"):
        d = cfg.dataset
        base_name = str(getattr(d, "base", "synthetic_demo"))
        self.base = get_dataset_cls(base_name)(cfg, stage)
        self.stage = stage
        self.voxel_size = float(cfg.model.voxel_size)
        self.max_neighbor_imgs = int(getattr(d, "max_neighbor_images", 5))
        self.num_pixels = int(getattr(d, "num_pixels", 1024))
        self.dimensions = self.base.dimensions
        mn, mx, n_xyz = vx.get_world_range(self.dimensions, self.voxel_size)
        self.world_min, self.world_max = mn, mx
        self.world_res = tuple(int(x) for x in n_xyz)
        self.add_noise = stage != "test"
        self.noise_seed = {"train": 0, "val": 101, "test": 202}.get(stage, 0)

    def __len__(self):
        return len(self.base)

    def _window_ids(self, idx: int, rng) -> np.ndarray:
        # reference fusion_dataset.py:152-159: stride (mul_factor) is 1 or 2
        mul = int(rng.rand() * 2) + 1
        ids = np.arange(self.max_neighbor_imgs + 1) - \
            np.floor(self.max_neighbor_imgs / 2)
        ids = ids * mul + idx
        return np.clip(ids, 0, len(self.base) - 1).astype(np.int64)

    def __getitem__(self, idx: int) -> Tuple[Dict, Dict]:
        rng = np.random.RandomState(self.noise_seed * 1000003 + idx)
        ids = self._window_ids(idx, rng)
        sim = geometry.DepthNoiseSimulator(seed=int(rng.randint(1 << 31)))

        T_wcs, intrs, rgbds, masks = [], [], [], []
        clean_depths, gt_pts_frames = [], []
        uv_list, ray_pts, ray_masks = [], [], []
        noisy_depths = []

        for fid in ids:
            f = self.base[int(fid)]
            clean = np.asarray(f["depth"], np.float32)
            T_wc = np.asarray(f["T_wc"], np.float32)
            intr = np.asarray(f["intr_mat"], np.float32)
            noisy = sim.simulate(clean) if self.add_noise else clean
            mask = clean > 0
            h, w = clean.shape

            rgb = f.get("rgb")
            rgb = (np.zeros((3, h, w), np.float32) if rgb is None
                   else np.moveaxis(np.asarray(rgb, np.float32), -1, 0))
            rgbds.append(np.concatenate([rgb, noisy[None]], axis=0))

            # clean-depth ray ground truth
            pts_c = geometry.depth_to_xyz_np(clean, intr).reshape(-1, 3)
            pts_w = pts_c @ T_wc[:3, :3].T + T_wc[:3, 3]
            sel = rng.randint(0, h * w, size=self.num_pixels)
            uu, vv = np.meshgrid(np.arange(w), np.arange(h))
            uv = np.stack([uu.reshape(-1), vv.reshape(-1)], -1)[sel]

            T_wcs.append(T_wc)
            intrs.append(intr)
            masks.append(mask)
            clean_depths.append(clean)
            gt_pts_frames.append(pts_w.astype(np.float32))
            uv_list.append(uv.astype(np.float32))
            ray_pts.append(pts_w[sel].astype(np.float32))
            ray_masks.append(mask.reshape(-1)[sel])
            noisy_depths.append(noisy)

        sdfs, w_sum = tsdf.accumulate_tsdf_window(
            noisy_depths, T_wcs, intrs, self.world_min, self.world_res,
            self.voxel_size)
        sdfs, w_sum = sdfs.numpy(), w_sum.numpy()

        frame = {
            "scene_id": getattr(self.base, "scan_id", "scene"),
            "frame_id": int(ids[len(ids) // 2]),
            "T_wc": np.stack(T_wcs),
            "intr_mat": np.stack(intrs),
            "rgbd": np.stack(rgbds),
            "mask": np.stack(masks).astype(np.float32),
            "sdfs": sdfs.astype(np.float32),
            "sdf_weights": w_sum.astype(np.float32),
            "gt_pts": np.stack(gt_pts_frames),
            "gt_depth": np.stack(clean_depths),
            "world_min_coords": self.world_min,
            "world_max_coords": self.world_max,
            "world_volume_resolution": np.asarray(self.world_res, np.int64),
        }
        rays = {
            "uv": np.stack(uv_list),
            "gt_pts": np.stack(ray_pts),
            "mask": np.stack(ray_masks).astype(np.float32),
            "intr_mat": np.stack(intrs),
            "T_wc": np.stack(T_wcs),
        }
        return frame, rays
