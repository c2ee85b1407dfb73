"""Refiner dataset readers ("fusion_refiner_dataset", "…_scannet_dataset").

Counterpart of bnv_fusion_tpu/datasets/refiner.py:29-61: per-frame
loaders over the canonical preprocessed layout resp. the raw ScanNet
``frames/`` layout, feeding global refinement as offline training
(train.py with model=fusion_refiner_model).  The readers return raw frames;
ray sampling and the 15x15 neighbour window run on the device in the
optimize step.  What stays on the host is the frame selection:
``skip_images`` striding from a ``sample_shift`` offset (the ScanNet
variant strides without shift).
"""

from __future__ import annotations

import numpy as np

from bnv_fusion_tpu_torch.datasets.canonical import FusionInferenceDataset
from bnv_fusion_tpu_torch.datasets.registry import register
from bnv_fusion_tpu_torch.datasets.scannet import FusionInferenceDatasetScanNet


@register("fusion_refiner_dataset")
class FusionRefinerDataset(FusionInferenceDataset):
    """Canonical-layout refiner reader (reference fusion_dataset.py:453-507).

    Same ``{scan}/image, depth, pose`` layout as fusion_inference_dataset;
    the refiner flow additionally strides the sequence by ``skip_images``
    starting at ``sample_shift`` (the reference trains the refiner on every
    skip-th frame of the full capture, fusion_dataset.py:460-462)."""

    def __init__(self, cfg, stage: str = "train"):
        super().__init__(cfg, stage)
        d = cfg.dataset
        shift = int(getattr(d, "sample_shift", 0) or 0)
        n = len(self.frame_ids)
        ids = np.arange(shift, n, max(self.skip, 1))
        if stage != "train":
            # reference :460-463: every non-train stage (val AND test)
            # keeps only the first two strided frames
            ids = ids[:2]
        self.frame_ids = [self.frame_ids[i] for i in ids]


@register("fusion_refiner_scannet_dataset")
class FusionRefinerScanNetDataset(FusionInferenceDatasetScanNet):
    """ScanNet-layout refiner reader (reference fusion_dataset.py:510-573).

    Identical to fusion_inference_dataset_scannet (axis-align + GT-mesh
    recentering, ``frames/`` layout, skip striding) — the reference's extra
    host-side work (ray sampling, 15x15 windows) runs on device here."""

    def __init__(self, cfg, stage: str = "train"):
        super().__init__(cfg, stage)
