"""Reconstruction metrics: accuracy / completeness / precision / recall / F1.

Counterpart of bnv_fusion_tpu/evaluation.py:25-51, with nearest neighbours
from ``scipy.spatial.cKDTree`` (scikit-learn is not a dependency).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
from scipy.spatial import cKDTree

from bnv_fusion_tpu_torch.mesh import Mesh, sample_surface


def _nn_dist(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    dist, _ = cKDTree(dst).query(src, k=1)
    return dist


def fscore_points(pred_pts: np.ndarray, gt_pts: np.ndarray,
                  threshold: float = 0.025) -> Dict[str, float]:
    """Point-set metrics at a distance threshold."""
    d_pred_gt = _nn_dist(pred_pts, gt_pts)   # accuracy direction
    d_gt_pred = _nn_dist(gt_pts, pred_pts)   # completeness direction
    precision = float((d_pred_gt < threshold).mean())
    recall = float((d_gt_pred < threshold).mean())
    f1 = 2 * precision * recall / max(precision + recall, 1e-8)
    return {
        "accuracy": float(d_pred_gt.mean()),
        "completeness": float(d_gt_pred.mean()),
        "chamfer": float(d_pred_gt.mean() + d_gt_pred.mean()) / 2,
        "precision": precision,
        "recall": recall,
        "fscore": f1,
        "threshold": threshold,
    }


def evaluate_mesh(pred: Mesh, gt: Mesh, n_samples: int = 100000,
                  thresholds: Sequence[float] = (0.025, 0.01),
                  seed: int = 0) -> Dict[str, Dict[str, float]]:
    """Sample ``n_samples`` surface points per mesh and report the metrics
    per threshold (the reference's 100k samples at 2.5 cm, plus 1 cm)."""
    pred_pts = sample_surface(pred, n_samples, seed)
    gt_pts = sample_surface(gt, n_samples, seed + 1)
    return {f"@{t}": fscore_points(pred_pts, gt_pts, t) for t in thresholds}
