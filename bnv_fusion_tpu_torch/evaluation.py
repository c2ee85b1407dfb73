"""Reconstruction metrics: accuracy / completeness / precision / recall / F1.

Counterpart of bnv_fusion_tpu/evaluation.py:25-43, with nearest neighbours
from ``scipy.spatial.cKDTree`` (scikit-learn is not a dependency).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial import cKDTree


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
