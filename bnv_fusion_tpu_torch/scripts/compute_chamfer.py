"""Single-pair Chamfer / F-score tool.

Counterpart of bnv_fusion_tpu/scripts/compute_chamfer.py:17-67, with
nearest neighbours from ``scipy.spatial.cKDTree`` in place of scikit-learn:

    python -m bnv_fusion_tpu_torch.scripts.compute_chamfer pred.ply gt.ply \\
        [--threshold 0.025] [--n_samples 100000] [--normal_consistency]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
from scipy.spatial import cKDTree

from bnv_fusion_tpu_torch.evaluation import fscore_points
from bnv_fusion_tpu_torch.mesh import load_ply, sample_surface


def normal_consistency(pred, gt, n: int = 50000) -> float:
    """Mean |cos| between the face normals at nearest surface samples."""

    def face_normals_at_samples(mesh, n, seed):
        rng = np.random.RandomState(seed)
        v, f = mesh.vertices, mesh.faces
        ab = v[f[:, 1]] - v[f[:, 0]]
        ac = v[f[:, 2]] - v[f[:, 0]]
        fn = np.cross(ab, ac)
        areas = 0.5 * np.linalg.norm(fn, axis=-1)
        fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
        tri = rng.choice(len(f), size=n, p=areas / areas.sum())
        r1 = np.sqrt(rng.rand(n, 1))
        r2 = rng.rand(n, 1)
        pts = (v[f[tri, 0]] * (1 - r1) + v[f[tri, 1]] * (r1 * (1 - r2)) +
               v[f[tri, 2]] * (r1 * r2))
        return pts.astype(np.float32), fn[tri]

    p_pts, p_n = face_normals_at_samples(pred, n, 0)
    g_pts, g_n = face_normals_at_samples(gt, n, 1)
    _, idx = cKDTree(g_pts).query(p_pts, k=1)
    return float(np.abs((p_n * g_n[idx]).sum(-1)).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pred")
    ap.add_argument("gt")
    ap.add_argument("--threshold", type=float, default=0.025)
    ap.add_argument("--n_samples", type=int, default=100000)
    ap.add_argument("--normal_consistency", action="store_true")
    args = ap.parse_args(argv)

    pred = load_ply(args.pred)
    gt = load_ply(args.gt)
    pred_pts = sample_surface(pred, args.n_samples, 0)
    gt_pts = sample_surface(gt, args.n_samples, 1)
    res = fscore_points(pred_pts, gt_pts, args.threshold)
    for k, v in res.items():
        print(f"{k}: {v:.6f}" if isinstance(v, float) else f"{k}: {v}")
    if args.normal_consistency:
        print(f"normal_consistency: {normal_consistency(pred, gt):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
