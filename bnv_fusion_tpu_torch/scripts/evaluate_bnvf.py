"""Batch mesh evaluation.

Counterpart of bnv_fusion_tpu/scripts/evaluate_bnvf.py:23-61.  Per
sequence: sample 100k surface points on the predicted and GT meshes, report
accuracy/completeness mean distances and precision/recall/F1 at each
threshold (the reference's 0.025 m and the quality target's 0.01 m by
default).

    python -m bnv_fusion_tpu_torch.scripts.evaluate_bnvf \\
        --pred out/seq1.ply out/seq2.ply --gt gt/seq1.ply gt/seq2.ply
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from bnv_fusion_tpu_torch.evaluation import evaluate_mesh
from bnv_fusion_tpu_torch.mesh import load_ply


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred", nargs="+", required=True,
                    help="predicted mesh .ply paths")
    ap.add_argument("--gt", nargs="+", required=True,
                    help="matching ground-truth mesh .ply paths")
    ap.add_argument("--thresholds", type=float, nargs="+",
                    default=[0.025, 0.01])
    ap.add_argument("--n_samples", type=int, default=100000)
    ap.add_argument("--json_out", default=None)
    args = ap.parse_args(argv)
    if len(args.pred) != len(args.gt):
        ap.error("--pred and --gt must have the same length")

    all_results = {}
    for pred_path, gt_path in zip(args.pred, args.gt):
        pred = load_ply(pred_path)
        gt = load_ply(gt_path)
        res = evaluate_mesh(pred, gt, n_samples=args.n_samples,
                            thresholds=args.thresholds)
        name = os.path.basename(pred_path)
        all_results[name] = res
        for t, r in res.items():
            print(f"{name} {t}: acc {r['accuracy']:.4f} "
                  f"comp {r['completeness']:.4f} P {r['precision']:.4f} "
                  f"R {r['recall']:.4f} F1 {r['fscore']:.4f}")

    # sequence means per threshold (reference prints the sweep mean)
    for t in (f"@{x}" for x in args.thresholds):
        f1s = [r[t]["fscore"] for r in all_results.values()]
        print(f"mean F1 {t}: {sum(f1s) / len(f1s):.4f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(all_results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
