"""One-command demo: reconstruct the analytic scene and render previews.

Counterpart of bnv_fusion_tpu/scripts/demo.py:29-99: runs the full
bi-level pipeline on the built-in synthetic scene (no external data),
exports meshes, preview renders of GT / before-optimization / final, and a
metrics JSON — the quickest way to see the port work end to end.  Without
``--checkpoint`` it runs on the seeded random weights (``run_e2e.load_params``);
a stage with no surface writes a blank preview and no mesh.

    python -m bnv_fusion_tpu_torch.scripts.demo [--out demo_out] [--frames 16]
        [--res 240 320] [--voxel 0.04] [--checkpoint ckpt] [overrides...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from bnv_fusion_tpu_torch import evaluation
from bnv_fusion_tpu_torch import mesh as mesh_mod
from bnv_fusion_tpu_torch.config import load_config
from bnv_fusion_tpu_torch.pipeline import NeuralMap
from bnv_fusion_tpu_torch.run_e2e import load_params
from bnv_fusion_tpu_torch.utils.logging import get_logger
from bnv_fusion_tpu_torch.utils.vis import render_mesh_preview, save_image

log = get_logger(__name__)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--res", type=int, nargs=2, default=[240, 320])
    ap.add_argument("--voxel", type=float, default=0.04)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--optim_iters", type=int, default=16)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = load_config([
        f"model.voxel_size={args.voxel}",
        f"dataset.num_images={args.frames}",
        f"dataset.img_res=[{args.res[0]},{args.res[1]}]",
        "model.min_pts_in_grid=4",
        "dataset.num_pixels=2048",
        "model.train_ray_splits=512",
        "model.table_capacity=524288",
    ] + ([f"trainer.checkpoint={args.checkpoint}"] if args.checkpoint else [])
        + list(args.overrides))
    from bnv_fusion_tpu_torch.datasets import get_dataset

    os.makedirs(args.out, exist_ok=True)
    ds = get_dataset(cfg, "val")
    params = load_params(cfg)
    nm = NeuralMap(ds.dimensions, cfg, params, args.out)

    log.info(f"fusing {len(ds)} frames...")
    for i in range(len(ds)):
        nm.integrate(ds[i])

    def export(name, m):
        if m is not None:
            mesh_mod.save_ply(os.path.join(args.out, f"{name}.ply"), m)
        save_image(os.path.join(args.out, f"{name}.png"),
                   render_mesh_preview(m, (360, 480)) if m is not None
                   else np.zeros((360, 480, 3), np.uint8))

    save_image(os.path.join(args.out, "gt.png"),
               render_mesh_preview(ds.gt_mesh(resolution=128), (360, 480)))
    before = nm.extract_mesh()
    export("before_optim", before)

    log.info(f"optimizing latents ({args.optim_iters} iterations)...")
    nm.optimize(n_iters=args.optim_iters)
    final = nm.extract_mesh()
    export("final", final)

    gt_pts = ds.gt_observed_points(50000)
    metrics = {}
    for name, m in (("before_optim", before), ("final", final)):
        if m is None:
            continue
        pts = mesh_mod.sample_surface(m, 50000, 0)
        metrics[name] = {
            f"@{t}": evaluation.fscore_points(pts, gt_pts, t)
            for t in (0.025, 0.01)
        }
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    for name in metrics:
        r = metrics[name]["@0.025"]
        print(f"{name}: F-score@2.5cm {r['fscore']:.4f} "
              f"(P {r['precision']:.4f} R {r['recall']:.4f})")
    log.info(f"artifacts in {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
