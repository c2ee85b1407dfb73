"""Batch inference runner: fuse + refine every sequence of a dataset sweep.

Counterpart of bnv_fusion_tpu/scripts/run_inference.py:22-112: one CLI for
the reference's four per-dataset runners, with their operating points
(voxel size, ray max dist, skip), calling the port's ``run_e2e``, ``test``
and ``train`` in-process:

    python -m bnv_fusion_tpu_torch.scripts.run_inference scene3d \\
        --seqs lounge copyroom --checkpoint pretrained/pointnet_tcnn.ckpt \\
        --data_dir data/fusion/scene3d
"""

from __future__ import annotations

import argparse
import os
import sys

from bnv_fusion_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# per-dataset operating points, as in the JAX package (the synthetic point
# carries occupancy-sized compaction widths measured for it there; the real
# scenes keep the safe defaults)
OPERATING_POINTS = {
    "scene3d": {"voxel_size": 0.01, "ray_max_dist": 3, "skip": 10,
                "dataset": "fusion_inference_dataset"},
    "icl_nuim": {"voxel_size": 0.02, "ray_max_dist": 5, "skip": 10,
                 "dataset": "fusion_inference_dataset"},
    "scannet": {"voxel_size": 0.02, "ray_max_dist": 5, "skip": 10,
                "dataset": "fusion_inference_dataset_scannet"},
    "arkit": {"voxel_size": 0.02, "ray_max_dist": 3, "skip": 1,
              "dataset": "fusion_inference_dataset_arkit"},
    "synthetic": {"voxel_size": 0.02, "ray_max_dist": 3, "skip": 1,
                  "dataset": "synthetic_demo",
                  "max_unique_cells_per_frame": 32768,
                  "max_unique_per_frame": 49152},
}


def sequence_overrides(op, seq: str, checkpoint: str, data_dir,
                       min_pts_in_grid: int, extra) -> list:
    """The config overrides of one sequence at an operating point."""
    overrides = [
        f"dataset={op['dataset']}",
        f"dataset.scan_id={seq}",
        f"dataset.skip_images={op['skip']}",
        f"model.voxel_size={op['voxel_size']}",
        f"model.ray_tracer.ray_max_dist={op['ray_max_dist']}",
        f"model.min_pts_in_grid={min_pts_in_grid}",
        f"trainer.checkpoint={checkpoint}",
    ]
    for width_key in ("max_unique_cells_per_frame", "max_unique_per_frame"):
        if width_key in op:
            overrides.append(f"model.{width_key}={op[width_key]}")
    if data_dir:
        overrides.append(f"data_dir={data_dir}")
    return overrides + list(extra)


def refiner_overrides(overrides, seq: str) -> list:
    """The refiner stage's overrides: the map and prior that ``test`` saved
    under the configured ``output_dir``."""
    from bnv_fusion_tpu_torch.config import load_config

    out_dir = load_config(list(overrides)).output_dir
    scan = seq.split("/")[-1]
    test_dir = os.path.join(str(out_dir), "test", scan)
    return overrides + [
        "model=fusion_refiner_model",
        f"model.sparse_volume_path={test_dir}/{scan}_sparse_volume.npz",
        f"model.tsdf_prior_path={test_dir}/{scan}_tsdf.npy",
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=sorted(OPERATING_POINTS))
    ap.add_argument("--seqs", nargs="+", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--min_pts_in_grid", type=int, default=8)
    ap.add_argument("--mode", choices=["e2e", "fuse_refine"], default="e2e",
                    help="e2e = online pipeline; fuse_refine = offline "
                         "test.py fuse then refiner (reference sweep flow)")
    ap.add_argument("--extra", nargs="*", default=[],
                    help="additional config overrides appended per sequence")
    args = ap.parse_args(argv)

    op = OPERATING_POINTS[args.kind]
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.parallel import launch

    # under torchrun the process group spans the whole sweep
    device_type = load_config(sequence_overrides(
        op, args.seqs[0], args.checkpoint, args.data_dir,
        args.min_pts_in_grid, args.extra)).device_type
    with launch.distributed(device_type):
        return _sweep(args, op)


def _sweep(args, op) -> int:
    failures = []
    for seq in args.seqs:
        overrides = sequence_overrides(op, seq, args.checkpoint,
                                       args.data_dir, args.min_pts_in_grid,
                                       args.extra)
        try:
            if args.mode == "e2e":
                from bnv_fusion_tpu_torch import run_e2e

                run_e2e.main(overrides)
            else:
                from bnv_fusion_tpu_torch import test, train

                test.main(overrides)
                train.main(refiner_overrides(overrides, seq))
            log.info(f"finished {seq}")
        except Exception:  # keep sweeping; report at the end
            log.exception(f"sequence {seq} failed")
            failures.append(seq)
    if failures:
        log.error(f"failed sequences: {failures}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
