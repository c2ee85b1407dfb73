"""Offline sequence fusion entry point (feeds the refiner).

Counterpart of bnv_fusion_tpu/test.py:27-54: fuse a whole sequence frame by
frame with local fusion only, then export ``{scan}.ply`` and the map
(``{scan}_sparse_volume.npz`` and ``{scan}_tsdf.npy``, the JAX package's
format) for the refiner stage of ``bnv_fusion_tpu_torch.train``:

    python -m bnv_fusion_tpu_torch.test dataset=synthetic_demo \\
        trainer.checkpoint=pretrained/pointnet_tcnn.ckpt
"""

from __future__ import annotations

import os
import sys

import numpy as np

from bnv_fusion_tpu_torch import mesh as mesh_mod
from bnv_fusion_tpu_torch.config import load_config
from bnv_fusion_tpu_torch.parallel import launch
from bnv_fusion_tpu_torch.pipeline import NeuralMap
from bnv_fusion_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def run(overrides):
    """Fuse, mesh and save; returns the map, the mesh and the saved map's
    path prefix for callers that check them.  Under torchrun every rank
    fuses its replica (``trainer.fuse_devices``), rank 0 alone meshes and
    saves, and every rank returns once the saved map exists (the refiner
    of ``scripts.run_inference --mode fuse_refine`` reads it next).  Under
    ``model.table_layout=spatial`` every rank meshes and saves with rank 0
    (collectives over the slabs of the map), and rank 0 alone writes."""
    cfg = load_config(list(overrides))
    with launch.distributed(getattr(cfg, "device_type", "tpu")):
        return _run(cfg)


def _run(cfg):
    from bnv_fusion_tpu_torch.datasets import get_dataset
    from bnv_fusion_tpu_torch.run_e2e import load_params

    dataset = get_dataset(cfg, "test")
    params = load_params(cfg)
    scan_id = cfg.dataset.scan_id.split("/")[-1]
    out_dir = os.path.join(cfg.output_dir, "test", scan_id)
    prefix = os.path.join(out_dir, scan_id)

    nmap = NeuralMap(dataset.dimensions, cfg, params, out_dir)
    for i in range(len(dataset)):
        nmap.integrate(dataset[i])
    if not launch.is_main_process():
        if nmap.mesh_is_collective:
            nmap.extract_mesh()
            nmap.save(prefix)
        launch.barrier()
        return {"nmap": nmap, "mesh": None, "prefix": prefix}
    os.makedirs(out_dir, exist_ok=True)
    if nmap.stats:
        s = np.asarray(nmap.stats)
        p25, p50, p75 = np.percentile(s, [25, 50, 75])
        log.info(f"pts/voxel: 25% {p25:.1f} 50% {p50:.1f} 75% {p75:.1f} "
                 f"mean {s.mean():.1f} min {s.min():.1f} max {s.max():.1f}")

    m = nmap.extract_mesh()
    if m is not None:
        out = os.path.join(out_dir, f"{scan_id}.ply")
        mesh_mod.save_ply(out, m)
        log.info(f"exported {out} ({len(m.vertices)} verts)")
    nmap.save(prefix)
    log.info(f"sparse volume saved under {out_dir}")
    launch.barrier()
    return {"nmap": nmap, "mesh": m, "prefix": prefix}


def main(argv=None):
    run(argv if argv is not None else sys.argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
