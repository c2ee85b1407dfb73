"""Classical TSDF-fusion baseline.

Counterpart of bnv_fusion_tpu/scripts/run_rgbd_integration.py:28-82: the
reference wraps Open3D's ScalableTSDFVolume; here the same baseline runs on
the port's dense torch TSDF (``tsdf.integrate``, on the card unless
``device_type=cpu``), then marching tetrahedra over the observed cells that
cross the level set — a neural-free reference point for quality
comparisons:

    python -m bnv_fusion_tpu_torch.scripts.run_rgbd_integration \\
        dataset=synthetic_demo model.tsdf_voxel_size=0.02
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from bnv_fusion_tpu_torch import mesh as mesh_mod
from bnv_fusion_tpu_torch import tsdf
from bnv_fusion_tpu_torch.config import load_config
from bnv_fusion_tpu_torch.pipeline import resolve_device
from bnv_fusion_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_CORNERS = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                     for z in (0, 1)])


def integrate_sequence(dataset, voxel_size: float, device) -> tsdf.TSDFVolume:
    vol, _ = tsdf.create_tsdf_volume(dataset.dimensions, voxel_size,
                                     device=device)
    for i in range(len(dataset)):
        f = dataset[i]

        def t(key):
            return torch.as_tensor(np.asarray(f[key], np.float32),
                                   device=device)

        tsdf.integrate(vol, t("depth"), t("intr_mat"), t("T_wc"), voxel_size)
    return vol


def tsdf_to_mesh(vol: tsdf.TSDFVolume, voxel_size: float):
    """Mesh of the cells whose 8 corners are all observed and cross the
    level set (selected on the volume's device), or None."""
    sdf, observed = vol.sdf, vol.weight > 0
    dx, dy, dz = sdf.shape
    corners = []
    for o in _CORNERS:
        sl = (slice(o[0], o[0] + dx - 1), slice(o[1], o[1] + dy - 1),
              slice(o[2], o[2] + dz - 1))
        corners.append((sdf[sl], observed[sl]))
    cs = torch.stack([c for c, _ in corners], -1)
    co = torch.stack([m for _, m in corners], -1)
    keep = co.all(-1) & (cs.amin(-1) < 0) & (cs.amax(-1) > 0)
    base = torch.nonzero(keep).cpu().numpy()
    cell_sdf = cs[keep].cpu().numpy()
    out = mesh_mod.marching_tetrahedra(base, cell_sdf)
    if len(out.vertices) == 0:
        return None
    verts = out.vertices * voxel_size + vol.origin.cpu().numpy()
    return mesh_mod.merge_vertices(
        mesh_mod.Mesh(verts.astype(np.float32), out.faces), voxel_size / 4)


def main(argv=None):
    cfg = load_config(list(argv if argv is not None else sys.argv[1:]))
    from bnv_fusion_tpu_torch.datasets import get_dataset

    device = resolve_device(getattr(cfg, "device_type", "tpu"))
    dataset = get_dataset(cfg, "val")
    voxel_size = float(getattr(cfg.model, "tsdf_voxel_size", 0.02))
    vol = integrate_sequence(dataset, voxel_size, device)
    m = tsdf_to_mesh(vol, voxel_size)
    scan_id = cfg.dataset.scan_id.split("/")[-1]
    out_dir = os.path.join(cfg.output_dir, "rgbd_integration")
    os.makedirs(out_dir, exist_ok=True)
    if m is None:
        log.warning("no surface extracted")
        return 1
    out = os.path.join(out_dir, f"{scan_id}_tsdf.ply")
    mesh_mod.save_ply(out, m)
    log.info(f"exported {out} ({len(m.vertices)} verts)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
