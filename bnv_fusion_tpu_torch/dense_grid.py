"""Dense feature-grid encode/decode: the reference's ``return_dense`` path.

Counterpart of bnv_fusion_tpu/dense_grid.py:24-101.  Serves the pretraining
trainer's ``training_global`` mode and its per-patch validation meshes; the
sparse table (fusion.py) is the production route.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from bnv_fusion_tpu_torch import nn as bnn
from bnv_fusion_tpu_torch import voxel
from bnv_fusion_tpu_torch.fusion import encode_corner_features


def encode_pointcloud_dense(params: Dict[str, Any], pts_w: torch.Tensor,
                            normals: torch.Tensor, valid: torch.Tensor,
                            bound_min: torch.Tensor, bound_max: torch.Tensor,
                            voxel_size: float, n_xyz: Tuple[int, int, int],
                            min_pts_in_grid: int):
    """Oriented points -> (feat_grid [X,Y,Z,F], count_grid [X,Y,Z]): per-
    corner PointNet features segment-meaned into a dense grid; voxels with
    fewer than min_pts points keep zero features but keep their count."""
    nx, ny, nz = (int(v) for v in n_xyz)
    corners, feats, valid8 = encode_corner_features(
        params, pts_w, normals, valid, bound_min, bound_max, voxel_size)
    n = pts_w.shape[0]
    c = corners.reshape(n * 8, 3).long()
    flat = voxel.flatten_coords(c, (nx, ny, nz))
    inside = torch.all((c >= 0) & (c < torch.as_tensor(
        [nx, ny, nz], device=c.device)), dim=-1)
    keep = valid8.reshape(n * 8) & inside
    n_vox = nx * ny * nz
    fdim = feats.shape[-1]
    idx = flat[keep]
    fsum = torch.zeros((n_vox, fdim), dtype=torch.float32,
                       device=feats.device).index_add(
        0, idx, feats.reshape(n * 8, fdim)[keep])
    cnt = torch.zeros((n_vox,), dtype=torch.float32,
                      device=feats.device).index_add(
        0, idx, torch.ones_like(idx, dtype=torch.float32))
    mean = fsum / torch.clamp(cnt, min=1.0)[:, None]
    mean = torch.where((cnt >= min_pts_in_grid)[:, None], mean,
                       torch.zeros((), device=mean.device))
    return mean.reshape(nx, ny, nz, fdim), cnt.reshape(nx, ny, nz)


def decode_dense_grid(params: Dict[str, Any], feat_grid: torch.Tensor,
                      count_grid: torch.Tensor, coords: torch.Tensor,
                      voxel_size: float, min_pts_in_grid: int
                      ) -> torch.Tensor:
    """SDF at continuous voxel coords [M, 3] from a dense feature grid:
    nearest-sampled corner features, decoder masked to corners with
    >= min_pts points, blended with unmasked normalized trilinear weights;
    points with no valid corner get +voxel_size."""
    nx, ny, nz, _ = feat_grid.shape
    dims = torch.as_tensor([nx, ny, nz], device=coords.device)
    corners = voxel.corner_neighbors(coords)                 # [M,8,3]
    tw = voxel.trilinear_weights(coords, corners)            # [M,8]
    local = voxel.local_offsets(coords, corners)             # [M,8,3]

    inside = torch.all((corners >= 0) & (corners < dims), dim=-1)
    c = torch.minimum(torch.clamp(corners, min=0), dims - 1).long()
    zero = torch.zeros((), device=coords.device)
    feats = torch.where(inside[..., None],
                        feat_grid[c[..., 0], c[..., 1], c[..., 2]], zero)
    cnt = torch.where(inside, count_grid[c[..., 0], c[..., 1], c[..., 2]],
                      zero)
    mask = cnt >= min_pts_in_grid

    alpha = bnn.decoder_apply(params, local, feats)[..., 0]
    alpha = alpha * voxel_size * mask
    sdf = torch.sum(alpha * tw, dim=-1)
    return torch.where(torch.any(mask, dim=-1), sdf,
                       torch.full((), voxel_size, device=sdf.device))


def global_feature_decode(params: Dict[str, Any], feats: torch.Tensor,
                          query_pts: torch.Tensor) -> torch.Tensor:
    """Single-latent decode for local-patch training: [B, F] x [B, Q, 3]
    -> [B, Q]."""
    b, q = query_pts.shape[:2]
    fb = feats[:, None, :].expand(b, q, feats.shape[-1])
    return bnn.decoder_apply(params, query_pts, fb)[..., 0]
