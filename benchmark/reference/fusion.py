"""Plain reference of local fusion and of the TSDF prior, in float32.

Works out again, from the frames and the weights alone, the map the system
builds: each frame is back-projected with normals from its depth, every
point inside the scene's bounds adds one (corner voxel, PointNet feature)
entry for each of its 8 corners (duplicated at integer coordinates), and
each voxel's entries of a frame are averaged; a voxel with at least
``min_pts_in_grid`` entries folds its mean into the map with weight
min(count / 32, 1) by a running mean.  The frames of one table update (K
frames; 1 on the per-frame path) are folded at once, which is the running
mean over them in real arithmetic.  Every voxel an entry touched is
allocated, with weight 0 where no frame kept it.  The map is held by the
flat voxel ids that updates touched (sorted, looked up by binary search);
sums are added in frame order.

The prior is the classic projective TSDF at its own voxel size.  Where the
system holds it dense, each update covers the window that encloses the
camera frustum where that is less than 70% of the grid, with the same
window placement as the system's; where the system holds it block-major
(``prior_is_blocks``), each update covers the whole grid, since voxels
outside the frustum cannot change.  The arithmetic is the system's, so that
its values can be compared bit for bit.

A frozen copy of the system's formulas in plain torch: no kernel, no
segmented reduction, no slot table; nothing of the system is imported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# corner order (f = floor, c = ceil): fff, cff, fcf, ffc, ccf, cfc, fcc, ccc
CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                    [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int32)


def tensors(tree, device):
    """A tree of numpy arrays as float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tensors(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


def mlp(layers: Dict[str, torch.Tensor], x: torch.Tensor,
        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ReLU MLP {w0, b0, ..., w_out, b_out}; with a lower ``dtype`` every
    operand is rounded to it and the products summed in float32."""
    def r(t):
        return t if dtype == torch.float32 else t.to(dtype).to(torch.float32)
    n = sum(1 for k in layers if k.startswith("w") and k != "w_out")
    h = r(x)
    for i in range(n):
        h = r(torch.relu(h @ r(layers[f"w{i}"]) + layers[f"b{i}"]))
    return h @ r(layers["w_out"]) + layers["b_out"]


def world_range(dimensions, voxel_size: float):
    """Scene bounds padded by one voxel, max snapped to whole voxels:
    (min [3] f32, max [3] f32, n_xyz [3] int)."""
    d = np.asarray(dimensions, np.float64)
    lo = -d / 2 - voxel_size
    hi = d / 2 + voxel_size
    n = np.ceil((hi - lo) / voxel_size).astype(np.int64)
    hi = lo + voxel_size * n
    return lo.astype(np.float32), hi.astype(np.float32), n.astype(np.int32)


class Grid:
    """The latent map's voxel grid."""

    def __init__(self, dimensions, voxel_size: float, device):
        lo, hi, n = world_range(dimensions, voxel_size)
        self.voxel_size = float(voxel_size)
        self.bound_min = torch.as_tensor(lo, device=device)
        self.bound_max = torch.as_tensor(hi, device=device)
        self.n_xyz = tuple(int(v) for v in n)
        self.n_vox = int(np.prod(self.n_xyz))

    def flat(self, c: torch.Tensor) -> torch.Tensor:
        _, ny, nz = self.n_xyz
        c = c.long()
        return c[..., 0] * (ny * nz) + c[..., 1] * nz + c[..., 2]


def depth_to_xyz(depth: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    h, w = depth.shape
    u = (torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
         - intr[0, 2]) / intr[0, 0]
    v = (torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
         - intr[1, 2]) / intr[1, 1]
    return torch.stack([u * depth, v * depth, depth], dim=-1)


def _gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    inner = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2
    first = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
    last = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def frame_points(depth: torch.Tensor, T_wc: torch.Tensor, intr: torch.Tensor):
    """World points [H*W, 3], world normals facing away from the camera
    (the encoder's convention), and depth > 0."""
    xyz = depth_to_xyz(depth, intr)
    mask = depth > 0
    xm = torch.where(mask[..., None], xyz, torch.zeros((), device=xyz.device))
    n = torch.linalg.cross(_gradient(xm, 1), _gradient(xm, 0), dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-8)
    n = torch.where(torch.sum(n * xm, -1, keepdim=True) > 0, -n, n)
    pts = xyz.reshape(-1, 3) @ T_wc[:3, :3].T + T_wc[:3, 3]
    normals = -(n.reshape(-1, 3) @ T_wc[:3, :3].T)
    return pts, normals, mask.reshape(-1)


def corner_keys(grid: Grid, pts: torch.Tensor, valid: torch.Tensor):
    """Continuous voxel coords [N, 3], corner coords [N, 8, 3] and the
    points whose 8 corners lie in the grid strictly inside the bounds."""
    vs = grid.voxel_size
    coords = (pts - grid.bound_min) / vs
    fl, ce = torch.floor(coords), torch.ceil(coords)
    n = torch.as_tensor(grid.n_xyz, dtype=coords.dtype, device=pts.device)
    inside = (torch.all((pts > grid.bound_min + vs) &
                        (pts < grid.bound_max - vs), -1) & valid &
              torch.all(fl >= 0, -1) & torch.all(ce < n, -1))
    pat = torch.as_tensor(CORNERS, device=pts.device).bool()
    corners = torch.where(pat, ce[:, None, :], fl[:, None, :])
    return coords, corners, inside


def frame_voxels(grid: Grid, params, pts, normals, valid,
                 dtype: torch.dtype = torch.float32):
    """One frame's (unique flat ids [U], entry counts [U], feature sums
    [U, F], counts: points inside, their (cell, corner code) groups and the
    voxels they touch)."""
    coords, corners, inside = corner_keys(grid, pts, valid)
    idx = torch.nonzero(inside).squeeze(1)
    c, k = coords[idx], corners[idx]
    fl = torch.floor(c)
    code = ((torch.ceil(c) > fl).long() *
            torch.as_tensor([4, 2, 1], device=c.device)).sum(-1)
    groups = len(torch.unique(grid.flat(fl) * 16 + code))
    rel = c[:, None, :] - k
    x = torch.cat([rel, normals[idx][:, None, :].expand_as(rel)], -1)
    feats = mlp(params["encoder"], x, dtype)
    fdim = feats.shape[-1]
    uniq, inv = torch.unique(grid.flat(k).reshape(-1), return_inverse=True)
    cnt = torch.bincount(inv, minlength=len(uniq)).to(torch.float32)
    sums = torch.zeros((len(uniq), fdim), device=pts.device).index_add_(
        0, inv, feats.reshape(-1, fdim))
    return uniq, cnt, sums, {"inside": len(idx), "groups": groups,
                             "voxels": len(uniq)}


class SparseMap:
    """The map held by the voxel ids that updates touched: ``ids`` [n]
    sorted int64 (every held id is allocated), latents ``F`` [n, F], weights
    ``W`` and hits ``H`` [n].  Its size follows the surface, not the grid,
    so it fits at any grid size the system takes."""

    def __init__(self, grid: Grid, fdim: int, device):
        self.grid = grid
        self.ids = torch.zeros((0,), dtype=torch.int64, device=device)
        self.F = torch.zeros((0, fdim), device=device)
        self.W = torch.zeros((0,), device=device)
        self.H = torch.zeros((0,), device=device)

    def _hold(self, ids: torch.Tensor):
        """Allocate ``ids`` (sorted, unique) with zero rows."""
        merged, inv = torch.unique(torch.cat([self.ids, ids]),
                                   return_inverse=True)
        old = inv[:len(self.ids)]
        F = torch.zeros((len(merged), self.F.shape[1]), device=merged.device)
        W = torch.zeros((len(merged),), device=merged.device)
        H = torch.zeros_like(W)
        F[old], W[old], H[old] = self.F, self.W, self.H
        self.ids, self.F, self.W, self.H = merged, F, W, H

    def fuse(self, params, frames: List[tuple], min_pts: int,
             dtype: torch.dtype = torch.float32) -> List[Dict[str, int]]:
        """Fold one table update's frames [(pts, normals, valid), ...];
        returns each frame's counts (``frame_voxels``).  Each voxel's sums
        are added in frame order, one frame at a time."""
        parts, counts = [], []
        for pts, normals, valid in frames:
            uniq, cnt, sums, n = frame_voxels(self.grid, params, pts, normals,
                                              valid, dtype)
            counts.append(n)
            keep = cnt >= min_pts
            c = cnt[keep]
            nw = torch.clamp(c / 32.0, max=1.0)
            parts.append((uniq, uniq[keep], nw,
                          sums[keep] / c[:, None] * nw[:, None]))
        touched = torch.unique(torch.cat([p[0] for p in parts]))
        Wg = torch.zeros((len(touched),), device=touched.device)
        Sg = torch.zeros((len(touched), self.F.shape[1]),
                         device=touched.device)
        Hg = torch.zeros_like(Wg)
        for _, u, nw, s in parts:
            i = torch.searchsorted(touched, u)
            Wg[i] += nw
            Sg[i] += s
            Hg[i] += 1.0
        del parts
        self._hold(touched)
        t = torch.nonzero(Wg > 0).squeeze(1)
        r = torch.searchsorted(self.ids, touched[t])
        w_new = self.W[r] + Wg[t]
        self.F[r] = (self.F[r] * self.W[r][:, None] + Sg[t]) / \
            torch.clamp(w_new, min=1e-12)[:, None]
        self.W[r] = w_new
        self.H[r] += Hg[t]
        return counts

    def lookup(self, flat: torch.Tensor):
        """(held [M], F [M, F], W [M], H [M]) at voxel ids ``flat``, zero
        where not held."""
        if not len(self.ids):
            z = torch.zeros((len(flat),), device=flat.device)
            return (z > 0, torch.zeros((len(flat), self.F.shape[1]),
                                       device=flat.device), z, z)
        r = torch.clamp(torch.searchsorted(self.ids, flat),
                        max=len(self.ids) - 1)
        held = self.ids[r] == flat
        zero = torch.zeros((), device=flat.device)
        return (held, torch.where(held[:, None], self.F[r], zero),
                torch.where(held, self.W[r], zero),
                torch.where(held, self.H[r], zero))

    def dense(self):
        """(F [n_vox, F], W [n_vox], allocated [n_vox]) over the whole grid,
        for the stages that follow on dense grids (small grids only)."""
        n, dev = self.grid.n_vox, self.F.device
        F = torch.zeros((n, self.F.shape[1]), device=dev)
        W = torch.zeros((n,), device=dev)
        alloc = torch.zeros((n,), dtype=torch.bool, device=dev)
        F[self.ids], W[self.ids], alloc[self.ids] = self.F, self.W, True
        return F, W, alloc


# ---------------------------------------------------------------------------
# the TSDF prior
# ---------------------------------------------------------------------------

def prior_is_blocks(layout: str, dimensions, voxel_size: float) -> bool:
    """Whether the system holds the prior block-major: under
    ``model.tsdf_layout`` blocks, or under auto from 8M prior voxels."""
    lo, hi, _ = world_range(dimensions, voxel_size)
    n = int(np.prod(np.ceil((hi - lo) / voxel_size)))
    return layout == "blocks" or (layout == "auto" and n >= 8_000_000)


class Prior:
    """Dense TSDF [X, Y, Z] (normalized units) and weights at
    ``voxel_size``, starting at -5 * voxel_size.  ``windowed``: each update
    covers the frustum's window, where that is under 70% of the grid (the
    dense layout's updates); otherwise the whole grid, voxel centres at
    global index x voxel_size + origin (the block-major layout's)."""

    def __init__(self, dimensions, voxel_size: float, device,
                 windowed: bool = True):
        lo, hi, _ = world_range(dimensions, voxel_size)
        shape = tuple(int(v) for v in np.ceil((hi - lo) / voxel_size))
        self.voxel_size = float(voxel_size)
        self.sdf = torch.full(shape, -5.0 * voxel_size, device=device)
        self.weight = torch.zeros(shape, device=device)
        self.origin = torch.as_tensor(lo, device=device)
        self.window: Optional[Tuple[int, int, int]] = None
        self._decided = not windowed

    def _decide(self, hw, intr: np.ndarray, max_depth: float):
        """The frustum's enclosing-sphere window, where it is under 70% of
        the grid."""
        h, w = hw
        vs = self.voxel_size
        zmax = max_depth + 5.0 * vs
        xs = (np.array([-0.5, w - 0.5]) - intr[0, 2]) / intr[0, 0] * zmax
        ys = (np.array([-0.5, h - 0.5]) - intr[1, 2]) / intr[1, 1] * zmax
        r2 = float(max(abs(x) for x in xs)) ** 2 + \
            float(max(abs(y) for y in ys)) ** 2
        c = (r2 + zmax * zmax) / (2.0 * zmax)
        radius = c if c <= zmax else np.sqrt(r2)
        n = int(np.ceil(2.0 * radius / vs)) + 2
        shape = tuple(self.sdf.shape)
        window = tuple(min(n, int(s)) for s in shape)
        self.window = (None if np.prod(window) >= 0.7 * np.prod(shape)
                       else window)
        self._decided = True

    def _start(self, hw, intr: torch.Tensor, T_wc: torch.Tensor,
               max_depth: float):
        h, w = hw
        dev = self.sdf.device
        zmax = max_depth + 5.0 * self.voxel_size
        xs = (torch.as_tensor([-0.5, w - 0.5], device=dev) - intr[0, 2]) / \
            intr[0, 0] * zmax
        ys = (torch.as_tensor([-0.5, h - 0.5], device=dev) - intr[1, 2]) / \
            intr[1, 1] * zmax
        r2 = torch.maximum(xs[0].abs(), xs[1].abs()) ** 2 + \
            torch.maximum(ys[0].abs(), ys[1].abs()) ** 2
        c = (r2 + zmax * zmax) / (2.0 * zmax)
        centre = torch.as_tensor([0.0, 0.0, 1.0], device=dev) * \
            torch.clamp(c, max=zmax)
        centre_w = centre @ T_wc[:3, :3].T + T_wc[:3, 3]
        wnd = torch.as_tensor(self.window, dtype=torch.float32, device=dev)
        lo = (centre_w - self.origin) / self.voxel_size - wnd / 2.0
        dims = torch.as_tensor(self.sdf.shape, device=dev)
        start = torch.clamp(torch.floor(lo).long(), min=0)
        start = torch.minimum(start, dims - wnd.long())
        return tuple(int(v) for v in start.tolist())

    def integrate(self, depth: torch.Tensor, intr: torch.Tensor,
                  T_wc: torch.Tensor, obs_weight: float, max_depth: float):
        if not self._decided:
            self._decide(tuple(depth.shape), intr.cpu().numpy(), max_depth)
        if self.window is None:
            sdf, weight, origin = self.sdf, self.weight, self.origin
        else:
            s = self._start(tuple(depth.shape), intr, T_wc, max_depth)
            sl = tuple(slice(a, a + b) for a, b in zip(s, self.window))
            sdf, weight = self.sdf[sl], self.weight[sl]
            origin = self.origin + torch.as_tensor(
                s, dtype=torch.float32, device=sdf.device) * self.voxel_size
        _update(sdf, weight, origin, depth, intr, T_wc, self.voxel_size,
                float(obs_weight))


def _update(sdf, weight, origin, depth, intr, T_wc, voxel_size: float,
            obs_weight: float):
    """One frame's projective TSDF update of [X, Y, Z] views, in place: the
    depth at the rounded pixel of each voxel centre, truncated at
    5 * voxel_size in front of the surface."""
    trunc = 5.0 * voxel_size
    dx, dy, dz = sdf.shape
    dev = sdf.device
    ii, jj, kk = torch.meshgrid(
        torch.arange(dx, dtype=torch.float32, device=dev),
        torch.arange(dy, dtype=torch.float32, device=dev),
        torch.arange(dz, dtype=torch.float32, device=dev), indexing="ij")
    world = torch.stack([ii, jj, kk], dim=-1) * voxel_size + origin
    T_cw = torch.linalg.inv(T_wc)
    cam = world @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = cam[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-8, z,
                         torch.full((), 1e-8, device=dev))
    px = torch.round(cam[..., 0] * intr[0, 0] / safe_z + intr[0, 2])
    py = torch.round(cam[..., 1] * intr[1, 1] / safe_z + intr[1, 2])
    h, w = depth.shape
    in_view = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (z > 0)
    flat = (torch.clamp(py, 0, h - 1) * w + torch.clamp(px, 0, w - 1)).long()
    d = torch.where(in_view, depth.reshape(-1)[flat],
                    torch.zeros((), device=dev))
    diff = d - z
    valid = (d > 0) & (diff >= -trunc)
    dist = torch.clamp(diff / trunc, max=1.0)
    w_new = weight + obs_weight
    sdf_new = (weight * sdf + obs_weight * dist) / w_new
    sdf.copy_(torch.where(valid, sdf_new, sdf))
    weight.copy_(torch.where(valid, w_new, weight))
