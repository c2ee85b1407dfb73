"""Plain reference of the SDF decode, of the render-loss optimization of the
latents, and of the mesh's SDF at its vertices, in float32.

Decode: a point's 8 corner voxels (floor / ceil of its voxel coordinates)
each decode (positional encoding of the offset, latent) through the MLP; the
SDF is their trilinear blend times the voxel size, ``fill`` where a corner's
weight is under ``min_pts_in_grid``, plus the prior at the corners (nearest
sample of the clipped, weighted TSDF).

Optimization: the system's draws replayed from the same CPU generator
state (a frame schedule, then per iteration a pixel permutation and one
(fine, coarse) pair of jitters per ray chunk), rays with their 3x3 pixel
neighbourhoods, fine samples in a band round the observed surface and
coarse ones from the camera, the neighbourhood-corrected truncated L1 loss,
its gradient with respect to the latents, a +1 weight on every voxel a chunk
touched (each chunk against the iteration's starting weights, the bumps
summed), and Adam (0.9, 0.999, 1e-8, bias corrected).  On dense grids held
by flat voxel id; nothing of the system is imported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.fusion import CORNERS, Grid, depth_to_xyz, mlp


def prior_delta(sdf: torch.Tensor, tsdf_voxel: float, truncated_dist: float,
                weight: float) -> torch.Tensor:
    """The prior as the decode's additive term (metric, clipped, weighted)."""
    return torch.clamp(sdf * (tsdf_voxel * 5.0), -truncated_dist,
                       truncated_dist) * weight


def _delta_at(delta: torch.Tensor, corners: torch.Tensor, n_xyz):
    """Nearest sample of the prior grid at latent-grid corners."""
    dims = torch.as_tensor(delta.shape, dtype=torch.float32,
                           device=corners.device)
    nx = torch.as_tensor([float(v) for v in n_xyz], device=corners.device)
    idx = torch.round(corners.to(torch.float32) / (nx - 1.0) *
                      (dims - 1.0)).to(torch.int64)
    di = dims.to(torch.int64)
    inside = torch.all((idx >= 0) & (idx < di), -1)
    idx = torch.minimum(torch.clamp(idx, min=0), di - 1)
    dy, dz = delta.shape[1], delta.shape[2]
    v = delta.reshape(-1)[idx[..., 0] * (dy * dz) + idx[..., 1] * dz +
                          idx[..., 2]]
    return torch.where(inside, v, torch.zeros((), device=v.device))


class Decoder:
    """Geometry of a decode batch; ``sdf(F)`` is differentiable in the
    gathered latents."""

    def __init__(self, grid: Grid, W: torch.Tensor, alloc: torch.Tensor,
                 coords: torch.Tensor, delta: Optional[torch.Tensor],
                 min_pts: int):
        dev = coords.device
        fl, ce = torch.floor(coords), torch.ceil(coords)
        pat = torch.as_tensor(CORNERS, device=dev).bool()
        corners = torch.where(pat, ce[:, None, :], fl[:, None, :])
        w8 = torch.prod(1.0 - torch.abs(coords[:, None, :] - corners), -1)
        self.tw = w8 / torch.clamp(w8.sum(-1, keepdim=True), min=1e-12)
        self.local = coords[:, None, :] - corners
        n = torch.as_tensor(grid.n_xyz, dtype=torch.float32, device=dev)
        in_grid = torch.all((corners >= 0) & (corners < n), -1)
        self.flat = torch.where(in_grid, grid.flat(corners), 0)
        self.found = in_grid & alloc[self.flat]
        w = torch.where(self.found, W[self.flat], torch.zeros((), device=dev))
        self.mask = torch.amin(w, -1) >= min_pts
        self.prior = (None if delta is None else
                      (_delta_at(delta, corners.to(torch.int64), grid.n_xyz)
                       * self.tw).sum(-1))
        self.voxel_size = grid.voxel_size

    def rows(self, F: torch.Tensor) -> torch.Tensor:
        return torch.where(self.found[..., None], F[self.flat],
                           torch.zeros((), device=F.device))

    def sdf(self, params, rows: torch.Tensor, fill: float,
            dtype: torch.dtype = torch.float32,
            fill_replaces_prior: bool = False) -> torch.Tensor:
        """The SDF of the batch; a masked point reads ``fill`` plus the
        prior, or ``fill`` alone with ``fill_replaces_prior`` (as a mesh's
        "no data" sample interpolates)."""
        loc = self.local
        x = torch.cat([loc, torch.sin(loc), torch.cos(loc), rows], -1)
        alpha = mlp(params["decoder"], x, dtype)[..., 0]
        s = torch.sum(alpha * self.voxel_size * self.tw, -1)
        fill_t = torch.full((), fill, device=s.device)
        if fill_replaces_prior:
            return torch.where(self.mask, s if self.prior is None
                               else s + self.prior, fill_t)
        s = torch.where(self.mask, s, fill_t)
        return s if self.prior is None else s + self.prior


def _hierarchical(n_fine, n_coarse, depths, surface, dirs, cam, offset, ts):
    def strat(n, dist, t):
        step = np.float32(1.0 / (n - 1))
        ticks = torch.arange(n, dtype=torch.float32, device=dist.device) * \
            float(step)
        ticks[-1] = 1.0
        ticks = ticks[None, :] * dist
        mids = 0.5 * (ticks[:, 1:] + ticks[:, :-1])
        upper = torch.cat([mids, ticks[:, -1:]], -1)
        lower = torch.cat([ticks[:, :1], mids], -1)
        return (lower + (upper - lower) * t)[..., None]

    t_fine, t_coarse = ts
    neg = torch.where(depths - offset < 0, depths,
                      torch.full_like(depths, offset))
    start = surface - neg[:, None] * dirs
    start_d = torch.linalg.norm(start - cam[None, :], dim=-1)
    fine = strat(n_fine, torch.full_like(depths, 2.0 * offset)[:, None],
                 t_fine) + start_d[:, None, None]
    coarse = strat(n_coarse, depths[:, None], t_coarse)
    dists = torch.sort(torch.cat([fine, coarse], 1), dim=1).values
    return cam[None, None, :] + dists * dirs[:, None, :]


def _loss(gt_pts, mask, nb_pts, nb_mask, pred, pts, cam, trunc):
    gt_d = torch.linalg.norm(gt_pts - cam[None, :], dim=-1, keepdim=True)
    d = torch.linalg.norm(pts - cam[None, None, :], dim=-1)
    gt_sdf = torch.clamp(gt_d - d, -trunc, trunc)
    valid = gt_sdf > max(-trunc * 0.5, -0.05)
    dist = torch.linalg.norm(nb_pts[:, None, :, :] - pts[:, :, None, :],
                             dim=-1)
    dist = torch.where(nb_mask[:, None, :] > 0, dist,
                       torch.full((), 1e4, device=dist.device))
    sign = torch.where(gt_sdf > 0, 1.0, -1.0)
    target = torch.clamp(torch.amin(dist, -1) * sign, -trunc, trunc)
    err = torch.sum(torch.abs(pred - target) * valid, -1) * mask
    return torch.sum(err) / (torch.sum(mask) + 1e-4)


class Optimizer:
    """The render-loss optimization of a dense map's latents."""

    def __init__(self, grid: Grid, params, settings: Dict):
        self.grid, self.params, self.s = grid, params, settings

    def _rays(self, depth, T_wc, intr, pixel_ids):
        s = self.s
        h, w = depth.shape
        mask = (depth > 0) & (depth < s["ray_max_dist"])
        xyz = (depth_to_xyz(depth, intr).reshape(-1, 3) @ T_wc[:3, :3].T
               + T_wc[:3, 3])
        idx = pixel_ids.to(depth.device).long()
        u, v = idx % w, torch.div(idx, w, rounding_mode="floor")
        offs = torch.arange(-1, 2, device=depth.device)
        dv, du = torch.meshgrid(offs, offs, indexing="ij")
        uu = torch.clamp(u[:, None] + du.reshape(-1)[None, :], 0, w - 1)
        vv = torch.clamp(v[:, None] + dv.reshape(-1)[None, :], 0, h - 1)
        xyz_map = xyz.reshape(h, w, 3)
        return (torch.stack([u, v], -1).to(torch.float32), xyz[idx],
                mask.reshape(-1)[idx].to(torch.float32), xyz_map[vv, uu],
                mask[vv, uu].to(torch.float32))

    def _camera(self, uv, T_wc, intr):
        fx, fy, cx, cy, sk = (intr[0, 0], intr[1, 1], intr[0, 2],
                              intr[1, 2], intr[0, 1])
        x, y = uv[:, 0], uv[:, 1]
        lift = torch.stack([(x - cx + cy * sk / fy - sk * y / fy) / fx,
                            (y - cy) / fy, torch.ones_like(x)], -1)
        cam = T_wc[:3, 3]
        # the point on the ray, then minus the centre, as the system forms
        # the direction, so that both draw the same samples bit for bit
        d = lift @ T_wc[:3, :3].T + cam - cam
        return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                               min=1e-8), cam

    def run(self, F: torch.Tensor, W: torch.Tensor, alloc: torch.Tensor,
            delta: Optional[torch.Tensor], frames: List[tuple],
            gen_state: torch.Tensor, n_iters: int,
            dtype: torch.dtype = torch.float32):
        """Optimize (in place) latents F and weights W over ``frames``
        [(depth, T_wc, intr), ...] from the generator state the system's
        call started from; returns the per-iteration losses."""
        s = self.s
        g = torch.Generator()
        g.set_state(gen_state)
        rng = np.random.RandomState(int(torch.randint(0, 2 ** 31 - 1, (1,),
                                                      generator=g)))
        n_rays, split = s["n_rays"], s["ray_splits"]
        nf, nc = s["n_fine"], s["n_coarse"]
        trunc, vs = s["truncated_dist"], self.grid.voxel_size
        mu, nu = torch.zeros_like(F), torch.zeros_like(F)
        losses, done, group = [], 0, s["iters_per_launch"]
        while done < n_iters:
            k = min(group, n_iters - done)
            for fi in rng.randint(0, len(frames), size=k):
                depth, T_wc, intr = frames[fi]
                h, w = depth.shape
                pix = torch.randperm(h * w, generator=g)[:n_rays]
                uv, gt, mask, nb, nbm = self._rays(depth, T_wc, intr, pix)
                ts = [(torch.rand((split, nf), generator=g).to(F.device),
                       torch.rand((split, nc), generator=g).to(F.device))
                      for _ in range(n_rays // split)]
                grad = torch.zeros_like(F)
                bump = torch.zeros_like(W)
                chunk_losses = []
                for c in range(n_rays // split):
                    sl = slice(c * split, (c + 1) * split)
                    dirs, cam = self._camera(uv[sl], T_wc, intr)
                    gt_d = torch.linalg.norm(gt[sl] - cam[None, :], dim=-1)
                    pts = _hierarchical(nf, nc, gt_d, gt[sl], dirs, cam,
                                        trunc, ts[c])
                    m, ns = pts.shape[:2]
                    coords = (pts.reshape(-1, 3) - self.grid.bound_min) / vs
                    dec = Decoder(self.grid, W, alloc, coords, delta,
                                  s["min_pts_in_grid"])
                    rows = dec.rows(F).detach().requires_grad_(True)
                    with torch.enable_grad():
                        pred = dec.sdf(self.params, rows, vs,
                                       dtype).reshape(m, ns)
                        loss = _loss(gt[sl], mask[sl], nb[sl], nbm[sl], pred,
                                     pts, cam, trunc)
                        (gr,) = torch.autograd.grad(loss, rows)
                    f = dec.found.reshape(-1)
                    ids = dec.flat.reshape(-1)[f]
                    grad.index_add_(0, ids, gr.reshape(-1, F.shape[1])[f])
                    hit = torch.zeros_like(W)
                    hit[ids] = 1.0
                    bump += hit
                    chunk_losses.append(loss.detach())
                W += bump
                done += 1
                mu.mul_(0.9).add_(0.1 * grad)
                nu.mul_(0.999).add_(0.001 * grad * grad)
                bc1 = 1.0 - 0.9 ** done
                bc2 = 1.0 - 0.999 ** done
                F -= s["lr"] * (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)
                losses.append(torch.stack(chunk_losses).mean())
        return torch.stack(losses).cpu().numpy().astype(np.float64)


# the directions of the lattice edges marching tetrahedra cuts: the cube
# edges and the face and main diagonals of its six tetrahedra round the
# 000-111 diagonal, each from its lower corner
_EDGE_DIRS = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0],
                       [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.float64)


def vertex_edges(verts: np.ndarray, bound_min: np.ndarray, voxel_size: float,
                 scale: int = 2, tol: float = 2e-4):
    """The lattice edge (a, a + d) and fraction t of each mesh vertex
    (world [V, 3]): marching tetrahedra puts every vertex on an edge between
    two lattice points; of the seven edge directions, the one whose segment
    passes nearest the vertex (within ``tol`` lattice units: float32
    coordinates) is its edge.  Returns (index of each matched vertex, a
    [n, 3], d [n, 3], t [n]) for the vertices off the lattice points, and
    the count on no edge."""
    u = (verts.astype(np.float64) - bound_min.astype(np.float64)) / \
        voxel_size * scale
    fl = np.floor(u)
    fr = u - fl
    best = np.full(len(u), np.inf)
    a = np.zeros_like(u)
    d = np.zeros_like(u)
    t = np.zeros(len(u))
    for dd in _EDGE_DIRS:
        on = dd > 0
        td = (fr * dd).sum(1) / dd.sum()
        ad = np.where(on, fl, np.round(u))
        res = np.abs(u - (ad + td[:, None] * dd)).max(1)
        better = res < best
        best = np.where(better, res, best)
        a[better], d[better], t[better] = ad[better], dd, td[better]
    on_edge = best < tol
    inner = on_edge & (t > tol) & (t < 1 - tol)
    idx = np.nonzero(inner)[0]
    return idx, a[idx], d[idx], t[idx], int((~on_edge).sum())


def mesh_sdf_gap(verts: np.ndarray, grid: Grid, params, F, W, alloc,
                 delta: Optional[torch.Tensor], min_pts: int,
                 scale: int = 2) -> Dict[str, float]:
    """How far the system's mesh lies from the reference's SDF: for each
    vertex on a lattice edge (a, b), the reference puts the crossing at
    t_ref = -s_a / (s_b - s_a) from its SDF at the two lattice points
    (masked points as +voxel, as the mesher takes them); the gap is
    (|t - t_ref| - e) * |s_b - s_a| in voxel units, the SDF error at the
    vertex, free of the edge's conditioning.  e bounds how far float32
    vertex coordinates (lattice units, then world) can move t by rounding
    alone.  Returns the largest gap (and the largest without e taken off),
    the vertices checked and those on no edge."""
    dev = F.device
    bmin = grid.bound_min.cpu().numpy()
    idx, a, d, t, off_edge = vertex_edges(verts, bmin, grid.voxel_size, scale)
    if len(idx) == 0:
        return {"gap": float("inf"), "gap_raw": float("inf"), "checked": 0,
                "off_edge": off_edge}
    vs = grid.voxel_size
    step = vs / scale
    u = (verts[idx].astype(np.float64) - bmin) / step
    e = 2.0 ** -22 * (np.abs(u) + 2.0 * np.abs(verts[idx].astype(
        np.float64)) / step).max(1)
    ends = np.concatenate([a, a + d]) / scale
    out = []
    for i in range(0, len(ends), 1 << 17):
        c = torch.as_tensor(ends[i:i + (1 << 17)], dtype=torch.float32,
                            device=dev)
        dec = Decoder(grid, W, alloc, c, delta, min_pts)
        with torch.no_grad():
            s = dec.sdf(params, dec.rows(F), vs, fill_replaces_prior=True)
        out.append(s.double().cpu().numpy())
    s = np.concatenate(out)
    sa, sb = s[:len(a)], s[len(a):]
    den = sb - sa
    tr = np.clip(np.where(np.abs(den) > 1e-12,
                          -sa / np.where(den == 0, 1, den), 0.5), 0.0, 1.0)
    dt = np.abs(t - tr)
    gap = np.maximum(dt - e, 0.0) * np.abs(den) / vs
    return {"gap": float(gap.max()),
            "gap_raw": float((dt * np.abs(den) / vs).max()),
            "checked": int(len(idx)), "off_edge": off_edge}
