"""Geometry: back-projection, normals, camera rays, pixel neighbourhoods.

Counterpart of bnv_fusion_tpu/geometry.py:19-217 on torch tensors.  Every
function keeps the input's device; shapes are those of the JAX package.
The host numpy helpers (``depth_to_xyz_np``, the AABB measures,
``DepthNoiseSimulator`` and ``load_K_Rt_from_P``, geometry.py:34-192) are
copied as they are, so that one seed gives the same noisy depth in both
packages; ``load_K_Rt_from_P`` takes scipy's RQ in place of
``cv2.decomposeProjectionMatrix``.
"""

from __future__ import annotations

import numpy as np
import torch


def get_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 4] with a trailing 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a [4,4] rigid transform to [..., 3] points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def rotate_vectors(T: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation part of a [4,4] transform to [..., 3] vectors."""
    return vec @ T[:3, :3].T


def depth_to_xyz_np(depth: np.ndarray, intr: np.ndarray) -> np.ndarray:
    """Host twin of ``depth_to_xyz`` (dataset preprocessing): float32
    [H, W, 3]."""
    h, w = depth.shape
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    x = (uu - intr[0, 2]) / intr[0, 0] * depth
    y = (vv - intr[1, 2]) / intr[1, 1] * depth
    return np.stack([x, y, depth], axis=-1).astype(np.float32)


def depth_to_xyz(depth: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Back-project a [H, W] depth map to a camera-frame [H, W, 3] xyz map
    (pinhole model, pixel centers at integer coordinates)."""
    h, w = depth.shape
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    u = (torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :] - cx) / fx
    v = (torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None] - cy) / fy
    return torch.stack([u * depth, v * depth, depth], dim=-1)


def _gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy/jnp.gradient with unit spacing: central differences inside,
    one-sided at the borders."""
    n = x.shape[dim]
    if n < 2:
        return torch.zeros_like(x)
    inner = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2
    first = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
    last = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def normals_from_depth(depth: torch.Tensor, intr: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Camera-frame unit normals from a depth map via central differences,
    oriented toward the camera (-z hemisphere)."""
    xyz = depth_to_xyz(depth, intr)
    if mask is not None:
        xyz = torch.where(mask[..., None], xyz, torch.zeros((), dtype=xyz.dtype,
                                                             device=xyz.device))
    du = _gradient(xyz, 1)
    dv = _gradient(xyz, 0)
    n = torch.linalg.cross(du, dv, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-8)
    flip = torch.sum(n * xyz, dim=-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def lift_pixels(uv: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Lift [N, 2] pixel coords (x=u, y=v) to z=1 camera-frame rays [N, 3],
    skew term included."""
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    sk = intr[0, 1]
    x, y = uv[..., 0], uv[..., 1]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx
    y_lift = (y - cy) / fy
    return torch.stack([x_lift, y_lift, torch.ones_like(x)], dim=-1)


def get_camera_rays(uv: torch.Tensor, T_wc: torch.Tensor, intr: torch.Tensor):
    """Pixel coords -> (unit world-space ray dirs [N,3], camera center [3])."""
    cam_loc = T_wc[:3, 3]
    pts_world = transform_points(T_wc, lift_pixels(uv, intr))
    dirs = pts_world - cam_loc
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-8)
    return dirs, cam_loc


def gather_pixel_neighborhoods(xyz_map: torch.Tensor, mask: torch.Tensor,
                               uv: torch.Tensor, kernel_size: int = 3):
    """k x k window of world points around each integer pixel [N, 2] (x=u,
    y=v), clamped at borders -> ([N, k*k, 3] points, [N, k*k] bool mask).
    The window order matches the JAX package (du varies fastest)."""
    h, w = mask.shape
    half = kernel_size // 2
    offs = torch.arange(-half, half + 1, device=uv.device)
    dv, du = torch.meshgrid(offs, offs, indexing="ij")
    du = du.reshape(-1)
    dv = dv.reshape(-1)
    u = torch.clamp(uv[:, None, 0] + du[None, :], 0, w - 1)
    v = torch.clamp(uv[:, None, 1] + dv[None, :], 0, h - 1)
    return xyz_map[v, u], mask[v, u]


def aabb_intersection(a: np.ndarray, b: np.ndarray) -> float:
    """Intersection volume of two AABBs given as [2, 3] (min, max) rows."""
    lo = np.maximum(a[0], b[0])
    hi = np.minimum(a[1], b[1])
    return float(np.prod(np.maximum(hi - lo, 0.0)))


def aabb_volume(a: np.ndarray) -> float:
    return float(np.prod(np.maximum(a[1] - a[0], 0.0)))


def aabb_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = aabb_intersection(a, b)
    union = aabb_volume(a) + aabb_volume(b) - inter
    return inter / union if union > 0 else 0.0


def aabb_giou(a: np.ndarray, b: np.ndarray) -> float:
    """Generalized IoU of two AABBs."""
    inter = aabb_intersection(a, b)
    union = aabb_volume(a) + aabb_volume(b) - inter
    hull = np.stack([np.minimum(a[0], b[0]), np.maximum(a[1], b[1])])
    hull_vol = aabb_volume(hull)
    iou = inter / union if union > 0 else 0.0
    return iou - (hull_vol - union) / hull_vol if hull_vol > 0 else iou


def _rq3(M: np.ndarray):
    """cv2.RQDecomp3x3 (calib3d): M = R @ Q by Givens rotations about x,
    y and z, then cv2's fix of the decomposition's sign ambiguity, step for
    step (including its transposes), so that the port takes the signs cv2
    takes."""
    M = np.asarray(M, np.float64)
    eps = np.finfo(np.float64).eps

    def givens(c, s):
        z = 1.0 / np.sqrt(c * c + s * s + eps)
        return c * z, s * z

    c, s = givens(M[2, 2], M[2, 1])
    Qx = np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    R = M @ Qx
    R[2, 1] = 0
    c, s = givens(R[2, 2], -R[2, 0])
    Qy = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    M2 = R @ Qy
    M2[2, 0] = 0
    c, s = givens(M2[1, 1], M2[1, 0])
    Qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    R = M2 @ Qz
    R[1, 0] = 0
    if R[0, 0] < 0:
        if R[1, 1] < 0:   # rotate about z by 180 degrees
            R[0, 0] *= -1
            R[0, 1] *= -1
            R[1, 1] *= -1
            Qz[:2, :2] *= -1
        else:             # rotate about y by 180 degrees
            R[0, 0] *= -1
            R[0, 2] *= -1
            R[1, 2] *= -1
            R[2, 2] *= -1
            Qz = Qz.T
            Qy[0, 0] *= -1
            Qy[0, 2] *= -1
            Qy[2, 0] *= -1
            Qy[2, 2] *= -1
    elif R[1, 1] < 0:     # rotate about x by 180 degrees
        R[0, 1] *= -1
        R[0, 2] *= -1
        R[1, 1] *= -1
        R[1, 2] *= -1
        R[2, 2] *= -1
        Qz = Qz.T
        Qy = Qy.T
        Qx[1:, 1:] *= -1
    Q = Qz.T @ Qy.T @ Qx.T
    return R, Q


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 projection matrix into intrinsics [4, 4] and a
    camera-to-world pose [4, 4] (the IDR helper the reference vendors),
    as the JAX package does through ``cv2.decomposeProjectionMatrix``."""
    P = np.asarray(P, np.float64)
    K, R = _rq3(P[:, :3])
    # camera centre: the right null vector of P (cv2 takes it from an SVD)
    t = np.linalg.svd(P)[2][-1]
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = t[:3] / t[3]
    return intrinsics.astype(np.float32), pose


class DepthNoiseSimulator:
    """Parametric Kinect-style depth noise: axial sigma(z) = a + b (z - z0)^2
    plus lateral jitter of the sampling position by ~1 pixel (host numpy)."""

    def __init__(self, seed: int = 0, a: float = 0.0012, b: float = 0.0019,
                 z0: float = 0.4, lateral_px: float = 0.8):
        self.rng = np.random.RandomState(seed)
        self.a, self.b, self.z0 = a, b, z0
        self.lateral_px = lateral_px

    def simulate(self, depth: np.ndarray) -> np.ndarray:
        h, w = depth.shape
        valid = depth > 0
        sigma = self.a + self.b * np.square(depth - self.z0)
        noisy = depth + self.rng.randn(h, w) * sigma
        du = np.clip(np.round(self.rng.randn(h, w) * self.lateral_px), -2, 2)
        dv = np.clip(np.round(self.rng.randn(h, w) * self.lateral_px), -2, 2)
        uu, vv = np.meshgrid(np.arange(w), np.arange(h))
        su = np.clip(uu + du, 0, w - 1).astype(np.int64)
        sv = np.clip(vv + dv, 0, h - 1).astype(np.int64)
        noisy = noisy[sv, su]
        return np.where(valid, np.maximum(noisy, 0.0), 0.0).astype(np.float32)
