"""SO(3)/SE(3) utilities: exp/log maps, Isometry, pose interpolation.

A copy of bnv_fusion_tpu/utils/motion.py:17-146 (host numpy, used by the
ARKitScenes readers and trajectory tooling), so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def so3_hat(w: np.ndarray) -> np.ndarray:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrices."""
    w = np.asarray(w)
    out = np.zeros(w.shape[:-1] + (3, 3), w.dtype)
    out[..., 0, 1], out[..., 0, 2] = -w[..., 2], w[..., 1]
    out[..., 1, 0], out[..., 1, 2] = w[..., 2], -w[..., 0]
    out[..., 2, 0], out[..., 2, 1] = -w[..., 1], w[..., 0]
    return out


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle [3] -> rotation matrix [3, 3]."""
    theta = np.linalg.norm(w)
    if theta < 1e-10:
        return np.eye(3) + so3_hat(w)
    k = so3_hat(w / theta)
    return np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)


def so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle [3]."""
    cos = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) / 2
    if np.pi - theta < 1e-6:  # near pi: use the symmetric part
        A = (R + np.eye(3)) / 2
        axis = np.sqrt(np.maximum(np.diag(A), 0))
        # fix signs from off-diagonals
        if A[0, 1] < 0:
            axis[1] = -axis[1]
        if A[0, 2] < 0:
            axis[2] = -axis[2]
        return axis / max(np.linalg.norm(axis), 1e-12) * theta
    return theta / (2 * np.sin(theta)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Twist [6] (v, w) -> homogeneous transform [4, 4]."""
    v, w = xi[:3], xi[3:]
    theta = np.linalg.norm(w)
    R = so3_exp(w)
    if theta < 1e-10:
        V = np.eye(3)
    else:
        k = so3_hat(w / theta)
        V = (np.eye(3) + (1 - np.cos(theta)) / theta * k +
             (theta - np.sin(theta)) / theta * (k @ k))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def se3_log(T: np.ndarray) -> np.ndarray:
    """Homogeneous transform -> twist [6] (v, w)."""
    w = so3_log(T[:3, :3])
    theta = np.linalg.norm(w)
    if theta < 1e-10:
        V_inv = np.eye(3)
    else:
        k = so3_hat(w / theta)
        V_inv = (np.eye(3) - 0.5 * theta * k +
                 (1 - theta / (2 * np.tan(theta / 2))) * (k @ k))
    return np.concatenate([V_inv @ T[:3, 3], w])


class Isometry:
    """Rigid transform wrapper (reference motion_utils.Isometry)."""

    def __init__(self, matrix: np.ndarray | None = None):
        self.matrix = np.eye(4) if matrix is None else np.asarray(
            matrix, np.float64)

    @classmethod
    def from_rt(cls, R: np.ndarray, t: np.ndarray) -> "Isometry":
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        return cls(T)

    @property
    def rotation(self) -> np.ndarray:
        return self.matrix[:3, :3]

    @property
    def translation(self) -> np.ndarray:
        return self.matrix[:3, 3]

    def inv(self) -> "Isometry":
        return Isometry(np.linalg.inv(self.matrix))

    def __matmul__(self, other):
        if isinstance(other, Isometry):
            return Isometry(self.matrix @ other.matrix)
        pts = np.asarray(other)
        return pts @ self.rotation.T + self.translation

    def log(self) -> np.ndarray:
        return se3_log(self.matrix)

    @classmethod
    def exp(cls, xi: np.ndarray) -> "Isometry":
        return cls(se3_exp(xi))


def interpolate_pose(T0: np.ndarray, T1: np.ndarray, t: float) -> np.ndarray:
    """Geodesic interpolation between two poses (slerp on SO(3) + lerp),
    the reference's ARKit pose interpolation."""
    w = so3_log(T1[:3, :3] @ T0[:3, :3].T)
    T = np.eye(4)
    T[:3, :3] = so3_exp(w * t) @ T0[:3, :3]
    T[:3, 3] = (1 - t) * T0[:3, 3] + t * T1[:3, 3]
    return T


def pose_spline(poses: Sequence[np.ndarray], n_out: int) -> list:
    """Densify a pose trajectory by piecewise geodesic interpolation
    (reference geometry.pose_spline, src/utils/geometry.py:585-603)."""
    poses = [np.asarray(p, np.float64) for p in poses]
    if len(poses) < 2:
        return [poses[0].copy() for _ in range(n_out)]
    ts = np.linspace(0, len(poses) - 1, n_out)
    out = []
    for t in ts:
        i = min(int(np.floor(t)), len(poses) - 2)
        out.append(interpolate_pose(poses[i], poses[i + 1], float(t - i)))
    return out
