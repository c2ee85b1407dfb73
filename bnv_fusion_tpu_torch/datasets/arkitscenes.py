"""ARKitScenes raw-capture helpers: trajectory association + interpolation.

A copy of bnv_fusion_tpu/datasets/arkitscenes.py:20-85 (host numpy): parse
the lowres trajectory (``lowres_wide.traj``: timestamp, axis-angle
rotation, translation per line), parse per-frame ``.pincam`` intrinsics,
associate frames to trajectory timestamps, and interpolate poses (SO(3)
geodesic + lerp) for frames between trajectory samples.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from bnv_fusion_tpu_torch.utils.motion import interpolate_pose, so3_exp


def parse_traj_line(line: str) -> Tuple[float, np.ndarray]:
    """One trajectory row -> (timestamp, T_cw [4,4]).

    ARKitScenes convention: ts, rx ry rz (axis-angle), tx ty tz — the
    world-to-camera transform.
    """
    vals = [float(v) for v in line.split()]
    ts = vals[0]
    R = so3_exp(np.asarray(vals[1:4]))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = vals[4:7]
    return ts, T


def read_trajectory(path: str) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Returns (timestamps [K], list of T_wc [4,4])."""
    ts_list, poses = [], []
    with open(path, "r") as f:
        for line in f:
            if not line.strip():
                continue
            ts, T_cw = parse_traj_line(line)
            ts_list.append(ts)
            poses.append(np.linalg.inv(T_cw).astype(np.float32))
    order = np.argsort(ts_list)
    return (np.asarray(ts_list)[order],
            [poses[i] for i in order])


def read_pincam(path: str) -> np.ndarray:
    """`.pincam` intrinsics file: w h fx fy cx cy -> [3,3] K."""
    with open(path, "r") as f:
        vals = [float(v) for v in f.read().split()]
    _, _, fx, fy, cx, cy = vals[:6]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def associate_pose(timestamps: np.ndarray, poses: List[np.ndarray],
                   query_ts: float, max_dt: float = 0.1,
                   max_gap: float = np.inf) -> Optional[np.ndarray]:
    """Pose at an arbitrary timestamp by geodesic interpolation between the
    two bracketing trajectory samples.

    Returns None when the query is outside the trajectory by more than
    ``max_dt``, or when the bracketing samples are further apart than
    ``max_gap`` (a tracking dropout)."""
    i = int(np.searchsorted(timestamps, query_ts))
    if i == 0:
        return poses[0] if abs(timestamps[0] - query_ts) <= max_dt else None
    if i >= len(timestamps):
        return (poses[-1]
                if abs(timestamps[-1] - query_ts) <= max_dt else None)
    t0, t1 = timestamps[i - 1], timestamps[i]
    if t1 - t0 > max_gap:
        return None
    alpha = float((query_ts - t0) / max(t1 - t0, 1e-9))
    return interpolate_pose(poses[i - 1], poses[i],
                            np.clip(alpha, 0.0, 1.0)).astype(np.float32)


def frame_timestamp_from_name(name: str) -> float:
    """Frame files are named ``{video_id}_{timestamp}.png``."""
    stem = os.path.splitext(os.path.basename(name))[0]
    return float(stem.split("_")[-1])
