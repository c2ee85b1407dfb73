"""The benchmark's traffic: posed depth frames of an analytic scene along a
circular camera path, made on the device from a seed.

One general generator reads every mix file (``benchmark/traffic/<mix>.json``):
the scene is data (spheres, boxes, and rooms seen from inside), and so is the
path (an eye and a target on circles, stepped by a fixed angle per frame).
The seed sets the path's phase and jitters its radius and height; every seed
sees the same scene over the same whole orbit or pan, so the work per scan
is the same up to the jitter.  Depth is the z-depth of the first hit, zero
without a hit or at ``max_depth_m`` and beyond, quantised to whole
millimetres as a uint16 sensor frame.

This is a frozen torch copy of the analytic scenes, ray-casts and look-at
poses of the system's synthetic dataset (its numpy ``render_depth``), so that
the frames render on the card in set-up; ``tests/test_traffic.py`` holds the
two to the millimetre.  It imports nothing of the system.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 32-bit seeds from any whole number (the driver's
    seeds exceed 32 signed bits)."""
    return [int(v) for v in
            np.random.SeedSequence(int(seed)).generate_state(n, np.uint32)]


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world [4, 4] float32, OpenCV axes (+z forward, +y down),
    world up +z."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, -np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def camera_path(path: Dict, n_frames: int, seed: int) -> np.ndarray:
    """[n_frames, 4, 4] poses: frame i looks from ``eye`` to ``target`` at
    angle phase + i * deg_per_frame, where eye = (ex cos a, ey sin a, ez) and
    target = (tx cos a, ty sin a, tz).  The seed draws the phase (uniform),
    a common scale of ex and ey (1 +- radius_jitter) and a height offset of
    ez (+- height_jitter_m)."""
    rs = np.random.RandomState(sub_seeds(seed, 1)[0])
    phase = rs.uniform(0.0, 2.0 * math.pi)
    scale = 1.0 + rs.uniform(-1.0, 1.0) * float(path["radius_jitter"])
    dz = rs.uniform(-1.0, 1.0) * float(path["height_jitter_m"])
    ex, ey, ez = path["eye"]
    tx, ty, tz = path["target"]
    step = math.radians(float(path["deg_per_frame"]))
    poses = []
    for i in range(n_frames):
        a = phase + i * step
        eye = np.array([ex * scale * math.cos(a), ey * scale * math.sin(a),
                        ez + dz])
        target = np.array([tx * math.cos(a), ty * math.sin(a), tz])
        poses.append(look_at(eye, target))
    return np.stack(poses)


def intrinsics(img_res, focal_per_width: float) -> np.ndarray:
    """Pinhole [3, 3] float32: f = focal_per_width * w, centre (w/2, h/2)."""
    h, w = img_res
    f = focal_per_width * w
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def _nanmax(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), -math.inf, x).amax(-1)


def _nanmin(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), math.inf, x).amin(-1)


def _slab(o, d, center, half):
    lo = torch.as_tensor(np.asarray(center, np.float32) -
                         np.asarray(half, np.float32), device=d.device)
    hi = torch.as_tensor(np.asarray(center, np.float32) +
                         np.asarray(half, np.float32), device=d.device)
    t0 = (lo - o) / d
    t1 = (hi - o) / d
    return _nanmax(torch.minimum(t0, t1)), _nanmin(torch.maximum(t0, t1))


def _hit_sphere(o, d, s):
    c = torch.as_tensor(np.asarray(s[:3], np.float32), device=d.device)
    r = float(np.float32(s[3]))
    oc = o - c
    a = (d * d).sum(-1)
    b = 2 * (d * oc).sum(-1)
    cc = (oc * oc).sum() - r * r
    disc = b * b - 4 * a * cc
    t = torch.where(disc > 0,
                    (-b - torch.sqrt(torch.clamp(disc, min=0))) / (2 * a),
                    torch.full_like(a, math.inf))
    return torch.where((disc > 0) & (t > 1e-6), t,
                       torch.full_like(t, math.inf))


def _hit_box(o, d, b):
    tmin, tmax = _slab(o, d, b[:3], b[3:])
    hit = tmax > torch.clamp(tmin, min=0)
    t = torch.where(tmin > 1e-6, tmin, torch.full_like(tmin, math.inf))
    return torch.where(hit, t, torch.full_like(t, math.inf))


def _hit_room(o, d, b):
    _, tmax = _slab(o, d, b[:3], b[3:])
    return torch.where(tmax > 1e-6, tmax, torch.full_like(tmax, math.inf))


def render_depth(scene: Dict, T_wc: torch.Tensor, intr: np.ndarray,
                 img_res, max_depth: float) -> torch.Tensor:
    """z-depth [H, W] float32 on T_wc's device of the first hit (0 = none,
    or at max_depth and beyond)."""
    h, w = img_res
    dev = T_wc.device
    uu = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    vv = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    dirs_c = torch.stack([(uu - float(intr[0, 2])) / float(intr[0, 0]),
                          (vv - float(intr[1, 2])) / float(intr[1, 1]),
                          torch.ones_like(uu)], -1).reshape(-1, 3)
    d = dirs_c @ T_wc[:3, :3].T
    o = T_wc[:3, 3]
    t = torch.full((h * w,), math.inf, device=dev)
    for s in scene.get("spheres", []):
        t = torch.minimum(t, _hit_sphere(o, d, s))
    for b in scene.get("boxes", []):
        t = torch.minimum(t, _hit_box(o, d, b))
    for r in scene.get("rooms", []):
        t = torch.minimum(t, _hit_room(o, d, r))
    depth = torch.where(torch.isfinite(t) & (t < max_depth), t,
                        torch.zeros((), device=dev))
    return depth.reshape(h, w)


def make_frames(traffic: Dict, img_res, focal_per_width: float, seed: int,
                device) -> Dict[str, np.ndarray]:
    """The mix's frames for one seed: ``raw`` uint16 millimetres
    [F, H, W] in host memory (as a sensor delivers them), ``T_wc``
    [F, 4, 4] and ``intr`` [3, 3] float32.  Rendered on ``device``."""
    n = int(traffic["frames"])
    poses = camera_path(traffic["path"], n, seed)
    intr = intrinsics(img_res, focal_per_width)
    max_depth = float(traffic["max_depth_m"])
    T = torch.as_tensor(poses, device=device)
    raw = torch.empty((n,) + tuple(img_res), dtype=torch.int32, device=device)
    for i in range(n):
        depth = render_depth(traffic["scene"], T[i], intr, img_res, max_depth)
        raw[i] = torch.round(depth * 1000.0).to(torch.int32)
    return {"raw": raw.cpu().numpy().astype(np.uint16), "T_wc": poses,
            "intr": intr}
