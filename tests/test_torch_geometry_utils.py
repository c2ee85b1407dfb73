"""Host and tensor helpers the real-data path brings to the port, against the
JAX package's functions on the same numpy inputs: geometry (depth_to_xyz_np,
get_homogeneous, the AABB measures, load_K_Rt_from_P), voxel
(coords_to_position, get_frustrum_range, depth_to_tsdf, voxel_traversal,
is_active), utils/motion, config.config_from_dict, utils/profiling and the
utils/vis helpers.

Tolerances: load_K_Rt_from_P within 1e-5 (scipy/numpy in place of cv2's RQ
and SVD); everything else within 1e-6, voxel_traversal exact.
"""

import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from bnv_fusion_tpu import config as jconfig
from bnv_fusion_tpu import geometry as jgeo
from bnv_fusion_tpu import voxel as jvox
from bnv_fusion_tpu.mesh import Mesh as JMesh
from bnv_fusion_tpu.utils import motion as jmotion
from bnv_fusion_tpu.utils import vis as jvis
from bnv_fusion_tpu_torch import config as tconfig
from bnv_fusion_tpu_torch import geometry as tgeo
from bnv_fusion_tpu_torch import voxel as tvox
from bnv_fusion_tpu_torch.mesh import Mesh as TMesh
from bnv_fusion_tpu_torch.utils import motion as tmotion
from bnv_fusion_tpu_torch.utils import profiling as tprof
from bnv_fusion_tpu_torch.utils import vis as tvis

ATOL = 1e-6
KRT_ATOL = 1e-5
INTR = np.array([[52.5, 0, 39.5], [0, 52.5, 29.5], [0, 0, 1]], np.float32)


def _projection(rng, mode):
    K = np.array([[rng.uniform(200, 900), rng.uniform(-5, 5),
                   rng.uniform(100, 400)],
                  [0, rng.uniform(200, 900), rng.uniform(100, 300)],
                  [0, 0, 1]])
    R = Rotation.random(random_state=rng).as_matrix()
    if mode == "reflected":
        R = R @ np.diag([1.0, 1.0, -1.0])
    P = K @ np.concatenate([R, rng.randn(3, 1)], 1)
    if mode == "negative":
        P = P * -rng.uniform(0.1, 3.0)
    elif mode == "scaled":
        P = P * rng.uniform(0.1, 3.0)
    return P


@pytest.mark.parametrize("mode", ["positive", "scaled", "negative",
                                  "reflected"])
def test_load_K_Rt_from_P_matches_cv2(mode):
    """RQ sign conventions: the port takes cv2's signs on positive-focal
    projections, P scaled by a negative factor and a reflected R."""
    rng = np.random.RandomState(["positive", "scaled", "negative",
                                 "reflected"].index(mode))
    for _ in range(200):
        P = _projection(rng, mode)
        jk, jp = jgeo.load_K_Rt_from_P(P)
        tk, tp = tgeo.load_K_Rt_from_P(P)
        assert jk.dtype == tk.dtype and jp.dtype == tp.dtype
        np.testing.assert_allclose(tk, jk, atol=KRT_ATOL * np.abs(jk).max())
        np.testing.assert_allclose(tp, jp, atol=KRT_ATOL)
        R, Q = tgeo._rq3(P[:, :3])
        Rc, Qc = cv2.RQDecomp3x3(P[:, :3])[1:3]
        np.testing.assert_allclose(Q, Qc, atol=1e-9)
        np.testing.assert_allclose(R, Rc, atol=1e-9 * np.abs(Rc).max())


def test_geometry_host_helpers():
    rng = np.random.RandomState(0)
    depth = rng.uniform(0.5, 3.0, (12, 16)).astype(np.float32)
    depth[::3, ::5] = 0
    np.testing.assert_allclose(tgeo.depth_to_xyz_np(depth, INTR),
                               jgeo.depth_to_xyz_np(depth, INTR), atol=ATOL)
    pts = rng.randn(5, 4, 3).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.get_homogeneous(torch.as_tensor(pts)).numpy(),
        np.asarray(jgeo.get_homogeneous(jnp.asarray(pts))), atol=ATOL)
    for _ in range(50):
        a = np.sort(rng.randn(2, 3), axis=0)
        b = np.sort(rng.randn(2, 3), axis=0)
        for f in ("aabb_intersection", "aabb_volume", "aabb_iou",
                  "aabb_giou"):
            args = (a,) if f == "aabb_volume" else (a, b)
            assert abs(getattr(tgeo, f)(*args) -
                       getattr(jgeo, f)(*args)) <= ATOL


def test_voxel_helpers():
    rng = np.random.RandomState(1)
    c = rng.uniform(0, 20, (100, 3)).astype(np.float32)
    mn = np.array([-1.3, -1.3, -0.8], np.float32)
    np.testing.assert_allclose(
        tvox.coords_to_position(torch.as_tensor(c), torch.as_tensor(mn),
                                0.05).numpy(),
        np.asarray(jvox.coords_to_position(jnp.asarray(c), mn, 0.05)),
        atol=ATOL)
    for got, want in zip(tvox.get_frustrum_range(INTR, 60, 80, 3.0, 0.04),
                         jvox.get_frustrum_range(INTR, 60, 80, 3.0, 0.04)):
        np.testing.assert_allclose(got, want, atol=ATOL)

    depth = rng.uniform(0.8, 2.5, (60, 80)).astype(np.float32)
    depth[:, :7] = 0
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, :3] = Rotation.from_euler("xyz", [0.1, -0.2, 0.05]).as_matrix()
    T_wc[:3, 3] = [0.1, -0.2, 0.3]
    q = rng.uniform(-1.5, 2.5, (4000, 3)).astype(np.float32)
    got = tvox.depth_to_tsdf(torch.as_tensor(depth), torch.as_tensor(INTR),
                             torch.as_tensor(T_wc), torch.as_tensor(q), 0.1)
    want = jvox.depth_to_tsdf(jnp.asarray(depth), jnp.asarray(INTR),
                              jnp.asarray(T_wc), jnp.asarray(q), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    n_xyz = np.array([20, 15, 10])
    for _ in range(30):
        o = rng.uniform(-5, 25, 3)
        d = rng.randn(3)
        if rng.rand() < 0.3:
            d[rng.randint(3)] = 0.0   # axis-parallel rays
        np.testing.assert_array_equal(
            tvox.voxel_traversal(o, d, 40.0, n_xyz),
            jvox.voxel_traversal(o, d, 40.0, n_xyz))

    flags = rng.rand(*n_xyz) < 0.4
    coords = rng.randint(-3, 23, (500, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tvox.is_active(torch.as_tensor(coords), torch.as_tensor(flags),
                       n_xyz).numpy(),
        np.asarray(jvox.is_active(jnp.asarray(coords), jnp.asarray(flags),
                                  n_xyz)))


def test_motion_matches():
    rng = np.random.RandomState(2)
    for _ in range(30):
        w = rng.randn(3) * rng.choice([1e-12, 0.5, 3.0])
        xi = np.concatenate([rng.randn(3), w])
        for f, arg in (("so3_hat", w), ("so3_exp", w), ("se3_exp", xi)):
            np.testing.assert_allclose(getattr(tmotion, f)(arg),
                                       getattr(jmotion, f)(arg), atol=ATOL)
        R = Rotation.random(random_state=rng).as_matrix()
        np.testing.assert_allclose(tmotion.so3_log(R), jmotion.so3_log(R),
                                   atol=ATOL)
        T = jmotion.se3_exp(xi)
        np.testing.assert_allclose(tmotion.se3_log(T), jmotion.se3_log(T),
                                   atol=ATOL)
        T1 = jmotion.se3_exp(rng.randn(6))
        t = rng.rand()
        np.testing.assert_allclose(tmotion.interpolate_pose(T, T1, t),
                                   jmotion.interpolate_pose(T, T1, t),
                                   atol=ATOL)
    # near-pi rotation branch
    R = Rotation.from_rotvec([np.pi - 1e-8, 0, 0]).as_matrix()
    np.testing.assert_allclose(tmotion.so3_log(R), jmotion.so3_log(R),
                               atol=ATOL)
    poses = [jmotion.se3_exp(rng.randn(6)) for _ in range(4)]
    for a, b in zip(tmotion.pose_spline(poses, 9),
                    jmotion.pose_spline(poses, 9)):
        np.testing.assert_allclose(a, b, atol=ATOL)
    xi = rng.randn(6)
    ti, ji = tmotion.Isometry.exp(xi), jmotion.Isometry.exp(xi)
    pts = rng.randn(7, 3)
    np.testing.assert_allclose((ti.inv() @ ti @ pts), (ji.inv() @ ji @ pts),
                               atol=ATOL)
    np.testing.assert_allclose(ti.log(), ji.log(), atol=ATOL)
    np.testing.assert_allclose(
        tmotion.Isometry.from_rt(ti.rotation, ti.translation).matrix,
        jmotion.Isometry.from_rt(ji.rotation, ji.translation).matrix,
        atol=ATOL)


def test_config_from_dict_matches():
    data = {"dataset": {"data_dir": "/x", "scan_id": "s", "skip": 1},
            "model": {"ray_tracer": {"ray_max_dist": 100.0}}}
    t, j = tconfig.config_from_dict(data), jconfig.config_from_dict(data)
    assert t == j and t.model.ray_tracer.ray_max_dist == 100.0
    t.dataset.scan_id = "other"
    assert data["dataset"]["scan_id"] == "s"   # a deep copy


def test_profiling_on_cpu(tmp_path):
    timer = tprof.PhaseTimer(["a", "b"])
    with timer.phase("a"):
        pass
    timer.start("b")
    timer.log("b")
    assert timer.counts == {"a": 1, "b": 1} and "a:" in timer.summary()
    assert timer.fps("a", steps=0) == 0.0 or timer.times["a"] == 0.0
    # sync runs before each reading
    synced = []
    timer = tprof.PhaseTimer(["a"], sync=lambda: synced.append(1))
    with timer.phase("a"):
        pass
    assert len(synced) == 2 and timer.counts == {"a": 1}
    with tprof.maybe_trace(str(tmp_path / "trace")):
        with tprof.span("work"):
            torch.ones(8).sum()
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    work = [e for e in trace["traceEvents"] if e.get("name") == "work"]
    assert work and all(e["cat"] == "cpu_op" for e in work)
    with tprof.maybe_trace(None):
        pass


def test_vis_helpers(tmp_path):
    rng = np.random.RandomState(3)
    depth = rng.uniform(0, 3, (20, 30)).astype(np.float32)
    depth[:4] = 0
    for md in (None, 2.0):
        np.testing.assert_array_equal(tvis.colorize_depth(depth, md),
                                      jvis.colorize_depth(depth, md))
    v = rng.randn(30, 3).astype(np.float32)
    f = rng.randint(0, 30, (40, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tvis.mesh_with_normal_colors(TMesh(v, f)),
        jvis.mesh_with_normal_colors(JMesh(v, f)))
    img = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    for ext in ("png", "jpg"):
        ours, theirs = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
        tvis.save_image(ours, img)
        jvis.save_image(theirs, img)
        a = cv2.imread(ours)
        b = cv2.imread(theirs)
        if ext == "png":
            np.testing.assert_array_equal(a, b)
        else:   # the same encoder settings: equal files
            assert open(ours, "rb").read() == open(theirs, "rb").read()
        assert os.path.getsize(ours) > 0
