"""The port's dataset readers against the JAX package's on the same fixture
directories, written in the real layouts from the synthetic scene.

For each reader: the same length, frame ids, scene_id and dimensions;
``depth`` and ``depth_raw`` bit for bit; ``T_wc`` and ``intr_mat`` within
1e-6 (IDR: 1e-5, through RQ); ``rgb`` bit for bit (the port's JPEG decode
and area resize give cv2's bits on these files; the bound the codec is
held to is tests/test_torch_image_io.py's).  The canonical fixture is
written by both packages' ``write_canonical`` and each package reads both.
The ARKitScenes helpers, the ``fusion_dataset`` windows and the refiner
strides are compared value by value; the windows' accumulated TSDF within
1e-6 on all but 1e-3 of the voxels (tests/test_torch_refiner.py's prior
budget: the two frameworks' 3x3 products differ in the last bit).
Last, ``model.fuse_color`` on frames that carry only ``img_path`` gives
the vertex colours of the same run with the decoded ``rgb`` inline.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets import get_dataset as jget_dataset
from bnv_fusion_tpu.datasets import arkitscenes as jarks
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu.mesh import Mesh, save_ply
from bnv_fusion_tpu.scripts.generate_fusion_data import \
    write_canonical as jwrite_canonical
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.datasets import arkitscenes as tarks
from bnv_fusion_tpu_torch.datasets import get_dataset as tget_dataset
from bnv_fusion_tpu_torch.pipeline import NeuralMap
from bnv_fusion_tpu_torch.scripts.generate_fusion_data import \
    write_canonical as twrite_canonical
from bnv_fusion_tpu_torch.utils import image_io

POSE_ATOL = 1e-6
IDR_ATOL = 1e-5
WINDOW_ATOL, WINDOW_BUDGET = 1e-6, 1e-3
COLOR_HW = (96, 128)     # 1.6x the depth: the area resize's fractional path


@pytest.fixture(scope="module")
def synth():
    cfg = jload_config(["dataset.num_images=4", "dataset.img_res=[60,80]",
                        "dataset.load_color=true"])
    ds = SyntheticDemoDataset(cfg, "val")
    return ds, [ds[i] for i in range(len(ds))]


def _color_png(path, rgb, hw=COLOR_HW):
    img = cv2.resize(np.clip(rgb, 0, 255).astype(np.uint8), hw[::-1],
                     interpolation=cv2.INTER_LINEAR)
    cv2.imwrite(path, img[..., ::-1])


@pytest.fixture(scope="module")
def canonical(tmp_path_factory, synth):
    """The same scene written by the port's and by the JAX package's
    write_canonical (colour PNGs re-encoded as JPEG by each)."""
    ds, frames = synth
    root = tmp_path_factory.mktemp("canon")
    src = root / "src"
    src.mkdir()
    for i, f in enumerate(frames):
        _color_png(str(src / f"{i}.png"), f["rgb"])

    def stream():
        for i, f in enumerate(frames):
            yield (str(src / f"{i}.png"),
                   (f["depth"] * 1000).astype(np.uint16), f["T_wc"],
                   f["intr_mat"])

    twrite_canonical(str(root / "port" / "scene"), stream(), ds.dimensions)
    jwrite_canonical(str(root / "jax" / "scene"), stream(), ds.dimensions)
    return root


def _both(overrides, stage="val"):
    return (tget_dataset(tload_config(overrides), stage),
            jget_dataset(jload_config(overrides), stage))


def _same_frames(t, j, pose_atol=POSE_ATOL):
    assert len(t) == len(j)
    assert t.scan_id == j.scan_id
    np.testing.assert_array_equal(t.dimensions, j.dimensions)
    for i in range(len(t)):
        a, b = t[i], j[i]
        assert set(a) == set(b)
        assert a["frame_id"] == b["frame_id"]
        assert a["scene_id"] == b["scene_id"]
        np.testing.assert_array_equal(a["depth"], b["depth"])
        assert a["depth"].dtype == b["depth"].dtype
        np.testing.assert_allclose(a["T_wc"], b["T_wc"], atol=pose_atol)
        np.testing.assert_allclose(a["intr_mat"], b["intr_mat"],
                                   atol=pose_atol * np.abs(b["intr_mat"]).max())
        if "depth_raw" in b:
            assert a["depth_raw"].dtype == np.uint16
            np.testing.assert_array_equal(a["depth_raw"], b["depth_raw"])
            assert a["depth_scale"] == b["depth_scale"]
        if "rgb" in b:
            assert a["rgb"].dtype == b["rgb"].dtype
            np.testing.assert_array_equal(a["rgb"], b["rgb"])
        if "img_path" in b:
            assert a["img_path"] == b["img_path"]


def test_canonical_writers_agree(canonical):
    for sub in ("depth", "pose"):
        for name in sorted(os.listdir(canonical / "jax" / "scene" / sub)):
            a = canonical / "port" / "scene" / sub / name
            b = canonical / "jax" / "scene" / sub / name
            if sub == "pose":
                assert a.read_text() == b.read_text(), name
            else:
                np.testing.assert_array_equal(
                    cv2.imread(str(a), cv2.IMREAD_UNCHANGED),
                    cv2.imread(str(b), cv2.IMREAD_UNCHANGED))
    for name in os.listdir(canonical / "jax" / "scene" / "image"):
        a = canonical / "port" / "scene" / "image" / name
        b = canonical / "jax" / "scene" / "image" / name
        assert a.read_bytes() == b.read_bytes()   # libjpeg's encoder


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("extra", [
    ["dataset.downsample_scale=0."],
    ["dataset.downsample_scale=0.5", "dataset.stage_raw_depth=true"],
    ["dataset.downsample_scale=0.", "dataset.stage_raw_depth=true",
     "dataset.load_color=true", "model.ray_tracer.ray_max_dist=1.9"],
], ids=["plain", "downsampled_raw", "raw_color_far_cut"])
def test_canonical_reader(canonical, writer, extra):
    t, j = _both(["dataset=fusion_inference_dataset",
                  f"data_dir={canonical / writer}", "dataset.scan_id=scene",
                  "dataset.skip_images=2"] + extra)
    _same_frames(t, j)
    # the JAX reader stores skip and never strides (ROADMAP Queue 3)
    assert t.skip == j.skip == 2 and len(t) == 4


def _scannet_fixture(root, frames):
    scan = "scene0000_00"
    frame_dir = root / scan / "frames"
    for sub in ("color", "depth", "pose", "intrinsic"):
        (frame_dir / sub).mkdir(parents=True)
    align = np.eye(4)
    c, s = np.cos(0.3), np.sin(0.3)
    align[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    align[:3, 3] = [0.4, -0.2, 0.1]
    (root / scan / f"{scan}.txt").write_text(
        "sceneType = Bedroom\naxisAlignment = " +
        " ".join(f"{v:.8f}" for v in align.ravel()) + "\n")
    gt = np.array([[-1.1, -1.2, -0.6], [1.3, 1.0, 0.9], [0.2, 0.1, 0.0]],
                  np.float32)
    save_ply(str(root / scan / f"{scan}_vh_clean_2.ply"),
             Mesh(gt, np.array([[0, 1, 2]], np.int32)))
    intr = np.eye(4)
    intr[:3, :3] = frames[0]["intr_mat"]
    np.savetxt(str(frame_dir / "intrinsic" / "intrinsic_depth.txt"), intr)
    for i, f in enumerate(frames):
        cv2.imwrite(str(frame_dir / "depth" / f"{i}.png"),
                    (f["depth"] * 1000).astype(np.uint16))
        img = cv2.resize(f["rgb"].astype(np.uint8), (130, 97))
        cv2.imwrite(str(frame_dir / "color" / f"{i}.jpg"), img[..., ::-1])
        np.savetxt(str(frame_dir / "pose" / f"{i}.txt"),
                   np.linalg.inv(f["T_wc"]))
    return scan


@pytest.mark.parametrize("name", ["fusion_inference_dataset_scannet",
                                  "fusion_refiner_scannet_dataset"])
def test_scannet_reader(tmp_path, synth, name):
    scan = _scannet_fixture(tmp_path, synth[1])
    for skip in (1, 3):
        t, j = _both([f"dataset={name}", f"data_dir={tmp_path}",
                      f"dataset.scan_id={scan}", f"dataset.skip_images={skip}",
                      "dataset.downsample_scale=0."], "train")
        _same_frames(t, j)
        np.testing.assert_allclose(t.axis_align_mat, j.axis_align_mat,
                                   atol=POSE_ATOL)


def test_arkit_reader(tmp_path, synth):
    frames = synth[1]
    seq = tmp_path / "myscan"
    seq.mkdir()
    with open(seq / "export.obj", "w") as f:
        f.write("# rough export\n")
        for v in [(-1.2, -1.0, 0.1), (1.1, 1.3, 1.2), (0, 0, 0.5)]:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        f.write("f 1 2 3\n")
    T_align = np.diag([1.0, -1.0, -1.0, 1.0])
    names = [3, 10, 17, 24]   # sorted numerically, not as strings
    for k, (i, f) in enumerate(zip(names, frames)):
        cv2.imwrite(str(seq / f"depth_{i}.png"),
                    (f["depth"] * 1000).astype(np.uint16))
        if k != 1:   # frame 10 has no confidence file: no mask
            conf = np.random.RandomState(k).randint(0, 3, f["depth"].shape)
            cv2.imwrite(str(seq / f"conf_{i}.png"), conf.astype(np.uint8))
        hi = f["intr_mat"].astype(np.float64).copy()
        hi[:2, :3] *= 7.5
        with open(seq / f"frame_{i}.json", "w") as fh:
            json.dump({"cameraPoseARFrame":
                       list(map(float, (f["T_wc"] @ T_align).ravel())),
                       "intrinsics": list(map(float, hi.ravel()))}, fh)
    base = ["dataset=fusion_inference_dataset_arkit", f"data_dir={tmp_path}",
            "dataset.scan_id=myscan"]
    for extra in (["dataset.confidence_level=2"],
                  ["dataset.confidence_level=1", "dataset.skip_images=2"]):
        t, j = _both(base + extra)
        assert t.names == j.names
        _same_frames(t, j)
    # kept as the JAX package has it: the confidence mask is not
    # downsampled, so downsample_scale fails on a frame with one
    t, j = _both(base + ["dataset.downsample_scale=0.5"])
    for ds in (t, j):
        with pytest.raises(ValueError):
            ds[0]
        assert ds[1]["depth"].shape == (30, 40)


def test_synthetic_idr_reader(tmp_path, synth):
    frames = synth[1]
    root = tmp_path / "idr_scan"
    (root / "image").mkdir(parents=True)
    (root / "depth").mkdir()
    cams = {}
    for i, f in enumerate(frames):
        cv2.imwrite(str(root / "image" / "{:03d}.png".format(i)),
                    np.zeros((60, 80, 3), np.uint8))
        cv2.imwrite(str(root / "depth" / "{:03d}.png".format(i)),
                    (f["depth"] * 1000).astype(np.uint16))
        K = np.eye(4)
        K[:3, :3] = f["intr_mat"]
        scale = np.diag([1.4, 1.4, 1.4, 1.0])
        scale[:3, 3] = [0.1, -0.05, 0.2]
        cams[f"world_mat_{i}"] = K @ np.linalg.inv(f["T_wc"]) @ \
            np.linalg.inv(scale)
        cams[f"scale_mat_{i}"] = scale
    cams["scale_factor_0"] = np.float64(1.3)
    np.savez(str(root / "cameras_sphere.npz"), **cams)
    for skip in (1, 2):
        t, j = _both(["dataset=fusion_inference_dataset_synthetic",
                      f"data_dir={tmp_path}", "dataset.scan_id=idr_scan",
                      f"dataset.skip_images={skip}",
                      "dataset.downsample_scale=0."])
        _same_frames(t, j, pose_atol=IDR_ATOL)


def test_arkitscenes_helpers(tmp_path):
    rng = np.random.RandomState(4)
    lines = []
    for k in range(12):
        ts = 10.0 + 0.1 * k + rng.uniform(-0.01, 0.01)
        vals = [ts] + list(rng.randn(3) * 0.7) + list(rng.randn(3))
        lines.append(" ".join(f"{v:.9f}" for v in vals))
    lines.insert(3, "")
    rng.shuffle(lines)
    traj = tmp_path / "lowres_wide.traj"
    traj.write_text("\n".join(lines) + "\n")
    for line in (ln for ln in lines if ln.strip()):
        (ta, Ta), (tb, Tb) = (tarks.parse_traj_line(line),
                              jarks.parse_traj_line(line))
        assert ta == tb
        np.testing.assert_allclose(Ta, Tb, atol=POSE_ATOL)
    (tt, tp), (jt, jp) = (tarks.read_trajectory(str(traj)),
                          jarks.read_trajectory(str(traj)))
    np.testing.assert_array_equal(tt, jt)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, atol=POSE_ATOL)
    pincam = tmp_path / "x.pincam"
    pincam.write_text("256 192 212.1 211.7 127.6 95.3\n")
    np.testing.assert_array_equal(tarks.read_pincam(str(pincam)),
                                  jarks.read_pincam(str(pincam)))
    for q in (9.85, 9.99, 10.0, 10.33, 10.571, 11.1, 11.25, 12.0):
        for kw in ({}, {"max_gap": 0.05}, {"max_dt": 0.3}):
            a = tarks.associate_pose(tt, tp, q, **kw)
            b = jarks.associate_pose(jt, jp, q, **kw)
            assert (a is None) == (b is None), (q, kw)
            if a is not None:
                np.testing.assert_allclose(a, b, atol=POSE_ATOL)
    for name in ("41069021_3967.415.png", "/x/v_12.5.png"):
        assert tarks.frame_timestamp_from_name(name) == \
            jarks.frame_timestamp_from_name(name)


@pytest.mark.parametrize("stage", ["train", "val", "test"])
def test_refiner_strides(canonical, stage):
    for skip, shift in ((1, 0), (2, 1), (3, 2)):
        t, j = _both(["dataset=fusion_refiner_dataset",
                      f"data_dir={canonical / 'port'}", "dataset.scan_id=scene",
                      f"dataset.skip_images={skip}",
                      f"dataset.sample_shift={shift}",
                      "dataset.downsample_scale=0."], stage)
        assert t.frame_ids == j.frame_ids
        _same_frames(t, j)


@pytest.mark.parametrize("stage", ["train", "test"])
def test_fusion_windows(stage):
    """Noise only outside test; windows clipped at both sequence ends."""
    ovr = ["dataset=fusion_dataset", "dataset.img_res=[30,40]",
           "dataset.num_images=5", "dataset.max_neighbor_images=4",
           "dataset.num_pixels=64", "model.voxel_size=0.1"]
    t, j = _both(ovr, stage)
    assert len(t) == len(j) == 5
    assert t.world_res == j.world_res
    for idx in (0, 4):
        (tf, tr), (jf, jr) = t[idx], j[idx]
        assert set(tf) == set(jf) and set(tr) == set(jr)
        for key in jf:
            if key in ("sdfs", "sdf_weights"):
                continue
            a, b = np.asarray(tf[key]), np.asarray(jf[key])
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, atol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(a, b, err_msg=key)
        for key in jr:
            np.testing.assert_allclose(tr[key], jr[key], atol=1e-6,
                                       err_msg=key)
        bad = np.abs(tf["sdfs"] - jf["sdfs"]) > WINDOW_ATOL
        assert bad.mean() <= WINDOW_BUDGET, bad.sum()
        assert np.mean(tf["sdf_weights"] != jf["sdf_weights"]) <= \
            WINDOW_BUDGET
        clean = jf["gt_depth"]
        noisy = jf["rgbd"][:, 3]
        assert (np.abs(noisy - clean).max() > 0) == (stage != "test")


def test_fuse_color_from_img_path(canonical):
    """fuse_color on frames with only an img_path == the same run with the
    decoded, area-resized rgb passed inline."""
    cfg = tload_config([
        "device_type=cpu", "dataset=fusion_inference_dataset",
        f"data_dir={canonical / 'port'}", "dataset.scan_id=scene",
        "dataset.downsample_scale=0.", "model.voxel_size=0.05",
        "model.min_pts_in_grid=0", "model.table_capacity=65536",
        "model.fuse_color=true"])
    ds = tget_dataset(cfg, "val")
    frames = [ds[i] for i in range(len(ds))]
    assert all("rgb" not in f and os.path.exists(f["img_path"])
               for f in frames)
    inline = [dict(f, rgb=image_io.read_color(f["img_path"],
                                              f["depth"].shape))
              for f in frames]
    assert inline[0]["rgb"].shape == (60, 80, 3)
    meshes = []
    for stream in (frames, inline):
        nm = NeuralMap(ds.dimensions, cfg, tnn.init_model(0))
        nm.integrate_batch(stream[:2])
        for f in stream[2:]:
            nm.integrate(f)
        meshes.append(nm.extract_mesh())
    a, b = meshes
    assert a is not None and a.colors is not None and a.colors.std() > 1.0
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.colors, b.colors)
    torch.testing.assert_close(torch.as_tensor(a.faces),
                               torch.as_tensor(b.faces))
