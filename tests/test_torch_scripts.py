"""The port's six scripts (bnv_fusion_tpu_torch/scripts) against the JAX
package's CLIs.

- compute_chamfer, evaluate_bnvf and evaluation.evaluate_mesh give the JAX
  metrics on the same meshes within 1e-6 (cKDTree in place of sklearn).
- generate_fusion_data, each converter on a small raw fixture: depth PNGs
  decode equal, pose text and dimensions.txt equal to the JAX converter's,
  colour JPEGs equal bytes (the same encoder settings).
- run_inference forwards the JAX CLI's overrides, in both modes.
- A tiny chain on the CPU: generate_fusion_data -> run_inference --mode
  e2e -> evaluate_bnvf writes its files, and its mesh equals the port's
  run_e2e on the same overrides.
- run_rgbd_integration: the JAX script's face count, vertices within 1e-4.
- demo writes its three PNGs and metrics.json.
"""

import json
import os

import cv2
import numpy as np
import pytest

import bnv_fusion_tpu.run_e2e as jrun_e2e
import bnv_fusion_tpu.test as jtest
import bnv_fusion_tpu.train as jtrain
from bnv_fusion_tpu.datasets.synth_scene import (SceneSpec, SphereObj,
                                                 gt_mesh, look_at_pose,
                                                 render_depth)
from bnv_fusion_tpu.evaluation import evaluate_mesh as jevaluate_mesh
from bnv_fusion_tpu.mesh import Mesh, load_ply as jload_ply, save_ply
from bnv_fusion_tpu.scripts import compute_chamfer as jchamfer
from bnv_fusion_tpu.scripts import evaluate_bnvf as jeval
from bnv_fusion_tpu.scripts import generate_fusion_data as jgen
from bnv_fusion_tpu.scripts import run_inference as jrun_inf
from bnv_fusion_tpu.scripts import run_rgbd_integration as jrgbd
from bnv_fusion_tpu_torch import run_e2e as trun_e2e
from bnv_fusion_tpu_torch import test as ttest
from bnv_fusion_tpu_torch import train as ttrain
from bnv_fusion_tpu_torch.checkpoint import save_state
from bnv_fusion_tpu_torch.evaluation import evaluate_mesh as tevaluate_mesh
from bnv_fusion_tpu_torch.mesh import load_ply as tload_ply
from bnv_fusion_tpu_torch.nn import init_model
from bnv_fusion_tpu_torch.scripts import compute_chamfer as tchamfer
from bnv_fusion_tpu_torch.scripts import demo as tdemo
from bnv_fusion_tpu_torch.scripts import evaluate_bnvf as teval
from bnv_fusion_tpu_torch.scripts import generate_fusion_data as tgen
from bnv_fusion_tpu_torch.scripts import run_inference as trun_inf
from bnv_fusion_tpu_torch.scripts import run_rgbd_integration as trgbd

METRIC_ATOL = 1e-6
VERT_ATOL = 1e-4
SPHERE = SceneSpec(spheres=[SphereObj(np.zeros(3, np.float32), 0.5)])


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    gt = gt_mesh(SPHERE, bounds=0.7, resolution=40)
    pred = gt_mesh(SceneSpec(spheres=[SphereObj(
        np.array([0.012, 0, 0], np.float32), 0.49)]), 0.7, 40)
    paths = str(d / "pred.ply"), str(d / "gt.ply")
    save_ply(paths[0], pred)
    save_ply(paths[1], gt)
    return paths


def _numbers(out: str):
    vals = []
    for line in out.splitlines():
        for tok in line.replace(":", " ").split():
            try:
                vals.append(float(tok))
            except ValueError:
                pass
    return np.asarray(vals)


def test_compute_chamfer_like_jax(meshes, capsys):
    args = list(meshes) + ["--n_samples", "4000", "--normal_consistency",
                           "--threshold", "0.01"]
    assert jchamfer.main(args) == 0
    want = capsys.readouterr().out
    assert tchamfer.main(args) == 0
    got = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in got.splitlines()] == \
        [ln.split(":")[0] for ln in want.splitlines()]
    np.testing.assert_allclose(_numbers(got), _numbers(want),
                               atol=METRIC_ATOL)


def test_evaluate_bnvf_like_jax(meshes, tmp_path, capsys):
    pred, gt = meshes
    outs = {}
    for name, mod in (("jax", jeval), ("port", teval)):
        js = str(tmp_path / f"{name}.json")
        assert mod.main(["--pred", pred, pred, "--gt", gt, gt,
                         "--n_samples", "4000", "--json_out", js]) == 0
        outs[name] = (capsys.readouterr().out, json.load(open(js)))
    assert outs["port"][0] == outs["jax"][0]
    for name, res in outs["jax"][1].items():
        for t, r in res.items():
            for k, v in r.items():
                assert abs(outs["port"][1][name][t][k] - v) <= METRIC_ATOL

    a = tevaluate_mesh(tload_ply(pred), tload_ply(gt), 3000, (0.02, 0.005), 3)
    b = jevaluate_mesh(jload_ply(pred), jload_ply(gt), 3000, (0.02, 0.005), 3)
    assert a.keys() == b.keys()
    for t in b:
        for k in b[t]:
            assert abs(a[t][k] - b[t][k]) <= METRIC_ATOL


# ---------------------------------------------------------------------------
# generate_fusion_data
# ---------------------------------------------------------------------------

def _poses(n):
    out = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = np.array([1.5 * np.cos(ang), 1.5 * np.sin(ang),
                        0.55 if i % 2 == 0 else -0.55])
        out.append(look_at_pose(eye, np.zeros(3)))
    return out


def _write_log(path, poses):
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            f.write(f"{i} {i} {i}\n")
            for row in T:
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")


def _gradient_bgr(h, w, i):
    x = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
    y = np.linspace(0, 255, h, dtype=np.float32)[:, None, None]
    img = np.concatenate([np.broadcast_to(x, (h, w, 1)),
                          np.broadcast_to(y, (h, w, 1)),
                          np.full((h, w, 1), 40.0 * i)], -1)
    return img.astype(np.uint8)


def _raw_fixture(root, kind, n=3, hw=(48, 64)):
    """A small raw capture in the converter's input layout."""
    name = {"scene3d": "lounge", "icl_nuim": "lr_kt0", "scannet":
            "scene0001_00", "arkit": "arscan"}[kind]
    seq = root / name
    seq.mkdir(parents=True)
    poses = _poses(n)
    intr = tgen.SCENE3D_INTR.astype(np.float32).copy()
    intr[:2] *= hw[1] / 640.0
    gt = gt_mesh(SPHERE, 0.7, 24)
    depths = [(render_depth(SPHERE, T, intr, hw) * 1000).astype(np.uint16)
              for T in poses]
    if kind == "scene3d":
        (seq / f"{name}_png" / "color").mkdir(parents=True)
        (seq / f"{name}_png" / "depth").mkdir(parents=True)
        save_ply(str(seq / f"{name}.ply"), gt)
        _write_log(seq / f"{name}_trajectory.log", poses)
        for i in range(n):
            cv2.imwrite(str(seq / f"{name}_png" / "depth" / f"{i:06d}.png"),
                        depths[i])
            cv2.imwrite(str(seq / f"{name}_png" / "color" / f"{i:06d}.png"),
                        _gradient_bgr(*hw, i))
    elif kind == "icl_nuim":
        (seq / "depth").mkdir()
        (seq / "rgb").mkdir()
        save_ply(str(seq / f"{name}.ply"), gt)
        _write_log(seq / f"{name}.log", poses)
        for i in range(n):
            cv2.imwrite(str(seq / "depth" / f"{i}.png"), depths[i])
            if i != 1:   # a frame without colour gets a black JPEG
                cv2.imwrite(str(seq / "rgb" / f"{i}.png"),
                            _gradient_bgr(*hw, i))
    elif kind == "scannet":
        fd = seq / "frames"
        for sub in ("color", "depth", "pose", "intrinsic"):
            (fd / sub).mkdir(parents=True)
        (seq / f"{name}.txt").write_text(
            "axisAlignment = 0 -1 0 0.3 1 0 0 -0.2 0 0 1 0.05 0 0 0 1\n")
        save_ply(str(seq / f"{name}_vh_clean_2.ply"),
                 Mesh(gt.vertices + np.float32([0.1, 0.2, 0.0]), gt.faces))
        K = np.eye(4)
        K[:3, :3] = intr
        np.savetxt(str(fd / "intrinsic" / "intrinsic_depth.txt"), K)
        for i in range(n):
            cv2.imwrite(str(fd / "depth" / f"{i}.png"), depths[i])
            cv2.imwrite(str(fd / "color" / f"{i}.jpg"),
                        _gradient_bgr(97, 130, i))   # a sensor-sized JPEG
            np.savetxt(str(fd / "pose" / f"{i}.txt"), np.linalg.inv(poses[i]))
    else:
        with open(seq / "export.obj", "w") as f:
            for v in gt.vertices[::7]:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        for i in range(n):
            cv2.imwrite(str(seq / f"depth_{i}.png"), depths[i])
            cv2.imwrite(str(seq / f"conf_{i}.png"),
                        np.full(hw, 2, np.uint8))
            hi = intr.astype(np.float64).copy()
            hi[:2] *= 7.5
            with open(seq / f"frame_{i}.json", "w") as f:
                json.dump({"cameraPoseARFrame":
                           list(map(float, (poses[i] @ flip).ravel())),
                           "intrinsics": list(map(float, hi.ravel()))}, f)
    return name


@pytest.mark.parametrize("kind", ["scene3d", "icl_nuim", "scannet", "arkit"])
def test_generate_fusion_data_like_jax(tmp_path, kind):
    name = _raw_fixture(tmp_path / "raw", kind)
    for mod, out in ((jgen, "jax"), (tgen, "port")):
        assert mod.main([kind, "--root", str(tmp_path / "raw"), "--out",
                         str(tmp_path / out), "--seqs", name]) == 0
    a, b = tmp_path / "port" / name, tmp_path / "jax" / name
    for sub in ("image", "depth", "pose"):
        assert sorted(os.listdir(a / sub)) == sorted(os.listdir(b / sub))
    for f in os.listdir(b / "pose"):
        assert (a / "pose" / f).read_text() == (b / "pose" / f).read_text()
    for f in os.listdir(b / "depth"):
        x = cv2.imread(str(a / "depth" / f), cv2.IMREAD_UNCHANGED)
        y = cv2.imread(str(b / "depth" / f), cv2.IMREAD_UNCHANGED)
        assert x.dtype == np.uint16
        np.testing.assert_array_equal(x, y)
    for f in os.listdir(b / "image"):
        assert (a / "image" / f).read_bytes() == \
            (b / "image" / f).read_bytes()


# ---------------------------------------------------------------------------
# run_inference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(jrun_inf.OPERATING_POINTS))
def test_run_inference_forwards_jax_overrides(monkeypatch, kind):
    assert trun_inf.OPERATING_POINTS == jrun_inf.OPERATING_POINTS
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jrun_e2e, "main", lambda o: calls["jax"].append(
        ("e2e", list(o))))
    monkeypatch.setattr(jtest, "main", lambda o: calls["jax"].append(
        ("test", list(o))))
    monkeypatch.setattr(jtrain, "main", lambda o: calls["jax"].append(
        ("train", list(o))))
    monkeypatch.setattr(trun_e2e, "main", lambda o: calls["port"].append(
        ("e2e", list(o))))
    monkeypatch.setattr(ttest, "main", lambda o: calls["port"].append(
        ("test", list(o))))
    monkeypatch.setattr(ttrain, "main", lambda o: calls["port"].append(
        ("train", list(o))))
    for mode in ("e2e", "fuse_refine"):
        argv = [kind, "--seqs", "a/s1", "s2", "--checkpoint", "w.ckpt",
                "--data_dir", "/data", "--min_pts_in_grid", "4", "--mode",
                mode, "--extra", "model.fuse_color=true"]
        assert jrun_inf.main(argv) == 0 and trun_inf.main(argv) == 0
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) == 6


def test_run_inference_reports_failures(monkeypatch):
    def boom(o):
        raise RuntimeError("no data")

    monkeypatch.setattr(trun_e2e, "main", boom)
    assert trun_inf.main(["scannet", "--seqs", "x", "--checkpoint",
                          "w.npz"]) == 1


CHAIN = ["device_type=cpu", "dataset.downsample_scale=0.125",
         "dataset.skip_images=1", "model.voxel_size=0.05",
         "model.integrate_batch_size=2", "dataset.num_pixels=200",
         "model.train_ray_splits=100", "trainer.global_steps=2",
         "model.table_capacity=65536"]


def test_chained_scripts(tmp_path):
    """generate_fusion_data -> run_inference --mode e2e -> evaluate_bnvf
    at 60x80 (480x640 captures read at 1/8), 4 frames, voxel 0.05."""
    raw = tmp_path / "raw" / "chain"
    (raw / "chain_png" / "color").mkdir(parents=True)
    (raw / "chain_png" / "depth").mkdir(parents=True)
    gt = gt_mesh(SPHERE, bounds=0.7, resolution=48)
    save_ply(str(raw / "chain.ply"), gt)
    poses = _poses(4)
    _write_log(raw / "chain_trajectory.log", poses)
    for i, T in enumerate(poses):
        d = render_depth(SPHERE, T, tgen.SCENE3D_INTR.astype(np.float32),
                         (480, 640))
        cv2.imwrite(str(raw / "chain_png" / "depth" / f"{i:06d}.png"),
                    (d * 1000).astype(np.uint16))
        cv2.imwrite(str(raw / "chain_png" / "color" / f"{i:06d}.png"),
                    _gradient_bgr(480, 640, i))
    canon = tmp_path / "canon"
    assert tgen.main(["scene3d", "--root", str(tmp_path / "raw"), "--out",
                      str(canon), "--seqs", "chain"]) == 0
    weights = str(tmp_path / "w.npz")
    save_state(weights, {"params": {
        n: {k: v.numpy() for k, v in p.items()}
        for n, p in init_model(0, bias_std=0.1).items()}})

    out = tmp_path / "out"
    assert trun_inf.main(["scene3d", "--seqs", "chain", "--checkpoint",
                          weights, "--data_dir", str(canon),
                          "--min_pts_in_grid", "0", "--extra"] + CHAIN +
                         [f"output_dir={out}"]) == 0
    final = out / "run_e2e" / "chain" / "final.ply"
    assert final.exists() and (out / "run_e2e" / "chain" /
                               "before_optim.ply").exists()
    js = str(tmp_path / "eval.json")
    assert teval.main(["--pred", str(final), "--gt", str(raw / "chain.ply"),
                       "--n_samples", "5000", "--json_out", js]) == 0
    (res,) = json.load(open(js)).values()
    assert 0.0 <= res["@0.025"]["fscore"] <= 1.0

    # the same overrides straight through run_e2e give the same mesh
    op = trun_inf.OPERATING_POINTS["scene3d"]
    direct = trun_e2e.run(trun_inf.sequence_overrides(
        op, "chain", weights, str(canon), 0,
        CHAIN + [f"output_dir={tmp_path / 'direct'}"]))
    m = tload_ply(str(final))
    np.testing.assert_array_equal(m.vertices, direct["final"].vertices)
    np.testing.assert_array_equal(m.faces, direct["final"].faces)


# ---------------------------------------------------------------------------
# run_rgbd_integration and demo
# ---------------------------------------------------------------------------

def test_run_rgbd_integration_like_jax(tmp_path):
    ovr = ["dataset.img_res=[60,80]", "dataset.num_images=4",
           "model.tsdf_voxel_size=0.05"]
    assert jrgbd.main(ovr + [f"output_dir={tmp_path / 'jax'}"]) == 0
    assert trgbd.main(ovr + ["device_type=cpu",
                             f"output_dir={tmp_path / 'port'}"]) == 0
    name = "rgbd_integration/synthetic_demo_tsdf.ply"
    a = tload_ply(str(tmp_path / "port" / name))
    b = jload_ply(str(tmp_path / "jax" / name))
    assert len(a.faces) == len(b.faces) > 100
    np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_allclose(a.vertices, b.vertices, atol=VERT_ATOL)


def test_demo_writes_its_files(tmp_path):
    out = str(tmp_path / "demo")
    assert tdemo.main(["--out", out, "--frames", "4", "--res", "60", "80",
                       "--voxel", "0.08", "--optim_iters", "2",
                       "device_type=cpu", "dataset.num_pixels=200",
                       "model.train_ray_splits=100", "model.min_pts_in_grid=0",
                       "model.table_capacity=65536"]) == 0
    for f in ("gt.png", "before_optim.png", "final.png", "metrics.json"):
        assert os.path.getsize(os.path.join(out, f)) > 0
    img = cv2.imread(os.path.join(out, "gt.png"))
    assert img.shape == (360, 480, 3) and img.std() > 1.0
    metrics = json.load(open(os.path.join(out, "metrics.json")))
    assert set(metrics) <= {"before_optim", "final"}
