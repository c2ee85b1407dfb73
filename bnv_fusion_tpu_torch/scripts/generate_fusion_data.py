"""Dataset preprocessors: raw captures -> the canonical preprocessed layout.

Counterpart of bnv_fusion_tpu/scripts/generate_fusion_data.py:33-198: one
CLI for the reference's four converters (scene3d, icl_nuim, scannet,
arkit), its images read and written by ``utils.image_io`` in place of cv2
(``.jpg`` colour copied byte for byte, other colour re-encoded as JPEG at
quality 95, 16-bit depth PNGs).  Output layout (what
FusionInferenceDataset reads): ``{out}/{scan}/image/{i}.jpg, depth/{i}.png
(mm uint16), pose/T_wc_{i}.txt, pose/intr_mat_{i}.txt, pose/dimensions.txt``
with poses recentred so the GT-mesh AABB midpoint is the origin.

    python -m bnv_fusion_tpu_torch.scripts.generate_fusion_data scene3d \\
        --root data/scene3d --out data/fusion/scene3d --seqs lounge copyroom
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

from bnv_fusion_tpu_torch.mesh import load_ply
from bnv_fusion_tpu_torch.utils import image_io
from bnv_fusion_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

SCENE3D_INTR = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
ICL_INTR = np.array([[481.2, 0, 319.5], [0, -480.0, 239.5], [0, 0, 1]])


def read_cam_traj(path: str):
    """Scene3D/ICL `.log` trajectory: blocks of [header, 4x4 matrix rows]."""
    with open(path, "r") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    T_wcs = []
    i = 0
    while i < len(lines):
        i += 1  # header line
        rows = []
        for r in range(4):
            parts = [p for p in lines[i + r].replace("\t", " ").split(" ")
                     if p]
            rows.append([float(p) for p in parts])
        i += 4
        T_wcs.append(np.asarray(rows, np.float32))
    return T_wcs


def write_canonical(out_dir: str, frames, dimensions: np.ndarray):
    """frames: iterable of (rgb_path_or_None, depth_mm uint16, T_wc, intr)."""
    for sub in ("image", "depth", "pose"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    with open(os.path.join(out_dir, "pose", "dimensions.txt"), "w") as f:
        f.write(" ".join(str(float(d)) for d in dimensions))
    for i, (rgb_path, depth_mm, T_wc, intr) in enumerate(frames):
        if rgb_path and os.path.exists(rgb_path):
            dst = os.path.join(out_dir, "image", f"{i}.jpg")
            if rgb_path.endswith(".jpg"):
                shutil.copy(rgb_path, dst)
            else:
                image_io.write_jpeg(dst, image_io.read_image(rgb_path))
        else:
            image_io.write_jpeg(os.path.join(out_dir, "image", f"{i}.jpg"),
                                np.zeros((depth_mm.shape[0],
                                          depth_mm.shape[1], 3), np.uint8))
        image_io.write_png(os.path.join(out_dir, "depth", f"{i}.png"),
                           depth_mm.astype(np.uint16))
        np.savetxt(os.path.join(out_dir, "pose", f"T_wc_{i}.txt"),
                   T_wc.reshape(1, -1), fmt="%.9f")
        np.savetxt(os.path.join(out_dir, "pose", f"intr_mat_{i}.txt"),
                   np.asarray(intr).reshape(1, -1), fmt="%.9f")


def recenter_from_mesh(mesh_path: str):
    gt = load_ply(mesh_path)
    max_pts, min_pts = gt.vertices.max(0), gt.vertices.min(0)
    dims = max_pts - min_pts
    recenter = np.eye(4, dtype=np.float32)
    recenter[:3, 3] = -(min_pts + max_pts) / 2
    return recenter, dims


def convert_scene3d(root: str, out: str, seqs):
    for name in seqs:
        recenter, dims = recenter_from_mesh(
            os.path.join(root, name, f"{name}.ply"))
        rgb_dir = os.path.join(root, name, f"{name}_png", "color")
        depth_dir = os.path.join(root, name, f"{name}_png", "depth")
        traj = read_cam_traj(
            os.path.join(root, name, f"{name}_trajectory.log"))

        def frames():
            for i in range(len(traj)):
                depth = image_io.read_png(
                    os.path.join(depth_dir, f"{i:06d}.png"))
                yield (os.path.join(rgb_dir, f"{i:06d}.png"), depth,
                       recenter @ traj[i], SCENE3D_INTR)

        write_canonical(os.path.join(out, name), frames(), dims)
        log.info(f"scene3d/{name}: {len(traj)} frames")


def convert_icl_nuim(root: str, out: str, seqs):
    for name in seqs:
        recenter, dims = recenter_from_mesh(
            os.path.join(root, name, f"{name}.ply"))
        traj = read_cam_traj(os.path.join(root, name, f"{name}.log"))
        depth_dir = os.path.join(root, name, "depth")
        rgb_dir = os.path.join(root, name, "rgb")

        def frames():
            for i in range(len(traj)):
                depth = image_io.read_png(os.path.join(depth_dir, f"{i}.png"))
                yield (os.path.join(rgb_dir, f"{i}.png"), depth,
                       recenter @ traj[i], ICL_INTR)

        write_canonical(os.path.join(out, name), frames(), dims)
        log.info(f"icl_nuim/{name}: {len(traj)} frames")


def convert_scannet(root: str, out: str, seqs):
    from bnv_fusion_tpu_torch.datasets.scannet import (read_matrix,
                                                       read_meta_axis_align)

    for name in seqs:
        scan_dir = os.path.join(root, name)
        axis_align = read_meta_axis_align(
            os.path.join(scan_dir, f"{name}.txt"))
        gt = load_ply(os.path.join(scan_dir, f"{name}_vh_clean_2.ply"))
        verts = gt.vertices @ axis_align[:3, :3].T + axis_align[:3, 3]
        dims = verts.max(0) - verts.min(0)
        recenter = np.eye(4, dtype=np.float32)
        recenter[:3, 3] = -(verts.min(0) + verts.max(0)) / 2
        align = recenter @ axis_align
        frame_dir = os.path.join(scan_dir, "frames")
        n = len(os.listdir(os.path.join(frame_dir, "color")))
        intr = read_matrix(os.path.join(
            frame_dir, "intrinsic", "intrinsic_depth.txt"))[:3, :3]

        def frames():
            for i in range(n):
                depth = image_io.read_png(
                    os.path.join(frame_dir, "depth", f"{i}.png"))
                T_cw = read_matrix(
                    os.path.join(frame_dir, "pose", f"{i}.txt"))
                yield (os.path.join(frame_dir, "color", f"{i}.jpg"), depth,
                       align @ np.linalg.inv(T_cw), intr)

        write_canonical(os.path.join(out, name), frames(), dims)
        log.info(f"scannet/{name}: {n} frames")


def convert_arkit(root: str, out: str, seqs):
    from bnv_fusion_tpu_torch.config import config_from_dict
    from bnv_fusion_tpu_torch.datasets.arkit import FusionInferenceDatasetARKit

    for name in seqs:
        cfg = config_from_dict({
            "dataset": {"data_dir": root, "scan_id": name, "skip_images": 1,
                        "confidence_level": 2, "downsample_scale": 0.0},
            "model": {"ray_tracer": {"ray_max_dist": 100.0}},
        })
        ds = FusionInferenceDatasetARKit(cfg, "val")

        def frames():
            for i in range(len(ds)):
                f = ds[i]
                yield (None, (f["depth"] * 1000).astype(np.uint16),
                       f["T_wc"], f["intr_mat"])

        write_canonical(os.path.join(out, name), frames(), ds.dimensions)
        log.info(f"arkit/{name}: {len(ds)} frames")


CONVERTERS = {
    "scene3d": convert_scene3d,
    "icl_nuim": convert_icl_nuim,
    "scannet": convert_scannet,
    "arkit": convert_arkit,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=sorted(CONVERTERS))
    ap.add_argument("--root", required=True, help="raw dataset root")
    ap.add_argument("--out", required=True, help="canonical output root")
    ap.add_argument("--seqs", nargs="+", required=True)
    args = ap.parse_args(argv)
    CONVERTERS[args.kind](args.root, args.out, args.seqs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
