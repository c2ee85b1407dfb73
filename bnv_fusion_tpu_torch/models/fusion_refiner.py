"""Global refinement as offline training over a saved sparse volume.

Counterpart of bnv_fusion_tpu/models/fusion_refiner.py:32-127: load a fused
sparse volume (the hand-off from ``test.py``) and an optional metric TSDF
prior ``.npy`` (resampled trilinearly when its grid differs from the
volume's, onto the dense grid of either prior layout) or, with
``model.prior_from_noisy_depth``, a prior accumulated from noise-degraded
depth; keep the decoder weights fixed and optimize the
latents with the pipeline's render loss over the dataset's frames; export a
mesh per epoch and save the refined map.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from bnv_fusion_tpu_torch import mesh as mesh_mod
from bnv_fusion_tpu_torch import tsdf as tsdf_mod
from bnv_fusion_tpu_torch import voxel as vx
from bnv_fusion_tpu_torch.models.registry import register
from bnv_fusion_tpu_torch.parallel.launch import is_main_process
from bnv_fusion_tpu_torch.pipeline import NeuralMap
from bnv_fusion_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@register("lit_fusion_refiner")
class FusionRefiner:
    def __init__(self, cfg, params: Dict[str, Any]):
        self.cfg = cfg
        self.params = params

    def run(self, dataset, working_dir: str, n_epochs: int = 1,
            iters_per_epoch: int | None = None) -> mesh_mod.Mesh | None:
        cfg = self.cfg
        nmap = NeuralMap(dataset.dimensions, cfg, self.params, working_dir)
        self.nmap = nmap

        vol_path = getattr(cfg.model, "sparse_volume_path", None)
        if vol_path:
            log.info(f"loading sparse volume {vol_path}")
            nmap.load_volume(vol_path)
        tsdf_path = getattr(cfg.model, "tsdf_prior_path", None)
        metric = None
        if not tsdf_path and bool(getattr(cfg.model,
                                          "prior_from_noisy_depth", False)):
            # the reference's training data builds its prior this way: TSDFs
            # of noise-degraded depth accumulated over the sequence at the
            # model voxel size, then resampled like a loaded .npy
            log.info("accumulating noisy-depth tsdf prior from the dataset")
            from bnv_fusion_tpu_torch import geometry

            sim = geometry.DepthNoiseSimulator(
                seed=int(getattr(cfg.trainer, "seed", 0)))
            mn, _, n_xyz = vx.get_world_range(dataset.dimensions,
                                              nmap.voxel_size)
            frames = [dataset[i] for i in range(len(dataset))]
            sdf, _ = tsdf_mod.accumulate_tsdf_window(
                [sim.simulate(np.asarray(f["depth"], np.float32))
                 for f in frames],
                [f["T_wc"] for f in frames],
                [f["intr_mat"] for f in frames],
                mn, tuple(int(x) for x in n_xyz), nmap.voxel_size,
                device=nmap.device)
            metric = sdf.cpu().numpy()
        if tsdf_path:
            log.info(f"loading tsdf prior {tsdf_path}")
            metric = np.load(tsdf_path)
        if metric is not None:
            # the prior's dense grid, also on a block-major volume (the JAX
            # package takes that volume's [n_blocks, 64] brick shape here,
            # ROADMAP Queue 3); set_tsdf_prior stores it block-major
            dst_shape = nmap.prior_shape()
            if metric.shape != dst_shape:
                # trilinear resize with align_corners=True: source index =
                # destination index * (S - 1) / (D - 1) per axis
                log.info(f"resampling tsdf prior {metric.shape} -> "
                         f"{dst_shape}")
                src_per_dst = (
                    (np.asarray(metric.shape, np.float64) - 1.0)
                    / np.maximum(np.asarray(dst_shape, np.float64) - 1.0, 1.0))
                metric = vx.grid_transform(
                    torch.as_tensor(metric, dtype=torch.float32,
                                    device=nmap.device),
                    src_min=np.zeros(3, np.float32),
                    src_voxel=np.ones(3, np.float32),
                    dst_min=np.zeros(3, np.float32),
                    dst_voxel=src_per_dst.astype(np.float32),
                    dst_shape=dst_shape).cpu().numpy()
            nmap.set_tsdf_prior(metric)

        # the dataset's frames are the optimization ray pool
        for i in range(len(dataset)):
            f = dataset[i]
            nmap.frames.append({
                "depth": nmap._tensor(f["depth"]),
                "T_wc": nmap._tensor(f["T_wc"]),
                "intr": nmap._tensor(f["intr_mat"]),
                "frame_id": f.get("frame_id"),
            })

        iters = iters_per_epoch or len(nmap.frames)
        mesh = None
        # under a process group every rank optimizes its replica
        # (trainer.optimize_devices); rank 0 alone meshes and writes, but
        # every rank of a spatial map meshes and saves (collectives)
        main = is_main_process()
        meshes = main or nmap.mesh_is_collective
        if main:
            os.makedirs(working_dir, exist_ok=True)
        # the reference refiner sweeps every frame once per epoch in order;
        # "random" takes the online loop's i.i.d. draws instead
        order = str(getattr(cfg.model, "refine_frame_order", "epoch"))
        for epoch in range(n_epochs):
            nmap.optimize(n_iters=iters, last_frame=-1,
                          lr=float(cfg.optimizer.lr.initial),
                          frame_order=order)
            if not meshes:
                continue
            mesh = nmap.extract_mesh()
            if mesh is not None and main:
                out = os.path.join(working_dir, f"refined_{epoch}.ply")
                mesh_mod.save_ply(out, mesh)
                log.info(f"epoch {epoch}: exported {out} "
                         f"({len(mesh.vertices)} verts)")
        if meshes:
            nmap.save(os.path.join(working_dir, "refined"))
        return mesh if main else None
