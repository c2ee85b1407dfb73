"""Online end-to-end reconstruction entry point.

Counterpart of bnv_fusion_tpu/run_e2e.py:33-176:

    python -m bnv_fusion_tpu_torch.run_e2e dataset=synthetic_demo \\
        model.integrate_batch_size=16 model.use_fused_decode_kernel=true

Streams posed depth frames through local fusion (K frames per table update
when ``model.integrate_batch_size`` > 1); with ``model.mode=demo`` every
``model.optim_interval`` frames it optimizes over the latest frames and
refreshes an incremental mesh (``{frame}.ply``, published to the live viewer
when ``trainer.live_viewer_port`` is set).  Then it meshes the map
(``before_optim.ply``),
runs the global render-loss optimization, meshes again (``final.ply``),
saves the map and prints the phase speeds and the F-scores against the
analytic scene, in the JAX package's format.  On N devices, one process
each (rank 0 writes the outputs), data parallel or region-sharded:

    torchrun --nproc_per_node=N -m bnv_fusion_tpu_torch.run_e2e \\
        trainer.fuse_devices=all trainer.optimize_devices=all
    torchrun --nproc_per_node=N -m bnv_fusion_tpu_torch.run_e2e \\
        model.table_layout=spatial trainer.fuse_devices=all
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from bnv_fusion_tpu_torch import evaluation
from bnv_fusion_tpu_torch import mesh as mesh_mod
from bnv_fusion_tpu_torch.config import load_config
from bnv_fusion_tpu_torch.parallel import launch
from bnv_fusion_tpu_torch.pipeline import NeuralMap

log = logging.getLogger(__name__)


def load_params(cfg):
    """Weights (``trainer.checkpoint``): a reference .ckpt (either format)
    or this framework's .npz; without one, the seeded ``init_model``
    weights."""
    ckpt = getattr(cfg.trainer, "checkpoint", None)
    if ckpt:
        log.info(f"loading pretrained weights from {ckpt}")
        from bnv_fusion_tpu_torch import checkpoint

        if str(ckpt).endswith(".npz"):
            state = checkpoint.load_state(ckpt)
            return state.get("params", state)
        return checkpoint.load_pretrained(ckpt)
    log.warning("no trainer.checkpoint given — using random weights")
    from bnv_fusion_tpu_torch.nn import init_model

    return init_model(0)


def run(overrides: List[str], params: Optional[Dict[str, Any]] = None
        ) -> Dict[str, Any]:
    """The whole main path; returns the map, the meshes, the F-scores, the
    working directory and, in demo mode, one record per event for callers
    that check them.  Under torchrun (WORLD_SIZE above 1) every rank fuses
    and optimizes its replica of the map through the DP paths of
    ``trainer.fuse_devices`` / ``optimize_devices``; rank 0 alone meshes,
    evaluates, saves, logs and writes, and the others meet it at a barrier
    before they return (``parallel.launch.distributed``).  Under
    ``model.table_layout=spatial`` each rank holds one slab of the map, so
    every rank meshes and saves with rank 0 (those are collectives), and
    rank 0 alone writes, logs and evaluates."""
    cfg = load_config(overrides)
    with launch.distributed(getattr(cfg, "device_type", "tpu")):
        return _run(cfg, params)


def _run(cfg, params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    from bnv_fusion_tpu_torch.datasets import get_dataset  # registers readers

    main = launch.is_main_process()
    dataset = get_dataset(cfg, "val")
    if params is None:
        params = load_params(cfg)
    scan_id = cfg.dataset.scan_id.split("/")[-1]
    working_dir = os.path.join(cfg.output_dir, "run_e2e", scan_id)
    if main:
        os.makedirs(working_dir, exist_ok=True)

    nmap = NeuralMap(dataset.dimensions, cfg, params, working_dir)
    # the ranks that mesh and save: rank 0, or every rank of a spatial map
    meshes = main or nmap.mesh_is_collective
    demo_mode = str(cfg.model.mode) == "demo"
    optim_interval = int(getattr(cfg.model, "optim_interval", 100))
    skip = int(getattr(cfg.dataset, "skip_images", 1)) or 1
    batch_k = int(getattr(cfg.model, "integrate_batch_size", 1))
    pending = []
    events: List[Dict[str, Any]] = []

    # live monitoring (the reference's optional pangolin window): an HTTP
    # page with the latest event mesh
    viewer = None
    viewer_port = int(getattr(cfg.trainer, "live_viewer_port", 0) or 0)
    if viewer_port and main:
        from bnv_fusion_tpu_torch.utils.live_viewer import LiveViewer

        viewer = LiveViewer(port=viewer_port)
        log.info(f"live viewer at http://127.0.0.1:{viewer.port}/")
    try:
        log.info(f"fusing {len(dataset)} frames (scan {cfg.dataset.scan_id})")
        for idx in range(len(dataset)):
            frame = dataset[idx]
            event = demo_mode and idx % optim_interval == 0
            nmap.timer.start("local")
            if batch_k > 1:
                # in demo mode the table is final at every event frame, so
                # pending frames flush there too
                pending.append(frame)
                if (len(pending) == batch_k or idx == len(dataset) - 1
                        or event):
                    if len(pending) == 1:
                        nmap.integrate(pending[0])
                    else:
                        nmap.integrate_batch(pending)
                    pending = []
            else:
                nmap.integrate(frame)
            nmap.timer.log("local")
            if event and nmap.frames:
                events.append(_demo_event(nmap, idx, optim_interval, skip,
                                          working_dir, viewer, main,
                                          meshes))
    finally:
        if viewer is not None:
            viewer.close()

    # read the lagged overflow copies still queued (auto widths), then
    # surface width misfits instead of dropping voxels silently
    nmap._note_overflow(flush=True)
    if nmap.overflow > 0:
        log.warning(
            f"table overflow = {nmap.overflow}: the compaction widths "
            f"(model.max_unique_per_frame / max_unique_cells_per_frame) "
            f"dropped observations — widen them or set them to 'auto'")

    nmap.timer.start("mesh")
    before = nmap.extract_mesh() if meshes else None
    nmap.timer.log("mesh")
    if before is not None and main:
        mesh_mod.save_ply(os.path.join(working_dir, "before_optim.ply"), before)
        log.info(f"before_optim mesh: {len(before.vertices)} verts")

    # reference formula: n_frames * skip, doubled outside demo mode;
    # trainer.global_steps > 0 overrides it
    global_steps = int(getattr(cfg.trainer, "global_steps", 0) or 0)
    if global_steps <= 0:
        global_steps = int(len(nmap.frames) * skip)
        if not demo_mode:
            global_steps *= 2
    nmap.timer.start("global")
    nmap.optimize(n_iters=global_steps, last_frame=-1)
    nmap.timer.log("global")
    if not main:
        if meshes:      # the spatial map's collective mesh and save
            nmap.extract_mesh()
            nmap.save(os.path.join(working_dir, "final"))
        return {"nmap": nmap, "before_optim": None, "final": None,
                "fscores": {}, "working_dir": working_dir,
                "global_steps": global_steps, "events": events}

    for phase in ("local", "global"):
        t = nmap.timer.times[phase]
        fps = global_steps / t if t > 0 else float("inf")
        # the reference's printout divides global_steps by both phases' times
        print(f"speed on {phase} fusion: {fps:.2f} fps")
    t_local = nmap.timer.times["local"]
    if t_local > 0:
        print(f"local fusion throughput: "
              f"{len(nmap.frames) / t_local:.2f} frames/s "
              f"({len(nmap.frames)} frames, compile included)")

    nmap.timer.start("mesh")
    final = nmap.extract_mesh()
    if final is not None and bool(getattr(cfg.trainer, "post_process", True)):
        final = mesh_mod.post_process_mesh(
            final, vertex_threshold=nmap.voxel_size / 4)
    nmap.timer.log("mesh")
    if final is not None:
        mesh_mod.save_ply(os.path.join(working_dir, "final.ply"), final)
        log.info(f"final mesh: {len(final.vertices)} verts -> "
                 f"{working_dir}/final.ply")
    nmap.save(os.path.join(working_dir, "final"))

    fscores = {}
    if final is not None and _area(final) <= 0:
        print("F-score: the final mesh has no surface area")
    elif final is not None and hasattr(dataset, "gt_observed_points"):
        pred = mesh_mod.sample_surface(final, 100000, 0)
        gt = dataset.gt_observed_points(100000)
        for t in (0.025, 0.01):
            res = evaluation.fscore_points(pred, gt, t)
            fscores[t] = res
            print(f"F-score @{t}: {res['fscore']:.4f} "
                  f"(precision {res['precision']:.4f}, "
                  f"recall {res['recall']:.4f})")
    return {"nmap": nmap, "before_optim": before, "final": final,
            "fscores": fscores, "working_dir": working_dir,
            "global_steps": global_steps, "events": events}


def _demo_event(nmap: NeuralMap, idx: int, optim_interval: int, skip: int,
                working_dir: str, viewer, main: bool = True,
                meshes: bool = True) -> Dict[str, Any]:
    """One demo-mode event at frame ``idx``: optimize over the last
    ``optim_interval`` frames, refresh the incremental mesh, write
    ``{idx}.ply`` and publish it (the mesh on the ``meshes`` ranks, the
    file and the viewer on rank 0 only).  Returns the event's record."""
    last = max(0, len(nmap.frames) - optim_interval)
    n_iters = min(len(nmap.frames), optim_interval) * skip
    tm = nmap.timer.times
    t_opt, t_mesh = tm["global"], tm["inc_mesh"]
    nmap.timer.start("global")
    nmap.optimize(n_iters=n_iters, last_frame=last)
    nmap.timer.log("global")
    if meshes:
        nmap.timer.start("inc_mesh")
        m = nmap.extract_mesh_incremental()
        nmap.timer.log("inc_mesh")
    if not main:
        return {"frame": idx, "optimize_iters": n_iters,
                "optimize_s": tm["global"] - t_opt}
    st = nmap.inc_mesher.last_stats
    rec = {"frame": idx, "optimize_iters": n_iters,
           "optimize_s": tm["global"] - t_opt,
           "mesh_s": tm["inc_mesh"] - t_mesh,
           "redecoded": st["redecoded"], "eligible": st["eligible"],
           "vertices": 0 if m is None else len(m.vertices)}
    if m is not None:
        mesh_mod.save_ply(os.path.join(working_dir, f"{idx}.ply"), m)
        if viewer is not None:
            viewer.publish(m, status={
                "frames": idx + 1, "local_s": round(tm["local"], 2),
                "global_s": round(tm["global"], 2)})
    log.info(f"event at frame {idx}: optimize {n_iters} iters "
             f"{rec['optimize_s']:.2f} s, incremental mesh "
             f"{rec['mesh_s']:.2f} s ({rec['redecoded']} of "
             f"{rec['eligible']} voxels re-decoded), {rec['vertices']} verts")
    return rec


def _area(m: mesh_mod.Mesh) -> float:
    v, f = m.vertices, m.faces
    return float(0.5 * np.linalg.norm(
        np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]),
        axis=-1).sum()) if len(f) else 0.0


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    run(list(argv if argv is not None else sys.argv[1:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
