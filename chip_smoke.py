#!/usr/bin/env python3
"""Smoke test of the PyTorch port (bnv_fusion_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from bnv_fusion_tpu_torch/csrc (one nvcc per
     source, started together);
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes and at edge cases, and time both (CUDA events,
     median after warm-up);
  4. run the main path, bnv_fusion_tpu_torch.run_e2e, at bench.py's
     operating point (voxel 0.01, 480x640, 48 frames, K=16 frames per table
     update, fused mesh decode, 64 optimization steps) on seeded random
     weights; the kernels' launch counts are zeroed just before and read
     just after;
  5. check the outputs: seg_reduce_sorted, fused_corner_decode and
     fused_encode launched, no overflow, finite losses,
     a non-empty binary final.ply, the saved map, and one K-batch fused
     through the kernel equal to the same batch through the plain
     seg-reduce (tables compared by voxel key);
  5a. options: run_e2e at the same point with dataset.load_color,
     model.fuse_color, trainer.optim_early_stop, model.optim_dtype=bfloat16
     and model.error_guided_sampling (launch counts zeroed just before, read
     just after): both kernels launched, no overflow, finite losses, the
     iterations run at most the ceiling and either it or a multiple of the
     launch group, one loss per iteration, a non-empty binary final.ply with
     uchar red/green/blue vertex colours that are not constant; then on the
     card: early stop at lr=0 and patience 2 stops at 4 groups (one frame,
     tests/test_optim_schedule.py's case); one optimize step in float32 and
     in bfloat16 on the same pixels and uniforms within OPTIM_DTYPE_RTOL,
     the bf16 step against the same step of the plain port on the CPU
     (loss within OPTIM_CPU_RTOL, first moments as often close as the f32
     step's, within OPTIM_CPU_MU_SLACK), 16 steps each way timed;
     decode_points rows, fm and fused on 2^18 points drawn from the final
     map's mesh lattice (fm within FM_ATOL of rows, the fused decode within
     DECODE_ATOL, each timed) and extract_mesh with mesh_decode_layout=fm
     against rows, kernel off (counts within MESH_COUNT_RTOL); sdf_gradient
     at up to 2^16 final-mesh vertices with the mesh's prior (finite, unit
     norm within 1e-3 where every corner has weight, and within
     SDF_GRAD_FD_RTOL of a float64 forward difference of the plain decode
     on SDF_GRAD_FD_SHARE of the unmasked points);
  5b. demo: run_e2e with model.mode=demo at profiling/bench_demo.py's
     operating point (voxel 0.01, 480x640, 48 frames, uint16 depth staging,
     max_unique_per_frame=116736, optim_interval=16, K=16, fused decode,
     the config's trainer.global_steps=0): events at frames 0, 16 and 32,
     each an optimize over the last 16 frames and an incremental mesh.
     Checked: non-empty binary 16.ply and 32.ply (after one frame no
     voxel has the weight model.min_pts_in_grid asks for, so the event at
     frame 0 meshes nothing and, as in the JAX package, writes no 0.ply:
     checked too), 48 final steps
     (the demo formula, not doubled), finite losses, no overflow, both
     kernels launched (counts zeroed just before, read just after), and
     the cache after one more incremental mesh on the post-optimize state
     equal to one update of a fresh IncrementalMesher: the same welded face
     and vertex counts and the same triangles (sorted, rounded to 1e-5 m);
     the same again after a partial update (a slab of latents and a box of
     the prior moved, so only their neighbourhoods re-decode).
     One line per event: optimize iterations and seconds, incremental-mesh
     seconds, re-decoded of eligible voxels, vertices;
  6. fused_mlp: FusedMLP (the kernel's public API) driven once on the
     encoder and decoder weights, then held against the plain mlp_apply at
     the encoder's M = 480*640*8 rows (profiling/profile_fused_mlp.py's
     shape) and the decoder's M = 2^18*8, both timed, at a ragged M and a
     batched [7, 11, 6] input, and at the tensor-core tile's edge cases:
     (din, dout) = (1, 1), (32, 16), (9, 2), (12, 9), M = 0, 5 and
     16k + 3, a view whose base is not 16-byte aligned, and two launches
     that must give identical bits;
  7. pretrain: bnv_fusion_tpu_torch.train on synthetic patches at the full
     model width (batch 32, 64 points, 256 queries, 32 steps): finite step
     losses, a falling loss, loadable last.npz / best.npz;
  8. offline: bnv_fusion_tpu_torch.test (frame-by-frame fusion) at bench.py's
     operating point, then the refiner (train.py model=fusion_refiner_model)
     on the saved map and prior with the fused mesh decode: the loaded table
     equals the saved one by voxel key, 48 finite losses, a non-empty
     binary refined_0.ply, the saved refined map, no overflow, and
     fused_corner_decode launched;
  8a. datasets: the real-data path on synthetic content written in the
     real layouts at 480x640.  A Scene3D capture (48 frames rendered with
     the converter's fixed camera, uint16 depth PNGs, colour PNGs, the
     trajectory .log, a GT .ply whose AABB is the scene's bounds) through
     generate_fusion_data scene3d, read back by fusion_inference_dataset:
     depth bit-exact, T_wc and intr_mat within 1e-6, dimensions == the
     bounds (the recentring is the identity), colour PSNR >= COLOR_PSNR_DB.
     The e2e phase's own frames in the canonical layout (write_canonical,
     JPEG colour) through run_inference scene3d --mode e2e with the e2e
     phase's overrides, its seeded weights as an .npz --checkpoint and
     model.fuse_color (colour only through img_path; counts zeroed just
     before, read just after): both kernels launched, no overflow, finite
     losses, a coloured final.ply equal to the e2e phase's where the poses
     come back bit-equal, else within MESH_VERTEX_RTOL vertices and
     F@1 cm >= MESH_F1_MIN both ways.  A ScanNet capture (24 frames,
     1296x968 JPEG colour, a rotated axisAlignment) through run_inference
     scannet --mode fuse_refine: fused_corner_decode launched, finite
     refiner losses, a non-empty refined_0.ply; generate_fusion_data
     scannet and one frame read with load_color: 480x640 colour.  Then
     evaluate_bnvf, compute_chamfer, run_rgbd_integration and scripts.demo
     (480x640, 16 frames), and the codec's timings (information only).
     Last, the colour modes (image_modes_step): every committed fixture of
     tests/data/torch_image_modes decoded on the card's host to the
     digests in its digests.json (the port's decodes on the CPU), each
     progressive and arithmetic-coded (SOF9, SOF10) file equal to its
     Huffman baseline twin; run_inference scene3d --mode e2e with
     model.fuse_color and the fused decode on the e2e phase's frames,
     their img_paths pointing at the six 240x320 fixture frames in turn
     (progressive, EXIF orientation 6 stored 320x240, CMYK, baseline,
     arithmetic-coded progressive, and progressive cut to 4 of its 10
     scans, block-smoothed: decoded, oriented and area-enlarged onto the
     480x640 depth), and again at PNGs of the port's decodes of the same
     files:
     table keys, features, weights and hits equal bit for bit, the colour
     prior too, seg_reduce_sorted and fused_corner_decode launched in each
     (counts zeroed just before, read just after).  Cut to the first
     MODES_FRAMES = 16 frames (one K=16 batch) and MODES_STEPS = 4 optimize
     steps.  One line each with the card's name and power limit: the
     progressive and baseline decode ms per 240x320 frame, the SOF9 and
     SOF10 decode ms, the block-smoothed decode ms beside its complete
     file's, the EXIF orientation ms and the 240x320 -> 480x640
     area-enlarge ms (host times);
  9. fuse: local fusion at bench.py's operating point (phase_fuse):
     throughput through integrate_batches, best of 3 passes, and its table
     equal to sequential integrate_batch calls' bit for bit; auto
     compaction widths against the explicit ones, and an undersized
     width_margin that overflows and widens; each fuse option
     (fuse_sort1_gather, fuse_front_chunks, fuse_dtype=bfloat16,
     fuse_batch_merge=false, fuse_algorithm=corner) against the default
     fuse of one K=16 batch, with its seg-reduce launches and peak device
     memory, the per-frame routes also through a float64-cumsum copy, and
     K=32 in 2 front chunks; fused_encode launched once per K=16 update
     and per front chunk of the K-merged front (float32 and bfloat16),
     never on the per-frame fronts;
     the stage-1 sort's two formulations timed;
 10. bigscene: profiling/profile_bigscene.py's 14 x 14 x 4 m scene at
     voxel 0.01 (790.2M voxels): the e2e phase's 48 frames written in the
     canonical layout with those dimensions, through run_inference scene3d
     --mode e2e at the e2e phase's overrides (counts zeroed just before,
     read just after): the table routed to BlockIndexedTable and the prior
     to TSDFVolumeBM, seg_reduce_sorted launched twice per K-batch and
     fused_corner_decode at least once, table and prior overflow 0, finite
     losses, a non-empty binary final.ply.  Then at that size: the run's
     first K=16 batch through the merged fuse into a block table and into
     a dense table of the same grid (a 3.2 GB slot map), equal by key bit
     for bit; the run's prior frames through integrate_blocks and the
     dense windowed integrate, within BIG_PRIOR_ATOL on all but
     BIG_EDGE_SHARE of the voxels (integrate_blocks timed, its active
     blocks counted); the hash table at profiling/probe_hash_table.py's
     point (2^17 keys, 2^19 slots) equal to the CPU port's slot for slot
     with both probe strategies, timed, with its probe rounds; one frame
     fused into a 2^21-slot hash table against the dense table's kernel
     front within HASH_FUSE_ATOL by key.
 11. parallel: the data-parallel layer (bnv_fusion_tpu_torch.parallel) at
     world size 1 under NCCL on cuda:0 (parallel.launch.initialize over
     tcp://127.0.0.1 with the card's device_id; one card takes no second
     NCCL rank): the e2e phase's 48 frames at bench.py's point fused
     through make_sharded_fuse_frame and, frame by frame, through
     fusion.fuse_frame_cellsort (test.py's route): tables equal by voxel key
     bit for bit; the DP-built map meshed by NeuralMap.extract_mesh
     (fused_corner_decode launched, counts zeroed just before, read just
     after) to the single map's vertex and face counts; 16 iterations of
     make_sharded_optimize_iter against optimize.make_optimize_step on the
     same drawn pixels and uniforms, each from the same state (losses
     within PAR_LOSS_RTOL, bumped weights equal, gradient rows and latents
     as tests/test_torch_optimize.py holds them); one make_sharded_pretrain_step
     against the trainer's single step (tests/test_torch_pretrain.py's
     tolerances); run_e2e with model.table_layout=dense and
     trainer.fuse_devices / optimize_devices = all (the world size, 1): a
     non-empty final.ply.  One line each, with the card's name and power
     limit: DP and single per-frame fuse ms per frame (CUDA events,
     medians), DP and single optimize s/iter, elements all-gathered per
     frame.  The phase takes its process group down at the end.
 12. spatial: the region-sharded map (bnv_fusion_tpu_torch.parallel.spatial)
     at world size 1 under NCCL on cuda:0 (NeuralMap refuses
     model.table_layout=spatial below 2 devices, as the JAX package does,
     and one card takes one NCCL rank, so the phase gives a NeuralMap a
     SpatialTable, the state NeuralMap's spatial routing builds, and drives
     its spatial methods): the e2e phase's 48 frames at bench.py's point
     fused through make_spatial_fuse_frame and, frame by frame, through
     fusion.fuse_frame_cellsort: tables equal by voxel key bit for bit;
     the spatial map meshed by NeuralMap.extract_mesh (keys from
     spatial_active_entries, the decode on OwnerRows; fused_corner_decode
     launched, counts zeroed just before, read just after) to the single
     map's vertex and face counts; SP_OPT_ITERS iterations of
     optimize.make_optimize_step on OwnerRows against the plain step on the
     same drawn pixels and uniforms: losses equal, latents and bumped
     weights equal bit for bit (at world 1 every corner is owned, so the
     steps compute the same sums: tighter than tests/test_torch_optimize.py's
     tolerance); the map saved by NeuralMap.save and loaded into a fresh
     spatial map by NeuralMap.load_volume (load_spatial_entries): equal by
     key bit for bit.  One line each, with the card's name and power limit:
     spatial and single per-frame fuse ms per frame (CUDA events, medians),
     spatial and single optimize s/iter, spatial and single mesh s, the
     shard's bytes, elements all-reduced per optimize iteration and
     all-gathered per fuse frame.  The phase takes its process group down
     at the end.
The e2e phase also holds the final mesh's optimize-overlapped lattice
prefetch: a re-extraction through it launches the decode and equals the
in-line build (model.mesh_prefetch=false) bit for bit; both are timed,
then 10 pairs of optimize + final mesh with the prefetch off and on.
Each phase prints its wall time; the kernels line gives each kernel's
launches on its path, error, times and bound: the larger of the bytes the
function must move over 3.35 TB/s and its operations over the peak rate of
the units they run on (H100 SXM published peaks).  For seg_reduce_sorted
those are f32 adds at 67 TFLOP/s.  For fused_corner_decode, whose hidden
layers run on the tensor cores in 3xTF32, they are three TF32 products of
the hidden layers at 495 TFLOP/s (the 64->1 output layer and the blend at
67 TFLOP/s are ~1% of that); for fused_mlp, three TF32 products of every
layer on the tensor cores (all four; for dout = 1 the output layer stays
on FMAs); for fused_encode the same for the valid points' 8 corners (its
line also gives the work counted once, as benchmark/rooflines.py counts
it).  The bound of the same work on f32 FMAs alone is printed beside
fused_corner_decode's and fused_mlp's.
fused_encode is checked at the main path's front (K=16 x 307,200 points,
62% valid and sorted first, timed, and timed again all valid), at a
ragged N with a frame without a valid point, and for identical bits
over two launches; its bfloat16 variant (model.fuse_dtype=bfloat16) at
the main path's front against the plain bfloat16 encoder, within
ENC_BF16_TOL and on average within a hundredth of the bfloat16
operands' own effect, timed.
The seg-reduce checks include edge cases at the kernel's own tile
(tile_rows() rows): a segment over >= 3 tiles with a run of tiles without
an end, M not a multiple of the tile (with M % 4 != 0, the scalar-load
path, and M % 4 == 0), and two launches on the stage-1 inputs that must
give identical bits.
Weights: the port's seeded init_model.  The kernel checks draw its biases
from N(0, 0.1^2) (bias_std), since zero biases would hide a decode kernel
that dropped them or read them from the wrong offsets; the e2e run keeps
the default zero biases, which leave the untrained decoder's SDF enough
zero crossings for a sizeable mesh (random biases shift its sign).
The last line of standard output is the JSON result
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
VOXEL = 0.01          # bench.py's voxel size, shared by e2e and the checks

# bench.py's operating point (bench.py:59-84) + K=16 + the fused decode
E2E_OVERRIDES = [
    f"model.voxel_size={VOXEL}",
    "dataset.num_images=48",
    "dataset.img_res=[480,640]",
    "dataset.stage_raw_depth=true",
    "model.tsdf_every=4",
    "model.max_unique_per_frame=116736",
    "model.integrate_batch_size=16",
    "model.use_fused_decode_kernel=true",
    "trainer.global_steps=64",
]

# profiling/bench_demo.py's operating point (:54-64) without its preset:
# the demo step formula (48 final steps) runs at the config's
# trainer.global_steps=0
DEMO_OVERRIDES = [
    f"model.voxel_size={VOXEL}",
    "dataset.num_images=48",
    "dataset.img_res=[480,640]",
    "dataset.stage_raw_depth=true",
    "model.max_unique_per_frame=116736",
    "model.mode=demo",
    "model.optim_interval=16",
    "model.integrate_batch_size=16",
    "model.use_fused_decode_kernel=true",
]

# rtol/atol of the kernel checks: float segment sums are taken in another
# order than the plain version's (index_add, CUDA atomics in no fixed
# order), so the seg-reduce's bound scales with each segment's sum of
# |value|: relative to the sum itself, a 3132-term segment whose sum
# cancels failed the unchanged kernel in some runs; the decode's FMAs run in
# another order than cuBLAS's full-f32 products.  The decode's outputs are
# ~alpha * voxel_size, so its bound scales with the voxel size.
SEG_RTOL = SEG_ATOL = 1e-5
DECODE_ATOL = 1e-4 * VOXEL
BIAS_STD = 0.1
# fused_mlp: 3xTF32 products (each operand's hi/lo split drops ~2^-22 of
# it) summed in another order than cuBLAS's, on outputs of magnitude ~1-10
# (observed on the H100: max abs err up to 1.2e-5 over 2.4M rows; one TF32
# pass, modelled in numpy, would miss by ~6e-3)
MLP_ATOL = MLP_RTOL = 1e-4
ENC_ROWS = 480 * 640 * 8          # profiling/profile_fused_mlp.py:16
# fused_encode at the main path's front: K=16 frames of 480x640 points,
# the share inside the bounds that the benchmark's scene3d.stream frames
# give (its fuse.mfu, 0.62% of 9.09 ms a frame on an H100, counts 192k of
# 307,200 points), sorted first as the front's stage-1 sort leaves them
ENC_K, ENC_N, ENC_INSIDE = 16, 480 * 640, 0.62
# its bfloat16 variant against the plain bfloat16 encoder: a hidden
# activation's rounding flipped by one bfloat16 ulp through the later
# layers (tests/test_torch_fused_encode.py's BF16_TOL)
ENC_BF16_TOL = 2.0 ** -5
# the prefetch on/off measurement: pairs of run_e2e's optimize (64 steps,
# the fast_e2e budget) plus the final extract_mesh, in alternating order
PREFETCH_ITERS = 64
PREFETCH_PAIRS = 10
# the fuse routes on the per-frame cumsum front (fuse_batch_merge=false,
# fuse_algorithm=corner), against the kernel front with an exact-f32 stage 2
# (fuse_sort_bf16=false):
# - the route with its cumsum and the table's features in float64 (the
#   route's logic without the cumsum's rounding) within WITNESS_ATOL: the
#   kernel front's own f32 sums (1.7e-7 at 60x80 on the CPU);
# - the f32 route against that float64 copy: the mean-centered cumsum over
#   N = 307,200 rows (8N for the corner algorithm) cancels to 4.8e-3 (cell)
#   and 6.9e-3 (corner) at this point on the H100 (2.5e-4 and 1.2e-4 at
#   60x80 on the CPU; the JAX package's own test of that front allows 2e-3
#   at its size): CUMSUM_ATOL;
# - against the merged route on the same front only the running mean's
#   order of operations differs (4.8e-7 on the H100): ROUTE_ATOL
WITNESS_ATOL = 1e-4
CUMSUM_ATOL = 1e-2
ROUTE_ATOL = 1e-4
SORT_REPS = 20                    # timed stage-1 sorts per formulation
DEC_ROWS = (1 << 18) * 8          # one mesh-lattice batch, 8 corners each

# H100 SXM published peaks (NVIDIA datasheet): HBM, f32 FMA outside the
# tensor cores, dense TF32 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12

# the offline flow at bench.py's operating point (bench.py:59-84), frames
# fused one at a time (test.py), then refined with the fused mesh decode
OFFLINE_OVERRIDES = [
    f"model.voxel_size={VOXEL}",
    "dataset.num_images=48",
    "dataset.img_res=[480,640]",
    "model.max_unique_per_frame=116736",
    "model.use_fused_decode_kernel=true",
]
# the options run: the online point with every model and trainer option of
# the dense single-device path that changes what it computes (the decode
# layouts are held by check_decode_layouts: with the fused mesh decode on,
# mesh_decode_layout does not apply, as in the JAX package)
OPTIONS_OVERRIDES = E2E_OVERRIDES + [
    "dataset.load_color=true", "model.fuse_color=true",
    "trainer.optim_early_stop=true", "model.optim_dtype=bfloat16",
    "model.error_guided_sampling=true"]
# one optimize step's loss, bf16 against f32 operands (relative), and the
# steps timed each way
OPTIM_DTYPE_RTOL = 1e-3
OPTIM_DTYPE_ITERS = 16
# the card's bf16 step against the same step of the plain port on the CPU:
# loss (relative; 1.6e-7 measured), and the share of the Adam first
# moment's nonzero entries within OPTIM_CPU_MU_RTOL relative, which must be
# within OPTIM_CPU_MU_SLACK of the f32 step's share (the card's scatter
# sums rows in another order than the CPU's, and a sum that cancels keeps
# that error: 77.3% f32, 76.2% bf16 measured on the H100; a card decode
# with products rounded to bf16 or a layer left unrounded gave 36.5% and
# 41.2%, while its loss moved only 3.3e-7)
OPTIM_CPU_RTOL = 2e-6
OPTIM_CPU_MU_RTOL = 1e-3
OPTIM_CPU_MU_SLACK = 0.05
# decode_points fm against rows (tests/test_decode_fm.py's tolerance), and
# the fm mesh's face and vertex counts against the rows mesh's
FM_ATOL = 2e-5
MESH_COUNT_RTOL = 1e-3
SDF_GRAD_POINTS = 1 << 16
# sdf_gradient against a float64 forward difference of the plain rows
# decode (step in metres): the share of unmasked points within the relative
# tolerance (99.53% measured; median 2.2e-5, 99th percentile 1.5e-4)
SDF_GRAD_FD_STEP = 1e-7
SDF_GRAD_FD_RTOL = 1e-3
SDF_GRAD_FD_SHARE = 0.99
# the parallel phase: 16 ray-DP iterations against the single-device step
# (tests/test_torch_optimize.py's loss tolerance, par_optimize), the
# pretrain step at tests/test_torch_pretrain.py's tolerances
PAR_OPT_ITERS = 16
PAR_LOSS_RTOL = 1e-5
PAR_PRE_RTOL, PAR_PRE_ATOL = 1e-5, 2e-6
# the spatial phase: optimize iterations against the single-device step
SP_OPT_ITERS = 16
PRETRAIN_OVERRIDES = ["model=fusion_pointnet_model",
                      "dataset=synthetic_patches", "dataset.num_patches=1024",
                      "trainer.max_epochs=1"]


def table_on(table, device, features_dtype=None):
    """A copy of a dense table with its tensors on ``device`` (features in
    ``features_dtype`` when given)."""
    import copy
    import torch

    out = copy.copy(table)
    for k, v in vars(table).items():
        if isinstance(v, torch.Tensor):
            setattr(out, k, v.to(device))
    if features_dtype is not None:
        out.features = out.features.to(features_dtype)
    out.device = torch.device(device)
    return out


def tree_to(tree, **kw):
    """A nested dict of tensors moved by ``Tensor.to(**kw)``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, **kw) for k, v in tree.items()}
    return tree.to(**kw)


def close_share(got, want, rtol: float) -> float:
    """Share of the entries nonzero on either side with |got - want| <=
    rtol * |want| + 1e-6 * max|want|."""
    import numpy as np

    nz = (got != 0) | (want != 0)
    ok = np.abs(got - want) <= rtol * np.abs(want) + 1e-6 * np.abs(want).max()
    return float(ok[nz].mean()) if nz.any() else 1.0


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def bound(n_bytes: float, n_flops: float, n_tf32_flops: float = 0.0):
    """(least time in ms, what bounds it) for work that must move n_bytes,
    do n_flops f32 operations on the FMA units and n_tf32_flops on the
    tensor cores (the two kinds of unit run side by side)."""
    t_mem = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = max(n_flops / PEAK_F32_FLOPS, n_tf32_flops / PEAK_TF32_FLOPS) * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def sorted_stream(B, M, n_int, n_float, n_distinct, sent, two_keys, g,
                  frac_valid=0.8):
    """A key-sorted stream like the fuse path's: ~n_distinct segments per
    row over the first frac_valid of the rows, sentinel padding after, zero
    payload on the padding."""
    import torch

    dev = "cuda"
    nv = int(M * frac_valid)
    base = torch.randint(0, n_distinct, (B, nv), generator=g, device=dev)
    base = base * max(1, (sent - 1) // max(n_distinct, 1))
    if two_keys:
        sub = torch.randint(0, 8, (B, nv), generator=g, device=dev)
        comb = torch.sort(base * 8 + sub, dim=1).values
        base, sub = comb // 8, comb % 8
    else:
        base = torch.sort(base, dim=1).values
    keys = torch.full((B, M), sent, dtype=torch.int32, device=dev)
    keys[:, :nv] = base.to(torch.int32)
    keys2 = None
    if two_keys:
        keys2 = torch.zeros((B, M), dtype=torch.int32, device=dev)
        keys2[:, :nv] = sub.to(torch.int32)
    cnts = torch.zeros((B, n_int, M), dtype=torch.int32, device=dev)
    cnts[:, :, :nv] = torch.randint(0, 100, (B, n_int, nv), generator=g,
                                    device=dev, dtype=torch.int32)
    vals = torch.zeros((B, n_float, M), dtype=torch.float32, device=dev)
    vals[:, :, :nv] = torch.randn((B, n_float, nv), generator=g, device=dev)
    return keys, keys2, cnts, vals


def check_seg(name, keys, keys2, cnts, vals, u, sent, timed=False):
    """Kernel vs plain: keys, int sums and n_seg exact, floats within
    SEG_ATOL + SEG_RTOL x the segment's sum of |value| (a float sum's
    rounding error scales with its terms' magnitudes, not with the sum,
    which cancels on long segments).  Returns (max_abs_err, ms, plain_ms,
    bytes, flops):
    bytes = the inputs read once and the outputs written once, flops = one
    add per input channel value."""
    import torch
    from bnv_fusion_tpu_torch.kernels import (seg_reduce_sorted,
                                              seg_reduce_sorted_torch)

    k = seg_reduce_sorted(keys, cnts, vals, u, sent, keys2=keys2)
    p = seg_reduce_sorted_torch(keys, cnts, vals, u, sent, keys2=keys2)
    torch.cuda.synchronize()
    if not torch.equal(k[4], p[4]):
        raise AssertionError(f"{name}: n_seg differs")
    for i, what in ((0, "keys"), (1, "keys2"), (2, "int sums")):
        if p[i] is not None and not torch.equal(k[i], p[i]):
            raise AssertionError(f"{name}: {what} differ")
    mag = seg_reduce_sorted_torch(keys, cnts, vals.abs(), u, sent,
                                  keys2=keys2)[3]
    err = (k[3] - p[3]).abs()
    if bool((err > SEG_ATOL + SEG_RTOL * mag).any()):
        raise AssertionError(f"{name}: float sums differ, max {err.max():.3e}")
    ms = plain_ms = float("nan")
    if timed:
        ms = median_ms(lambda: seg_reduce_sorted(keys, cnts, vals, u, sent,
                                                 keys2=keys2))
        plain_ms = median_ms(lambda: seg_reduce_sorted_torch(
            keys, cnts, vals, u, sent, keys2=keys2))
    print(f"  {name}: B={keys.shape[0]} M={keys.shape[1]} "
          f"n_float={vals.shape[1]} u={u} n_seg[0]={int(p[4][0])} "
          f"max_abs_err={float(err.max()) if err.numel() else 0.0:.3e}"
          + (f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms" if timed else ""),
          flush=True)
    n_bytes = nbytes(keys, keys2, cnts, vals, *k)
    n_flops = cnts.numel() + vals.numel()
    return ((float(err.max()) if err.numel() else 0.0), ms, plain_ms,
            n_bytes, n_flops)


def encode_points(k, n, inside, g):
    """Sorted-front-like encoder inputs on the card: voxel coordinates in
    [0, 250) (a fifth on integers, where corners collapse), unit normals,
    the first ``inside`` share of each frame valid (or ``inside`` a [k, n]
    mask), invalid entries zeroed as the stage-1 sort leaves them."""
    import torch

    coords = torch.rand((k, n, 3), generator=g, device="cuda") * 250
    snap = torch.rand((k, n, 3), generator=g, device="cuda") < 0.2
    coords = torch.where(snap, coords.round(), coords)
    normals = torch.nn.functional.normalize(
        torch.randn((k, n, 3), generator=g, device="cuda"), dim=-1)
    valid = (inside if torch.is_tensor(inside) else
             (torch.arange(n, device="cuda") < int(inside * n)).expand(k, n))
    valid = valid.contiguous()
    zero = torch.zeros((), device="cuda")
    return (torch.where(valid[..., None], coords, zero),
            torch.where(valid[..., None], normals, zero), valid)


def check_fused_encode(g):
    """fused_encode_sorted against the plain version: at the main path's
    front (ENC_K x ENC_N points, ENC_INSIDE valid; timed, and timed again
    with every point valid), at a ragged N with a frame without a valid
    point and one valid at random, and two launches that must give
    identical bits; the bfloat16 variant at the main path's front against
    the plain bfloat16 encoder, timed.  Returns the kernels-line entry: the
    timed shape's
    bound counts three TF32 products of every layer for the valid points'
    8 corners (3xTF32, as fused_mlp's), the bytes the inputs and the
    [K, 64, N] output need."""
    import torch
    from bnv_fusion_tpu_torch import nn as bnn
    from bnv_fusion_tpu_torch.kernels import (fused_encode_sorted,
                                              fused_encode_sorted_torch)

    params = bnn.init_model(0, device="cuda", bias_std=BIAS_STD)
    enc = params["encoder"]
    errs = {}

    def check(name, pts):
        y = fused_encode_sorted(params, *pts)
        ref = fused_encode_sorted_torch(params, *pts)
        torch.cuda.synchronize()
        err = (y - ref).abs()
        if bool((err > MLP_ATOL + MLP_RTOL * ref.abs()).any()):
            raise AssertionError(f"fused_encode {name}: max abs err "
                                 f"{float(err.max()):.3e}")
        if bool(y[:, :, ~pts[2].any(0)].any()):
            raise AssertionError(f"fused_encode {name}: non-zero features "
                                 "at invalid points")
        errs[name] = float(err.max())
        return y

    rag = 32 * 1000 + 17
    mask = torch.rand((3, rag), generator=g, device="cuda") < 0.6
    mask[1] = False
    check(f"K=3 N={rag}, a frame without a valid point",
          encode_points(3, rag, mask, g))
    main = encode_points(ENC_K, ENC_N, ENC_INSIDE, g)
    y1 = check(f"K={ENC_K} N={ENC_N} inside {ENC_INSIDE}", main)
    y2 = fused_encode_sorted(params, *main)
    torch.cuda.synchronize()
    if not torch.equal(y1.view(torch.int32), y2.view(torch.int32)):
        raise AssertionError("fused_encode: two launches differ")
    print("  fused_encode: two launches give identical bits", flush=True)
    bf16 = torch.bfloat16
    yb = fused_encode_sorted(params, *main, compute_dtype=bf16)
    ref = fused_encode_sorted_torch(params, *main, bf16)
    err = (yb - ref).abs()
    moved = float((ref - y1).abs().mean())
    print(f"  fused_encode bfloat16 vs the plain bfloat16 encoder: max abs "
          f"{float(err.max()):.3e}, mean {float(err.mean()):.3e} (the "
          f"bfloat16 operands move the float32 kernel by {moved:.3e} on "
          f"average)", flush=True)
    if bool((err > ENC_BF16_TOL + ENC_BF16_TOL * ref.abs()).any()) or \
            float(err.mean()) > 1e-2 * moved:
        raise AssertionError("fused_encode bfloat16: beyond its tolerance")
    if not torch.equal(yb.view(torch.int32), fused_encode_sorted(
            params, *main, compute_dtype=bf16).view(torch.int32)):
        raise AssertionError("fused_encode bfloat16: two launches differ")
    del y1, y2, yb, ref, err
    bf_ms = median_ms(lambda: fused_encode_sorted(params, *main,
                                                  compute_dtype=bf16))
    bf_plain = median_ms(lambda: fused_encode_sorted_torch(params, *main,
                                                           bf16))
    print(f"  fused_encode bfloat16 K={ENC_K} N={ENC_N} inside "
          f"{ENC_INSIDE}: kernel {bf_ms:.3f} ms, plain {bf_plain:.3f} ms",
          flush=True)
    hidden = sum(enc[k].numel() for k in ("w0", "w1", "w2", "w_out"))
    out = {}
    for share in (ENC_INSIDE, 1.0):
        pts = main if share == ENC_INSIDE else \
            encode_points(ENC_K, ENC_N, share, g)
        ms = median_ms(lambda: fused_encode_sorted(params, *pts))
        plain_ms = median_ms(lambda: fused_encode_sorted_torch(params, *pts))
        rows = 8 * int(pts[2].sum())
        n_bytes = nbytes(*pts) + ENC_K * 64 * ENC_N * 4 + \
            nbytes(*enc.values())
        b = bound(n_bytes, 0.0, rows * 3 * 2 * hidden)
        once = bound(n_bytes, 0.0, rows * 2 * hidden)
        print(f"  fused_encode K={ENC_K} N={ENC_N} inside {share}: kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms "
              f"({b[1]}, 3xTF32 on the tensor cores; counted once "
              f"{once[0]:.3f} ms, {100 * once[0] / ms:.1f}% of the kernel's "
              f"time)", flush=True)
        if share == ENC_INSIDE:
            out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                   "bound_by": b[1]}
        del pts
    out["max_abs_err"] = max(errs.values())
    print("  fused_encode max_abs_err by case: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
    return out


def phase_kernels():
    import torch
    from bnv_fusion_tpu_torch import nn as bnn
    from bnv_fusion_tpu_torch.kernels import (fused_corner_decode,
                                              fused_corner_decode_torch,
                                              seg_reduce_sorted)
    from bnv_fusion_tpu_torch.kernels.fused_decode import pack_decoder_tc
    from bnv_fusion_tpu_torch.kernels.seg_reduce import tile_rows

    TILE = tile_rows()

    g = torch.Generator(device="cuda").manual_seed(0)
    sent = 260 * 260 * 160          # n_vox of the bench scene at voxel 0.01
    res = {}
    # the main path's two calls per K=16 batch (fusion.py:611,681)
    s1 = sorted_stream(16, 307200, 1, 64, 7000, sent, True, g)
    e1, ms1, pm1, by1, fl1 = check_seg("seg_reduce stage 1", *s1, u=65536,
                                       sent=sent, timed=True)
    # determinism: no atomics, so two launches give the same bits
    keys, keys2, cnts, vals = s1
    r1 = seg_reduce_sorted(keys, cnts, vals, 65536, sent, keys2=keys2)
    r2 = seg_reduce_sorted(keys, cnts, vals, 65536, sent, keys2=keys2)
    torch.cuda.synchronize()
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(r1, r2)):
        raise AssertionError("seg_reduce stage 1: two launches differ")
    print("  seg_reduce stage 1: two launches give identical bits",
          flush=True)
    del s1, keys, keys2, cnts, vals, r1, r2
    e2, ms2, pm2, by2, fl2 = check_seg("seg_reduce stage 2", *sorted_stream(
        16, 524288, 1, 8, 110000, sent, False, g), u=116736, sent=sent,
        timed=True)
    # edge cases of tests/test_seg_reduce.py
    k, k2, c, v = sorted_stream(2, 4096, 1, 3, 10, 100, False, g)
    k.fill_(100)
    c.zero_()
    v.zero_()
    e3, *_ = check_seg("seg_reduce all-sentinel", k, k2, c, v, 16, 100)
    k = torch.arange(5000, dtype=torch.int32, device="cuda")[None].repeat(2, 1)
    c = torch.ones((2, 1, 5000), dtype=torch.int32, device="cuda")
    v = torch.randn((2, 2, 5000), generator=g, device="cuda")
    e4, *_ = check_seg("seg_reduce more segments than u", k, None, c, v,
                         64, 1 << 16)
    k = torch.cat([torch.arange(100), torch.full((3000,), 500),
                   torch.arange(1000, 1996)]).to(torch.int32).cuda()[None]
    c = torch.randint(0, 5, (1, 1, 4096), generator=g, device="cuda",
                      dtype=torch.int32)
    v = torch.randn((1, 2, 4096), generator=g, device="cuda")
    e5, *_ = check_seg("seg_reduce segment over many blocks", k, None, c, v,
                         1024, 1 << 20)
    # at the kernel's tile T: a segment from row T-50 to row 4T+9 (tiles 1-3
    # hold no end, tiles 0 and 4 do), M = 5T + 123 (not a multiple of T nor
    # of 4: scalar loads) and 5T + 124 (16-byte loads), two key rows
    errs = []
    for m_rows in (5 * TILE + 123, 5 * TILE + 124):
        runs = ([7] * ((TILE - 50) // 7) + [(TILE - 50) % 7, 3 * TILE + 60]
                + [5] * 80)
        seg = torch.repeat_interleave(
            torch.arange(len(runs), device="cuda") * 2,
            torch.tensor(runs, device="cuda"))
        k = torch.full((2, m_rows), 1 << 20, dtype=torch.int32, device="cuda")
        k2 = torch.zeros((2, m_rows), dtype=torch.int32, device="cuda")
        k[:, :seg.numel()] = seg.to(torch.int32)
        k2[:, :seg.numel()] = (seg % 3).to(torch.int32)
        c = torch.zeros((2, 2, m_rows), dtype=torch.int32, device="cuda")
        v = torch.zeros((2, 9, m_rows), dtype=torch.float32, device="cuda")
        c[:, :, :seg.numel()] = torch.randint(
            0, 100, (2, 2, seg.numel()), generator=g, device="cuda",
            dtype=torch.int32)
        v[:, :, :seg.numel()] = torch.randn((2, 9, seg.numel()), generator=g,
                                            device="cuda")
        e, *_ = check_seg(f"seg_reduce long segment over 5 tiles, M={m_rows}",
                          k, k2, c, v, 512, 1 << 20)
        errs.append(e)
    e6 = max(errs)
    b1, b2 = bound(by1, fl1), bound(by2, fl2)
    print(f"  seg_reduce bound: stage 1 {b1[0]:.3f} ms ({b1[1]}), stage 2 "
          f"{b2[0]:.3f} ms ({b2[1]})", flush=True)
    res["seg_reduce_sorted"] = {"max_abs_err": max(e1, e2, e3, e4, e5, e6),
                                "ms": ms1 + ms2, "plain_ms": pm1 + pm2,
                                "bound_ms": b1[0] + b2[0],
                                "bound_by": b1[1]}

    params = bnn.init_model(0, device="cuda", bias_std=BIAS_STD)
    # packed once, as the mesh path packs once per weight set; the ragged
    # batch leaves the packing to the wrapper
    packed = pack_decoder_tc(params["decoder"])
    errs, times = [], None
    for n, pk in ((262144, packed), (262144 - 37, None)):
        local = torch.rand((n, 8, 3), generator=g, device="cuda") * 2 - 1
        feats = torch.randn((n, 8, 8), generator=g, device="cuda")
        tw = torch.rand((n, 8), generator=g, device="cuda")
        tw = tw / tw.sum(-1, keepdim=True)
        a = fused_corner_decode(params, local, feats, tw, VOXEL, pk)
        b = fused_corner_decode_torch(params, local, feats, tw, VOXEL)
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        if not err <= DECODE_ATOL:
            raise AssertionError(f"fused_corner_decode N={n}: max abs err "
                                 f"{err:.3e} > {DECODE_ATOL}")
        errs.append(err)
        if times is None:
            times = (median_ms(lambda: fused_corner_decode(
                params, local, feats, tw, VOXEL, packed)),
                median_ms(lambda: fused_corner_decode_torch(
                    params, local, feats, tw, VOXEL)))
            # per corner: the hidden layers' multiply-adds (x2 flops) on
            # the tensor cores, three TF32 products each (3xTF32); the
            # output layer and the blend's scale, weight and add on the
            # FMA units; the positional encoding's sin/cos run on the
            # special-function units and are not counted.  fma_bound is
            # the same work on f32 FMAs alone (the earlier design's bound)
            d = params["decoder"]
            hidden = sum(d[k].numel() for k in ("w0", "w1", "w2"))
            n_bytes = nbytes(local, feats, tw, a, *d.values())
            dec_bound = bound(n_bytes, n * 8 * (2 * d["w_out"].numel() + 3),
                              n * 8 * 3 * 2 * hidden)
            fma_bound = bound(n_bytes, n * 8 * (2 * (
                hidden + d["w_out"].numel()) + 3))
        print(f"  fused_corner_decode N={n}: max_abs_err={err:.3e}"
              + (f" kernel {times[0]:.3f} ms, plain {times[1]:.3f} ms"
                 if n == 262144 else ""), flush=True)
    print(f"  fused_corner_decode bound: {dec_bound[0]:.3f} ms "
          f"({dec_bound[1]}, 3xTF32 on the tensor cores); on f32 FMAs "
          f"alone {fma_bound[0]:.3f} ms ({fma_bound[1]})", flush=True)
    res["fused_corner_decode"] = {"max_abs_err": max(errs), "ms": times[0],
                                  "plain_ms": times[1],
                                  "bound_ms": dec_bound[0],
                                  "bound_by": dec_bound[1]}
    res["fused_encode"] = check_fused_encode(g)
    return res


def mlp_params(din: int, dout: int, seed: int):
    """A din -> 64 x 3 -> dout MLP with the port's init (He-normal weights,
    biases from N(0, BIAS_STD^2)) on the card."""
    import numpy as np
    from bnv_fusion_tpu_torch import nn as bnn

    return bnn.params_from_numpy(bnn._init_mlp(
        np.random.RandomState(seed), [din, 64, 64, 64, dout], BIAS_STD),
        "cuda")


def mlp_bounds(prm, x, y):
    """(bound, f32-FMA bound) of fused_mlp on x -> y: the layers on the
    tensor cores as three TF32 products each (3xTF32), all four for
    dout >= 2, for dout = 1 the output layer on FMAs; the second is all four
    on f32 FMAs (the earlier design's units)."""
    rows, wo = x.shape[0], prm["w_out"].numel()
    hidden = sum(prm[k].numel() for k in ("w0", "w1", "w2"))
    on_fma = wo if y.shape[1] == 1 else 0
    n_bytes = nbytes(x, y, *prm.values())
    return (bound(n_bytes, rows * 2 * on_fma,
                  rows * 3 * 2 * (hidden + wo - on_fma)),
            bound(n_bytes, rows * 2 * (hidden + wo)))


def phase_fused_mlp():
    """FusedMLP driven once per network (its path: the public API), then
    held against the plain version and timed, and at the tensor-core tile's
    edge cases.  Returns the kernels-line entry, with the path's launches."""
    import torch
    from bnv_fusion_tpu_torch import nn as bnn
    from bnv_fusion_tpu_torch.kernels import FusedMLP, _build, fused_mlp_torch

    params = bnn.init_model(0, device="cuda", bias_std=BIAS_STD)
    g = torch.Generator(device="cuda").manual_seed(1)
    enc, dec = FusedMLP(params["encoder"]), FusedMLP(params["decoder"])
    x_enc = torch.randn((ENC_ROWS, 6), generator=g, device="cuda")
    x_dec = torch.randn((DEC_ROWS, 17), generator=g, device="cuda")
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    y_enc, y_dec = enc(x_enc), dec(x_dec)
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["fused_mlp"]
    if launches != 2:
        raise AssertionError(f"FusedMLP launched fused_mlp {launches} times "
                             "for 2 calls")

    def check(name, mlp, prm, x, y=None):
        y = mlp(x) if y is None else y
        ref = fused_mlp_torch(prm, x)
        torch.cuda.synchronize()
        if y.shape != ref.shape:
            raise AssertionError(f"fused_mlp {name}: shape {tuple(y.shape)} "
                                 f"!= {tuple(ref.shape)}")
        err = (y - ref).abs()
        if bool((err > MLP_ATOL + MLP_RTOL * ref.abs()).any()):
            raise AssertionError(f"fused_mlp {name}: max abs err "
                                 f"{float(err.max()):.3e}")
        errs[name] = float(err.max()) if err.numel() else 0.0

    errs = {}
    check("encoder", enc, params["encoder"], x_enc, y_enc)
    check("decoder", dec, params["decoder"], x_dec, y_dec)
    check("ragged", enc, params["encoder"], x_enc[:3000 - 37])
    check("batched", enc, params["encoder"],
          torch.randn((7, 11, 6), generator=g, device="cuda"))
    # the tile's edge cases: layer 0's 1-4 k-steps, the output layer on
    # FMAs (dout 1) and on 1-2 n-tiles with even and odd dout; M = 0, a
    # partial 16-row tile, a partial 32-row unit; a base that is not
    # 16-byte aligned (the kernel's 4-byte copy path)
    ragged = 16 * 1000 + 3
    for din, dout in ((1, 1), (32, 16), (9, 2), (12, 9)):
        prm = mlp_params(din, dout, seed=100 * din + dout)
        check(f"{din}->{dout} M={ragged}", FusedMLP(prm), prm,
              torch.randn((ragged, din), generator=g, device="cuda"))
    for m_rows in (0, 5, ragged):
        check(f"M={m_rows}", enc, params["encoder"], x_enc[:m_rows])
    view = x_enc[1:]
    if view.data_ptr() % 16 == 0:
        raise AssertionError("x_enc[1:] is 16-byte aligned")
    check("misaligned view x_enc[1:]", enc, params["encoder"], view)
    y1, y2 = enc(x_enc), enc(x_enc)
    torch.cuda.synchronize()
    if not torch.equal(y1.view(torch.int32), y2.view(torch.int32)):
        raise AssertionError("fused_mlp: two launches differ")
    print("  fused_mlp encoder: two launches give identical bits",
          flush=True)
    del y1, y2, view

    out = {"launches": launches, "max_abs_err": max(errs.values())}
    for name, mlp, prm, x, y in (("encoder", enc, params["encoder"], x_enc,
                                  y_enc),
                                 ("decoder", dec, params["decoder"], x_dec,
                                  y_dec)):
        ms = median_ms(lambda: mlp(x))
        plain_ms = median_ms(lambda: fused_mlp_torch(prm, x))
        b, fma_bound = mlp_bounds(prm, x, y)
        print(f"  fused_mlp {name}: M={x.shape[0]} {x.shape[1]}->"
              f"{y.shape[1]} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {b[0]:.3f} ms ({b[1]}, 3xTF32 on the tensor cores; on "
              f"f32 FMAs alone {fma_bound[0]:.3f} ms)", flush=True)
        if name == "encoder":
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                       bound_by=b[1])
    print("  fused_mlp max_abs_err by case: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
    print(f"  fused_mlp max_abs_err={out['max_abs_err']:.3e} over "
          f"{len(errs)} cases; launches on its path: {launches}",
          flush=True)
    return out


def phase_pretrain(tmp):
    """Pretraining at the full model width: finite step losses, a falling
    loss, loadable last.npz / best.npz."""
    import numpy as np
    from bnv_fusion_tpu_torch import train
    from bnv_fusion_tpu_torch.checkpoint import load_state

    out = train.run(PRETRAIN_OVERRIDES + [f"output_dir={tmp}"])
    losses = np.asarray(out["trainer"].step_losses, np.float64)
    if len(losses) != 32 or not np.all(np.isfinite(losses)):
        raise AssertionError(f"pretrain step losses: {losses}")
    first, last = losses[:8].mean(), losses[-8:].mean()
    if not last < first:
        raise AssertionError(f"pretrain loss did not fall: first 8 "
                             f"{first:.4f}, last 8 {last:.4f}")
    for name in ("last.npz", "best.npz"):
        params = load_state(os.path.join(out["out_dir"], name))["params"]
        for net in ("encoder", "decoder"):
            if not all(np.all(np.isfinite(v)) for v in params[net].values()):
                raise AssertionError(f"{name}: non-finite {net} weights")
    print(f"  pretrain: {len(losses)} steps, loss first 8 {first:.4f} -> "
          f"last 8 {last:.4f}, best val {out['best']:.4f}; last.npz and "
          f"best.npz load", flush=True)


def phase_offline(tmp, params):
    """test.py then the refiner at bench.py's operating point."""
    import numpy as np
    from bnv_fusion_tpu_torch import tables as tbl
    from bnv_fusion_tpu_torch import test as offline, train
    from bnv_fusion_tpu_torch.checkpoint import load_state
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.pipeline import NeuralMap

    common = OFFLINE_OVERRIDES + [f"output_dir={tmp}"]
    t0 = time.time()
    fused = offline.run(common)
    t_fuse = time.time() - t0
    nmap, prefix = fused["nmap"], fused["prefix"]
    if nmap.overflow != 0:
        raise AssertionError(f"test.py table overflow {nmap.overflow}")
    if fused["mesh"] is None:
        raise AssertionError("test.py exported no mesh")
    ref_over = ["model=fusion_refiner_model", "trainer.max_epochs=1",
                f"model.sparse_volume_path={prefix}_sparse_volume.npz",
                f"model.tsdf_prior_path={prefix}_tsdf.npy"] + common
    t0 = time.time()
    refined = train.run(ref_over)
    t_refine = time.time() - t0
    rmap = refined["refiner"].nmap

    saved = load_state(prefix + "_sparse_volume.npz")
    loaded = NeuralMap(rmap.dimensions, load_config(ref_over), params)
    loaded.load_volume(prefix + "_sparse_volume.npz")

    def by_key(keys, *cols):
        order = np.lexsort(np.asarray(keys).T[::-1])
        return [np.asarray(keys)[order]] + [np.asarray(c)[order]
                                            for c in cols]

    want = by_key(saved["active_coordinates"], saved["features"],
                  saved["weights"], saved["num_hits"])
    k, f, w, h, _ = tbl.active_entries(loaded.table)
    for a, b, what in zip(by_key(k, f, w, h), want,
                          ("keys", "features", "weights", "hits")):
        if not np.array_equal(a, b):
            raise AssertionError(f"loaded table {what} differ from the "
                                 "saved map")
    rk = tbl.active_entries(rmap.table, with_features=False)[0]
    if not np.array_equal(by_key(rk)[0], want[0]):
        raise AssertionError("the refiner's table keys differ from the "
                             "saved map")
    losses = np.asarray(rmap.optimize_losses, np.float64)
    if len(losses) != len(rmap.frames) or not np.all(np.isfinite(losses)):
        raise AssertionError(f"refiner losses: {losses}")
    if rmap.overflow != 0:
        raise AssertionError(f"refiner table overflow {rmap.overflow}")
    wd = refined["out_dir"]
    head, n_v, n_f = read_ply_header(os.path.join(wd, "refined_0.ply"))
    if "binary_little_endian" not in head or n_v <= 0 or n_f <= 0:
        raise AssertionError(f"refined_0.ply is not a non-empty binary PLY "
                             f"({n_v} vertices, {n_f} faces)")
    if not os.path.exists(os.path.join(wd, "refined_sparse_volume.npz")):
        raise AssertionError("refined_sparse_volume.npz was not written")
    s = np.asarray(nmap.stats)
    print(f"  test.py: {len(nmap.frames)} frames fused one at a time, "
          f"{len(want[0])} voxels, {len(fused['mesh'].vertices)} mesh "
          f"vertices, pts/voxel median {np.median(s):.1f}; {t_fuse:.1f} s",
          flush=True)
    print(f"  refiner: loaded table == saved map by voxel key; "
          f"{len(losses)} losses {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"refined_0.ply {n_v} vertices, {n_f} faces; {t_refine:.1f} s",
          flush=True)


# the datasets phase: synthetic content written in the real layouts at
# the e2e phase's width (480x640) and depth cut to 48 and 24 frames
DATASET_FRAMES = 48
SCANNET_FRAMES = 24
SCANNET_COLOR_HW = (968, 1296)     # the ScanNet colour sensor's size
COLOR_PSNR_DB = 35.0               # decoded q95 JPEG against the render
MESH_VERTEX_RTOL = 0.01            # real-layout e2e mesh vs the e2e phase's
MESH_F1_MIN = 0.99                 # F@1 cm of each against the other
CODEC_REPS = 20
DEMO_SCRIPT_ARGS = ["--res", "480", "640", "--frames", "16"]
# run_inference scannet --mode fuse_refine: every frame, the fused decode,
# one refiner epoch
SCANNET_EXTRA = ["dataset.skip_images=1", "model.use_fused_decode_kernel=true",
                 "model.max_unique_per_frame=116736", "trainer.max_epochs=1"]


def host_ms(fn, reps: int = CODEC_REPS) -> float:
    """Median host wall time of fn() in ms (one warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def recording(*modules):
    """Point each module's ``main`` at its ``run``, keeping the results
    (a CLI entry point returns only its exit code); returns the list and an
    undo function."""
    results = []
    saved = [(m, m.main) for m in modules]

    def via_run(mod):
        def main(argv=None):
            results.append((mod.__name__.split(".")[-1],
                            mod.run(list(argv))))
            return 0
        return main

    for m in modules:
        m.main = via_run(m)

    def undo():
        for m, f in saved:
            m.main = f
    return results, undo


def write_gt_ply(path, surface, dims, transform=None):
    """The GT .ply: the synthetic scene's surface plus two unreferenced
    vertices at the corners of its bounds, so that the AABB the converters
    recentre by is the bounds, centred at the origin (``transform`` [4, 4]
    maps the vertices into a capture's own frame)."""
    from bnv_fusion_tpu_torch.mesh import Mesh, save_ply
    import numpy as np

    half = np.asarray(dims, np.float32) / 2
    v = np.concatenate([surface.vertices, [-half, half]]).astype(np.float32)
    if transform is not None:
        v = (v @ transform[:3, :3].T + transform[:3, 3]).astype(np.float32)
    save_ply(path, Mesh(v, surface.faces))


def phase_datasets(tmp, params, e2e_final_path, card):
    """The real-data path: converters, readers, run_inference in both modes
    and the tools on synthetic content written in the real layouts, then
    the colour modes (image_modes_step)."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import evaluation, run_e2e, test as offline
    from bnv_fusion_tpu_torch import train
    from bnv_fusion_tpu_torch.checkpoint import save_state
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.datasets import get_dataset
    from bnv_fusion_tpu_torch.kernels import _build
    from bnv_fusion_tpu_torch.mesh import load_ply
    from bnv_fusion_tpu_torch.scripts import (compute_chamfer, demo,
                                              evaluate_bnvf, run_inference,
                                              run_rgbd_integration)
    from bnv_fusion_tpu_torch.scripts import generate_fusion_data as gen
    from bnv_fusion_tpu_torch.utils import image_io

    def step(msg, t0):
        print(f"  {msg} ({time.time() - t0:.1f} s)", flush=True)

    os.makedirs(tmp, exist_ok=True)
    weights = os.path.join(tmp, "weights.npz")
    save_state(weights, {"params": {
        n: {k: v.detach().cpu().numpy() for k, v in p.items()}
        for n, p in params.items()}})
    synth_cfg = load_config(E2E_OVERRIDES + ["dataset.load_color=true"])
    synth = get_dataset(synth_cfg, "val")
    dims = synth.dimensions
    gt_ply = os.path.join(tmp, "gt.ply")
    write_gt_ply(gt_ply, synth.gt_mesh(resolution=128), dims)

    # 1. Scene3D raw layout, rendered with the converter's camera (the
    # converter writes SCENE3D_INTR whatever the capture), converted, read
    t0 = time.time()
    s3 = get_dataset(synth_cfg, "val")
    s3.intr = gen.SCENE3D_INTR.astype(np.float32)
    raw = os.path.join(tmp, "scene3d_raw", "scene")
    for sub in ("color", "depth"):
        os.makedirs(os.path.join(raw, "scene_png", sub))
    shutil.copy(gt_ply, os.path.join(raw, "scene.ply"))
    s3_frames = []
    with open(os.path.join(raw, "scene_trajectory.log"), "w") as log:
        for i in range(DATASET_FRAMES):
            f = s3[i]
            rgb = np.clip(f["rgb"], 0, 255).astype(np.uint8)
            image_io.write_png(os.path.join(raw, "scene_png", "color",
                                            f"{i:06d}.png"), rgb)
            image_io.write_png(os.path.join(raw, "scene_png", "depth",
                                            f"{i:06d}.png"), f["depth_raw"])
            log.write(f"{i} {i} {i + 1}\n")
            for row in np.asarray(f["T_wc"], np.float64):
                log.write(" ".join(f"{v:.9f}" for v in row) + "\n")
            s3_frames.append((f["depth_raw"], f["T_wc"], rgb))
    recenter, gt_dims = gen.recenter_from_mesh(os.path.join(raw, "scene.ply"))
    canon1 = os.path.join(tmp, "scene3d_canon")
    if gen.main(["scene3d", "--root", os.path.dirname(raw), "--out", canon1,
                 "--seqs", "scene"]) != 0:
        raise AssertionError("generate_fusion_data scene3d failed")
    rd = get_dataset(load_config([
        "dataset=fusion_inference_dataset", f"data_dir={canon1}",
        "dataset.scan_id=scene", "dataset.downsample_scale=0.",
        "dataset.stage_raw_depth=true", "dataset.load_color=true"]), "val")
    if len(rd) != DATASET_FRAMES:
        raise AssertionError(f"canonical reader: {len(rd)} frames")
    if np.abs(recenter[:3, 3]).max() > 1e-6 or \
            np.abs(rd.dimensions - dims).max() > 1e-6 or \
            np.abs(gt_dims - dims).max() > 1e-6:
        raise AssertionError(f"converter recentring {recenter[:3, 3]} / "
                             f"dimensions {rd.dimensions} vs {dims}")
    pose_err = intr_err = 0.0
    psnr = []
    for i, (raw_d, T_wc, rgb) in enumerate(s3_frames):
        f = rd[i]
        if not np.array_equal(f["depth_raw"], raw_d):
            raise AssertionError(f"frame {i}: depth differs after the "
                                 "converter's round trip")
        pose_err = max(pose_err, float(np.abs(f["T_wc"] - T_wc).max()))
        intr_err = max(intr_err, float(np.abs(f["intr_mat"] -
                                              s3.intr).max()))
        mse = np.mean((f["rgb"].astype(np.float64) - rgb) ** 2)
        psnr.append(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
    if pose_err > 1e-6 or intr_err > 1e-6 or min(psnr) < COLOR_PSNR_DB:
        raise AssertionError(f"converter round trip: T_wc err {pose_err}, "
                             f"intr err {intr_err}, colour PSNR "
                             f"{min(psnr):.2f} dB")
    step(f"scene3d: {DATASET_FRAMES} frames converted and read back; depth "
         f"bit-exact, T_wc err {pose_err:.2e}, intr err {intr_err:.2e}, "
         f"dimensions == bounds, colour PSNR min {min(psnr):.2f} dB", t0)

    # 2. run_inference --mode e2e on the canonical layout of the e2e
    # phase's own frames (the synthetic camera), written by the converter's
    # writer; colour reaches the prior only through img_path
    t0 = time.time()
    canon2 = os.path.join(tmp, "e2e_canon")
    src = os.path.join(tmp, "e2e_color")
    os.makedirs(src)
    synth_frames = [synth[i] for i in range(DATASET_FRAMES)]
    frames, bit_equal = [], True
    for i, f in enumerate(synth_frames):
        image_io.write_png(os.path.join(src, f"{i}.png"),
                           np.clip(f["rgb"], 0, 255).astype(np.uint8))
        frames.append((os.path.join(src, f"{i}.png"), f["depth_raw"],
                       f["T_wc"], f["intr_mat"]))
    gen.write_canonical(os.path.join(canon2, "scene"), frames, dims)
    back = get_dataset(load_config([
        "dataset=fusion_inference_dataset", f"data_dir={canon2}",
        "dataset.scan_id=scene"]), "val")
    for i, (_, _, T_wc, intr) in enumerate(frames):
        g = back[i]
        bit_equal &= bool(np.array_equal(g["T_wc"],
                                         np.asarray(T_wc, np.float32)) and
                          np.array_equal(g["intr_mat"],
                                         np.asarray(intr, np.float32)))
    out_dir = os.path.join(tmp, "e2e_real")
    extra = [
        "dataset.skip_images=1", "dataset.stage_raw_depth=true",
        "model.integrate_batch_size=16", "model.use_fused_decode_kernel=true",
        "model.fuse_color=true"] + E2E_OVERRIDES + [
        f"model.ray_tracer.ray_max_dist="
        f"{synth_cfg.model.ray_tracer.ray_max_dist}",
        f"output_dir={out_dir}"]
    results, undo = recording(run_e2e)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    try:
        rc = run_inference.main([
            "scene3d", "--seqs", "scene", "--checkpoint", weights,
            "--data_dir", canon2, "--min_pts_in_grid",
            str(synth_cfg.model.min_pts_in_grid), "--mode", "e2e",
            "--extra"] + extra)
    finally:
        undo()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if rc != 0 or len(results) != 1:
        raise AssertionError(f"run_inference scene3d --mode e2e rc {rc}")
    res = results[0][1]
    nmap = res["nmap"]
    for name in ("seg_reduce_sorted", "fused_corner_decode"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"run_inference e2e never launched {name}")
    losses = np.asarray(nmap.optimize_losses, np.float64)
    if nmap.overflow != 0 or not np.all(np.isfinite(losses)) or \
            len(losses) != res["global_steps"]:
        raise AssertionError(f"run_inference e2e: overflow {nmap.overflow}, "
                             f"losses {losses}")
    final_path = os.path.join(out_dir, "run_e2e", "scene", "final.ply")
    head, n_v, n_f = read_ply_header(final_path)
    if "binary_little_endian" not in head or n_v <= 0 or n_f <= 0 or \
            "property uchar red" not in head:
        raise AssertionError(f"final.ply: {n_v} vertices, {n_f} faces, "
                             "coloured: " + str("uchar red" in head))
    mine, ref = load_ply(final_path), load_ply(e2e_final_path)
    if bit_equal:
        if not (np.array_equal(mine.vertices, ref.vertices) and
                np.array_equal(mine.faces, ref.faces)):
            raise AssertionError("poses came back bit-equal, but the mesh "
                                 "differs from the e2e phase's")
        agree = "identical to the e2e phase's mesh (poses bit-equal)"
    else:
        rel = abs(len(mine.vertices) - len(ref.vertices)) / len(ref.vertices)
        f1 = [evaluation.evaluate_mesh(a, b, thresholds=(0.01,))["@0.01"]
              ["fscore"] for a, b in ((mine, ref), (ref, mine))]
        if rel > MESH_VERTEX_RTOL or min(f1) < MESH_F1_MIN:
            raise AssertionError(f"real-layout mesh vs e2e phase: vertices "
                                 f"{len(mine.vertices)} vs "
                                 f"{len(ref.vertices)}, F@1cm {f1}")
        agree = (f"vs the e2e phase's mesh: vertices {len(mine.vertices)} "
                 f"vs {len(ref.vertices)} ({rel:.4%}), F@1cm {f1[0]:.4f} / "
                 f"{f1[1]:.4f}")
    tm = nmap.timer.times
    step(f"run_inference scene3d --mode e2e: launches {launches}; "
         f"{len(nmap.frames)} frames, local {tm['local']:.2f} s, optimize "
         f"{tm['global']:.2f} s, mesh {tm['mesh']:.2f} s; final.ply {n_v} "
         f"vertices, coloured; {agree}", t0)
    del res, nmap, results

    # 3. ScanNet raw layout: sensor-sized colour, an axis alignment that is
    # not the identity; fuse_refine (test.py, then the refiner)
    t0 = time.time()
    scan = "scene0000_00"
    sroot = os.path.join(tmp, "scannet_raw")
    fdir = os.path.join(sroot, scan, "frames")
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(fdir, sub))
    c, s_ = np.cos(0.5), np.sin(0.5)
    align = np.array([[c, -s_, 0, 0.3], [s_, c, 0, -0.2], [0, 0, 1, 0.1],
                      [0, 0, 0, 1]])
    with open(os.path.join(sroot, scan, f"{scan}.txt"), "w") as fh:
        fh.write("axisAlignment = " +
                 " ".join(f"{v:.12f}" for v in align.ravel()) + "\n")
    unalign = np.linalg.inv(align)
    write_gt_ply(os.path.join(sroot, scan, f"{scan}_vh_clean_2.ply"),
                 load_ply(gt_ply), dims, unalign)
    K = np.eye(4)
    K[:3, :3] = synth.intr
    np.savetxt(os.path.join(fdir, "intrinsic", "intrinsic_depth.txt"), K)
    for i, f in enumerate(synth_frames[:SCANNET_FRAMES]):
        image_io.write_png(os.path.join(fdir, "depth", f"{i}.png"),
                           f["depth_raw"])
        rgb = torch.nn.functional.interpolate(
            torch.as_tensor(f["rgb"]).permute(2, 0, 1)[None],
            size=SCANNET_COLOR_HW, mode="bilinear", align_corners=False)
        rgb = rgb[0].permute(1, 2, 0).clamp(0, 255).to(torch.uint8).numpy()
        image_io.write_jpeg(os.path.join(fdir, "color", f"{i}.jpg"), rgb)
        np.savetxt(os.path.join(fdir, "pose", f"{i}.txt"),
                   np.linalg.inv(unalign @ np.asarray(f["T_wc"], np.float64)))
    sout = os.path.join(tmp, "scannet_out")
    results, undo = recording(offline, train)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    try:
        rc = run_inference.main([
            "scannet", "--seqs", scan, "--checkpoint", weights, "--data_dir",
            sroot, "--mode", "fuse_refine", "--extra"] + SCANNET_EXTRA +
            [f"output_dir={sout}"])
    finally:
        undo()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if rc != 0 or [r[0] for r in results] != ["test", "train"]:
        raise AssertionError(f"run_inference scannet --mode fuse_refine rc "
                             f"{rc}")
    fused, refined = results[0][1], results[1][1]
    rmap = refined["refiner"].nmap
    rlosses = np.asarray(rmap.optimize_losses, np.float64)
    if launches.get("fused_corner_decode", 0) <= 0:
        raise AssertionError("fuse_refine never launched fused_corner_decode")
    if fused["nmap"].overflow != 0 or rmap.overflow != 0 or \
            len(rlosses) == 0 or not np.all(np.isfinite(rlosses)):
        raise AssertionError(f"fuse_refine: overflow {fused['nmap'].overflow}"
                             f"/{rmap.overflow}, refiner losses {rlosses}")
    refined_ply = os.path.join(refined["out_dir"], "refined_0.ply")
    head, rn_v, rn_f = read_ply_header(refined_ply)
    if "binary_little_endian" not in head or rn_v <= 0 or rn_f <= 0:
        raise AssertionError(f"refined_0.ply: {rn_v} vertices, {rn_f} faces")
    canon3 = os.path.join(tmp, "scannet_canon")
    if gen.main(["scannet", "--root", sroot, "--out", canon3, "--seqs",
                 scan]) != 0:
        raise AssertionError("generate_fusion_data scannet failed")
    g = get_dataset(load_config([
        "dataset=fusion_inference_dataset", f"data_dir={canon3}",
        f"dataset.scan_id={scan}", "dataset.load_color=true"]), "val")[0]
    if g["rgb"].shape != tuple(synth_cfg.dataset.img_res) + (3,):
        raise AssertionError(f"scannet colour read at {g['rgb'].shape}")
    step(f"run_inference scannet --mode fuse_refine: launches {launches}; "
         f"test.py {len(fused['nmap'].frames)} frames, refiner "
         f"{len(rlosses)} losses {rlosses[0]:.5f} -> {rlosses[-1]:.5f}, "
         f"refined_0.ply {rn_v} vertices; generate_fusion_data scannet, "
         f"frame 0 colour {SCANNET_COLOR_HW[1]}x{SCANNET_COLOR_HW[0]} -> "
         f"{g['rgb'].shape[1]}x{g['rgb'].shape[0]}", t0)
    del fused, refined, rmap, results

    # 4. the tools
    t0 = time.time()
    js = os.path.join(tmp, "eval.json")
    if evaluate_bnvf.main(["--pred", final_path, refined_ply, "--gt", gt_ply,
                           gt_ply, "--json_out", js]) != 0 or \
            compute_chamfer.main([final_path, gt_ply,
                                  "--normal_consistency"]) != 0:
        raise AssertionError("evaluate_bnvf / compute_chamfer failed")
    rg_out = os.path.join(tmp, "rgbd")
    if run_rgbd_integration.main([
            "dataset=fusion_inference_dataset", f"data_dir={canon2}",
            "dataset.scan_id=scene", "model.tsdf_voxel_size=0.02",
            f"output_dir={rg_out}"]) != 0:
        raise AssertionError("run_rgbd_integration extracted no surface")
    _, tn_v, tn_f = read_ply_header(os.path.join(
        rg_out, "rgbd_integration", "scene_tsdf.ply"))
    if tn_v <= 0 or tn_f <= 0:
        raise AssertionError("run_rgbd_integration: empty mesh")
    dout = os.path.join(tmp, "demo_script")
    if demo.main(["--out", dout] + DEMO_SCRIPT_ARGS) != 0:
        raise AssertionError("scripts.demo failed")
    for name in ("gt.png", "before_optim.png", "final.png", "metrics.json"):
        if os.path.getsize(os.path.join(dout, name)) <= 0:
            raise AssertionError(f"scripts.demo wrote no {name}")
    step(f"tools: evaluate_bnvf and compute_chamfer (F-scores above are "
         f"information only, untrained weights); run_rgbd_integration "
         f"{tn_v} vertices, {tn_f} faces; scripts.demo "
         f"{' '.join(DEMO_SCRIPT_ARGS)} wrote its 3 PNGs and metrics.json",
         t0)

    # 5. codec timings (host, this machine's CPU)
    depth_png = os.path.join(fdir, "depth", "0.png")
    jpg = os.path.join(fdir, "color", "0.jpg")
    rgb0 = np.clip(synth_frames[0]["rgb"], 0, 255).astype(np.uint8)
    t_png = host_ms(lambda: image_io.read_png(depth_png))
    t_jpg = host_ms(lambda: image_io.read_jpeg(jpg))
    hw = tuple(synth_cfg.dataset.img_res)
    t_area = host_ms(lambda: image_io.read_color(jpg, hw))
    t_enc = host_ms(lambda: image_io.encode_jpeg(rgb0, 95))
    size = f"{hw[1]}x{hw[0]}"
    print(f"  codec (host, median of {CODEC_REPS}): {size} 16-bit depth PNG "
          f"read {t_png:.2f} ms; {SCANNET_COLOR_HW[1]}x{SCANNET_COLOR_HW[0]} "
          f"JPEG read {t_jpg:.2f} ms (with the area resize to {size}: "
          f"{t_area:.2f} ms); {size} JPEG write {t_enc:.2f} ms", flush=True)

    # 6. the colour modes
    image_modes_step(os.path.join(tmp, "modes"), weights,
                     [e for e in extra if not e.startswith("output_dir=")],
                     synth_frames, dims, card)


# the datasets phase's colour-modes step: the committed fixtures and the
# digests of the port's decodes of them (tests/test_torch_image_modes.py
# make_fixtures), and run_inference --mode e2e cut to one K=16 batch and a
# few optimize steps, with the six 240x320 fixture frames as its colour
MODES_DIR = os.path.join(HERE, "tests", "data", "torch_image_modes")
MODES_FRAME_FILES = ("frame_prog.jpg", "frame_o6.jpg", "frame_cmyk.jpg",
                     "frame_base.jpg", "frame_sof10.jpg", "frame_smooth.jpg")
MODES_FRAMES = 16
MODES_STEPS = 4


def image_modes_step(tmp, weights, e2e_extra, synth_frames, dims, card):
    """The fixtures' decodes against digests.json and their twins, then
    the same capture fused from the fixture files and from PNGs of their
    decodes: equal maps and colour priors."""
    import hashlib

    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import run_e2e, tsdf
    from bnv_fusion_tpu_torch.kernels import _build
    from bnv_fusion_tpu_torch.scripts import run_inference
    from bnv_fusion_tpu_torch.scripts import generate_fusion_data as gen
    from bnv_fusion_tpu_torch.utils import image_io

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    def step(msg, t0):
        print(f"  {msg} ({time.time() - t0:.1f} s)", flush=True)

    t0 = time.time()
    with open(os.path.join(MODES_DIR, "digests.json")) as f:
        want = json.load(f)
    decoded, bad = {}, []
    for name in sorted(want["read_image"]):
        path = os.path.join(MODES_DIR, name)
        img = decoded[name] = image_io.read_image(path)
        if sha(img) != want["read_image"][name] or \
                list(img.shape) != want["shape"][name]:
            bad.append(f"{name} decode")
        if name in want["jpeg_orientation"]:
            with open(path, "rb") as f:
                if image_io.jpeg_orientation(f.read()) != \
                        want["jpeg_orientation"][name]:
                    bad.append(f"{name} orientation")
    depth_hw = synth_frames[0]["depth_raw"].shape
    area = want[f"read_color_{depth_hw[0]}x{depth_hw[1]}"]
    for name in MODES_FRAME_FILES:
        if sha(image_io.read_color(os.path.join(MODES_DIR, name),
                                   depth_hw)) != area[name]:
            bad.append(f"{name} area resize")
    for prog, base in want["twins"].items():
        if not np.array_equal(decoded[prog], decoded[base]):
            bad.append(f"{prog} != {base}")
    arith = [n for n in want["twins"] if "sof9" in n or "sof10" in n]
    for name in arith:
        sof = b"\xff\xc9" if "sof9" in name else b"\xff\xca"
        with open(os.path.join(MODES_DIR, name), "rb") as f:
            if sof not in f.read():
                bad.append(f"{name} is not arithmetic-coded")
    if len(arith) != 14:
        bad.append(f"{len(arith)} arithmetic-coded twins, not 14")
    if bad:
        raise AssertionError(f"colour fixtures: {bad}")
    step(f"colour modes: {len(decoded)} fixtures decoded to their digests, "
         f"{len(want['twins'])} progressive or arithmetic-coded files "
         f"({len(arith)} SOF9/SOF10) equal to their baseline twins", t0)

    # the same capture twice: colour from the fixture files, then from
    # PNGs of the port's decodes of them (read_image sniffs the content)
    t0 = time.time()
    frames = synth_frames[:MODES_FRAMES]
    maps = []
    for kind in ("fixtures", "png"):
        canon = os.path.join(tmp, kind)
        gen.write_canonical(os.path.join(canon, "scene"), [
            (os.path.join(MODES_DIR,
                          MODES_FRAME_FILES[i % len(MODES_FRAME_FILES)]),
             f["depth_raw"], f["T_wc"], f["intr_mat"])
            for i, f in enumerate(frames)], dims)
        if kind == "png":
            for i in range(len(frames)):
                image_io.write_png(os.path.join(canon, "scene", "image",
                                                f"{i}.jpg"),
                                   decoded[MODES_FRAME_FILES[
                                       i % len(MODES_FRAME_FILES)]])
        results, undo = recording(run_e2e)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        try:
            rc = run_inference.main([
                "scene3d", "--seqs", "scene", "--checkpoint", weights,
                "--data_dir", canon, "--mode", "e2e", "--extra"] +
                e2e_extra + [f"trainer.global_steps={MODES_STEPS}",
                             f"output_dir={os.path.join(tmp, 'out_' + kind)}"])
        finally:
            undo()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        if rc != 0 or len(results) != 1:
            raise AssertionError(f"run_inference ({kind} colour) rc {rc}")
        for name in ("seg_reduce_sorted", "fused_corner_decode"):
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"run_inference ({kind} colour) never "
                                     f"launched {name}")
        nmap = results[0][1]["nmap"]
        if len(nmap.frames) != MODES_FRAMES or nmap.overflow != 0 or \
                len(nmap.optimize_losses) != MODES_STEPS:
            raise AssertionError(f"run_inference ({kind} colour): "
                                 f"{len(nmap.frames)} frames, overflow "
                                 f"{nmap.overflow}, "
                                 f"{len(nmap.optimize_losses)} steps")
        vol = tsdf.as_dense(nmap.tsdf_vol)
        if vol.color is None:
            raise AssertionError("model.fuse_color made no colour prior")
        maps.append((table_by_key(nmap), vol.color.cpu().numpy(),
                     vol.sdf.cpu().numpy(), launches))
        del nmap, results
    (ta, ca, sa, la), (tb, cb, sb, lb) = maps
    same_table("fixture colour vs PNG colour", ta, tb)
    if not (np.array_equal(ca, cb) and np.array_equal(sa, sb)):
        raise AssertionError("fixture colour vs PNG colour: the colour "
                             "prior differs")
    if not np.any(ca != 0):
        raise AssertionError("the colour prior is empty")
    step(f"colour modes: run_inference scene3d --mode e2e, {MODES_FRAMES} "
         f"frames ({', '.join(MODES_FRAME_FILES)} in turn), "
         f"{MODES_STEPS} steps: launches {la} / {lb}; {len(ta[0])} voxels, "
         f"maps and colour priors equal bit for bit from the files and from "
         f"PNGs of their decodes", t0)

    # host timings at the 240x320 frames
    data_o6 = open(os.path.join(MODES_DIR, "frame_o6.jpg"), "rb").read()
    img_o6 = decoded["frame_o6.jpg"]
    def t_read(name):
        return host_ms(lambda: image_io.read_image(
            os.path.join(MODES_DIR, name)))

    t_prog, t_base = t_read("frame_prog.jpg"), t_read("frame_base.jpg")
    t_sof9, t_sof10 = t_read("frame_sof9.jpg"), t_read("frame_sof10.jpg")
    t_smooth = t_read("frame_smooth.jpg")
    t_orient = host_ms(lambda: image_io.apply_orientation(
        img_o6, image_io.jpeg_orientation(data_o6)))
    t_grow = host_ms(lambda: image_io.resize_area(
        decoded["frame_base.jpg"], depth_hw[::-1]))
    print(f"  {card}: host decode (median of {CODEC_REPS}) of a 240x320 "
          f"JPEG: progressive {t_prog:.3f} ms/frame, its baseline twin "
          f"{t_base:.3f} ms/frame", flush=True)
    print(f"  {card}: host decode (median of {CODEC_REPS}) of a 240x320 "
          f"arithmetic-coded JPEG: SOF9 {t_sof9:.3f} ms/frame, SOF10 "
          f"{t_sof10:.3f} ms/frame", flush=True)
    print(f"  {card}: host decode (median of {CODEC_REPS}) of a 240x320 "
          f"progressive JPEG cut to 4 of its 10 scans, block-smoothed: "
          f"{t_smooth:.3f} ms/frame (the complete file {t_prog:.3f})",
          flush=True)
    print(f"  {card}: host EXIF orientation (parse + orientation 6) of a "
          f"240x320 decode: {t_orient:.3f} ms", flush=True)
    print(f"  {card}: host area enlarge 240x320 -> {depth_hw[0]}x"
          f"{depth_hw[1]}: {t_grow:.3f} ms", flush=True)


def read_ply_header(path):
    with open(path, "rb") as f:
        head = f.read(512).split(b"end_header")[0].decode(errors="replace")
    n_v = n_f = 0
    for line in head.splitlines():
        parts = line.split()
        if parts[:2] == ["element", "vertex"]:
            n_v = int(parts[2])
        if parts[:2] == ["element", "face"]:
            n_f = int(parts[2])
    return head, n_v, n_f


def phase_demo(tmp, params):
    """run_e2e in demo mode, then the incremental cache against a fresh
    mesher's after the final optimize and after a partial update."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import run_e2e, tables as tbl
    from bnv_fusion_tpu_torch.kernels import _build

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    out = run_e2e.run(DEMO_OVERRIDES + [f"output_dir={tmp}"], params=params)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    nmap, wd = out["nmap"], out["working_dir"]
    for e in out["events"]:
        print(f"  event at frame {e['frame']}: optimize "
              f"{e['optimize_iters']} iters {e['optimize_s']:.3f} s, "
              f"incremental mesh {e['mesh_s']:.3f} s, re-decoded "
              f"{e['redecoded']} of {e['eligible']} eligible voxels "
              f"({e['redecoded'] / max(e['eligible'], 1):.1%}), "
              f"{e['vertices']} vertices", flush=True)
    tm = nmap.timer.times
    print(f"  launches in the demo run: {launches}", flush=True)
    print(f"  local fusion {tm['local']:.2f} s, optimize {tm['global']:.2f} s "
          f"({sum(e['optimize_iters'] for e in out['events'])} event + "
          f"{out['global_steps']} final iters), full meshes {tm['mesh']:.2f} "
          f"s, incremental meshes {tm['inc_mesh']:.2f} s", flush=True)
    for name in ("seg_reduce_sorted", "fused_corner_decode"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"the demo run never launched {name}")
    frames = [e["frame"] for e in out["events"]]
    if frames != [0, 16, 32]:
        raise AssertionError(f"events at frames {frames}")
    for e in out["events"]:
        path = os.path.join(wd, f"{e['frame']}.ply")
        if e["frame"] == 0 and e["eligible"] == 0:
            # one frame leaves every voxel's weight below
            # model.min_pts_in_grid: no mesh and, as in the JAX package,
            # no file
            if os.path.exists(path):
                raise AssertionError("0.ply written for an empty mesh")
            continue
        head, n_v, n_f = read_ply_header(path)
        if "binary_little_endian" not in head or n_v != e["vertices"] or \
                n_v <= 0 or n_f <= 0:
            raise AssertionError(f"{e['frame']}.ply is not a non-empty "
                                 f"binary PLY of the event's mesh ({n_v} "
                                 f"vertices, {n_f} faces)")
    losses = np.asarray(nmap.optimize_losses, np.float64)
    if out["global_steps"] != 48 or len(losses) != 48:
        raise AssertionError(f"final optimize ran {len(losses)} steps "
                             f"(global_steps {out['global_steps']}), not 48")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"demo optimize losses not all finite: {losses}")
    if nmap.overflow != 0:
        raise AssertionError(f"demo table overflow {nmap.overflow}")

    check_cache(nmap, "after the final optimize")
    # a partial update at full size: latents of a slab of voxels and a box
    # of the prior move, so only their neighbourhoods are re-decoded
    keys = tbl.active_entries(nmap.table, with_features=False)[0]
    lo, hi = np.percentile(keys[:, 0], [45, 55])
    slab = np.nonzero((keys[:, 0] >= lo) & (keys[:, 0] < hi))[0]
    nmap.table.features[torch.as_tensor(slab, device=nmap.device)] += 0.01
    # the prior cells around one voxel of the map outside the slab
    # (pipeline's voxel -> prior index map)
    dims = np.asarray(nmap.tsdf_vol.sdf.shape)
    far = keys[keys[:, 0] < np.percentile(keys[:, 0], 20)]
    c = np.round(far[len(far) // 2] / (np.asarray(nmap.n_xyz) - 1) *
                 (dims - 1)).astype(int)
    box = tuple(slice(max(v - 3, 0), v + 4) for v in c)
    nmap.tsdf_vol.sdf[box] += 0.05
    st = check_cache(nmap, "after moving a slab of latents and a prior box")
    if not 0 < st["redecoded"] < st["eligible"]:
        raise AssertionError(f"the partial update re-decoded "
                             f"{st['redecoded']} of {st['eligible']} voxels")


def check_cache(nmap, when: str) -> dict:
    """One more incremental mesh against one update of a fresh mesher on
    the same state: equal welded face and vertex counts and the same
    triangles, sorted and rounded to 1e-5 m (the welded vertices follow the
    cache's triangle order, ROADMAP Queue 3).  Returns the update's
    counts."""
    import numpy as np
    from bnv_fusion_tpu_torch.incremental_mesh import IncrementalMesher

    t0 = time.time()
    inc = nmap.extract_mesh_incremental()
    t_inc = time.time() - t0
    st = dict(nmap.inc_mesher.last_stats)
    decode, keys, weights, delta, _ = nmap.incremental_mesh_inputs()
    fresh = IncrementalMesher(nmap.bound_min.cpu().numpy(), nmap.voxel_size,
                              n_xyz=np.asarray(nmap.n_xyz),
                              device=nmap.device)
    t0 = time.time()
    full = fresh.update(decode, keys, weights, None, nmap.min_pts_in_grid,
                        sdf_delta=delta,
                        changed_rows=np.ones(len(keys), bool))
    t_fresh = time.time() - t0

    def rows(tris):
        r = np.round(tris.reshape(-1, 9) / 1e-5).astype(np.int64)
        return r[np.lexsort(r.T[::-1])]

    if inc is None or (len(inc.faces), len(inc.vertices)) != \
            (len(full.faces), len(full.vertices)):
        raise AssertionError(
            f"{when}: incremental mesh "
            f"{None if inc is None else len(inc.faces)} faces vs a fresh "
            f"mesher's {len(full.faces)}")
    if not np.array_equal(rows(nmap.inc_mesher.triangles()),
                          rows(fresh.triangles())):
        raise AssertionError(f"{when}: the incremental cache's triangles "
                             "differ from a fresh mesher's")
    print(f"  cache exactness {when}: re-decoded {st['redecoded']} of "
          f"{st['eligible']} voxels in {t_inc:.3f} s; a fresh mesher "
          f"{t_fresh:.3f} s; {len(full.faces)} faces, {len(full.vertices)} "
          f"vertices, triangles equal", flush=True)
    return st


def phase_reference(nmap):
    """One K-batch of the bench frames fused through the kernel path and
    through the plain seg-reduce path into fresh tables: keys, weights and
    hits must match exactly, features within 1e-4 (exact-f32 stage 2)."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import fusion, tables as tbl
    from bnv_fusion_tpu_torch.pipeline import _frame_points

    frames = nmap.frames[:4]
    pts = [_frame_points(f["depth"], f["T_wc"], f["intr"]) for f in frames]
    pw, nw, va = (torch.stack([p[j] for p in pts]) for j in range(3))
    out = {}
    for mode in (True, "interpret"):
        t = tbl.create_table(nmap.feat_dims, nmap.table.capacity,
                             n_xyz=nmap.n_xyz, device=nmap.device)
        mu, muc = nmap._width_values()
        fusion.fuse_frames_merged(
            t, nmap.params, pw, nw, va, nmap.bound_min, nmap.bound_max,
            nmap.voxel_size, nmap.min_pts_in_grid, max_unique=mu,
            max_unique_cells=muc, seg_kernel=mode, sort_bf16=False)
        keys, feats, w, h, _ = tbl.active_entries(t)
        order = np.lexsort(keys.T[::-1])
        out[mode] = (keys[order], feats[order], w[order], h[order])
    (ka, fa, wa, ha), (kb, fb, wb, hb) = out[True], out["interpret"]
    if not (np.array_equal(ka, kb) and np.array_equal(wa, wb) and
            np.array_equal(ha, hb)):
        raise AssertionError("kernel-path fusion: keys/weights/hits differ "
                             "from the plain path")
    ferr = float(np.abs(fa - fb).max()) if len(fa) else 0.0
    if not ferr <= 1e-4:
        raise AssertionError(f"kernel-path fusion: features differ by {ferr}")
    print(f"  reference check: 4 bench frames fused via kernel == plain "
          f"path ({len(ka)} voxels, feature max abs err {ferr:.3e})",
          flush=True)


def check_prefetch(nmap, final):
    """The final extract_mesh of run_e2e had a valid mesh-lattice prefetch
    (the fuse epoch has not moved since the final optimize started it):
    re-extract through it with the launch counts zeroed (the decode kernel
    must launch), then with model.mesh_prefetch=false (the in-line lattice
    build): identical vertices and faces, and post-processed, the run's
    final mesh.  Prints both mesh times."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import mesh as mesh_mod
    from bnv_fusion_tpu_torch.kernels import _build

    if nmap._prefetched_lattice() is None:
        raise AssertionError("no valid mesh-lattice prefetch after the final "
                             "optimize")
    meshes, secs, decodes = {}, {}, {}
    for prefetch in (True, False):
        nmap.config.model.mesh_prefetch = prefetch
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.time()
        meshes[prefetch] = nmap.extract_mesh()
        secs[prefetch] = time.time() - t0
        decodes[prefetch] = _build.LAUNCHES["fused_corner_decode"]
    nmap.config.model.mesh_prefetch = True
    pre, inline = meshes[True], meshes[False]
    if not (np.array_equal(pre.vertices, inline.vertices) and
            np.array_equal(pre.faces, inline.faces)):
        raise AssertionError("the prefetched mesh differs from the in-line "
                             "build")
    post = mesh_mod.post_process_mesh(pre,
                                      vertex_threshold=nmap.voxel_size / 4)
    if not (np.array_equal(post.vertices, final.vertices) and
            np.array_equal(post.faces, final.faces)):
        raise AssertionError("the re-extracted mesh differs from final.ply's")
    if decodes[True] <= 0:
        raise AssertionError("the prefetched extract_mesh never launched "
                             "fused_corner_decode")
    print(f"  mesh prefetch: extract_mesh {secs[True]:.3f} s through the "
          f"prefetched lattice, {secs[False]:.3f} s with the in-line build "
          f"({decodes[True]} and {decodes[False]} fused_corner_decode "
          f"launches); identical "
          f"vertices and faces ({len(pre.vertices)} vertices), equal to "
          f"final.ply after post-processing", flush=True)

    # the prefetch thread runs beside the optimize loop's launches and
    # saves the final mesh its lattice build: run_e2e's optimize plus the
    # final extract_mesh, with the prefetch off and on, in pairs of
    # alternating order on this map; the net is the pair's total
    import statistics
    opt, msh = {False: [], True: []}, {False: [], True: []}
    for pair in range(PREFETCH_PAIRS):
        for prefetch in ((False, True) if pair % 2 == 0 else (True, False)):
            nmap.config.model.mesh_prefetch = prefetch
            nmap._mesh_prefetch = None
            torch.cuda.synchronize()
            t0 = time.time()
            nmap.optimize(n_iters=PREFETCH_ITERS)
            torch.cuda.synchronize()
            t1 = time.time()
            nmap.extract_mesh()
            torch.cuda.synchronize()
            opt[prefetch].append((t1 - t0) / PREFETCH_ITERS)
            msh[prefetch].append(time.time() - t1)
    nmap.config.model.mesh_prefetch = True
    total = {p: [o * PREFETCH_ITERS + m for o, m in zip(opt[p], msh[p])]
             for p in opt}
    net = [on - off for on, off in zip(total[True], total[False])]
    med = statistics.median
    for p in (False, True):
        print(f"  prefetch {'on ' if p else 'off'}: optimize "
              f"{', '.join(f'{x:.4f}' for x in opt[p])} s/iter; final mesh "
              f"{', '.join(f'{x:.3f}' for x in msh[p])} s", flush=True)
    print(f"  prefetch off / on over {PREFETCH_PAIRS} pairs of "
          f"{PREFETCH_ITERS} optimize iterations + the final mesh: optimize "
          f"median {med(opt[False]):.4f} / {med(opt[True]):.4f} s/iter "
          f"({(med(opt[True]) / med(opt[False]) - 1) * 100:+.1f}%), mesh "
          f"median {med(msh[False]):.3f} / {med(msh[True]):.3f} s, total "
          f"median {med(total[False]):.3f} / {med(total[True]):.3f} s; "
          f"per pair on - off: median {med(net):+.3f} s, on faster in "
          f"{sum(x < 0 for x in net)} of {len(net)}", flush=True)


def table_by_key(nmap):
    """(keys, features, weights, hits) of a map's table, sorted by key."""
    import numpy as np
    from bnv_fusion_tpu_torch import tables as tbl

    keys, feats, w, h, _ = tbl.active_entries(nmap.table)
    order = np.lexsort(keys.T[::-1])
    return keys[order], feats[order], w[order], h[order]


def same_table(what, a, b, atol=None, rtol=0.0) -> float:
    """Two tables by key: keys, weights and hits exact; features bit for
    bit (atol None) or within atol + rtol |b|.  Returns the features' max
    abs difference."""
    import numpy as np

    for i, name in ((0, "keys"), (2, "weights"), (3, "hits")):
        if not np.array_equal(a[i], b[i]):
            raise AssertionError(f"{what}: {name} differ")
    diff = np.abs(a[1] - b[1])
    err = float(diff.max()) if diff.size else 0.0
    if atol is None:
        ok = np.array_equal(a[1].view(np.int32), b[1].view(np.int32))
    else:
        ok = bool(np.all(diff <= atol + rtol * np.abs(b[1])))
    if not ok:
        raise AssertionError(f"{what}: features differ, max abs {err:.3e}")
    return err


def sort1_other(pts_w, normals, valid, bound_min, bound_max, voxel_size,
                n_xyz, n_vox):
    """The stage-1 sort in its other bit-identical formulation (the JAX
    package's fuse_sort1_gather): sort the combined (cell, mcode) key with
    its row index, decode (cell, mcode) from the sorted key, gather only the
    float payloads."""
    import torch
    from bnv_fusion_tpu_torch import fusion

    inside, cell, mcode, coords = fusion._cell_keys(
        pts_w, valid, bound_min, bound_max, voxel_size, n_xyz, n_vox)
    zero = torch.zeros((), dtype=coords.dtype, device=coords.device)
    coords_z = torch.where(inside[..., None], coords, zero)
    normals_z = torch.where(inside[..., None], normals, zero)
    key_s, idx = torch.sort(cell.long() * 16 + mcode.long(), dim=-1,
                            stable=True)
    o3 = idx[..., None].expand(idx.shape + (3,))
    return ((key_s // 16).to(torch.int32), (key_s % 16).to(torch.int32),
            torch.gather(coords_z, -2, o3), torch.gather(normals_z, -2, o3),
            inside.to(torch.float32).sum(-1))


def time_sort1(nm, batch):
    """The stage-1 sort of one K=16 batch at bench.py's point: the
    package's _cellsort_sort1 and sort1_other, identical bits, each timed
    with CUDA events SORT_REPS times in alternation after 2 warm-ups."""
    import statistics
    import torch
    from bnv_fusion_tpu_torch import fusion
    from bnv_fusion_tpu_torch.pipeline import _frame_points

    st = nm._stack_batch(batch)
    depths = nm._convert_raw_depth(st["raw"], st["scale"]) if "raw" in st \
        else nm._tensor(st["depth"])
    pts = [_frame_points(d, t, i) for d, t, i in
           zip(depths, nm._tensor(st["T_wc"]), nm._tensor(st["intr"]))]
    args = tuple(torch.stack([p[j] for p in pts]) for j in range(3)) + (
        nm.bound_min, nm.bound_max, nm.voxel_size, nm.n_xyz,
        nm.table.n_voxels)
    fns = {"package": fusion._cellsort_sort1, "other": sort1_other}
    for x, y in zip(*(fn(*args) for fn in fns.values())):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError("the two stage-1 sort formulations differ")
    ms = {k: [] for k in fns}
    for rep in range(SORT_REPS + 2):
        for k, fn in fns.items():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn(*args)
            ev[1].record()
            ev[1].synchronize()
            if rep >= 2:
                ms[k].append(ev[0].elapsed_time(ev[1]))
    med = {k: statistics.median(v) for k, v in ms.items()}
    print(f"  stage-1 sort of {args[0].shape[0]} x {args[0].shape[1]} "
          f"points, identical bits: the package's {med['package']:.3f} ms, "
          f"the other formulation {med['other']:.3f} ms (medians of "
          f"{SORT_REPS}; ranges {min(ms['package']):.3f}-"
          f"{max(ms['package']):.3f} and {min(ms['other']):.3f}-"
          f"{max(ms['other']):.3f})", flush=True)


def phase_fuse(params, card):
    """Local fusion at bench.py's operating point (bench.py:59-84: K=16, 48
    frames, uint16 staging, tsdf_every=4):
    (a) throughput as bench.py takes it (a warm-up batch, then 3 passes over
        fresh maps, each timing integrate_batches(batches[1:])); the table
        must equal sequential integrate_batch calls' bit for bit;
    (b) auto widths: no overflow, the explicit-width table within 2e-3
        (tests/test_auto_widths.py:100-105); then width_margin=0.05
        overflows, widens and keeps the features finite;
    (c) each fuse option against the default fuse of the same K=16 batch,
        with its seg-reduce launches and peak device memory; the per-frame
        routes also against their float64-cumsum copies;
    (d) the stage-1 sort of one K=16 batch timed in its two bit-identical
        formulations: the package's, and the JAX package's
        fuse_sort1_gather one, which the port does not keep.
    Every check runs; the phase fails at its end if any failed."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import fusion
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.datasets import get_dataset
    from bnv_fusion_tpu_torch.kernels import _build
    from bnv_fusion_tpu_torch.pipeline import NeuralMap

    ds = get_dataset(load_config(E2E_OVERRIDES), "val")
    frames = [ds[i] for i in range(len(ds))]
    batches = [frames[i:i + 16] for i in range(0, len(frames) - 15, 16)]
    n_timed = sum(len(b) for b in batches[1:])
    failed = []

    def new_map(extra=()):
        return NeuralMap(ds.dimensions,
                         load_config(E2E_OVERRIDES + list(extra)), params)

    def check(what, fn):
        try:
            return fn()
        except AssertionError as e:
            failed.append(what)
            print(f"  FAILED {what}: {e}", flush=True)

    # (a) throughput; integrate_batches == sequential integrate_batch
    warm = new_map()
    warm.integrate_batch(batches[0])
    torch.cuda.synchronize()
    del warm
    fps = []
    for _ in range(3):
        nm = new_map()
        nm.integrate_batch(batches[0])
        torch.cuda.synchronize()
        t0 = time.time()
        nm.integrate_batches(batches[1:])
        torch.cuda.synchronize()
        fps.append(n_timed / (time.time() - t0))
    v = sorted(fps)
    print(f"  fuse throughput via integrate_batches: passes "
          f"{', '.join(f'{x:.2f}' for x in v)} frames/s; best {v[-1]:.2f}, "
          f"median {v[1]:.2f}, spread {v[-1] - v[0]:.2f} ({n_timed} frames, "
          f"K=16); {card}", flush=True)
    if nm.overflow:
        failed.append("integrate_batches overflow")
        print(f"  FAILED integrate_batches: table overflow {nm.overflow}",
              flush=True)
    staged = table_by_key(nm)
    seq = new_map()
    for b in batches:
        seq.integrate_batch(b)
    seq = table_by_key(seq)
    check("integrate_batches == sequential", lambda: same_table(
        "integrate_batches vs sequential integrate_batch", staged, seq))
    print(f"  integrate_batches table == sequential integrate_batch table, "
          f"bit for bit by key ({len(seq[0])} voxels)", flush=True)
    del seq, nm

    # (b) auto widths against the explicit ones (staged: all 48 frames)
    auto = ["model.max_unique_per_frame=auto",
            "model.max_unique_cells_per_frame=auto"]
    nm = new_map(auto)
    _build.LAUNCHES.clear()
    nm.integrate_batches(batches)
    nm._note_overflow(flush=True)
    n_seg = _build.LAUNCHES["seg_reduce_sorted"]
    n_enc = _build.LAUNCHES["fused_encode"]
    print(f"  auto widths: probed max_unique_per_frame={nm._widths[0]}, "
          f"cells={nm._widths[1]} (explicit 116736, 65536); overflow "
          f"{nm.overflow}; {n_seg} seg_reduce and {n_enc} fused_encode "
          f"launches for {len(batches)} batches", flush=True)
    if nm.overflow:
        failed.append("auto widths overflow")
    if n_enc != len(batches):
        failed.append("fused_encode launches per K=16 update")
        print(f"  FAILED fused_encode launched {n_enc} times for "
              f"{len(batches)} K=16 updates", flush=True)
    err = check("auto == explicit", lambda: same_table(
        "auto widths vs explicit", table_by_key(nm), staged, atol=2e-3))
    print(f"  auto-width table vs explicit: keys, weights, hits exact, "
          f"features max abs diff {err}", flush=True)
    del nm, staged
    nm = new_map(auto + ["model.width_margin=0.05"])
    nm.integrate_batch(batches[0])
    first = nm._widths
    nm.integrate_batches(batches[1:])
    nm._note_overflow(flush=True)
    widened = nm._widths
    nm.integrate_batch(batches[1])
    nm._note_overflow(flush=True)
    n = int(nm.table.n_alloc)
    finite = bool(torch.isfinite(nm.table.features[:n]).all())
    print(f"  width_margin=0.05: widths {first} -> {widened} -> "
          f"{nm._widths}, overflow seen {nm._overflow_seen}, features "
          f"finite {finite}", flush=True)
    if not (nm._overflow_seen > 0 and widened[0] > first[0] and finite):
        failed.append("width_margin=0.05 widen")
    del nm

    # (c) options against the default fuse of batches[1]
    cumsum = fusion._cumsum_rows

    def option(extra, batch=batches[1], float64=False):
        """The table after fusing ``batch``, its seg-reduce launches, peak
        GiB and overflow; ``float64``: the cumsum fronts and the table's
        features in float64 (the route without its cumsum's rounding)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        nm = new_map(extra)
        if float64:
            nm.table.features = nm.table.features.double()
            fusion._cumsum_rows = lambda x: cumsum(x.double())
        try:
            nm.integrate_batch(batch)
        finally:
            fusion._cumsum_rows = cumsum
        torch.cuda.synchronize()
        out = (table_by_key(nm), _build.LAUNCHES["seg_reduce_sorted"],
               torch.cuda.max_memory_allocated() / 2**30, nm.overflow)
        launched["fused_encode"] = _build.LAUNCHES["fused_encode"]
        del nm
        return out

    # fused_encode launches per K-frame update: one per front chunk of
    # the K-merged front, none on the per-frame fronts
    launched = {}
    want_enc = {"": 1, "fuse_sort1_gather=true": 1, "fuse_front_chunks=2": 2,
                "fuse_dtype=bfloat16": 1, "fuse_batch_merge=false": 0,
                "fuse_algorithm=corner": 0}

    def count_encode(name):
        n_enc = launched["fused_encode"]
        print(f"  {name or 'default'}: {n_enc} fused_encode launches",
              flush=True)
        if n_enc != want_enc[name]:
            failed.append(f"{name or 'default'} fused_encode launches")
            print(f"  FAILED {name or 'default'}: fused_encode launched "
                  f"{n_enc} times, want {want_enc[name]}", flush=True)

    base, n_base, peak16, _ = option([])
    print(f"  default fuse, K=16: {n_base} seg_reduce launches, peak "
          f"{peak16:.2f} GiB", flush=True)
    count_encode("")
    for name, tol in (("fuse_sort1_gather=true", None),
                      ("fuse_front_chunks=2", None),
                      ("fuse_dtype=bfloat16", (0.02, 0.02))):
        t, n_seg, peak, ovf = option([f"model.{name}"])
        count_encode(name)
        err = check(name, lambda: same_table(name, t, base,
                                             *(tol or (None,))))
        if name == "fuse_dtype=bfloat16" and np.array_equal(t[1], base[1]):
            failed.append(name)
            print(f"  FAILED {name}: features equal the float32 fuse's",
                  flush=True)
        print(f"  {name}: {n_seg} seg_reduce launches, peak {peak:.2f} GiB, "
              f"overflow {ovf}; vs the default: keys, weights, hits exact, "
              f"features max abs diff {err} "
              f"({'bit for bit' if tol is None else f'tolerance {tol}'})",
              flush=True)
    # the per-frame routes' references: the kernel front with an exact-f32
    # stage 2, and the merged route on the per-frame cumsum front (the
    # unmerged route's own front)
    exact = option(["model.fuse_sort_bf16=false"])[0]
    front = option(["model.use_seg_reduce_kernel=false"])[0]
    for name in ("fuse_batch_merge=false", "fuse_algorithm=corner"):
        t, n_seg, peak, ovf = option([f"model.{name}"])
        count_encode(name)
        t64 = option([f"model.{name}"], float64=True)[0]
        e64 = check(f"{name} float64 copy", lambda: same_table(
            f"{name} with a float64 cumsum vs the kernel front", t64, exact,
            WITNESS_ATOL))
        e32 = check(f"{name} vs its float64 copy", lambda: same_table(
            f"{name} vs its float64-cumsum copy", t, t64, CUMSUM_ATOL))
        err = check(name, lambda: same_table(
            f"{name} vs the kernel front", t, exact, CUMSUM_ATOL))
        print(f"  {name}: {n_seg} seg_reduce launches, peak {peak:.2f} GiB, "
              f"overflow {ovf}; keys, weights, hits exact against the "
              f"default with fuse_sort_bf16=false; features max abs diff: "
              f"its float64-cumsum copy vs the kernel front {e64} "
              f"(tolerance {WITNESS_ATOL}), the route vs its float64 copy "
              f"{e32} and vs the kernel front {err} (tolerance "
              f"{CUMSUM_ATOL})", flush=True)
        if name == "fuse_batch_merge=false":
            err = check(f"{name} vs the same front", lambda: same_table(
                f"{name} vs the merged route on the per-frame front", t,
                front, ROUTE_ATOL))
            print(f"  {name} vs the merged route on the same per-frame "
                  f"front (use_seg_reduce_kernel=false): features max abs "
                  f"diff {err} (tolerance {ROUTE_ATOL})", flush=True)
        del t, t64
    del base, exact, front
    big = {}
    for chunks in (2, 1):
        t, n_seg, peak, ovf = option(["model.integrate_batch_size=32",
                                      f"model.fuse_front_chunks={chunks}"],
                                     frames[:32])
        big[chunks] = t
        if launched["fused_encode"] != chunks:
            failed.append(f"K=32 fuse_front_chunks={chunks} fused_encode "
                          "launches")
        print(f"  K=32, fuse_front_chunks={chunks}: {n_seg} seg_reduce "
              f"and {launched['fused_encode']} fused_encode "
              f"launches, peak {peak:.2f} GiB (K=16, 1 chunk: "
              f"{peak16:.2f} GiB), overflow {ovf}", flush=True)
    check("K=32 chunks", lambda: same_table(
        "K=32: front_chunks=2 vs 1", big[2], big[1]))
    del big
    check("stage-1 sort", lambda: time_sort1(new_map(), batches[1]))
    if failed:
        raise AssertionError(f"fuse checks failed: {', '.join(failed)}")


def options_run(tmp, params):
    """run_e2e at OPTIONS_OVERRIDES with the launch counts zeroed just
    before and read just after; checks the run's outputs.  Returns the
    run's output dict."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import run_e2e
    from bnv_fusion_tpu_torch.datasets.synth_scene import procedural_albedo
    from bnv_fusion_tpu_torch.kernels import _build

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    out = run_e2e.run(OPTIONS_OVERRIDES + [f"output_dir={tmp}"], params=params)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    nmap, wd = out["nmap"], out["working_dir"]
    print(f"  launches in the options run: {launches}", flush=True)
    for name in ("seg_reduce_sorted", "fused_corner_decode"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"the options run never launched {name}")
    if nmap.overflow != 0:
        raise AssertionError(f"options run table overflow {nmap.overflow}")
    ceiling = out["global_steps"]
    group = int(nmap.config.model.optim_iters_per_launch)
    n_it = nmap.last_optimize_iters
    losses = np.asarray(nmap.optimize_losses, np.float64)
    if not (n_it <= ceiling and (n_it == ceiling or n_it % group == 0)):
        raise AssertionError(f"early stop ran {n_it} iterations (ceiling "
                             f"{ceiling}, group {group})")
    if len(losses) != n_it or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{len(losses)} optimize losses for {n_it} "
                             f"iterations, finite {np.isfinite(losses).all()}")
    head, n_v, n_f = read_ply_header(os.path.join(wd, "final.ply"))
    if "binary_little_endian" not in head or n_v <= 0 or n_f <= 0 or not all(
            f"property uchar {c}" in head for c in ("red", "green", "blue")):
        raise AssertionError(f"final.ply is not a non-empty binary PLY with "
                             f"uchar colours ({n_v} vertices, {n_f} faces)")
    final = out["final"]
    col = final.colors.astype(np.float32)
    if not col.std() > 10:
        raise AssertionError(f"vertex colours nearly constant (std "
                             f"{col.std():.2f})")
    maps = list(nmap.error_maps.values())
    shapes = {tuple(m.shape) for m in maps}
    moved = float(np.mean([(m != 1.0).float().mean().item() for m in maps]))
    tm = nmap.timer.times
    print(f"  optimize: {n_it} of {ceiling} iterations (early stop, group "
          f"{group}), {tm['global'] / max(n_it, 1):.4f} s/iter, loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}", flush=True)
    print(f"  error maps: {len(maps)} of {len(nmap.frames)} frames, shape "
          f"{sorted(shapes)}, {moved:.1%} of their patches moved from 1",
          flush=True)
    err = np.abs(col - procedural_albedo(final.vertices)).mean()
    print(f"  final.ply: {n_v} vertices, {n_f} faces, uchar colours (std "
          f"{col.std():.1f}); mean |colour - procedural_albedo| {err:.1f} "
          f"(untrained weights, information only)", flush=True)
    return out


def check_early_stop():
    """tests/test_optim_schedule.py:40-51 on the card: a one-frame map,
    optimize(64, lr=0) at patience 2 stops at 4 launch groups."""
    import numpy as np
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.nn import init_model
    from bnv_fusion_tpu_torch.pipeline import NeuralMap

    cfg = load_config(["model.voxel_size=0.05", "dataset.num_pixels=128",
                       "model.train_ray_splits=64",
                       "model.table_capacity=16384", "model.min_pts_in_grid=1",
                       "trainer.optim_early_stop=true",
                       "trainer.optim_es_patience=2"])
    rng = np.random.RandomState(7)
    h, w = 48, 64
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [0, 0, -1.2]
    frame = {"depth": (1.0 + 0.3 * rng.rand(h, w)).astype(np.float32),
             "T_wc": T_wc, "frame_id": 0,
             "intr_mat": np.array([[60.0, 0, w / 2], [0, 60.0, h / 2],
                                   [0, 0, 1]], np.float32)}
    nm = NeuralMap(np.array([2.0, 2.0, 2.0], np.float32), cfg,
                   init_model(0, bias_std=BIAS_STD))
    nm.integrate(frame)
    nm.optimize(64, lr=0.0)
    group = int(cfg.model.optim_iters_per_launch)
    if nm.last_optimize_iters != 4 * group or \
            len(nm.optimize_losses) != 4 * group:
        raise AssertionError(f"lr=0, patience 2: stopped at "
                             f"{nm.last_optimize_iters}, not {4 * group}")
    print(f"  early stop at lr=0, patience 2: {nm.last_optimize_iters} "
          f"iterations of 64 (4 groups of {group})", flush=True)


def check_optim_dtype(nmap):
    """One optimize step in float32 and in bfloat16 on the same injected
    pixel ids and uniforms: losses within OPTIM_DTYPE_RTOL; each step held
    against the same step of the plain port on the CPU (bf16: loss within
    OPTIM_CPU_RTOL, first moments as often close as f32's, within
    OPTIM_CPU_MU_SLACK); then 16 steps each way timed (information)."""
    import torch
    from bnv_fusion_tpu_torch import optimize, render, tsdf

    # the plain (uniform-ray) step, so both dtypes draw the same pixels;
    # the CPU steps are built from a CPU copy of the weights
    m = nmap.config.model
    keep = (m.optim_dtype, m.error_guided_sampling, nmap.params)
    cpu = torch.device("cpu")
    steps, cpu_steps = {}, {}
    try:
        m.error_guided_sampling = False
        for dt in ("float32", "bfloat16"):
            m.optim_dtype = dt
            nmap.params = keep[2]
            steps[dt] = nmap.make_optim_step(1e-3)
            nmap.params = tree_to(keep[2], device=cpu)
            cpu_steps[dt] = nmap.make_optim_step(1e-3)
    finally:
        m.optim_dtype, m.error_guided_sampling, nmap.params = keep
    g = torch.Generator().manual_seed(3)
    f = nmap.frames[len(nmap.frames) // 2]
    h, w = f["depth"].shape
    ids = torch.randperm(h * w, generator=g)[:nmap.sampling_size]
    nf = nmap.truncated_units * 2
    nc = int(nmap.ray_max_dist * 5)
    uni = [render.draw_sampling_uniforms(g, nmap.train_ray_splits, nf, nc,
                                         nmap.device)
           for _ in range(nmap.sampling_size // nmap.train_ray_splits)]
    sdf_delta = tsdf.prepare_sdf_delta(nmap.tsdf_vol, nmap.tsdf_voxel_size,
                                       nmap.truncated_dist,
                                       nmap.sdf_delta_weight)
    loss, mu = {}, {}
    for dt, step in steps.items():
        st = optimize.init_optim_state(nmap.table)
        loss[dt] = float(step(st, nmap.table, f["depth"], f["T_wc"],
                              f["intr"], nmap.bound_min, nmap.n_xyz,
                              sdf_delta, pixel_ids=ids, uniforms=uni)[1])
        mu[dt] = st.mu.cpu().numpy()
        del st
    rel = abs(loss["bfloat16"] - loss["float32"]) / abs(loss["float32"])
    if not rel <= OPTIM_DTYPE_RTOL or loss["bfloat16"] == loss["float32"]:
        raise AssertionError(f"one optimize step: bf16 loss "
                             f"{loss['bfloat16']} vs f32 {loss['float32']} "
                             f"(rel {rel:.2e})")
    ctable = table_on(nmap.table, cpu)
    cargs = (ctable, f["depth"].cpu(), f["T_wc"].cpu(), f["intr"].cpu(),
             nmap.bound_min.cpu(), nmap.n_xyz, sdf_delta.cpu())
    cuni = [tuple(u.cpu() for u in us) for us in uni]
    on_cpu = {}
    for dt, step in cpu_steps.items():
        st = optimize.init_optim_state(ctable)
        t0 = time.time()
        c_loss = float(step(st, *cargs, pixel_ids=ids.cpu(),
                            uniforms=cuni)[1])
        on_cpu[dt] = (abs(loss[dt] - c_loss) / abs(c_loss),
                      close_share(mu[dt], st.mu.numpy(), OPTIM_CPU_MU_RTOL),
                      time.time() - t0)
        del st
    del ctable, mu
    print("  optim step, card against the plain port on the CPU: "
          + "; ".join(f"{dt} loss rel {r:.2e}, first moment within "
                      f"{OPTIM_CPU_MU_RTOL} on {sh:.2%} ({sec:.1f} s on the "
                      f"CPU)" for dt, (r, sh, sec) in on_cpu.items()),
          flush=True)
    r, sh, _ = on_cpu["bfloat16"]
    floor = on_cpu["float32"][1] - OPTIM_CPU_MU_SLACK
    if not (r <= OPTIM_CPU_RTOL and sh >= floor):
        raise AssertionError(f"bf16 step on the card vs the CPU: loss rel "
                             f"{r:.2e} (tol {OPTIM_CPU_RTOL}), moments close "
                             f"{sh:.2%} (at least {floor:.2%})")
    secs = {}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        st = optimize.init_optim_state(nmap.table)
        torch.cuda.synchronize()
        t0 = time.time()
        for i in range(OPTIM_DTYPE_ITERS // 2):
            fr = nmap.frames[(7 * i) % len(nmap.frames)]
            steps[dt](st, nmap.table, fr["depth"], fr["T_wc"], fr["intr"],
                      nmap.bound_min, nmap.n_xyz, sdf_delta,
                      generator=nmap.generator)
        torch.cuda.synchronize()
        secs[dt] = secs.get(dt, 0.0) + time.time() - t0
    print(f"  optim_dtype: one step's loss f32 {loss['float32']:.6f}, bf16 "
          f"{loss['bfloat16']:.6f} (rel {rel:.2e}, tolerance "
          f"{OPTIM_DTYPE_RTOL}); {OPTIM_DTYPE_ITERS} steps each way (f32, "
          f"bf16, bf16, f32 halves): f32 "
          f"{secs['float32'] / OPTIM_DTYPE_ITERS:.4f} s/iter, bf16 "
          f"{secs['bfloat16'] / OPTIM_DTYPE_ITERS:.4f} s/iter (information;"
          f" operands rounded, products in f32)", flush=True)


def check_decode_layouts(nmap):
    """decode_points rows-plain, fm-plain and fused on 2^18 points drawn
    from the final map's mesh lattice: fm within FM_ATOL of rows, the
    fused decode within DECODE_ATOL, each timed; then extract_mesh with
    mesh_decode_layout=fm and the kernel off against rows: face and vertex
    counts within MESH_COUNT_RTOL."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import fusion, mesh as mesh_mod, tables as tbl
    from bnv_fusion_tpu_torch import tsdf
    from bnv_fusion_tpu_torch.kernels import _build
    from bnv_fusion_tpu_torch.kernels.fused_decode import pack_decoder_tc

    keys, _, weights, hits, _ = tbl.active_entries(nmap.table,
                                                   with_features=False)
    active = keys[nmap._mesh_weights(weights, hits) >= nmap.min_pts_in_grid]
    scale = int(nmap.config.model.mesh_lattice_scale)
    points = mesh_mod.build_sample_lattice(active.astype(np.int32), scale)[0]
    # a seeded sample over the whole lattice, in voxel coordinates (the
    # lattice's integer points are in units of voxel / scale)
    sel = np.random.RandomState(0).choice(
        len(points), min(DEC_ROWS // 8, len(points)), replace=False)
    pts = torch.as_tensor(points[np.sort(sel)].astype(np.float32) / scale,
                          device=nmap.device)
    delta = tsdf.prepare_sdf_delta(nmap.tsdf_vol, nmap.tsdf_voxel_size,
                                   nmap.truncated_dist, nmap.sdf_delta_weight)
    packed = pack_decoder_tc(nmap.params["decoder"])

    def dec(layout, fused):
        with torch.no_grad():
            return fusion.decode_points(
                nmap.table.features, nmap.table, nmap.params, pts,
                nmap.bound_min, nmap.voxel_size, nmap.min_pts_in_grid,
                sdf_delta=delta, n_xyz=nmap.n_xyz, is_coords=True,
                use_fused_kernel=fused, masked_fill=float("nan"),
                layout=layout, packed_decoder=packed if fused else None)

    rows, fm, fused = dec("rows", False), dec("fm", False), dec("rows", True)
    live = torch.isfinite(rows)
    if not bool(live.any()):
        raise AssertionError("no unmasked point among the decoded lattice")
    if not (torch.equal(live, torch.isfinite(fm)) and
            torch.equal(live, torch.isfinite(fused))):
        raise AssertionError("the three decodes mask different points")
    e_fm = float((fm - rows)[live].abs().max())
    e_fused = float((fused - rows)[live].abs().max())
    if not (e_fm <= FM_ATOL and e_fused <= DECODE_ATOL):
        raise AssertionError(f"decode layouts: fm vs rows {e_fm:.3e} (tol "
                             f"{FM_ATOL}), fused vs rows {e_fused:.3e} (tol "
                             f"{DECODE_ATOL})")
    ms = {k: median_ms(lambda: dec(*a)) for k, a in (
        ("rows", ("rows", False)), ("fm", ("fm", False)),
        ("fused", ("rows", True)))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dec("fm", False)
    torch.cuda.synchronize()
    peak_fm = torch.cuda.max_memory_allocated() / 2**30
    print(f"  decode of {pts.shape[0]} lattice points ({int(live.sum())} "
          f"unmasked): rows {ms['rows']:.3f} ms, fm {ms['fm']:.3f} ms (peak "
          f"{peak_fm:.2f} GiB), fused {ms['fused']:.3f} ms; max abs diff to "
          f"rows: fm {e_fm:.2e}, fused {e_fused:.2e}", flush=True)

    m = nmap.config.model
    keep = (m.use_fused_decode_kernel, m.mesh_decode_layout)
    meshes, secs = {}, {}
    try:
        m.use_fused_decode_kernel = False
        for layout in ("fm", "rows"):
            m.mesh_decode_layout = layout
            _build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.time()
            meshes[layout] = nmap.extract_mesh()
            secs[layout] = time.time() - t0
            if _build.LAUNCHES["fused_corner_decode"]:
                raise AssertionError("the plain mesh decode launched the "
                                     "kernel")
    finally:
        m.use_fused_decode_kernel, m.mesh_decode_layout = keep
    counts = {k: (len(v.faces), len(v.vertices)) for k, v in meshes.items()}
    for i, what in ((0, "faces"), (1, "vertices")):
        a, b = counts["fm"][i], counts["rows"][i]
        if not abs(a - b) <= MESH_COUNT_RTOL * b:
            raise AssertionError(f"mesh_decode_layout=fm: {a} {what} vs "
                                 f"rows {b}")
    print(f"  extract_mesh, kernel off: mesh_decode_layout=fm "
          f"{counts['fm'][0]} faces / {counts['fm'][1]} vertices in "
          f"{secs['fm']:.3f} s, rows {counts['rows'][0]} / "
          f"{counts['rows'][1]} in {secs['rows']:.3f} s", flush=True)


def check_sdf_gradient(nmap, final):
    """fusion.sdf_gradient at up to 2^16 final-mesh vertices, with the
    mesh's prior: finite, unit norm within 1e-3 where every corner has
    weight; unnormalized, within SDF_GRAD_FD_RTOL of a float64 forward
    difference of the plain rows decode on SDF_GRAD_FD_SHARE of the unmasked
    points; the share aligned with the mesh's area-weighted vertex normals
    is printed."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import fusion, tsdf

    v = final.vertices[:SDF_GRAD_POINTS]
    pts = torch.as_tensor(v, device=nmap.device)
    delta = tsdf.prepare_sdf_delta(nmap.tsdf_vol, nmap.tsdf_voxel_size,
                                   nmap.truncated_dist, nmap.sdf_delta_weight)
    torch.cuda.synchronize()
    t0 = time.time()
    g = fusion.sdf_gradient(nmap.table.features, nmap.table, nmap.params,
                            pts, nmap.bound_min, nmap.voxel_size,
                            nmap.min_pts_in_grid, sdf_delta=delta,
                            n_xyz=nmap.n_xyz)
    torch.cuda.synchronize()
    secs = time.time() - t0
    prep = fusion.decode_prepare(nmap.table, pts, nmap.bound_min,
                                 nmap.voxel_size)
    live = (torch.amin(prep.w, dim=-1) >= nmap.min_pts_in_grid).cpu().numpy()
    g = g.cpu().numpy()
    if not np.isfinite(g).all():
        raise AssertionError("sdf_gradient: non-finite gradients")
    norm = np.linalg.norm(g[live], axis=-1)
    if not (live.any() and np.abs(norm - 1.0).max() <= 1e-3):
        raise AssertionError(f"sdf_gradient: {int(live.sum())} unmasked, "
                             f"norms {norm.min() if live.any() else 0:.4f}-"
                             f"{norm.max() if live.any() else 0:.4f}")
    # against a float64 forward difference of the plain rows decode, at the
    # vertices moved by 1e-3 voxel along (1, 1, 1): the lattice puts many
    # vertices on a cell face, where the gradient is one-sided and the side
    # follows the rounding of the coordinate, which differs between float32
    # and float64
    q = pts + 1e-3 * nmap.voxel_size
    gq = fusion.sdf_gradient(nmap.table.features, nmap.table, nmap.params,
                             q, nmap.bound_min, nmap.voxel_size,
                             nmap.min_pts_in_grid, normalize=False,
                             sdf_delta=delta, n_xyz=nmap.n_xyz)
    t64 = table_on(nmap.table, nmap.device, torch.float64)
    p64 = tree_to(nmap.params, dtype=torch.float64)

    def sdf64(x):
        with torch.no_grad():
            return fusion.decode_points(
                t64.features, t64, p64, x, nmap.bound_min.double(),
                nmap.voxel_size, nmap.min_pts_in_grid,
                sdf_delta=delta.double(), n_xyz=nmap.n_xyz,
                masked_fill=float("nan"))

    q64 = q.double()
    s0 = sdf64(q64)
    fd = torch.empty_like(q64)
    for k in range(3):
        qk = q64.clone()
        qk[:, k] += SDF_GRAD_FD_STEP
        fd[:, k] = (sdf64(qk) - s0) / (qk[:, k] - q64[:, k])
    del t64
    fd = fd.cpu().numpy()
    gq = gq.double().cpu().numpy()
    ok = np.isfinite(fd).all(-1)
    err = (np.linalg.norm(gq[ok] - fd[ok], axis=-1)
           / np.maximum(np.linalg.norm(fd[ok], axis=-1), 1e-12))
    share = float((err <= SDF_GRAD_FD_RTOL).mean()) if ok.any() else 0.0
    q50, q99 = (np.quantile(err, [0.5, 0.99]) if ok.any() else (0, 0))
    print(f"  sdf_gradient vs a float64 forward difference (step "
          f"{SDF_GRAD_FD_STEP} m) at {int(ok.sum())} unmasked points: "
          f"relative error median {q50:.1e}, 99th percentile {q99:.1e}, "
          f"within {SDF_GRAD_FD_RTOL} at {share:.2%}", flush=True)
    if not share >= SDF_GRAD_FD_SHARE:
        raise AssertionError(f"sdf_gradient vs the forward difference: "
                             f"{share:.2%} within {SDF_GRAD_FD_RTOL} (at "
                             f"least {SDF_GRAD_FD_SHARE:.0%})")
    # area-weighted vertex normals of the final mesh
    f = final.faces
    fn = np.cross(final.vertices[f[:, 1]] - final.vertices[f[:, 0]],
                  final.vertices[f[:, 2]] - final.vertices[f[:, 0]])
    vn = np.zeros_like(final.vertices)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    vn = vn[:len(v)]
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    cos = np.abs(np.sum(vn * g, axis=-1))
    print(f"  sdf_gradient at {len(v)} final-mesh vertices in {secs:.3f} s: "
          f"finite, {int(live.sum())} unmasked with unit norm (max dev "
          f"{np.abs(norm - 1.0).max():.1e}); |cos| > 0.9 to the mesh's "
          f"vertex normal at {(cos[live] > 0.9).mean():.1%} of them "
          f"(information)", flush=True)


def phase_options(tmp, params):
    """The model and trainer options of the dense path: the options run,
    then the early-stop, optim_dtype, decode-layout and sdf_gradient
    checks on the card."""
    out = options_run(tmp, params)
    nmap = out["nmap"]
    check_early_stop()
    check_optim_dtype(nmap)
    check_decode_layouts(nmap)
    check_sdf_gradient(nmap, out["final"])


# the bigscene phase: profiling/profile_bigscene.py's scene (:35-48), 14 x
# 14 x 4 m at voxel 0.01 = 1402 x 1402 x 402 = 790.2M voxels, which routes
# the table to blocks and the prior (562 x 562 x 162 at 0.025) to the
# block-major volume; the e2e phase's 48 frames in its canonical layout
BIG_DIMS = (14.0, 14.0, 4.0)
# the prior through integrate_blocks against the dense windowed integrate:
# sdf within BIG_PRIOR_ATOL on all but BIG_EDGE_SHARE of the voxels (a voxel
# that projects within float noise of a pixel's edge can sample the other
# pixel in the two layouts' differently shaped products; the CPU tests'
# bound, tests/test_torch_tsdf_blocks.py)
BIG_PRIOR_ATOL = 1e-6
BIG_EDGE_SHARE = 1e-3
# the hash table at profiling/probe_hash_table.py's point (2^17 keys drawn
# from [0, 200)^3 into 2^19 slots), and one 480x640 frame fused into 2^21
# slots against the dense table's kernel front (direct sums on both sides;
# the hash path's scatter-adds sum in no fixed order)
HASH_KEYS, HASH_SLOTS = 1 << 17, 1 << 19
HASH_FUSE_SLOTS = 1 << 21
HASH_FUSE_ATOL = 1e-5
HASH_REPS = 5


def live_by_key(table):
    """(keys, features, weights, hits) of a table's entries carrying state,
    sorted by key."""
    import numpy as np
    from bnv_fusion_tpu_torch import tables as tbl

    keys, feats, w, h, _ = tbl.active_entries(table)
    live = (w > 0) | (h > 0)
    order = np.lexsort(keys[live].T[::-1])
    return tuple(a[live][order] for a in (keys, feats, w, h))


def probe_rounds(keys, slots, found, capacity: int) -> int:
    """Probe rounds the insert needed: the largest i with slot = (h0 + i *
    stride) mod capacity over the found keys, plus one (the odd stride is
    inverted mod the power-of-two capacity by Newton steps)."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import table as hash_table

    k = torch.as_tensor(keys)
    h0 = hash_table._hash_coords(k, capacity).numpy()
    s = hash_table._probe_stride(k, capacity).numpy()
    inv = s.copy()
    for _ in range(5):
        inv = (inv * (2 - s * inv)) % capacity
    i = ((np.asarray(slots) - h0) % capacity) * inv % capacity
    return int(i[np.asarray(found)].max()) + 1


def phase_bigscene(tmp, params, card):
    """The big-scene layouts on the card: run_inference --mode e2e on the
    790M-voxel scene, the block table and block-major prior against the
    dense ones at that size, and the hash table against the CPU port."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import fusion, run_e2e, table_dense, tsdf
    from bnv_fusion_tpu_torch import table as hash_table
    from bnv_fusion_tpu_torch import tables as tbl
    from bnv_fusion_tpu_torch import voxel as vx
    from bnv_fusion_tpu_torch.checkpoint import save_state
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.datasets import get_dataset
    from bnv_fusion_tpu_torch.kernels import _build
    from bnv_fusion_tpu_torch.pipeline import _frame_points
    from bnv_fusion_tpu_torch.scripts import run_inference
    from bnv_fusion_tpu_torch.scripts import generate_fusion_data as gen
    from bnv_fusion_tpu_torch.table_blocks import BlockIndexedTable

    def step(msg, t0):
        print(f"  {msg} ({time.time() - t0:.1f} s; {card})", flush=True)

    # 1. the e2e phase's frames in the canonical layout, dimensions 14 14 4
    t0 = time.time()
    os.makedirs(tmp, exist_ok=True)
    weights = os.path.join(tmp, "weights.npz")
    save_state(weights, {"params": {
        n: {k: v.detach().cpu().numpy() for k, v in p.items()}
        for n, p in params.items()}})
    synth_cfg = load_config(E2E_OVERRIDES)
    synth = get_dataset(synth_cfg, "val")
    canon = os.path.join(tmp, "canon")
    gen.write_canonical(
        os.path.join(canon, "scene"),
        [(None, f["depth_raw"], f["T_wc"], f["intr_mat"])
         for f in (synth[i] for i in range(len(synth)))],
        np.asarray(BIG_DIMS, np.float32))
    step(f"{len(synth)} frames written in the canonical layout, "
         f"dimensions {BIG_DIMS}", t0)

    # 2. run_inference --mode e2e at the e2e phase's overrides
    out_dir = os.path.join(tmp, "run")
    extra = ["dataset.skip_images=1"] + E2E_OVERRIDES + [
        f"model.ray_tracer.ray_max_dist="
        f"{synth_cfg.model.ray_tracer.ray_max_dist}",
        f"output_dir={out_dir}"]
    results, undo = recording(run_e2e)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    t0 = time.time()
    try:
        rc = run_inference.main([
            "scene3d", "--seqs", "scene", "--checkpoint", weights,
            "--data_dir", canon, "--min_pts_in_grid",
            str(synth_cfg.model.min_pts_in_grid), "--mode", "e2e",
            "--extra"] + extra)
    finally:
        undo()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if rc != 0 or len(results) != 1:
        raise AssertionError(f"run_inference --mode e2e rc {rc}")
    res = results[0][1]
    nmap = res["nmap"]
    table, vol = nmap.table, nmap.tsdf_vol
    print(f"  grid {nmap.n_xyz} = {table.n_voxels / 1e6:.1f}M voxels: "
          f"{type(table).__name__}, prior {type(vol).__name__}", flush=True)
    if not isinstance(table, BlockIndexedTable) or \
            not isinstance(vol, tsdf.TSDFVolumeBM):
        raise AssertionError("the 790M-voxel scene did not route to the "
                             "block table and the block-major prior")
    # two seg-reduce launches per K-batch
    k = int(nmap.config.model.integrate_batch_size)
    print(f"  launches in the bigscene run: {launches}", flush=True)
    if launches.get("seg_reduce_sorted", 0) != \
            2 * -(-len(nmap.frames) // k) or \
            launches.get("fused_corner_decode", 0) <= 0:
        raise AssertionError(f"bigscene launches {launches}")
    losses = np.asarray(nmap.optimize_losses, np.float64)
    if nmap.overflow != 0 or int(vol.overflow) != 0 or \
            not np.all(np.isfinite(losses)) or \
            len(losses) != res["global_steps"]:
        raise AssertionError(f"bigscene: table overflow {nmap.overflow}, "
                             f"prior overflow {int(vol.overflow)}, losses "
                             f"{losses}")
    final_path = os.path.join(out_dir, "run_e2e", "scene", "final.ply")
    head, n_v, n_f = read_ply_header(final_path)
    if "binary_little_endian" not in head or n_v <= 0 or n_f <= 0:
        raise AssertionError(f"bigscene final.ply: {n_v} vertices, {n_f} "
                             "faces")
    tm = nmap.timer.times
    n_frames = len(nmap.frames)
    n_live = int(tbl.occupancy(table))
    print(f"  block table: {table.n_blocks} blocks "
          f"({table.n_blocks * 4 / 1e6:.1f} MB map), {table.capacity} slots "
          f"({table.capacity * (table.feat_dims + 2) * 4 / 1e6:.0f} MB of "
          f"values); {int(table.n_alloc)} blocks allocated, {n_live} live "
          f"voxels; {card}", flush=True)
    print(f"  prior: {vol.vol_dim} voxels in {vol.nb_xyz} blocks of 64 "
          f"({vol.sdf.numel() * 8 / 1e6:.0f} MB); block budget "
          f"{nmap._max_blocks} per frame", flush=True)
    step(f"run_inference --mode e2e: local fusion "
         f"{n_frames / tm['local']:.2f} frames/s ({n_frames} frames in "
         f"{tm['local']:.2f} s), optimize "
         f"{tm['global'] / res['global_steps']:.4f} s/iter, mesh "
         f"{tm['mesh']:.2f} s, peak {peak / 2 ** 30:.2f} GiB, wall "
         f"{wall:.1f} s; final.ply {n_v} vertices, overflow 0/0", t0)

    # 3. the block layouts against the dense ones at this size: the first
    # K=16 batch of the run's own staged frames through the merged fuse
    # into a block table and a dense table of the same grid (a 3.2 GB slot
    # map), and the run's prior frames through both prior layouts
    t0 = time.time()
    cfg = nmap.config.model
    batch = nmap.frames[:16]
    pts = [_frame_points(f["depth"], f["T_wc"], f["intr"]) for f in batch]
    pw, nw, va = (torch.stack([p[j] for p in pts]) for j in range(3))
    del pts
    mu, muc = nmap._width_values()
    fuse_kw = dict(max_unique=mu, max_unique_cells=muc,
                   max_unique_batch=nmap._mu_batch, seg_kernel=True,
                   sort_bf16=bool(getattr(cfg, "fuse_sort_bf16", False)))
    cap = int(getattr(cfg, "table_capacity", 1 << 21))
    tb = tbl.create_table(nmap.feat_dims, cap, n_xyz=nmap.n_xyz,
                          device=nmap.device)
    td = table_dense.create_dense_table(nmap.n_xyz, cap, nmap.feat_dims,
                                        nmap.device)
    for t in (tb, td):
        fusion.fuse_frames_merged(t, nmap.params, pw, nw, va,
                                  nmap.bound_min, nmap.bound_max,
                                  nmap.voxel_size, nmap.min_pts_in_grid,
                                  **fuse_kw)
    if not isinstance(tb, BlockIndexedTable) or tb.overflow or td.overflow:
        raise AssertionError("the K=16 batch: block table not routed or "
                             "overflowed")
    same_table("block table vs dense table", live_by_key(tb),
               live_by_key(td))
    n_cmp = len(live_by_key(tb)[0])
    del tb, td, pw, nw, va
    torch.cuda.empty_cache()
    tvs = nmap.tsdf_voxel_size
    every = int(getattr(cfg, "tsdf_every", 1))
    vb, _ = tsdf.create_tsdf_volume_bm(nmap.dimensions, tvs,
                                       device=nmap.device)
    vd, _ = tsdf.create_tsdf_volume(nmap.dimensions, tvs, device=nmap.device)
    f0 = nmap.frames[0]
    intr0 = f0["intr"].cpu().numpy()
    hw = tuple(f0["depth"].shape)
    mb = tsdf.frustum_max_blocks(intr0, hw, nmap.ray_max_dist, tvs,
                                 vb.nb_xyz)
    window = tsdf.frustum_window_shape(intr0, hw, nmap.ray_max_dist, tvs,
                                       tuple(vd.sdf.shape))
    ms, active = [], []
    for f in nmap.frames[::every]:
        active.append(int(tsdf.frustum_blocks(
            vb, hw, f["intr"], torch.linalg.inv(f["T_wc"]), tvs,
            nmap.ray_max_dist).sum()))
        s_ev = torch.cuda.Event(enable_timing=True)
        e_ev = torch.cuda.Event(enable_timing=True)
        s_ev.record()
        tsdf.integrate_blocks(vb, f["depth"], f["intr"], f["T_wc"], tvs, mb,
                              nmap.ray_max_dist, obs_weight=float(every))
        e_ev.record()
        tsdf.integrate_windowed(vd, f["depth"], f["intr"], f["T_wc"], tvs,
                                window, nmap.ray_max_dist,
                                obs_weight=float(every))
        torch.cuda.synchronize()
        ms.append(s_ev.elapsed_time(e_ev))
    if int(vb.overflow) != 0:
        raise AssertionError(f"integrate_blocks overflow {int(vb.overflow)}")
    w_far = (tsdf.bm_to_dense(vb, "weight") != vd.weight).float().mean()
    d = (tsdf.bm_to_dense(vb, "sdf") - vd.sdf).abs()
    d_far = (d > BIG_PRIOR_ATOL).float().mean()
    if float(w_far) > BIG_EDGE_SHARE or float(d_far) > BIG_EDGE_SHARE:
        raise AssertionError(f"block-major prior vs dense: weights differ on "
                             f"{float(w_far):.2e}, sdf beyond "
                             f"{BIG_PRIOR_ATOL} on {float(d_far):.2e}")
    print(f"  block table == dense table ({table.n_voxels / 1e6:.1f}M-voxel "
          f"grid, K={len(batch)} batch): {n_cmp} live voxels bit for bit",
          flush=True)
    print(f"  integrate_blocks: {np.median(ms):.3f} ms per frame (median of "
          f"{len(ms)}; range {min(ms):.3f}-{max(ms):.3f}), active blocks per "
          f"frame median {int(np.median(active))} max {max(active)} of the "
          f"budget {mb}; vs the dense windowed prior: max |sdf| diff "
          f"{float(d.max()):.3e}, share beyond {BIG_PRIOR_ATOL} "
          f"{float(d_far):.2e}, weights differ on {float(w_far):.2e}; "
          f"{card}", flush=True)
    del vb, vd, d
    torch.cuda.empty_cache()
    step("layouts held against the dense ones", t0)

    # 4. the hash table: probe_hash_table.py's point on the card against
    # the CPU port, slot for slot, both probe strategies; then one frame
    # fused into a hash table against the dense table's kernel front
    t0 = time.time()
    keys = np.random.RandomState(0).randint(0, 200, size=(HASH_KEYS, 3)) \
        .astype(np.int32)
    kd = torch.as_tensor(keys, device=nmap.device)
    ones = torch.ones(HASH_KEYS, dtype=torch.bool, device=nmap.device)
    for unroll in (False, True):
        name = "unrolled" if unroll else "early exit"
        ref = hash_table.create_table(HASH_SLOTS, 8)
        rs, rok = hash_table.insert(ref, torch.as_tensor(keys),
                                    ones.cpu(), unroll=unroll)
        ht = hash_table.create_table(HASH_SLOTS, 8, nmap.device)
        gs, gok = hash_table.insert(ht, kd, ones, unroll=unroll)
        ls, lf = hash_table.lookup(ht, kd, unroll=unroll)
        if not (torch.equal(gs.cpu(), rs) and torch.equal(gok.cpu(), rok) and
                torch.equal(ht.keys.cpu(), ref.keys) and
                torch.equal(ls.cpu(), rs) and bool(lf.all()) and
                int(ht.overflow) == int(ref.overflow) == 0):
            raise AssertionError(f"hash table ({name}): the card's slots "
                                 "differ from the CPU port's")

        def fresh_insert():
            hash_table.insert(hash_table.create_table(HASH_SLOTS, 8,
                                                      nmap.device),
                              kd, ones, unroll=unroll)

        ins_ms = median_ms(fresh_insert, reps=HASH_REPS, warmup=1)
        look_ms = median_ms(lambda: hash_table.lookup(ht, kd, unroll=unroll),
                            reps=HASH_REPS, warmup=1)
        print(f"  hash {name}: {HASH_KEYS} keys ({int(gok.sum())} found, "
              f"{int(hash_table.occupancy(ht))} distinct) into {HASH_SLOTS} "
              f"slots == the CPU port's slot for slot; insert {ins_ms:.3f} "
              f"ms (table creation included), lookup {look_ms:.3f} ms, "
              f"probe rounds {probe_rounds(keys, rs, rok, HASH_SLOTS)}; "
              f"{card}", flush=True)
    smin, smax, sn = vx.get_world_range(synth.dimensions, VOXEL)
    bmin = torch.as_tensor(smin, device=nmap.device)
    bmax = torch.as_tensor(smax, device=nmap.device)
    f = nmap.frames[0]
    pw, nw, va = _frame_points(f["depth"], f["T_wc"], f["intr"])
    ht = tbl.create_table(nmap.feat_dims, HASH_FUSE_SLOTS,
                          device=nmap.device)
    fusion.fuse_frame(ht, nmap.params, pw, nw, va, bmin, bmax, VOXEL,
                      nmap.min_pts_in_grid)
    td = table_dense.create_dense_table(sn, 1 << 21, nmap.feat_dims,
                                        nmap.device)
    fusion.fuse_frames_merged(td, nmap.params, pw[None], nw[None], va[None],
                              bmin, bmax, VOXEL, nmap.min_pts_in_grid,
                              max_unique=mu, max_unique_cells=muc,
                              seg_kernel=True)
    if int(ht.overflow) or int(td.overflow):
        raise AssertionError(f"hash fuse: overflow {int(ht.overflow)} (hash), "
                             f"{int(td.overflow)} (dense)")
    err = same_table("hash fuse_frame vs dense", live_by_key(ht),
                     live_by_key(td), atol=HASH_FUSE_ATOL)
    step(f"hash fuse_frame of one {hw[0]}x{hw[1]} frame into "
         f"{HASH_FUSE_SLOTS} "
         f"slots == the dense table by key ({len(live_by_key(ht)[0])} live "
         f"voxels, features max abs diff {err:.3e})", t0)
    del res, nmap, results


def par_fuse_pass(nm, frames, fuse, times):
    """Fuse ``frames`` into ``nm`` by ``fuse(pts, normals, valid)`` (timed
    per frame with CUDA events into ``times``), and each frame's prior."""
    import torch
    from bnv_fusion_tpu_torch.pipeline import _frame_points

    nm._ensure_window(frames[0])
    for f in frames:
        depth = nm._tensor(f["depth"])
        T_wc, intr = nm._tensor(f["T_wc"]), nm._tensor(f["intr_mat"])
        pts, nrm, valid = _frame_points(depth, T_wc, intr)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fuse(pts, nrm, valid)
        e.record()
        nm._integrate_prior(depth, T_wc, intr)
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))


def par_optimize(nm, group, card):
    """PAR_OPT_ITERS ray-DP iterations against the single-device step on the
    same drawn pixels and uniforms.  Each iteration starts both steps from
    the single step's state (so float noise cannot compound through Adam)
    and holds: the losses within PAR_LOSS_RTOL, the bumped weights equal,
    the gradients (recorded where the Adam update takes them) with at most
    0.5% of the rows beyond 1e-4 * max|g|, and the latents within the
    difference Adam's update makes of the two gradients (float64, from the
    shared moments) plus 2 ulp: tests/test_torch_optimize.py's rules,
    whose slope bound is this difference to first order at the first step.
    Then both run PAR_OPT_ITERS iterations on their own, timed (single, DP,
    DP, single)."""
    import dataclasses

    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import optimize, render, tsdf
    from bnv_fusion_tpu_torch.parallel import dp

    lr = 1e-3
    kw = dict(voxel_size=nm.voxel_size, min_pts_in_grid=nm.min_pts_in_grid,
              truncated_units=nm.truncated_units,
              truncated_dist=nm.truncated_dist, ray_max_dist=nm.ray_max_dist,
              n_rays=nm.sampling_size, train_ray_splits=nm.train_ray_splits,
              lr=lr)
    one = optimize.make_optimize_step(nm.params, parallel_chunks=False, **kw)
    par = dp.make_sharded_optimize_iter(group, nm.params, **kw)
    delta = tsdf.prepare_sdf_delta(nm.tsdf_vol, nm.tsdf_voxel_size,
                                   nm.truncated_dist, nm.sdf_delta_weight)
    g = torch.Generator().manual_seed(11)
    nf, nc = nm.truncated_units * 2, int(nm.ray_max_dist * 5)
    draws = []
    for i in range(PAR_OPT_ITERS):
        f = nm.frames[i % len(nm.frames)]
        pix = torch.randperm(f["depth"].numel(), generator=g)[:nm.sampling_size]
        uni = [render.draw_sampling_uniforms(g, nm.train_ray_splits, nf, nc,
                                             nm.device)
               for _ in range(nm.sampling_size // nm.train_ray_splits)]
        draws.append((f, pix, uni))

    def run(step, state, d):
        f, pix, uni = d
        return step(state, nm.table, f["depth"], f["T_wc"], f["intr"],
                    nm.bound_min, nm.n_xyz, delta, pixel_ids=pix,
                    uniforms=uni, lr_scale=1.0)

    def adam64(s0, grad):
        """optax.adam's update of grad from s0's moments, in float64."""
        t = s0.count + 1
        m = 0.9 * s0.mu.double() + 0.1 * grad
        v = 0.999 * s0.nu.double() + 0.001 * grad * grad
        return -lr * (m / (1 - 0.9 ** t)) / (
            torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8)

    grads = []
    real_adam = optimize._adam_update

    def recording_adam(state, grad, lr_, scale):
        grads.append(grad.double())
        real_adam(state, grad, lr_, scale)

    optimize._adam_update = recording_adam
    rel, rows_off, lat_slack = [], 0, 0.0
    try:
        state = optimize.init_optim_state(nm.table)
        for d in draws:
            s0 = dataclasses.replace(state, **{
                k: getattr(state, k).clone()
                for k in ("features", "weights", "mu", "nu")})
            s_dp = dataclasses.replace(s0, **{
                k: getattr(s0, k).clone()
                for k in ("features", "weights", "mu", "nu")})
            grads.clear()
            state, l1 = run(one, state, d)
            s_dp, l2 = run(par, s_dp, d)
            g1, g2 = grads
            l1, l2 = float(l1), float(l2)
            rel.append(abs(l2 - l1) / abs(l1))
            if rel[-1] > PAR_LOSS_RTOL:
                raise AssertionError(f"DP optimize loss {l2} vs single {l1}")
            if not torch.equal(state.weights, s_dp.weights):
                raise AssertionError("DP optimize bumped weights differ")
            off = ((g2 - g1).abs().amax(1) > 1e-4 * g1.abs().max()).sum()
            rows_off = max(rows_off, int(off))
            if off > 0.005 * int((g1.abs().amax(1) > 0).sum()):
                raise AssertionError(f"DP gradient rows off: {int(off)}")
            want = (adam64(s0, g2) - adam64(s0, g1)).abs() + 1e-9 + \
                2.4e-7 * state.features.double().abs()
            diff = (s_dp.features.double() - state.features.double()).abs()
            if bool((diff > want).any()):
                raise AssertionError("DP latents beyond Adam's update of "
                                     "the gradient difference")
            lat_slack = max(lat_slack, float(diff.max()))
    finally:
        optimize._adam_update = real_adam
    times = []
    for step in (one, par, par, one):
        state = optimize.init_optim_state(nm.table)
        torch.cuda.synchronize()
        t0 = time.time()
        for d in draws:
            state, _ = run(step, state, d)
        torch.cuda.synchronize()
        times.append((time.time() - t0) / PAR_OPT_ITERS)
    print(f"  parallel optimize: {PAR_OPT_ITERS} iterations from shared "
          f"states, losses max rel diff {max(rel):.2e}, weights equal, "
          f"gradient rows off at most {rows_off}, latents max diff "
          f"{lat_slack:.2e} (within Adam's update of the gradient "
          f"difference); DP {times[1]:.4f} / {times[2]:.4f} s/iter, single "
          f"{times[0]:.4f} / {times[3]:.4f} s/iter (single, DP, DP, "
          f"single) [{card}]", flush=True)
    return times


def par_pretrain(group):
    """One make_sharded_pretrain_step against the trainer's single step on
    one full-width batch."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.datasets import get_dataset
    from bnv_fusion_tpu_torch.models.local_point_fusion import (
        FusionPointNetTrainer, iterate_batches)
    from bnv_fusion_tpu_torch.nn import init_model
    from bnv_fusion_tpu_torch.parallel import dp

    cfg = load_config(PRETRAIN_OVERRIDES)
    batch = next(iterate_batches(get_dataset(cfg, "train"), 32))
    n_keep = np.random.RandomState(5).randint(4, 64, size=32)
    p0 = {net: {k: v.numpy() for k, v in d.items()}
          for net, d in init_model(0, bias_std=BIAS_STD).items()}
    one, par = FusionPointNetTrainer(cfg, p0), FusionPointNetTrainer(cfg, p0)
    step = dp.make_sharded_pretrain_step(group, par.optimizer,
                                         reg_weight=par.reg_weight)
    l1, logs1 = one.train_step(batch, n_keep=n_keep)
    t = par._tensor
    l2, logs2 = step(par.params, t(batch["input_pts"]),
                     t(n_keep, torch.int64), t(batch["training_pts"]),
                     t(batch["gt"]))
    if abs(float(l2) - l1) > PAR_PRE_RTOL * abs(l1):
        raise AssertionError(f"DP pretrain loss {float(l2)} vs {l1}")
    err = max(float((a - b).detach().abs().max()) for net in one.params
              for a, b in zip(one.params[net].values(),
                              par.params[net].values()))
    if err > PAR_PRE_ATOL:
        raise AssertionError(f"DP pretrain weights {err:.3e} from single")
    print(f"  parallel pretrain: loss {l1:.6f} vs DP {float(l2):.6f}, "
          f"weights after the step max diff {err:.2e}", flush=True)


def phase_parallel(tmp, params, card):
    """The DP layer at world size 1 under NCCL (see the module docstring)."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from bnv_fusion_tpu_torch import fusion, run_e2e
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.datasets import get_dataset
    from bnv_fusion_tpu_torch.kernels import _build
    from bnv_fusion_tpu_torch.parallel import dp, launch, make_mesh
    from bnv_fusion_tpu_torch.pipeline import NeuralMap

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    launch.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"expected NCCL at world 1, got "
                                 f"{dist.get_backend()} at "
                                 f"{dist.get_world_size()}")
        group = make_mesh(1)
        cfg = load_config(OFFLINE_OVERRIDES + [f"output_dir={tmp}"])
        ds = get_dataset(cfg, "val")
        frames = [ds[i] for i in range(len(ds))]
        maps = {k: NeuralMap(ds.dimensions, cfg, params) for k in ("dp",
                                                                  "one")}
        mu = int(cfg.model.max_unique_per_frame)
        ndp, none = maps["dp"], maps["one"]
        step = dp.make_sharded_fuse_frame(group, ndp.params, VOXEL,
                                          ndp.min_pts_in_grid, ndp.table,
                                          max_unique=mu)
        group.traffic.clear()
        t_dp, t_one = [], []
        par_fuse_pass(ndp, frames, lambda p, n, v: step(
            ndp.table, p, n, v, ndp.bound_min, ndp.bound_max), t_dp)
        gathered = sum(n for op, n, _ in group.traffic
                       if op == "all_gather") / len(frames)
        par_fuse_pass(none, frames, lambda p, n, v: fusion.fuse_frame_cellsort(
            none.table, none.params, p, n, v, none.bound_min, none.bound_max,
            VOXEL, none.min_pts_in_grid, max_unique=mu), t_one)
        for nm in (ndp, none):
            if nm.overflow != 0:
                raise AssertionError(f"parallel fuse overflow {nm.overflow}")
        a, b = table_by_key(ndp), table_by_key(none)
        same_table("DP fuse vs per-frame fuse", a, b)
        print(f"  parallel fuse: {len(frames)} frames, {len(a[0])} voxels, "
              f"DP table == per-frame table bit for bit by key", flush=True)
        print(f"  parallel fuse: DP {np.median(t_dp):.3f} ms/frame, single "
              f"per-frame {np.median(t_one):.3f} ms/frame (CUDA events, "
              f"medians of {len(frames)}); {gathered:.0f} elements "
              f"all-gathered per frame [{card}]", flush=True)
        # what one collective costs the DP steps at world 1 (DPGroup's copy
        # included): the fuse's partials, the optimize's scalars and bump
        dev = ndp.device
        ms = {what: median_ms(fn) for what, fn in (
            ("all_reduce scalar", lambda: group.all_reduce(
                torch.zeros((), device=dev))),
            ("all_reduce [capacity]", lambda: group.all_reduce(
                ndp.table.weights, "max")),
            ("all_gather [U, 8]", lambda: group.all_gather(
                ndp.table.features[:mu])))}
        print("  parallel collectives at world 1: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in ms.items()) +
            f" (CUDA events, medians of 10) [{card}]", flush=True)

        _build.LAUNCHES.clear()
        m_dp = ndp.extract_mesh()
        n_dec = _build.LAUNCHES.get("fused_corner_decode", 0)
        m_one = none.extract_mesh()
        if n_dec <= 0:
            raise AssertionError("the DP map's mesh never launched "
                                 "fused_corner_decode")
        if m_dp is None or m_one is None or \
                len(m_dp.vertices) != len(m_one.vertices) or \
                len(m_dp.faces) != len(m_one.faces):
            raise AssertionError("DP map's mesh counts differ from the "
                                 "single map's")
        print(f"  parallel mesh: {len(m_dp.vertices)} vertices, "
              f"{len(m_dp.faces)} faces (== the single map's); "
              f"fused_corner_decode launches {n_dec}", flush=True)

        for f in frames:
            none.frames.append({"depth": none._tensor(f["depth"]),
                                "T_wc": none._tensor(f["T_wc"]),
                                "intr": none._tensor(f["intr_mat"])})
        par_optimize(none, group, card)
        del maps, ndp, none
        par_pretrain(group)

        out = run_e2e.run(E2E_OVERRIDES + [
            "model.table_layout=dense", "trainer.fuse_devices=all",
            "trainer.optimize_devices=all", f"output_dir={tmp}/e2e"],
            params=params)
        head, n_v, n_f = read_ply_header(
            os.path.join(out["working_dir"], "final.ply"))
        if "binary_little_endian" not in head or n_v <= 0 or n_f <= 0:
            raise AssertionError("run_e2e with the device counts at all: "
                                 "final.ply is not a non-empty binary PLY")
        print(f"  parallel run_e2e (table_layout=dense, fuse_devices=all, "
              f"optimize_devices=all at world 1): final.ply {n_v} "
              f"vertices, {n_f} faces", flush=True)
    finally:
        launch.shutdown()


def as_spatial(nm, group):
    """Give ``nm`` an empty SpatialTable of its grid and capacity over
    ``group`` and the spatial routing's state (what NeuralMap builds under
    model.table_layout=spatial, which it refuses below 2 devices)."""
    from bnv_fusion_tpu_torch.parallel import spatial

    nm.table = spatial.create_spatial_table(
        group, nm.n_xyz, nm.table.capacity, nm.feat_dims, nm.device)
    nm._spatial, nm._group = True, group
    nm._rows = spatial.OwnerRows(group)
    return nm


def sp_by_key(group, nm):
    """(keys, features, weights, hits) of a spatial map, sorted by key."""
    import numpy as np
    from bnv_fusion_tpu_torch.parallel import spatial

    keys, feats, w, h = spatial.spatial_active_entries(group, nm.table)
    order = np.lexsort(keys.T[::-1])
    return keys[order], feats[order], w[order], h[order]


def sp_optimize(nsp, none, group, card):
    """SP_OPT_ITERS iterations of optimize.make_optimize_step on
    spatial.OwnerRows on the spatial map against the plain step on the
    single map, on the same drawn pixels and uniforms: losses, latents and
    bumped weights equal bit for bit (by key); both timed (single,
    spatial, spatial, single)."""
    import numpy as np
    import torch
    from bnv_fusion_tpu_torch import optimize, render, tsdf
    from bnv_fusion_tpu_torch.parallel import spatial

    kw = dict(voxel_size=none.voxel_size,
              min_pts_in_grid=none.min_pts_in_grid,
              truncated_units=none.truncated_units,
              truncated_dist=none.truncated_dist,
              ray_max_dist=none.ray_max_dist, n_rays=none.sampling_size,
              train_ray_splits=none.train_ray_splits, lr=1e-3)
    steps = {"one": optimize.make_optimize_step(none.params, **kw),
             "sp": optimize.make_optimize_step(
                 nsp.params, rows=spatial.OwnerRows(group), **kw)}
    maps = {"one": none, "sp": nsp}
    delta = tsdf.prepare_sdf_delta(none.tsdf_vol, none.tsdf_voxel_size,
                                   none.truncated_dist, none.sdf_delta_weight)
    g = torch.Generator().manual_seed(12)
    nf, nc = none.truncated_units * 2, int(none.ray_max_dist * 5)
    draws = []
    for i in range(SP_OPT_ITERS):
        f = none.frames[i % len(none.frames)]
        pix = torch.randperm(f["depth"].numel(),
                             generator=g)[:none.sampling_size]
        uni = [render.draw_sampling_uniforms(g, none.train_ray_splits, nf,
                                             nc, none.device)
               for _ in range(none.sampling_size // none.train_ray_splits)]
        draws.append((f, pix, uni))

    def run(which):
        nm, step = maps[which], steps[which]
        state = optimize.init_optim_state(nm.table)
        losses = []
        torch.cuda.synchronize()
        t0 = time.time()
        for f, pix, uni in draws:
            state, loss = step(state, nm.table, f["depth"], f["T_wc"],
                               f["intr"], nm.bound_min, nm.n_xyz, delta,
                               pixel_ids=pix, uniforms=uni)
            losses.append(loss)
        torch.cuda.synchronize()
        return ((time.time() - t0) / SP_OPT_ITERS, state,
                torch.stack(losses).cpu().numpy())

    out, times = {}, []
    for which in ("one", "sp", "sp", "one"):
        group.traffic.clear()
        t, state, losses = run(which)
        times.append(t)
        out[which] = (state, losses)
        if which == "sp":
            reduced = sum(n for op, n, _ in group.traffic
                          if op.startswith("all_reduce")) / SP_OPT_ITERS
    (s1, l1), (s2, l2) = out["one"], out["sp"]
    if not np.array_equal(l1, l2):
        raise AssertionError(f"spatial optimize losses {l2} vs single {l1}")
    for nm, s in ((none, s1), (nsp, s2)):
        nm.table.features, nm.table.weights = s.features, s.weights
    same_table("spatial optimize vs single step", sp_by_key(group, nsp),
               table_by_key(none))
    print(f"  spatial optimize: {SP_OPT_ITERS} iterations, losses equal "
          f"(first {l1[0]:.6f}, last {l1[-1]:.6f}), latents and bumped "
          f"weights equal bit for bit by key; spatial {times[1]:.4f} / "
          f"{times[2]:.4f} s/iter, single {times[0]:.4f} / {times[3]:.4f} "
          f"s/iter (single, spatial, spatial, single); {reduced:.0f} "
          f"elements all-reduced per spatial iteration [{card}]",
          flush=True)


def phase_spatial(tmp, params, card):
    """The region-sharded map at world size 1 under NCCL (see the module
    docstring)."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from bnv_fusion_tpu_torch import fusion
    from bnv_fusion_tpu_torch.config import load_config
    from bnv_fusion_tpu_torch.datasets import get_dataset
    from bnv_fusion_tpu_torch.kernels import _build
    from bnv_fusion_tpu_torch.parallel import launch, make_mesh, spatial
    from bnv_fusion_tpu_torch.pipeline import NeuralMap

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    launch.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"expected NCCL at world 1, got "
                                 f"{dist.get_backend()} at "
                                 f"{dist.get_world_size()}")
        group = make_mesh(1)
        cfg = load_config(OFFLINE_OVERRIDES + [f"output_dir={tmp}"])
        ds = get_dataset(cfg, "val")
        frames = [ds[i] for i in range(len(ds))]
        none = NeuralMap(ds.dimensions, cfg, params)
        nsp = as_spatial(NeuralMap(ds.dimensions, cfg, params), group)
        mu = int(cfg.model.max_unique_per_frame)
        step = spatial.make_spatial_fuse_frame(group, nsp.params, VOXEL,
                                               nsp.min_pts_in_grid,
                                               max_unique=mu)
        group.traffic.clear()
        t_sp, t_one = [], []
        par_fuse_pass(nsp, frames, lambda p, n, v: step(
            nsp.table, p, n, v, nsp.bound_min, nsp.bound_max), t_sp)
        gathered = sum(n for op, n, _ in group.traffic
                       if op == "all_gather") / len(frames)
        par_fuse_pass(none, frames, lambda p, n, v: fusion.fuse_frame_cellsort(
            none.table, none.params, p, n, v, none.bound_min, none.bound_max,
            VOXEL, none.min_pts_in_grid, max_unique=mu), t_one)
        for nm in (nsp, none):
            if nm.overflow != 0:
                raise AssertionError(f"spatial fuse overflow {nm.overflow}")
        a, b = sp_by_key(group, nsp), table_by_key(none)
        same_table("spatial fuse vs per-frame fuse", a, b)
        print(f"  spatial fuse: {len(frames)} frames, {len(a[0])} voxels, "
              f"spatial table == per-frame table bit for bit by key",
              flush=True)
        print(f"  spatial fuse: spatial {np.median(t_sp):.3f} ms/frame, "
              f"single per-frame {np.median(t_one):.3f} ms/frame (CUDA "
              f"events, medians of {len(frames)}); {gathered:.0f} elements "
              f"all-gathered per frame; the shard holds "
              f"{nsp.table.nbytes()} bytes (slot map {nsp.table.nv_shard} "
              f"voxels, {nsp.table.capacity} rows) [{card}]", flush=True)

        def timed_mesh(nm):
            torch.cuda.synchronize()
            t0 = time.time()
            m = nm.extract_mesh()
            torch.cuda.synchronize()
            return m, time.time() - t0

        # single, spatial, spatial, single: the first mesh of the phase
        # pays the decoder's packing and the first launches
        m_one, t_one0 = timed_mesh(none)
        _build.LAUNCHES.clear()
        m_sp, t_sp0 = timed_mesh(nsp)
        n_dec = _build.LAUNCHES.get("fused_corner_decode", 0)
        _, t_sp1 = timed_mesh(nsp)
        _, t_one1 = timed_mesh(none)
        if n_dec <= 0:
            raise AssertionError("the spatial map's mesh never launched "
                                 "fused_corner_decode")
        if m_sp is None or m_one is None or \
                len(m_sp.vertices) != len(m_one.vertices) or \
                len(m_sp.faces) != len(m_one.faces):
            raise AssertionError("the spatial map's mesh counts differ from "
                                 "the single map's")
        print(f"  spatial mesh: {len(m_sp.vertices)} vertices, "
              f"{len(m_sp.faces)} faces (== the single map's); "
              f"fused_corner_decode launches {n_dec}; spatial "
              f"{t_sp0:.3f} / {t_sp1:.3f} s, single {t_one0:.3f} / "
              f"{t_one1:.3f} s (single, spatial, spatial, single) [{card}]",
              flush=True)

        for nm in (nsp, none):
            for f in frames:
                nm.frames.append({"depth": nm._tensor(f["depth"]),
                                  "T_wc": nm._tensor(f["T_wc"]),
                                  "intr": nm._tensor(f["intr_mat"])})
        sp_optimize(nsp, none, group, card)

        os.makedirs(tmp, exist_ok=True)
        prefix = os.path.join(tmp, "spatial")
        nsp.save(prefix)
        loaded = as_spatial(NeuralMap(ds.dimensions, cfg, params), group)
        loaded.load_volume(prefix + "_sparse_volume.npz")
        same_table("spatial map saved and loaded", sp_by_key(group, loaded),
                   sp_by_key(group, nsp))
        print(f"  spatial save/load: {len(a[0])} entries, the loaded map "
              f"== the saved one bit for bit by key", flush=True)
    finally:
        launch.shutdown()


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "bnv_fusion_tpu_torch")):
        return fail("bnv_fusion_tpu_torch/ not found beside chip_smoke.py; "
                    "run it from a checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = (smi.stdout.strip().splitlines() or ["unknown"])[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from bnv_fusion_tpu_torch.kernels import _build
    t0 = time.time()
    took = _build.build()
    print(f"phase build: {time.time() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})",
          flush=True)

    print("phase kernels vs plain versions:", flush=True)
    t0 = time.time()
    kres = phase_kernels()
    print(f"phase kernels: {time.time() - t0:.1f} s", flush=True)

    print("phase e2e: run_e2e at the bench operating point", flush=True)
    from bnv_fusion_tpu_torch import run_e2e
    from bnv_fusion_tpu_torch.nn import init_model

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        params = init_model(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        t0 = time.time()
        out = run_e2e.run(E2E_OVERRIDES + [f"output_dir={tmp}"], params=params)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        nmap = out["nmap"]
        tm = nmap.timer.times
        print(f"  launches in the e2e run: {launches}", flush=True)
        print(f"  local fusion: {len(nmap.frames) / tm['local']:.2f} frames/s "
              f"({len(nmap.frames)} frames in {tm['local']:.2f} s)")
        print(f"  optimize: {tm['global'] / out['global_steps']:.4f} s/iter "
              f"({out['global_steps']} iters in {tm['global']:.2f} s)")
        print(f"  mesh: {tm['mesh']:.2f} s for 2 extractions "
              f"(before_optim + final)")
        for t, r in out["fscores"].items():
            print(f"  F-score @{t}: {r['fscore']:.4f} (untrained weights, "
                  f"information only)")
        print(f"  peak device memory: {peak / 2**30:.2f} GiB; e2e wall "
              f"{wall:.1f} s", flush=True)

        for name in ("seg_reduce_sorted", "fused_corner_decode",
                     "fused_encode"):
            if launches.get(name, 0) <= 0:
                return fail(f"the main path never launched {name}")
        if nmap.overflow != 0:
            return fail(f"table overflow {nmap.overflow}")
        losses = np.asarray(nmap.optimize_losses, np.float64)
        if len(losses) != out["global_steps"] or \
                not np.all(np.isfinite(losses)):
            return fail(f"optimize losses not all finite: {losses}")
        print(f"  optimize loss first {losses[0]:.5f} last {losses[-1]:.5f}")
        wd = out["working_dir"]
        head, n_v, n_f = read_ply_header(os.path.join(wd, "final.ply"))
        if "binary_little_endian" not in head or n_v <= 0 or n_f <= 0:
            return fail(f"final.ply is not a non-empty binary PLY "
                        f"({n_v} vertices, {n_f} faces)")
        if not np.all(np.isfinite(out["final"].vertices)):
            return fail("final mesh has non-finite vertices")
        if not os.path.exists(os.path.join(wd, "final_sparse_volume.npz")):
            return fail("final_sparse_volume.npz was not written")
        if not bool(torch.isfinite(nmap.table.features).all()):
            return fail("table features are not finite")
        print(f"  final.ply: {n_v} vertices, {n_f} faces", flush=True)
        e2e_final = os.path.join(wd, "final.ply")
        phase_reference(nmap)
        check_prefetch(nmap, out["final"])
        print(f"phase e2e: {time.time() - t0:.1f} s (reference and "
              "prefetch checks included)", flush=True)
        del out, nmap

        print("phase options: run_e2e with the model and trainer options",
              flush=True)
        t0 = time.time()
        phase_options(os.path.join(tmp, "options"), params)
        print(f"phase options: {time.time() - t0:.1f} s", flush=True)

        print("phase demo: run_e2e model.mode=demo at bench_demo's point",
              flush=True)
        t0 = time.time()
        phase_demo(os.path.join(tmp, "demo"), params)
        print(f"phase demo: {time.time() - t0:.1f} s", flush=True)

        print("phase fused_mlp: FusedMLP vs the plain MLP", flush=True)
        t0 = time.time()
        kres["fused_mlp"] = phase_fused_mlp()
        print(f"phase fused_mlp: {time.time() - t0:.1f} s", flush=True)

        print("phase pretrain: train.py on synthetic patches", flush=True)
        t0 = time.time()
        phase_pretrain(os.path.join(tmp, "pretrain"))
        print(f"phase pretrain: {time.time() - t0:.1f} s", flush=True)

        print("phase offline: test.py -> train.py refiner", flush=True)
        _build.LAUNCHES.clear()
        t0 = time.time()
        phase_offline(os.path.join(tmp, "offline"), params)
        off_launches = dict(_build.LAUNCHES)
        print(f"  launches in the offline run: {off_launches}", flush=True)
        if off_launches.get("fused_corner_decode", 0) <= 0:
            return fail("the offline flow never launched fused_corner_decode")
        print(f"phase offline: {time.time() - t0:.1f} s", flush=True)

        print("phase datasets: the real-data path (converters, readers, "
              "run_inference, tools)", flush=True)
        t0 = time.time()
        phase_datasets(os.path.join(tmp, "datasets"), params, e2e_final,
                       card)
        print(f"phase datasets: {time.time() - t0:.1f} s", flush=True)

        print("phase fuse: local fusion at bench.py's point", flush=True)
        t0 = time.time()
        phase_fuse(params, card)
        print(f"phase fuse: {time.time() - t0:.1f} s", flush=True)

        print("phase bigscene: the 790M-voxel scene through run_inference, "
              "the big-scene layouts against the dense ones, the hash table",
              flush=True)
        t0 = time.time()
        phase_bigscene(os.path.join(tmp, "bigscene"), params, card)
        print(f"phase bigscene: {time.time() - t0:.1f} s", flush=True)

        print("phase parallel: the DP layer at world 1 under NCCL",
              flush=True)
        t0 = time.time()
        phase_parallel(os.path.join(tmp, "parallel"), params, card)
        print(f"phase parallel: {time.time() - t0:.1f} s", flush=True)

        print("phase spatial: the region-sharded map at world 1 under NCCL",
              flush=True)
        t0 = time.time()
        phase_spatial(os.path.join(tmp, "spatial"), params, card)
        print(f"phase spatial: {time.time() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    src = {"seg_reduce_sorted": ("bnv_fusion_tpu_torch/csrc/seg_reduce.cu",
                                 "bnv_fusion_tpu/kernels/seg_reduce.py:184"),
           "fused_corner_decode": ("bnv_fusion_tpu_torch/csrc/fused_decode.cu",
                                   "bnv_fusion_tpu/kernels/fused_decode.py:64"),
           "fused_mlp": ("bnv_fusion_tpu_torch/csrc/fused_mlp.cu",
                         "bnv_fusion_tpu/kernels/fused_mlp.py:79"),
           "fused_encode": ("bnv_fusion_tpu_torch/csrc/fused_encode.cu",
                            None)}
    launches["fused_mlp"] = kres["fused_mlp"]["launches"]
    # library_ms: no single PyTorch call computes any of the four (the MLP
    # is four F.linear calls and activations; torch.segment_reduce does not
    # rank keys into a compacted width); fused_encode replaces no TPU
    # kernel (the JAX package leaves the encoder to XLA)
    kernels = [{"name": n, "route": "cuda", "source": src[n][0],
                "replaces": src[n][1], "launches": launches[n],
                "max_abs_err": kres[n]["max_abs_err"], "ms": kres[n]["ms"],
                "plain_ms": kres[n]["plain_ms"],
                "bound_ms": kres[n]["bound_ms"],
                "bound_by": kres[n]["bound_by"], "library_ms": None}
               for n in src]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # noqa: BLE001 - report, then exit non-zero
        import traceback

        traceback.print_exc()
        sys.exit(fail(f"{type(e).__name__}: {e}"))
