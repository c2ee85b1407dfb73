"""Each cell cut to a size a CPU test run holds: smaller frames, coarser
voxels, fewer frames, rays and iterations; every loop and comparison of the
cell as it runs on the card."""

import contextlib

from benchmark.run import bench_with_parked

TINY = ["dataset.img_res=[48,64]", "model.max_unique_per_frame=8192",
        "model.max_unique_cells_per_frame=4096", "model.table_capacity=65536",
        "dataset.num_pixels=200", "model.train_ray_splits=100"]

# the K-frame cells' batched front with the plain seg-reduce, the path the
# card takes with the kernel
KMERGE = ["model.use_seg_reduce_kernel=interpret"]

CASES = {
    "scene3d.stream": dict(extra_overrides=TINY + KMERGE +
                           ["model.voxel_size=0.05"],
                           traffic_patch={"frames": 32}),
    "arkit.stream": dict(extra_overrides=TINY + ["model.voxel_size=0.08"],
                         traffic_patch={"frames": 20}),
    "scene3d.refine": dict(extra_overrides=TINY + KMERGE +
                           ["model.voxel_size=0.05"],
                           traffic_patch={"frames": 16}),
    "arkit.demo": dict(extra_overrides=TINY + ["model.voxel_size=0.08",
                                               "model.optim_interval=10"],
                       traffic_patch={"frames": 30, "session_frames": 30}),
    "house.stream": dict(extra_overrides=TINY + KMERGE +
                         ["model.voxel_size=0.1", "model.tsdf_voxel_size=0.1",
                          "model.tsdf_layout=blocks"],
                         traffic_patch={"frames": 32}),
}

# cells whose map takes the block table at their full size (from the
# system's dense-map ceiling of 512M voxels); at the CPU size the ceiling is
# lowered, in this process and for the run only, so that it does there too
BLOCK_TABLE = ("house.stream",)

SEED = 2 ** 33 + 5


@contextlib.contextmanager
def block_table(on: bool):
    """The system's map routed to the block table at any grid size."""
    from bnv_fusion_tpu_torch import tables

    saved = tables.DENSE_MAP_MAX_VOXELS
    if on:
        tables.DENSE_MAP_MAX_VOXELS = 1
    try:
        yield
    finally:
        tables.DENSE_MAP_MAX_VOXELS = saved


def run_tiny(name, seed=SEED, traced=False, more=()):
    from benchmark import run as bench_run

    case = dict(CASES[name])
    case["extra_overrides"] = case["extra_overrides"] + list(more)
    with block_table(name in BLOCK_TABLE):
        return bench_run.run_cell(name, seed, 0.1, traced, device="cpu",
                                  bench=bench_with_parked(), **case)
