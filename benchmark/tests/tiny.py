"""Each cell cut to a size a CPU test run holds: smaller frames, coarser
voxels, fewer frames, rays and iterations; every loop and comparison of the
cell as it runs on the card."""

import os

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
}

SEED = 2 ** 33 + 5


def bench_with_parked():
    """BENCHMARK.json with the cells it does not enrol yet (``parked.json``:
    refine and demo, whose runs on the card spread wider than a bound may;
    PERF.md section 7) added, so that their loops stay tested."""
    from benchmark import run as bench_run

    bench = bench_run.load_json(bench_run.ROOT, "BENCHMARK.json")
    parked = bench_run.load_json(os.path.dirname(__file__), "parked.json")
    for k, v in parked.items():
        bench[k] = bench[k] + v
    return bench


def run_tiny(name, seed=SEED, traced=False, more=()):
    from benchmark import run as bench_run

    case = dict(CASES[name])
    case["extra_overrides"] = case["extra_overrides"] + list(more)
    return bench_run.run_cell(name, seed, 0.1, traced, device="cpu",
                              bench=bench_with_parked(), **case)
