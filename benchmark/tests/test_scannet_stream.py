"""scannet.stream at a CPU size (``run_cell``'s ``config_patch`` and
``traffic_patch``): a sound run reads ``correct`` with no mismatch and no
dropped frame, its control (the cell's limits file) does not, a stale brick
of the block-major prior is caught, and a traced run resolves the four
per-layer metrics that read ``tsdf.integrate_blocks``' spans and count."""

import math

import pytest
import torch

from benchmark import run as bench_run

CELL = "scannet.stream"
SEED = 2 ** 33 + 22
NEW_METRICS = ("fuse.prior.cull.ms_per_frame",
               "fuse.prior.compact.ms_per_frame",
               "fuse.prior.bricks.ms_per_frame", "fuse.prior.budget")


def _patches():
    """The cell's room and loop at 48 x 64, 5 cm voxels, 32 frames (two K=16
    updates), the prior block-major as at the cell's size, the seg-reduce's
    plain version (the kernel's path)."""
    _, _, config, _ = bench_run.load_cell(CELL)
    shrink = ["dataset.img_res=[48,64]", "model.voxel_size=0.05",
              "model.tsdf_voxel_size=0.1", "model.tsdf_layout=blocks",
              "model.max_unique_per_frame=32768",
              "model.max_unique_cells_per_frame=4096",
              "model.table_capacity=131072",
              "model.use_seg_reduce_kernel=interpret"]
    return dict(config_patch={"overrides": config["overrides"] + shrink},
                traffic_patch={"frames": 32})


def _run(traced=False, more=(), seed=SEED):
    return bench_run.run_cell(CELL, seed, 0.1, traced, device="cpu",
                              extra_overrides=list(more), **_patches())


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert r["readings"]["map_mismatch"] == 0
    assert r["readings"]["prior_mismatch"] == 0
    assert r["readings"]["prior_bricks"] > 0
    assert set(r["metrics"]) == {"fuse_fps", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("seed", [3, 2 ** 34 + 1])
def test_control_is_not_correct(seed):
    ctl = bench_run.load_json(bench_run.HERE, "limits",
                              CELL + ".json")["control"]
    r = _run(more=ctl, seed=seed)
    assert not r["correct"], r["checks"]


def test_stale_brick_is_caught(monkeypatch):
    from bnv_fusion_tpu_torch import tsdf

    fn = tsdf.integrate_blocks

    def broken(vol, *a, **k):
        saved = vol.sdf.clone(), vol.weight.clone()
        out = fn(vol, *a, **k)
        b = int(torch.nonzero((vol.weight != saved[1]).any(1))[0, 0])
        vol.sdf[b], vol.weight[b] = saved[0][b], saved[1][b]
        return out

    monkeypatch.setattr(tsdf, "integrate_blocks", broken)
    r = _run()
    assert not r["correct"]
    assert r["readings"]["prior_mismatch"] > 0


def test_traced_run_resolves_the_prior_metrics():
    r = _run(traced=True)
    assert r["correct"], r["checks"]
    for name in NEW_METRICS:
        v = r["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, name
    # the brick budget is the pipeline's (tsdf.frustum_max_blocks)
    from benchmark.traffic import generator
    from bnv_fusion_tpu_torch import tsdf

    _, _, config, traffic = bench_run.load_cell(CELL)
    vol, _ = tsdf.create_tsdf_volume_bm(traffic["scene"]["dimensions"], 0.1)
    intr = generator.intrinsics((48, 64), config["focal_per_width"])
    assert r["metrics"]["fuse.prior.budget"]["value"] == \
        tsdf.frustum_max_blocks(intr, (48, 64), 5.0, 0.1, vol.nb_xyz)
    entries = {m["name"]: m for m in bench_run.load_json(
        bench_run.ROOT, "BENCHMARK.json")["per_layer"]}
    for name in NEW_METRICS:
        assert entries[name]["workloads"] == [CELL]
        assert r["metrics"][name]["unit"] == entries[name]["unit"]
