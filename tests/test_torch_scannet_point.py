"""The reference's ScanNet operating point (benchmark/configs/scannet_v020.json)
on the port's normal path: the K=16 map and the block-major prior against
the benchmark's plain reference on a shrunk copy of the cell's room, the
layout rule at the configuration's full extent (checked without allocating
its grids), and the spans and the brick-budget count inside
``tsdf.integrate_blocks``."""

import json
import os

import numpy as np
import pytest
import torch

# benchmark.run points the kernel caches into the checkout on import; the
# other tests in this process keep their own
_ENV = {k: os.environ.get(k) for k in ("TORCH_EXTENSIONS_DIR",
                                       "TRITON_CACHE_DIR")}
from benchmark import run as bench_run  # noqa: E402
from benchmark import trace  # noqa: E402
from benchmark.reference import fusion as ref_fusion  # noqa: E402
from benchmark.tests.tiny import bench_with_parked  # noqa: E402
from bnv_fusion_tpu_torch import tables, tsdf  # noqa: E402
from bnv_fusion_tpu_torch import voxel as vx  # noqa: E402
from bnv_fusion_tpu_torch.config import load_config  # noqa: E402
from bnv_fusion_tpu_torch.utils import profiling  # noqa: E402

for _k, _v in _ENV.items():
    if _v is None:
        os.environ.pop(_k, None)
    else:
        os.environ[_k] = _v

CELL = "scannet.stream"
SEED = 2 ** 33 + 22
PRIOR_SPANS = ["fuse.prior.cull", "fuse.prior.compact", "fuse.prior.bricks"]


def _shrunk_scene(scene, s):
    """The cell's room with its floor plan scaled by ``s`` (x and y of every
    centre and half-size; heights kept)."""
    def box(b):
        return [b[0] * s, b[1] * s, b[2], b[3] * s, b[4] * s, b[5]]
    return {"dimensions": [scene["dimensions"][0] * s,
                           scene["dimensions"][1] * s,
                           scene["dimensions"][2]],
            "rooms": [box(r) for r in scene["rooms"]],
            "boxes": [box(b) for b in scene["boxes"]],
            "spheres": [[c[0] * s, c[1] * s, c[2], c[3] * s]
                        for c in scene["spheres"]]}


def _shrunk_cell(scale=0.5):
    """run_cell's patches: the cell's room at ``scale`` of its floor plan,
    two K=16 updates of 60x80 frames, coarser voxels, the block-major prior
    forced and the seg-reduce's plain version (the kernel's path)."""
    _, _, config, traffic = bench_run.load_cell(CELL)
    path = dict(traffic["path"])
    path["eye"] = [path["eye"][0] * scale, path["eye"][1] * scale,
                   path["eye"][2]]
    path["target"] = [path["target"][0] * scale, path["target"][1] * scale,
                      path["target"][2]]
    shrink = ["dataset.img_res=[60,80]", "model.voxel_size=0.05",
              "model.tsdf_voxel_size=0.05", "model.tsdf_layout=blocks",
              "model.max_unique_per_frame=8192",
              "model.max_unique_cells_per_frame=4096",
              "model.table_capacity=65536",
              "model.use_seg_reduce_kernel=interpret"]
    return dict(config_patch={"overrides": config["overrides"] + shrink},
                traffic_patch={"frames": 32, "path": path,
                               "scene": _shrunk_scene(traffic["scene"],
                                                      scale)})


def test_shrunk_scannet_map_and_block_prior_match_the_reference():
    """(a) Two K=16 updates at the point's overrides (2 cm voxels shrunk to
    5 cm, ray_max 5, min_pts 8, tsdf_every 4): the map and the block-major
    prior equal the plain reference's exactly, the latents within the
    cell's limits, and no frame dropped."""
    r = bench_run.run_cell(CELL, SEED, 0.1, False, device="cpu",
                           **_shrunk_cell())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 32
    assert r["readings"]["map_mismatch"] == 0
    assert r["readings"]["prior_mismatch"] == 0
    assert r["readings"]["prior_bricks"] > 0      # the prior was block-major
    limits = bench_run.load_json(bench_run.HERE, "limits", CELL + ".json")
    for k in ("latent_gap", "latent_rms_gap"):
        assert r["readings"][k] <= limits["checks"][k]


# (cell, prior block-major, map layout) at each configuration's full extent
LAYOUTS = [("scene3d.stream", False, "dense"),
           ("arkit.stream", False, "dense"),
           ("scannet.stream", True, "dense"),
           ("house.stream", True, "blocks")]


@pytest.mark.parametrize("cell,blocks,table", LAYOUTS)
def test_layout_rule_at_full_extent(cell, blocks, table):
    """(b) The port's rule (``tsdf.is_block_major``, ``tables.map_layout``)
    at the cell's full extent, without allocating its grids, and the
    reference's ``prior_is_blocks`` agrees."""
    _, _, config, traffic = bench_run.load_cell(cell, bench_with_parked())
    cfg = load_config(config["overrides"] + traffic["overrides"])
    m = cfg.model
    dims = np.asarray(traffic["scene"]["dimensions"], np.float32)
    layout = str(getattr(m, "tsdf_layout", "auto"))
    assert layout == "auto"          # the layout is the rule's, not forced
    tvs = float(m.tsdf_voxel_size)
    assert tsdf.is_block_major(layout, dims, tvs) is blocks
    assert ref_fusion.prior_is_blocks(layout, dims, tvs) is blocks
    n_xyz = vx.get_world_range(dims, float(m.voxel_size))[2]
    assert tables.map_layout(n_xyz) == table


def test_scannet_extent_sizes():
    """The sizes scannet_v020's file states: a 402 x 402 x 152 map at 2 cm
    and a 322 x 322 x 122 prior at 2.5 cm (81 x 81 x 31 bricks), over
    BLOCKS_FROM_VOXELS."""
    _, _, config, traffic = bench_run.load_cell(CELL)
    dims = np.asarray(traffic["scene"]["dimensions"], np.float32)
    assert tuple(vx.get_world_range(dims, 0.02)[2]) == (402, 402, 152)
    lo, hi, _ = vx.get_world_range(dims, 0.025)
    vol_dim = tuple(int(v) for v in np.ceil((hi - lo) / 0.025))
    assert vol_dim == (322, 322, 122)
    assert np.prod(vol_dim) >= tsdf.BLOCKS_FROM_VOXELS
    assert tuple(-(-d // tsdf.TSDF_BLOCK) for d in vol_dim) == (81, 81, 31)
    assert "model.tsdf_layout" not in json.dumps(config["overrides"])


def test_pipeline_takes_the_rule(monkeypatch):
    """NeuralMap holds the prior block-major exactly when the rule says so
    (its threshold lowered so that a small scene crosses it)."""
    from benchmark.weights import make_params
    from bnv_fusion_tpu_torch.pipeline import NeuralMap

    _, _, config, _ = bench_run.load_cell(CELL)
    cfg = load_config(config["overrides"] +
                      ["model.voxel_size=0.05", "model.tsdf_voxel_size=0.05",
                       "model.table_capacity=65536", "device_type=cpu"])
    params = make_params(config["network"], SEED, torch.device("cpu"))
    dims = np.asarray([2.0, 2.0, 1.5], np.float32)
    small = NeuralMap(dims, cfg, params)
    assert isinstance(small.tsdf_vol, tsdf.TSDFVolume)
    assert not tsdf.is_block_major("auto", dims, 0.05)
    monkeypatch.setattr(tsdf, "BLOCKS_FROM_VOXELS", 1000)
    assert tsdf.is_block_major("auto", dims, 0.05)
    big = NeuralMap(dims, cfg, params)
    assert isinstance(big.tsdf_vol, tsdf.TSDFVolumeBM)


# --- (c) the spans and the count inside integrate_blocks -------------------

H, W = 48, 64
INTR = np.array([[0.9025 * W, 0, W / 2], [0, 0.9025 * W, H / 2], [0, 0, 1]],
                np.float32)


def _prior_inputs():
    """A block-major prior of the shrunk room and one frame of the cell's
    loop at 48 x 64, with the pipeline's brick budget."""
    from benchmark.traffic import generator

    traffic = _shrunk_cell()["traffic_patch"]
    poses = generator.camera_path(traffic["path"], 3, SEED)
    depth = generator.render_depth(traffic["scene"],
                                   torch.as_tensor(poses[2]), INTR, (H, W),
                                   5.0)
    dims = np.asarray(traffic["scene"]["dimensions"], np.float32)
    vol, _ = tsdf.create_tsdf_volume_bm(dims, 0.05)
    budget = tsdf.frustum_max_blocks(INTR, (H, W), 5.0, 0.05, vol.nb_xyz)
    return vol, depth, torch.as_tensor(INTR), torch.as_tensor(poses[2]), \
        budget


def _integrate(vol, depth, intr, T_wc, budget):
    return tsdf.integrate_blocks(vol, depth, intr, T_wc, 0.05, budget, 5.0,
                                 obs_weight=4.0)


def test_integrate_blocks_spans_and_budget_count():
    """Inside a capture: the budget count, then cull, compact and bricks,
    in that order and all inside the pipeline's ``fuse.prior``; the
    readers find them."""
    vol, depth, intr, T_wc, budget = _prior_inputs()
    with trace.Recorder("cpu") as rec:
        with profiling.span("fuse.prior"):
            _integrate(vol, depth, intr, T_wc, budget)
    host = sorted(rec.timeline().host, key=lambda e: e[1])
    outer = [(a, b) for n, a, b in host if n == "fuse.prior"]
    assert len(outer) == 1
    lo, hi = outer[0]
    ours = [n for n, a, b in host
            if n.startswith("fuse.prior.") and lo <= a and b <= hi]
    assert ours == [f"fuse.prior.budget={budget}"] + PRIOR_SPANS

    class Ctx:
        timeline = rec.timeline()
        counters = {"frames": 4}
    assert bench_run.read_metric("fuse.prior.budget", Ctx) == budget
    for stage in ("cull", "compact", "bricks"):
        assert bench_run.read_metric(f"fuse.prior.{stage}.ms_per_frame",
                                     Ctx) > 0


class _NoRange:
    def __init__(self, *a, **k):
        raise AssertionError("a profiler range outside a capture")


def test_integrate_blocks_off_enters_no_range_and_is_bit_equal(monkeypatch):
    """Outside a capture no profiler range is entered; the volume is bit
    for bit the one a profiled update leaves."""
    vol_on, depth, intr, T_wc, budget = _prior_inputs()
    vol_off = _prior_inputs()[0]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _integrate(vol_on, depth, intr, T_wc, budget)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _NoRange)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _NoRange)
    _integrate(vol_off, depth, intr, T_wc, budget)
    assert int((vol_on.weight > 0).sum()) > 0
    for f in ("sdf", "weight", "overflow"):
        assert torch.equal(getattr(vol_on, f), getattr(vol_off, f)), f
    assert int(vol_off.overflow) == 0


@pytest.mark.parametrize("value", [torch.tensor(3), True, "3", None])
def test_count_takes_host_numbers_only(value):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(TypeError):
            profiling.count("fuse.prior.budget", value)


def test_count_off_is_a_no_op_and_on_names_the_value():
    assert profiling.count("x", torch.tensor(1)) is None   # off: no check
    with trace.Recorder("cpu") as rec:
        profiling.count("x.count", 7)
        profiling.count("x.count", np.int64(9))
        profiling.count("x.share", 0.5)
    names = [n for n, _, _ in rec.timeline().host if n.startswith("x.")]
    assert names == ["x.count=7", "x.count=9", "x.share=0.5"]

    class Ctx:
        timeline = rec.timeline()
    assert bench_run.read_metric("fuse.prior.budget", Ctx) is None
