"""The system against the plain reference, every cell cut to a CPU size:
sound runs come out correct, with every compared number far under its
limit; the reference's map storage and prior rule change no bit of what
the dense cells compare."""

import math

import pytest
import torch

from benchmark import run as bench_run
from benchmark.reference import fusion as ref_fusion
from benchmark.tests.tiny import CASES, run_tiny


@pytest.mark.parametrize("name", sorted(CASES))
def test_sound_run_is_correct(name):
    r = run_tiny(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    for k, c in r["checks"].items():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"], k
    assert r["jax_modules"] == []


@pytest.mark.parametrize("name", sorted(CASES))
def test_traced_run_reports_its_per_layer_metrics(name):
    r = run_tiny(name, traced=True)
    assert r["correct"]
    assert r["metrics"], "a traced run reports per-layer metrics"
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


MODE_NUMBER = {"stream": "fuse_fps", "refine": "refine_s", "demo": "event_s"}


def test_every_metric_resolves_in_its_cells():
    """Each metric of a cell resolves by ``base_name``: an end-to-end one
    to a number that the cell's mode reports, a per-layer one to a reader
    in ``metrics/``."""
    bench = bench_run.bench_with_parked()
    readers = bench_run.readers()
    for w in bench["workloads"]:
        traffic = bench_run.load_cell(w["name"], bench)[3]
        e2e = {MODE_NUMBER[traffic["mode"]], "peak_mem_gib", "setup_s"}
        for m in bench["end_to_end"]:
            if bench_run.applies(m, w["name"]):
                assert bench_run.base_name(m["name"], e2e, "_") in e2e
        for m in bench["per_layer"]:
            if bench_run.applies(m, w["name"]):
                assert bench_run.base_name(m["name"], readers, ".") in \
                    readers
    assert bench_run.base_name("fuse.ms_per_frame.house", readers, ".") == \
        "fuse.ms_per_frame"


def test_a_metric_without_number_or_reader_is_named():
    with pytest.raises(KeyError, match="fuse_rate_k1"):
        bench_run.base_name("fuse_rate_k1", {"fuse_fps": 1.0}, "_")
    with pytest.raises(KeyError, match="fuse.speed.k1"):
        bench_run.base_name("fuse.speed.k1", bench_run.readers(), ".")


class DenseMap:
    """The map held dense over the whole grid, as the reference held it
    before it held only the voxels that updates touch: the witness that the
    sparse storage changes no bit of what the dense cells compare."""

    def __init__(self, grid, fdim, device):
        self.grid = grid
        self.F = torch.zeros((grid.n_vox, fdim), device=device)
        self.W = torch.zeros((grid.n_vox,), device=device)
        self.H = torch.zeros((grid.n_vox,), device=device)
        self.alloc = torch.zeros((grid.n_vox,), dtype=torch.bool,
                                 device=device)

    def fuse(self, params, frames, min_pts, dtype=torch.float32):
        Wg, Sg, Hg = (torch.zeros_like(self.W), torch.zeros_like(self.F),
                      torch.zeros_like(self.H))
        counts = []
        for pts, normals, valid in frames:
            uniq, cnt, sums, n = ref_fusion.frame_voxels(
                self.grid, params, pts, normals, valid, dtype)
            counts.append(n)
            self.alloc[uniq] = True
            keep = cnt >= min_pts
            u, c = uniq[keep], cnt[keep]
            nw = torch.clamp(c / 32.0, max=1.0)
            Wg[u] += nw
            Sg[u] += sums[keep] / c[:, None] * nw[:, None]
            Hg[u] += 1.0
        t = torch.nonzero(Wg > 0).squeeze(1)
        w_new = self.W[t] + Wg[t]
        self.F[t] = (self.F[t] * self.W[t][:, None] + Sg[t]) / \
            torch.clamp(w_new, min=1e-12)[:, None]
        self.W[t] = w_new
        self.H[t] += Hg[t]
        return counts

    @property
    def ids(self):
        return torch.nonzero(self.alloc).squeeze(1)

    def lookup(self, flat):
        return self.alloc[flat], self.F[flat], self.W[flat], self.H[flat]

    def dense(self):
        return self.F.clone(), self.W.clone(), self.alloc.clone()


class WindowedPrior(ref_fusion.Prior):
    """The prior updated over the frustum's window whatever the layout, as
    the reference did before it followed the block-major layout."""

    def __init__(self, dimensions, voxel_size, device, windowed=True):
        super().__init__(dimensions, voxel_size, device, windowed=True)


@pytest.mark.parametrize("name", ["scene3d.stream", "arkit.stream",
                                  "scene3d.refine"])
def test_sparse_map_and_prior_rule_leave_dense_cells_alone(name,
                                                           monkeypatch):
    sparse = run_tiny(name)["readings"]
    monkeypatch.setattr(ref_fusion, "SparseMap", DenseMap)
    monkeypatch.setattr(ref_fusion, "Prior", WindowedPrior)
    dense = run_tiny(name)["readings"]
    assert sparse.keys() == dense.keys()
    for k in dense:
        assert sparse[k] == dense[k], (k, sparse[k], dense[k])


def _full_size(cell):
    """(the prior goes block-major, the map's voxels) of a cell at its
    full size, by the configuration's own rule."""
    from bnv_fusion_tpu_torch.config import load_config

    _, _, config, traffic = bench_run.load_cell(
        cell, bench_run.bench_with_parked())
    m = load_config(list(config["overrides"])).model
    dims = traffic["scene"]["dimensions"]
    return (ref_fusion.prior_is_blocks(str(getattr(m, "tsdf_layout", "auto")),
                                       dims, float(m.tsdf_voxel_size)),
            ref_fusion.Grid(dims, float(m.voxel_size), "cpu").n_vox)


@pytest.mark.parametrize("cell", ["scene3d.stream", "arkit.stream"])
def test_full_size_dense_cells_keep_the_dense_layouts(cell):
    from bnv_fusion_tpu_torch import tables

    blocks, n_vox = _full_size(cell)
    assert not blocks and n_vox < tables.DENSE_MAP_MAX_VOXELS


def test_house_takes_the_block_layouts():
    from bnv_fusion_tpu_torch import tables

    blocks, n_vox = _full_size("house.stream")
    assert blocks and tables.DENSE_MAP_MAX_VOXELS <= n_vox < 2 ** 31


@pytest.mark.chip
@pytest.mark.parametrize("name", ["scene3d.stream", "arkit.stream"])
def test_readings_repeat_and_match_the_dense_witness_on_the_card(
        name, cuda_device, monkeypatch):
    readings = []
    check = bench_run.reference_check

    def thrice(mode):
        readings.extend([check(mode), check(mode)])
        with monkeypatch.context() as m:
            m.setattr(ref_fusion, "SparseMap", DenseMap)
            readings.append(check(mode))
        return readings[0]

    monkeypatch.setattr(bench_run, "reference_check", thrice)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    bench_run.run_cell(name, 3_300_000_001, 1.0, False, cuda_device)
    assert readings[0] == readings[1] == readings[2], readings
