"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have (a step that leaves its state unchanged, half of
the batch left out with the mean over the rest, an answer altered where it
is produced), planted in the system at a CPU size; on the block table and
the block-major prior besides, one slot's write dropped, a brick of the
prior left stale, and a block allocated that no frame touched.  One card,
so no exchange between cards to leave out."""

import pytest
import torch

from benchmark.tests.tiny import run_tiny


def _unchanged(fn):
    def broken(table, *a, **k):
        saved = {n: v.clone() for n, v in vars(table).items()
                 if torch.is_tensor(v)}
        out = fn(table, *a, **k)
        for n, v in saved.items():
            getattr(table, n).copy_(v)
        return out
    return broken


def _dropped_slot(fn):
    def broken(table, *a, **k):
        saved = [t.clone() for t in (table.features, table.weights,
                                     table.num_hits)]
        out = fn(table, *a, **k)
        i = int(torch.nonzero(table.weights != saved[1])[0, 0])
        for t, v in zip((table.features, table.weights, table.num_hits),
                        saved):
            t[i] = v[i]
        return out
    return broken


def _extra_block(fn):
    def broken(table, *a, **k):
        out = fn(table, *a, **k)
        # the grid's last free block lies under the ceiling, which no frame
        # of the house scans sees
        free = torch.nonzero(table.block_map < 0)[-1, 0]
        table.block_map[free] = int(table.n_alloc)
        table.n_alloc = table.n_alloc + 1
        return out
    return broken


def _stale_brick(mp):
    from bnv_fusion_tpu_torch import tsdf

    fn = tsdf.integrate_blocks

    def broken(vol, *a, **k):
        saved = vol.sdf.clone(), vol.weight.clone()
        out = fn(vol, *a, **k)
        b = int(torch.nonzero((vol.weight != saved[1]).any(1))[0, 0])
        vol.sdf[b], vol.weight[b] = saved[0][b], saved[1][b]
        return out
    mp.setattr(tsdf, "integrate_blocks", broken)


def _altered(fn):
    def broken(table, *a, **k):
        out = fn(table, *a, **k)
        i = int(torch.nonzero(table.weights > 0)[0, 0])
        table.features[i, 0] += 0.05
        return out
    return broken


def _half_frames(fn):
    def broken(table, params, pts, normals, valid, *a, **k):
        h = pts.shape[0] // 2
        return fn(table, params, pts[:h], normals[:h], valid[:h], *a, **k)
    return broken


def _half_points(fn):
    def broken(table, params, pts, normals, valid, *a, **k):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return fn(table, params, pts, normals, valid, *a, **k)
    return broken


def _fuse_fault(name, make):
    def plant(mp):
        from bnv_fusion_tpu_torch import fusion

        fn = getattr(fusion, name)
        mp.setattr(fusion, name, make(fn))
    return plant


def _adam_unchanged(mp):
    from bnv_fusion_tpu_torch import optimize

    mp.setattr(optimize, "_adam_update", lambda *a, **k: None)


def _half_rays(mp):
    from bnv_fusion_tpu_torch import render

    fn = render.compute_sdf_loss

    def broken(rays, *a, **k):
        mask = rays.mask.clone()
        mask[: mask.shape[0] // 2] = 0
        return fn(rays._replace(mask=mask), *a, **k)
    mp.setattr(render, "compute_sdf_loss", broken)


def _mesh_altered(method):
    def plant(mp):
        from bnv_fusion_tpu_torch.pipeline import NeuralMap

        fn = getattr(NeuralMap, method)

        def broken(self, *a, **k):
            m = fn(self, *a, **k)
            if m is not None and len(m.vertices):
                m.vertices[len(m.vertices) // 2] += 0.05 * self.voxel_size
            return m
        mp.setattr(NeuralMap, method, broken)
    return plant


FAULTS = {
    ("scene3d.stream", "unchanged"): _fuse_fault("fuse_frames_merged",
                                                 _unchanged),
    ("scene3d.stream", "half_batch"): _fuse_fault("fuse_frames_merged",
                                                  _half_frames),
    ("scene3d.stream", "altered"): _fuse_fault("fuse_frames_merged",
                                               _altered),
    ("arkit.stream", "unchanged"): _fuse_fault("fuse_frame", _unchanged),
    ("arkit.stream", "half_batch"): _fuse_fault("fuse_frame", _half_points),
    ("arkit.stream", "altered"): _fuse_fault("fuse_frame", _altered),
    ("scene3d.refine", "unchanged"): _adam_unchanged,
    ("scene3d.refine", "half_batch"): _half_rays,
    ("scene3d.refine", "altered"): _mesh_altered("extract_mesh"),
    ("arkit.demo", "unchanged"): _adam_unchanged,
    ("arkit.demo", "half_batch"): _half_rays,
    ("arkit.demo", "altered"): _mesh_altered("extract_mesh_incremental"),
    ("house.stream", "unchanged"): _fuse_fault("fuse_frames_merged",
                                               _unchanged),
    ("house.stream", "half_batch"): _fuse_fault("fuse_frames_merged",
                                                _half_frames),
    ("house.stream", "altered"): _fuse_fault("fuse_frames_merged", _altered),
    ("house.stream", "dropped_slot"): _fuse_fault("fuse_frames_merged",
                                                  _dropped_slot),
    ("house.stream", "extra_block"): _fuse_fault("fuse_frames_merged",
                                                 _extra_block),
    ("house.stream", "stale_brick"): _stale_brick,
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[(cell, fault)](monkeypatch)
    r = run_tiny(cell)
    assert not r["correct"], r["checks"]
