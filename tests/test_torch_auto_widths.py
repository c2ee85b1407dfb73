"""Port parity of the auto compaction widths (``model.max_unique_per_frame:
auto``): the occupancy probe ``fusion.frame_width_counts``, the sizing
``NeuralMap._size_widths``, and the lagged overflow monitor that widens the
widths (``_note_overflow``, ``_widen``), against the JAX package.

The probe's counts are integers and must be EXACT, so the module-level test
feeds both packages the same points.  The NeuralMap tests run at voxel 0.05,
where the synthetic stream has no point within float noise of a voxel face
(tests/test_torch_e2e.py), so each package's own back-projection lands
every point in the same cell and the probed widths must be equal too.
Tables are compared by voxel key: keys, weights and hits exactly, features
within 2e-3 (the per-frame cumsum front's noise, as the JAX package's own
auto == explicit test allows, tests/test_auto_widths.py:100-105).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import fusion as jfusion
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu.pipeline import NeuralMap as JNeuralMap
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import tables as ttables
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

BASE = ["dataset.img_res=[60,80]", "dataset.num_images=4",
        "model.voxel_size=0.05", "model.min_pts_in_grid=1",
        "model.table_capacity=65536"]


@pytest.fixture(scope="module")
def stream():
    cfg = jload_config(BASE)
    ds = SyntheticDemoDataset(cfg, "val")
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(0, bias_std=0.1))
    return dict(frames=[ds[i] for i in range(len(ds))], dims=ds.dimensions,
                params=params)


def _maps(stream, extra):
    jnm = JNeuralMap(stream["dims"], jload_config(BASE + extra),
                     stream["params"])
    tnm = TNeuralMap(stream["dims"], tload_config(BASE + extra +
                                                  ["device_type=cpu"]),
                     stream["params"])
    return jnm, tnm


def _by_key(entries):
    keys, feats, w, h, _ = entries
    o = np.lexsort(keys.T[::-1])
    return keys[o], feats[o], w[o], h[o]


def test_frame_width_counts_matches_jax():
    """Random points (some outside the bounds, some invalid), batched over
    3 frames: the same (groups, corners) integers as the JAX probe, which
    equal a brute-force unique over the keys and the corner fuse's count."""
    rng = np.random.RandomState(11)
    pts = (rng.rand(3, 2048, 3).astype(np.float32) * 2.2 - 1.1)
    pts[:, :16] = np.floor(pts[:, :16] / 0.05) * 0.05     # on voxel faces
    valid = rng.rand(3, 2048) > 0.05
    n_xyz = np.array([40, 40, 40], np.int32)
    n_vox = int(n_xyz.prod())
    bmin, bmax = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    g, c = tfusion.frame_width_counts(
        torch.as_tensor(pts), torch.as_tensor(valid), torch.as_tensor(bmin),
        torch.as_tensor(bmax), 0.05, n_xyz, n_vox)
    assert g.dtype == c.dtype == torch.int32 and g.shape == (3,)
    for k in range(3):
        jg, jc = jfusion.frame_width_counts(
            jnp.asarray(pts[k]), jnp.asarray(valid[k]), jnp.asarray(bmin),
            jnp.asarray(bmax), 0.05, jnp.asarray(n_xyz), n_vox)
        assert (int(g[k]), int(c[k])) == (int(jg), int(jc))
        inside, cell, mcode, _ = tfusion._cell_keys(
            torch.as_tensor(pts[k]), torch.as_tensor(valid[k]),
            torch.as_tensor(bmin), torch.as_tensor(bmax), 0.05, n_xyz, n_vox)
        pairs = torch.stack([cell, mcode], -1)[inside].numpy()
        assert int(g[k]) == len(np.unique(pairs, axis=0))
        table = ttables.create_table(8, 1 << 15, n_xyz=n_xyz)
        tfusion.fuse_frame_sorted(
            table, tnn.init_model(0), torch.as_tensor(pts[k]),
            torch.zeros((2048, 3)), torch.as_tensor(valid[k]),
            torch.as_tensor(bmin), torch.as_tensor(bmax), 0.05, 1)
        assert int(c[k]) == int(table.n_alloc)


@pytest.mark.parametrize("route", ["batch", "frame"])
def test_size_widths_matches_jax(stream, route):
    """The first integrate_batch (or integrate) probes and sizes the widths
    exactly as the JAX package does; the probe's per-frame counts agree."""
    jnm, tnm = _maps(stream, ["model.max_unique_per_frame=auto"])
    frames = stream["frames"]
    if route == "batch":
        jnm.integrate_batch(frames)
        tnm.integrate_batch(frames)
    else:
        jnm.integrate(frames[0])
        tnm.integrate(frames[0])
    assert tnm._widths == jnm._widths
    mu, cells = tnm._widths
    assert mu % 4096 == 0 and cells >= 4096 and mu <= 8 * cells
    jg, jc = jnm._probe_width_counts(*jnm._last_staged_dev)
    tg, tc = tnm._probe_width_counts(*tnm._last_staged_dev)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_auto_widths_match_explicit(stream):
    """Auto widths (all three 'auto', 'auto' per batch = 2 x per frame)
    fuse what wide explicit widths fuse, and what the JAX package's auto
    widths fuse; no overflow."""
    auto = ["model.max_unique_per_frame=auto",
            "model.max_unique_cells_per_frame=auto",
            "model.max_unique_per_batch=auto"]
    jnm, tnm = _maps(stream, auto)
    _, wide = _maps(stream, ["model.max_unique_per_frame=32768",
                             "model.max_unique_cells_per_frame=16384"])
    frames = stream["frames"]
    for nm in (jnm, tnm, wide):
        nm.integrate_batch(frames[:2])
        nm.integrate_batch(frames[2:])
    assert tnm.overflow == 0 == wide.overflow == jnm.overflow
    assert tnm._widths[0] < 32768 and tnm._mu_batch is None
    a = _by_key(ttables.active_entries(tnm.table))
    b = _by_key(ttables.active_entries(wide.table))
    j = _by_key(jtables.active_entries(jnm.table))
    for other in (b, j):
        for x, y in zip(a[:1] + a[2:], other[:1] + other[2:]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(a[1], other[1], atol=2e-3, rtol=0)


def test_overflow_widens_like_jax(stream):
    """An undersized margin overflows; the lagged monitor widens to the
    same widths as the JAX package's, and the widened step keeps fusing
    finite features.  (At voxel 0.02 a few points sit within float noise of
    a voxel face, so the two packages' drop counts may differ slightly;
    the widths come from the probe of one frame and agree.)"""
    extra = ["model.max_unique_per_frame=auto", "model.width_margin=0.05",
             "model.voxel_size=0.02"]
    jnm, tnm = _maps(stream, extra)
    frames = stream["frames"]
    jnm.integrate(frames[0])
    tnm.integrate(frames[0])
    first = tnm._widths
    assert first == jnm._widths
    assert int(tnm.table.overflow) > 0
    for f in frames[1:]:
        jnm.integrate(f)
        tnm.integrate(f)
    jnm._note_overflow(flush=True)
    tnm._note_overflow(flush=True)
    assert tnm._overflow_seen > 0 and tnm._widths[0] > first[0]
    assert tnm._widths == jnm._widths
    tnm.integrate(frames[0])
    assert bool(torch.isfinite(tnm.table.features).all())


def test_overflow_monitor_reads_copies(stream):
    """The monitor queues copies of the counter: the table's counter moves
    on after the copy is queued, and the copy keeps the earlier value."""
    _, tnm = _maps(stream, ["model.max_unique_per_frame=auto",
                            "model.width_margin=0.05",
                            "model.voxel_size=0.02"])
    tnm.integrate(stream["frames"][0])
    (val, ev), = tnm._overflow_lag
    before = int(val)
    assert ev is None and before == int(tnm.table.overflow) > 0
    tnm.integrate(stream["frames"][1])
    assert int(tnm.table.overflow) > before == int(tnm._overflow_lag[0][0])
