"""Port parity of NeuralMap's batch routes: the unmerged batch step
(``model.fuse_batch_merge=false`` or ``fuse_algorithm: corner``),
``integrate_batches`` and the fuse epoch, against the JAX package and
against sequential ``integrate_batch`` calls.

Operating point: tests/test_torch_e2e.py's (60x80 synthetic frames, voxel
0.05, where each package's own back-projection puts every point in the same
cell; min_pts_in_grid 0; the batched front with the plain seg-reduce and
exact-f32 partial sums).  Tables are compared by voxel key: keys, weights
and hits exactly; features within 2e-5 on the batched front (direct
segment sums in two orders) and 2e-3 on the per-frame cumsum fronts
(tests/test_torch_fusion.py).  The TSDF prior: a voxel whose projection
lies within float noise of a pixel boundary may take the neighbouring
pixel on one side, so at most 0.1% of voxels may differ; the rest agree
within 1e-5 (tests/test_torch_fusion.py).  integrate_batches against
sequential calls is held bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu.pipeline import NeuralMap as JNeuralMap
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import tables as ttables
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

BASE = ["dataset.img_res=[60,80]", "dataset.num_images=4",
        "model.voxel_size=0.05", "model.min_pts_in_grid=0",
        "model.table_capacity=65536", "model.use_seg_reduce_kernel=interpret",
        "model.fuse_sort_bf16=false"]
# uint16 depth staging (bench.py's): with millimetre depths a few points land
# within float noise of a voxel face, where the two packages'
# back-projections may disagree in the last bit (6 of 7,934 voxels took
# another point count here), so it runs only where the port is held to itself
RAW = ["dataset.stage_raw_depth=true"]


@pytest.fixture(scope="module")
def stream():
    ds = SyntheticDemoDataset(jload_config(BASE), "val")
    raw = SyntheticDemoDataset(jload_config(BASE + RAW), "val")
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(0, bias_std=0.1))
    return dict(frames=[ds[i] for i in range(len(ds))], dims=ds.dimensions,
                raw=[raw[i] for i in range(len(raw))], params=params)


def _jmap(stream, extra=()):
    return JNeuralMap(stream["dims"], jload_config(BASE + list(extra)),
                      stream["params"])


def _tmap(stream, extra=()):
    return TNeuralMap(stream["dims"], tload_config(
        BASE + list(extra) + ["device_type=cpu"]), stream["params"])


def _by_key(entries):
    keys, feats, w, h, _ = entries
    o = np.lexsort(keys.T[::-1])
    return keys[o], feats[o], w[o], h[o]


def _assert_like_jax(jnm, tnm, atol):
    j = _by_key(jtables.active_entries(jnm.table))
    t = _by_key(ttables.active_entries(tnm.table))
    assert len(j[0]) > 1000
    for x, y in zip(t[:1] + t[2:], j[:1] + j[2:]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(t[1], j[1], atol=atol, rtol=0)
    jw, tw = np.asarray(jnm.tsdf_vol.weight), tnm.tsdf_vol.weight.numpy()
    bad = (np.abs(np.asarray(jnm.tsdf_vol.sdf) - tnm.tsdf_vol.sdf.numpy())
           > 1e-5) | (jw != tw)
    assert (jw > 0).sum() > 1000 and bad.mean() <= 1e-3, bad.sum()


@pytest.mark.parametrize("route", ["fuse_batch_merge=false",
                                   "fuse_algorithm=corner"])
def test_unmerged_batch_matches_jax(stream, route):
    """The unmerged route is a loop of per-frame steps: the same table as
    the JAX package's, the same as per-frame integrate calls, and the prior
    on EVERY frame at obs_weight 1 (tsdf_every=3 does not apply, so 4
    frames give weight 4, where the merged route gives 6)."""
    extra = [f"model.{route}", "model.tsdf_every=3"]
    jnm, tnm, seq = _jmap(stream, extra), _tmap(stream, extra), \
        _tmap(stream, extra)
    jnm.integrate_batch(stream["frames"])
    tnm.integrate_batch(stream["frames"])
    for f in stream["frames"]:
        seq.integrate(f)
    _assert_like_jax(jnm, tnm, 2e-3)
    for name in ("features", "weights", "num_hits", "slot_flat"):
        assert torch.equal(getattr(tnm.table, name),
                           getattr(seq.table, name)), name
    assert torch.equal(tnm.tsdf_vol.sdf, seq.tsdf_vol.sdf)
    assert float(tnm.tsdf_vol.weight.max()) == 4.0
    merged = _tmap(stream, ["model.tsdf_every=3"])
    merged.integrate_batch(stream["frames"])
    assert float(merged.tsdf_vol.weight.max()) == 6.0


@pytest.mark.parametrize("nan_pose", [False, True], ids=["staged", "nan"])
def test_integrate_batches_matches_sequential(stream, nan_pose):
    """integrate_batches == sequential integrate_batch calls, bit for bit:
    table rows, prior, kept frames; a NaN pose in the second batch drops
    that frame in both.  Frames staged as uint16 depth, as bench.py stages
    them."""
    frames = [dict(f) for f in stream["raw"]]
    if nan_pose:
        frames[3]["T_wc"] = np.full((4, 4), np.nan, np.float32)
    batches = [frames[:2], frames[2:]]
    a, b = _tmap(stream), _tmap(stream)
    for batch in batches:
        a.integrate_batch(batch)
    b.integrate_batches(batches)
    for name in ("features", "weights", "num_hits", "slot_flat", "slot_map"):
        assert torch.equal(getattr(a.table, name), getattr(b.table, name))
    assert torch.equal(a.tsdf_vol.sdf, b.tsdf_vol.sdf)
    assert torch.equal(a.tsdf_vol.weight, b.tsdf_vol.weight)
    assert len(a.frames) == len(b.frames) == 4 - nan_pose
    for fa, fb in zip(a.frames, b.frames):
        assert torch.equal(fa["depth"], fb["depth"])
    assert a.stats == b.stats


def test_integrate_batches_matches_jax(stream):
    """Both packages' integrate_batches over two K=2 batches: the same
    table by key and the same prior."""
    jnm, tnm = _jmap(stream), _tmap(stream)
    batches = [stream["frames"][:2], stream["frames"][2:]]
    jnm.integrate_batches(batches)
    tnm.integrate_batches(batches)
    _assert_like_jax(jnm, tnm, 2e-5)
    assert len(tnm.frames) == len(jnm.frames) == 4


def test_sort1_gather_option_changes_nothing(stream):
    """model.fuse_sort1_gather=true is accepted and fuses the same table,
    prior and stats as the default, bit for bit (the port keeps one of the
    JAX package's two bit-identical stage-1 sorts)."""
    a, b = _tmap(stream), _tmap(stream, ["model.fuse_sort1_gather=true"])
    for nm in (a, b):
        nm.integrate_batch(stream["frames"])
    for name in ("features", "weights", "num_hits", "slot_flat"):
        assert torch.equal(getattr(a.table, name), getattr(b.table, name))
    assert torch.equal(a.tsdf_vol.sdf, b.tsdf_vol.sdf)
    assert a.stats == b.stats


def test_fuse_epoch_bumps_like_jax(stream):
    """The fuse epoch (the mesh prefetch's validity token) moves where the
    JAX package moves it: once per integrate and per fused batch, not for
    a batch whose every pose is NaN."""
    jnm, tnm = _jmap(stream), _tmap(stream)
    bad = dict(stream["frames"][0],
               T_wc=np.full((4, 4), np.nan, np.float32))
    for nm in (jnm, tnm):
        nm.integrate(stream["frames"][0])
        nm.integrate_batch([bad, bad])
        nm.integrate_batch(stream["frames"][1:3])
        nm.integrate_batches([stream["frames"][:2], stream["frames"][2:]])
    assert tnm._fuse_epoch == jnm._fuse_epoch == 4
