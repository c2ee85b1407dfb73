"""Port parity of the block-major TSDF prior (bnv_fusion_tpu_torch.tsdf's
TSDFVolumeBM, integrate_blocks, frustum_max_blocks, the two converters,
as_dense and the consumers that read through it) and of the merged K-frame
integrate_batch, against the JAX package on the same numpy frames.

Priors are held to 1e-6 (the same projection and running mean in both
frameworks) and colour means to 1e-4 of their 0-255 scale, on all but
EDGE_SHARE of the voxels: a voxel whose projection lies within float noise
of a pixel's edge samples the neighbouring pixel on one side (the boundary
ROADMAP Queue 3 records for the dense prior; 1 of 59,136 voxels here).
integrate_blocks is also held against the port's own dense integrate: the
same voxels and values, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import tsdf as jtsdf
from bnv_fusion_tpu.datasets.synth_scene import look_at_pose
from bnv_fusion_tpu_torch import tsdf as ttsdf

DIMS = np.array([2.0, 2.1, 1.5], np.float32)   # a grid of 42 x 44 x 32
VS = 0.05
H, W = 48, 64
INTR = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
MAX_DEPTH = 2.0
SDF_ATOL = 1e-6
COLOR_ATOL = 1e-4
EDGE_SHARE = 1e-3


def _frames(seed, n=3, target=(0.0, 0.0, 0.0)):
    """Random depth (10% holes), colour and look-at poses around the
    scene, none axis-aligned."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        depth = (0.6 + 0.9 * rng.rand(H, W)).astype(np.float32)
        depth[rng.rand(H, W) < 0.1] = 0.0
        eye = rng.uniform(-1.2, 1.2, 3)
        T_wc = look_at_pose(eye, np.asarray(target) +
                            rng.uniform(-0.3, 0.3, 3)).astype(np.float32)
        rgb = rng.randint(0, 256, (H, W, 3)).astype(np.float32)
        out.append((depth, T_wc, rgb))
    return out


def _close(got, want, atol):
    """Within atol on all but EDGE_SHARE of the entries (pixel-edge
    voxels)."""
    far = np.abs(np.asarray(got) - np.asarray(want)) > atol
    assert far.mean() <= EDGE_SHARE, (far.sum(), far.size)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def test_create_matches_jax():
    """The block grid, true dims, origin and the -trunc init."""
    jv, jtr = jtsdf.create_tsdf_volume_bm(DIMS, VS, with_color=True)
    tv, ttr = ttsdf.create_tsdf_volume_bm(DIMS, VS, with_color=True)
    assert (tv.vol_dim, tv.nb_xyz, ttr) == (jv.vol_dim, jv.nb_xyz, jtr)
    assert tv.vol_dim[0] % 4
    for f in ("sdf", "weight", "origin", "color"):
        np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                      np.asarray(getattr(jv, f)))
    assert int(tv.overflow) == 0


@pytest.mark.parametrize("fx,hw,max_depth,vs,nb", [
    (60.0, (48, 64), 2.0, 0.05, (11, 11, 8)),
    (480.0, (480, 640), 3.0, 0.025, (141, 141, 41)),
    (525.0, (480, 640), 4.0, 0.02, (200, 200, 60)),
    (20.0, (30, 40), 5.0, 0.05, (3, 3, 3))])
def test_frustum_max_blocks_equal(fx, hw, max_depth, vs, nb):
    """frustum_max_blocks: equal ints, at the bigscene point too, and
    capped at the block grid."""
    h, w = hw
    intr = np.array([[fx, 0, w / 2 - 0.5], [0, fx, h / 2 + 0.5], [0, 0, 1]],
                    np.float32)
    got = ttsdf.frustum_max_blocks(intr, hw, max_depth, vs, nb)
    assert isinstance(got, int)
    assert got == jtsdf.frustum_max_blocks(intr, hw, max_depth, vs, nb)
    assert got <= int(np.prod(nb))


@pytest.mark.parametrize("tail", [(), (3,)], ids=["scalar", "rgb"])
def test_converters_match_jax(tail):
    """dense_to_bm and bm_to_dense on dims that are no multiple of 4 (the
    padding), with and without a channel tail: exact and inverse."""
    jv, _ = jtsdf.create_tsdf_volume_bm(DIMS, VS)
    tv, _ = ttsdf.create_tsdf_volume_bm(DIMS, VS)
    dense = np.random.RandomState(1).randn(*(tv.vol_dim + tail)) \
        .astype(np.float32)
    tb = ttsdf.dense_to_bm(tv, _t(dense))
    jb = jtsdf.dense_to_bm(jv, _j(dense), field_tail=tail)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    tv.color = tb if tail else None
    tv.sdf = tb if not tail else tv.sdf
    back = ttsdf.bm_to_dense(tv, "color" if tail else "sdf")
    np.testing.assert_array_equal(back.numpy(), dense)


def _integrate_both(frames, obs_weight, with_color, max_blocks=None):
    jv, _ = jtsdf.create_tsdf_volume_bm(DIMS, VS, with_color=with_color)
    tv, _ = ttsdf.create_tsdf_volume_bm(DIMS, VS, with_color=with_color)
    mb = max_blocks or jtsdf.frustum_max_blocks(INTR, (H, W), MAX_DEPTH, VS,
                                                jv.nb_xyz)
    for depth, T_wc, rgb in frames:
        jv = jtsdf.integrate_blocks(jv, _j(depth), _j(INTR), _j(T_wc), VS, mb,
                                    MAX_DEPTH, obs_weight=obs_weight,
                                    rgb=_j(rgb) if with_color else None)
        ttsdf.integrate_blocks(tv, _t(depth), _t(INTR), _t(T_wc), VS, mb,
                               MAX_DEPTH, obs_weight=obs_weight,
                               rgb=_t(rgb) if with_color else None)
    return jv, tv


def _same_prior(tv, jv):
    jd, td = jtsdf.as_dense(jv), ttsdf.as_dense(tv)
    np.testing.assert_array_equal(td.weight.numpy(), np.asarray(jd.weight))
    _close(td.sdf.numpy(), jd.sdf, SDF_ATOL)
    if jv.color is not None:
        _close(td.color.numpy(), jd.color, COLOR_ATOL)
    assert int(tv.overflow) == int(jv.overflow)


@pytest.mark.parametrize("obs_weight,with_color", [(1.0, False), (4.0, True)],
                         ids=["plain", "rgb_obs4"])
def test_integrate_blocks_matches_jax(obs_weight, with_color):
    """Three frames through integrate_blocks (with obs_weight and the rgb
    running mean): the same updated voxels, sdf within 1e-6."""
    jv, tv = _integrate_both(_frames(0), obs_weight, with_color)
    assert int(tv.overflow) == 0
    assert (ttsdf.as_dense(tv).weight.numpy() > 0).mean() > 0.05
    _same_prior(tv, jv)


def test_integrate_blocks_overflow_matches_jax():
    """A block budget far below the frustum's: the same bricks kept (the
    lowest ids), the same drops counted."""
    jv, tv = _integrate_both(_frames(2, n=2), 1.0, False, max_blocks=40)
    assert int(tv.overflow) > 0
    _same_prior(tv, jv)


def test_integrate_blocks_equals_dense_integrate():
    """integrate_blocks against the port's dense integrate on the same
    frames, including a view of the grid's far corner, whose last brick is
    active while the compacted id list still has pad entries (they point
    at that brick and must not write stale rows over it)."""
    dims = DIMS * 2                      # the grid's far corner: (2, 2.1, 1.5)
    rng = np.random.RandomState(4)
    corner = [((1.9 + 0.1 * rng.rand(H, W)).astype(np.float32),
               look_at_pose(np.array([1.0, 1.1, 0.6 + 0.2 * i]),
                            np.array([2.1, 2.2, 1.6])).astype(np.float32),
               rng.randint(0, 256, (H, W, 3)).astype(np.float32))
              for i in range(2)]
    frames = _frames(3) + corner
    tv, _ = ttsdf.create_tsdf_volume_bm(dims, VS, with_color=True)
    td, _ = ttsdf.create_tsdf_volume(dims, VS, with_color=True)
    mb = ttsdf.frustum_max_blocks(INTR, (H, W), MAX_DEPTH, VS, tv.nb_xyz)
    assert mb < int(np.prod(tv.nb_xyz))
    for depth, T_wc, rgb in frames:
        ttsdf.integrate_blocks(tv, _t(depth), _t(INTR), _t(T_wc), VS, mb,
                               MAX_DEPTH, rgb=_t(rgb))
        ttsdf.integrate(td, _t(depth), _t(INTR), _t(T_wc), VS, rgb=_t(rgb))
    assert int(tv.overflow) == 0
    assert (tv.weight[-1] > 0).any()      # the last brick was updated
    got = ttsdf.as_dense(tv)
    np.testing.assert_array_equal(got.weight.numpy(), td.weight.numpy())
    np.testing.assert_allclose(got.sdf.numpy(), td.sdf.numpy(),
                               atol=SDF_ATOL)
    np.testing.assert_allclose(got.color.numpy(), td.color.numpy(),
                               atol=COLOR_ATOL)


def test_consumers_read_through_as_dense():
    """as_dense, prepare_sdf_delta and sample_color on a block-major volume
    equal the JAX package's (sample_color through as_dense there)."""
    jv, tv = _integrate_both(_frames(5), 1.0, True)
    delta_t = ttsdf.prepare_sdf_delta(tv, VS, 0.04, 0.3)
    delta_j = jtsdf.prepare_sdf_delta(jv, VS, 0.04, 0.3)
    assert tuple(delta_t.shape) == tv.vol_dim
    _close(delta_t.numpy(), delta_j, SDF_ATOL)
    pts = (np.random.RandomState(6).rand(3000, 3) * DIMS - DIMS / 2) \
        .astype(np.float32)
    got = ttsdf.sample_color(tv, _t(pts), VS).numpy()
    want = np.asarray(jtsdf.sample_color(jtsdf.as_dense(jv), _j(pts), VS))
    assert (np.abs(got.astype(int) - want.astype(int)) <= 1).all()
    assert (got == want).mean() > 0.999
    np.testing.assert_array_equal(
        got, ttsdf.sample_color(ttsdf.as_dense(tv), _t(pts), VS).numpy())


def test_integrate_batch_matches_jax():
    """The merged K-frame dense update (with colour): the JAX package's
    integrate_batch on the same frames, and the port's sequential
    integrate up to the merge's regrouping of the running mean."""
    frames = _frames(7)
    depths, poses, rgbs = (np.stack([f[i] for f in frames]) for i in range(3))
    intrs = np.stack([INTR] * len(frames))
    jv, _ = jtsdf.create_tsdf_volume(DIMS, VS, with_color=True)
    tv, _ = ttsdf.create_tsdf_volume(DIMS, VS, with_color=True)
    jv = jtsdf.integrate_batch(jv, _j(depths), _j(intrs), _j(poses), VS,
                               obs_weight=2.0, rgbs=_j(rgbs))
    ttsdf.integrate_batch(tv, _t(depths), _t(intrs), _t(poses), VS,
                          obs_weight=2.0, rgbs=_t(rgbs))
    np.testing.assert_array_equal(tv.weight.numpy(), np.asarray(jv.weight))
    _close(tv.sdf.numpy(), jv.sdf, SDF_ATOL)
    _close(tv.color.numpy(), jv.color, COLOR_ATOL)
    seq, _ = ttsdf.create_tsdf_volume(DIMS, VS, with_color=True)
    for depth, T_wc, rgb in frames:
        ttsdf.integrate(seq, _t(depth), _t(INTR), _t(T_wc), VS,
                        obs_weight=2.0, rgb=_t(rgb))
    np.testing.assert_array_equal(tv.weight.numpy(), seq.weight.numpy())
    np.testing.assert_allclose(tv.sdf.numpy(), seq.sdf.numpy(), atol=1e-5)
