"""Port parity: the feature-major decode (``fusion.decode_points_fm``,
``decode_points(layout="fm")``), ``fusion.sdf_gradient`` and the render-loss
route that takes a decode layout (``render.calculate_loss``), against the
JAX package run eagerly on the CPU.

Map: 400 oriented points fused by the JAX package into a 24^3 dense table
(voxel 0.1), voxel weights lifted to 8 where fused (as
tests/test_decode_fm.py does), loaded into the port's table in the same slot
order; weights ``init_model(5, bias_std=0.1)``.

Tolerances (float32 on both sides, products and sums in other orders):
* fm decode against JAX's fm decode: atol 1e-5 (rtol 1e-5), NaN where JAX
  has NaN; port fm against port rows: atol 2e-5 (rtol 1e-5), the JAX
  package's own fm-vs-rows tolerance;
* feature gradients through fm against JAX's: atol 1e-4 * max|g|;
* ``sdf_gradient`` against JAX's, normalized or not, rows and fm: atol 1e-5
  (rtol 1e-5) on the points where every corner has weight (the decode there
  is smooth); every gradient finite;
* ``calculate_loss`` on injected jitter uniforms: loss rtol 1e-5 in both
  layouts, the bump corners equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import fusion as jfusion
from bnv_fusion_tpu import geometry as jgeom
from bnv_fusion_tpu import render as jrender
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu import table_dense as jtd
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import render as trender
from bnv_fusion_tpu_torch import table_dense as ttd

VS, MIN_PTS, N_XYZ = 0.1, 2, (24, 24, 24)
BOUND_MIN = np.array([-1.0, -1.0, -1.0], np.float32)


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(4)
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(5, bias_std=0.1))
    jparams = jax.tree.map(jnp.asarray, params)
    n = 400
    pts = rng.rand(n, 3).astype(np.float32) * 1.2 - 0.6
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    t = jtd.create_dense_table(list(N_XYZ), 4096, 8)
    t, _ = jfusion.fuse_frame(t, jparams, jnp.asarray(pts),
                              jnp.asarray(normals), jnp.ones((n,), bool),
                              jnp.asarray(BOUND_MIN), jnp.asarray(-BOUND_MIN),
                              VS, MIN_PTS, max_unique=4096)
    t = t.replace(weights=jnp.where(t.weights > 0, 8.0, 0.0))
    keys, feats, w, h, _ = jtables.active_entries(t)
    tt = ttd.load_entries(N_XYZ, t.capacity, keys, feats, w, h)
    delta = (rng.randn(10, 11, 12) * 0.01).astype(np.float32)
    # voxel coords over the fused region, a tenth of them on the lattice
    # (where ceil == floor and corners repeat)
    coords = rng.uniform(3.0, 17.0, (800, 3)).astype(np.float32)
    coords[::10] = np.round(coords[::10])
    tparams = tnn.params_from_numpy(params)
    # points near the surface: 300 whose 8 corners all carry weight and 100
    # masked ones
    cand = rng.uniform(-0.6, 0.6, (8000, 3)).astype(np.float32)
    live = torch.isfinite(tfusion.decode_points(
        tt.features, tt, tparams, torch.as_tensor(cand),
        torch.as_tensor(BOUND_MIN), VS, MIN_PTS,
        masked_fill=float("nan"))).numpy()
    near = np.concatenate([cand[live][:300], cand[~live][:100]])
    return dict(jt=t, tt=tt, params=params, jparams=jparams, tparams=tparams,
                delta=delta,
                qpts=rng.uniform(-0.9, 0.9, (3000, 3)).astype(np.float32),
                coords=coords, near=near)


def _args(world, use_delta, coords):
    q = world["coords"] if coords else world["qpts"]
    d = world["delta"] if use_delta else None
    return q, d


@pytest.mark.parametrize("coords", [False, True], ids=["points", "coords"])
@pytest.mark.parametrize("use_delta", [False, True], ids=["no_prior", "prior"])
def test_decode_fm_matches_jax(world, use_delta, coords):
    q, d = _args(world, use_delta, coords)
    jt = world["jt"]
    with jax.disable_jit():
        j = np.asarray(jfusion.decode_points_fm(
            jt.features, jt, world["jparams"], jnp.asarray(q),
            jnp.asarray(BOUND_MIN), VS, MIN_PTS,
            sdf_delta=None if d is None else jnp.asarray(d),
            n_xyz=jnp.asarray(N_XYZ), is_coords=coords,
            masked_fill=float("nan")))
    tt = world["tt"]
    t = tfusion.decode_points(
        tt.features, tt, world["tparams"], torch.as_tensor(q),
        torch.as_tensor(BOUND_MIN), VS, MIN_PTS,
        sdf_delta=None if d is None else torch.as_tensor(d), n_xyz=N_XYZ,
        is_coords=coords, masked_fill=float("nan"), layout="fm").numpy()
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5, equal_nan=True)
    assert np.isfinite(j).sum() > 50 and np.isnan(j).sum() > 50

    rows = tfusion.decode_points(
        tt.features, tt, world["tparams"], torch.as_tensor(q),
        torch.as_tensor(BOUND_MIN), VS, MIN_PTS,
        sdf_delta=None if d is None else torch.as_tensor(d), n_xyz=N_XYZ,
        is_coords=coords, masked_fill=float("nan")).numpy()
    np.testing.assert_allclose(t, rows, atol=2e-5, rtol=1e-5, equal_nan=True)


def test_decode_fm_feature_grads_match_jax(world):
    q = world["near"]
    jt, tt = world["jt"], world["tt"]

    def jloss(f):
        s = jfusion.decode_points_fm(f, jt, world["jparams"], jnp.asarray(q),
                                     jnp.asarray(BOUND_MIN), VS, MIN_PTS)
        return jnp.sum(jnp.sin(s))

    with jax.disable_jit():
        jg = np.asarray(jax.grad(jloss)(jt.features))
    f = tt.features.clone().requires_grad_(True)
    s = tfusion.decode_points(f, tt, world["tparams"], torch.as_tensor(q),
                              torch.as_tensor(BOUND_MIN), VS, MIN_PTS,
                              layout="fm")
    (tg,) = torch.autograd.grad(torch.sin(s).sum(), f)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=1e-4 * np.abs(jg).max())


def test_fm_with_the_fused_kernel_stays_on_rows(world):
    """layout=fm with the fused kernel runs the kernel's own (rows) path, as
    the JAX package does; on CPU tensors the wrapper runs its plain
    version."""
    tt, q = world["tt"], torch.as_tensor(world["qpts"])
    kw = dict(sdf_delta=torch.as_tensor(world["delta"]), n_xyz=N_XYZ,
              use_fused_kernel=True, masked_fill=float("nan"))
    a = tfusion.decode_points(tt.features, tt, world["tparams"], q,
                              torch.as_tensor(BOUND_MIN), VS, MIN_PTS,
                              layout="fm", **kw)
    b = tfusion.decode_points(tt.features, tt, world["tparams"], q,
                              torch.as_tensor(BOUND_MIN), VS, MIN_PTS,
                              layout="rows", **kw)
    assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    with pytest.raises(ValueError, match="unknown decode layout"):
        tfusion.decode_points(tt.features, tt, world["tparams"], q,
                              torch.as_tensor(BOUND_MIN), VS, MIN_PTS,
                              layout="cols")


@pytest.mark.parametrize("layout", ["rows", "fm"])
@pytest.mark.parametrize("normalize", [True, False],
                         ids=["normalized", "raw"])
def test_sdf_gradient_matches_jax(world, layout, normalize):
    q = world["near"]
    jt, tt = world["jt"], world["tt"]
    d = world["delta"]
    with jax.disable_jit():
        j = np.asarray(jfusion.sdf_gradient(
            jt.features, jt, world["jparams"], jnp.asarray(q),
            jnp.asarray(BOUND_MIN), VS, MIN_PTS, normalize=normalize,
            sdf_delta=jnp.asarray(d), n_xyz=jnp.asarray(N_XYZ),
            layout=layout))
        live = np.asarray(jfusion.decode_points(
            jt.features, jt, world["jparams"], jnp.asarray(q),
            jnp.asarray(BOUND_MIN), VS, MIN_PTS, masked_fill=float("nan")))
    live = np.isfinite(live)
    t = tfusion.sdf_gradient(
        tt.features, tt, world["tparams"], torch.as_tensor(q),
        torch.as_tensor(BOUND_MIN), VS, MIN_PTS, normalize=normalize,
        sdf_delta=torch.as_tensor(d), n_xyz=N_XYZ, layout=layout).numpy()
    assert t.shape == (len(q), 3) and np.isfinite(t).all()
    assert live.sum() == 300
    np.testing.assert_allclose(t[live], j[live], atol=1e-5, rtol=1e-5)
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(t[live], axis=-1), 1.0,
                                   atol=1e-3)


def test_sdf_gradient_refuses_the_fused_kernel(world):
    tt = world["tt"]
    with pytest.raises(ValueError, match="forward only"):
        tfusion.sdf_gradient(tt.features, tt, world["tparams"],
                             torch.as_tensor(world["near"]),
                             torch.as_tensor(BOUND_MIN), VS, MIN_PTS,
                             use_fused_kernel=True)


@pytest.mark.parametrize("layout", ["rows", "fm"])
def test_calculate_loss_matches_jax(world, layout):
    """The render loss through render_rays_sdf in either decode layout, on
    rays at the fused points, with the JAX key's jitter uniforms
    injected."""
    rng = np.random.RandomState(9)
    n, units, tdist, ray_max = 64, 4, 0.2, 3.0
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [0.0, 0.0, -1.5]
    intr = np.array([[60.0, 0, 40], [0, 60.0, 30], [0, 0, 1]], np.float32)
    uv = np.stack([rng.uniform(20, 60, n), rng.uniform(15, 45, n)],
                  -1).astype(np.float32)
    depth = rng.uniform(1.0, 2.0, n).astype(np.float32)
    dirs, cam = jgeom.get_camera_rays(jnp.asarray(uv), jnp.asarray(T_wc),
                                      jnp.asarray(intr))
    gt = np.array(cam[None] + dirs * jnp.asarray(depth)[:, None])
    nb = gt[:, None, :] + rng.randn(n, 9, 3).astype(np.float32) * 0.01
    nbm = (rng.rand(n, 9) > 0.2).astype(np.float32)
    mask = (rng.rand(n) > 0.1).astype(np.float32)
    key = jax.random.key(3)
    ts = jrender.draw_sampling_uniforms(key, n, 2 * units, int(ray_max * 5))
    jt, tt = world["jt"], world["tt"]
    jrays = jrender.Rays(*(jnp.asarray(x) for x in (uv, gt, mask, nb, nbm,
                                                    T_wc, intr)))
    with jax.disable_jit():
        jloss, jcorners = jrender.calculate_loss(
            jt.features, jt, world["jparams"], jrays, key,
            jnp.asarray(BOUND_MIN), VS, MIN_PTS, units, tdist, ray_max,
            jnp.asarray(world["delta"]), jnp.asarray(N_XYZ),
            decode_layout=layout)
    trays = trender.Rays(*(torch.as_tensor(x) for x in (uv, gt, mask, nb, nbm,
                                                        T_wc, intr)))
    tloss, tcorners = trender.calculate_loss(
        tt.features, tt, world["tparams"], trays,
        tuple(torch.as_tensor(np.asarray(u)) for u in ts),
        torch.as_tensor(BOUND_MIN), VS, MIN_PTS, units, tdist, ray_max,
        torch.as_tensor(world["delta"]), N_XYZ, decode_layout=layout)
    assert float(jloss) > 0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(tcorners.numpy(), np.asarray(jcorners))
    _, (_, ray_err) = trender.calculate_loss(
        tt.features, tt, world["tparams"], trays,
        tuple(torch.as_tensor(np.asarray(u)) for u in ts),
        torch.as_tensor(BOUND_MIN), VS, MIN_PTS, units, tdist, ray_max,
        torch.as_tensor(world["delta"]), N_XYZ, per_ray=True,
        decode_layout=layout)
    assert ray_err.shape == (n,)
    np.testing.assert_allclose(float(ray_err.sum() / (mask.sum() + 1e-4)),
                               float(tloss), rtol=1e-6)
