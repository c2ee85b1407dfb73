"""Port parity: one global-optimization step of bnv_fusion_tpu_torch against
the JAX package, on the same fused map, prior, frame and weights, with the
JAX-drawn pixel ids and sampling uniforms injected into the port.

Tolerances (float32 on both sides, products and sums in other orders):
* loss rtol 1e-5; per-chunk row cotangents atol 1e-4 * max|g|;
* bumped weights exact (integer bumps);
* the JAX reference runs jitted, and XLA fuses the sample arithmetic
  differently, so a ray sample within float noise of a voxel face, of a
  kink of the loss (the L1 sign, the truncation clip) or of a decoder ReLU
  (a hidden pre-activation within ~1e-6 of 0), can take another branch on
  one side.  At most 0.1% of the samples may differ beyond the
  tolerance above (a sample's cotangent rows are its 8 gathered corner
  rows); all others must agree.  Likewise at most 0.5% of
  the rows of the accumulated gradient (read back from the Adam first
  moment, mu = (1 - b1) g) may exceed atol 1e-4 * max|g| (the rows are
  summed by sort + float32 cumsum + difference on both sides, whose
  cancellation noise is ~1e-5 * max|g| here);
* Adam: the port's update applied to the JAX gradient (read back from the
  first moment) gives JAX's latents within float32 rounding of the result
  (atol 1e-9, rtol 2.4e-7, i.e. 2 ulp).  The step's own latents: the first
  Adam step moves a latent by lr_scale * lr * g / (|g| + eps), whose slope
  in g is lr_scale * lr * eps / (|g| + eps)**2, so each latent is held to
  that slope, taken at the end of [g_port, g_jax] nearest 0 (at 0 if the
  two straddle it), times |g_port - g_jax|, plus the same rounding bound;
  every row included.  lr_scale is 0.5 on both sides, so a dropped scale
  shows too.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import fusion as jfusion
from bnv_fusion_tpu import optimize as jopt
from bnv_fusion_tpu import pipeline as jpipe
from bnv_fusion_tpu import render as jrender
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu import tsdf as jtsdf
from bnv_fusion_tpu import voxel as jvoxel
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import optimize as topt
from bnv_fusion_tpu_torch import render as trender
from bnv_fusion_tpu_torch import table_dense as ttd

# min_pts_in_grid 0: at 60x80 a voxel gathers a few points per frame, so its
# fusion weight (count / 32 per frame) stays far below the default 8 and
# every decode would be masked to a constant (zero gradient)
VOXEL, MIN_PTS = 0.03, 0
N_RAYS, SPLITS = 200, 100
UNITS, RAY_MAX = 10, 3.0
TRUNC = min(UNITS * VOXEL * 0.5, 0.1)
N_FINE, N_COARSE = 2 * UNITS, int(RAY_MAX * 5)
LR, LR_SCALE, EPS = 1e-3, 0.5, 1e-8


@pytest.fixture(scope="module")
def world():
    cfg = jload_config(["dataset.img_res=[60,80]", "dataset.num_images=6",
                        f"model.voxel_size={VOXEL}"])
    ds = SyntheticDemoDataset(cfg, "val")
    frames = [ds[i] for i in range(3)]
    # non-zero biases (the init_model default zeroes them), so a dropped or
    # misplaced bias shows in the loss and its gradient
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(1, bias_std=0.1))
    mn, mx, n_xyz = jvoxel.get_world_range(ds.dimensions, VOXEL)
    pts = [jpipe._frame_points(jnp.asarray(f["depth"]), jnp.asarray(f["T_wc"]),
                               jnp.asarray(f["intr_mat"])) for f in frames]
    table = jtables.create_table(8, 1 << 16, n_xyz=n_xyz)
    table, _ = jax.jit(partial(
        jfusion.fuse_frames_merged, voxel_size=VOXEL, min_pts_in_grid=MIN_PTS,
        max_unique=16384, max_unique_cells=8192))(
        table, jax.tree.map(jnp.asarray, params),
        jnp.stack([p[0] for p in pts]), jnp.stack([p[1] for p in pts]),
        jnp.stack([p[2] for p in pts]), jnp.asarray(mn), jnp.asarray(mx))
    vol, _ = jtsdf.create_tsdf_volume(ds.dimensions, 0.025)
    for f in frames:
        vol = jtsdf.integrate(vol, jnp.asarray(f["depth"]),
                              jnp.asarray(f["intr_mat"]), jnp.asarray(f["T_wc"]),
                              0.025)
    delta = np.asarray(jtsdf.prepare_sdf_delta(vol, 0.025, TRUNC, 0.1))
    keys, feats, w, h, _ = jtables.active_entries(table)
    # the port's table holds the same entries in the same slot order
    ttable = ttd.load_entries(n_xyz, table.capacity, keys, feats, w, h)
    f = frames[1]
    key = jax.random.key(7)
    k_rays, k_chunks = jax.random.split(key)
    h_, w_ = f["depth"].shape
    pixel_ids = np.asarray(jax.random.choice(k_rays, h_ * w_, (N_RAYS,),
                                             replace=False))
    uniforms = [tuple(np.asarray(u) for u in jrender.draw_sampling_uniforms(
        k, SPLITS, N_FINE, N_COARSE))
        for k in jax.random.split(k_chunks, N_RAYS // SPLITS)]
    world = dict(table=table, ttable=ttable, params=params, delta=delta,
                 frame=f, key=key, pixel_ids=pixel_ids, uniforms=uniforms,
                 mn=mn, n_xyz=n_xyz)
    world["chunks"] = _jax_chunks(world)
    return world


def _jax_chunks(w):
    """Per ray chunk, on the JAX side (jitted): (loss, row cotangents,
    slots) against the start weights."""
    f = w["frame"]
    params = jax.tree.map(jnp.asarray, w["params"])

    @jax.jit
    def chunk_grads(table, rays, ts):
        prep, pts, cam = jrender.prepare_render(
            table, rays, None, jnp.asarray(w["mn"]), VOXEL, UNITS, TRUNC,
            RAY_MAX, jnp.asarray(w["delta"]), jnp.asarray(w["n_xyz"]), ts=ts)
        loss, g = jax.value_and_grad(lambda gf: jrender.eval_render_loss(
            gf, prep, params, rays, pts, cam, VOXEL, MIN_PTS, TRUNC))(
            table.features[prep.slots])
        return loss, g, prep.slots

    rays = jopt.build_rays_from_frame(
        None, jnp.asarray(f["depth"]), jnp.asarray(f["T_wc"]),
        jnp.asarray(f["intr_mat"]), RAY_MAX, N_RAYS,
        pixel_ids=jnp.asarray(w["pixel_ids"]))
    out = []
    for c in range(N_RAYS // SPLITS):
        sl = slice(c * SPLITS, (c + 1) * SPLITS)
        chunk = jrender.Rays(*(x[sl] for x in rays[:5]), rays.T_wc, rays.intr)
        res = chunk_grads(w["table"], chunk,
                          tuple(jnp.asarray(u) for u in w["uniforms"][c]))
        out.append(tuple(np.asarray(x) for x in res))
    return out


def test_chunk_loss_and_row_cotangents_match_jax(world):
    """Loss and d loss / d gathered rows of the first ray chunk."""
    w, f = world, world["frame"]
    jloss, jg, jslots = w["chunks"][0]
    t = torch.as_tensor
    tparams = tnn.params_from_numpy(w["params"])
    trays = topt.build_rays_from_frame(
        t(f["depth"]), t(f["T_wc"]), t(f["intr_mat"]), RAY_MAX, N_RAYS,
        pixel_ids=t(w["pixel_ids"]))
    tchunk = trender.Rays(*(x[:SPLITS] for x in trays[:5]), trays.T_wc,
                          trays.intr)
    tprep, tpts, tcam = trender.prepare_render(
        w["ttable"], tchunk, t(w["mn"]), VOXEL, UNITS, TRUNC, RAY_MAX,
        t(w["delta"]), w["n_xyz"], ts=tuple(t(u) for u in w["uniforms"][0]))
    np.testing.assert_array_equal(tprep.slots.numpy(), jslots)
    gf = w["ttable"].features[tprep.slots].clone().requires_grad_(True)
    tloss = trender.eval_render_loss(gf, tprep, tparams, tchunk, tpts, tcam,
                                     VOXEL, MIN_PTS, TRUNC)
    (tg,) = torch.autograd.grad(tloss, gf)

    assert float(jloss) > 0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert np.abs(jg).max() > 0
    row_off = np.abs(tg.numpy() - jg).max(1) > 1e-4 * np.abs(jg).max()
    assert row_off.reshape(-1, 8).any(1).mean() <= 1e-3


@pytest.mark.parametrize("parallel", [True, False],
                         ids=["parallel_chunks", "sequential_chunks"])
def test_optimize_step_matches_jax(world, parallel):
    """One full step: mean loss, count_optim-bumped weights, Adam-updated
    latents."""
    w, f = world, world["frame"]
    _, jstep, _ = jopt.make_optimize_step(
        jax.tree.map(jnp.asarray, w["params"]), VOXEL, MIN_PTS, UNITS, TRUNC,
        RAY_MAX, N_RAYS, SPLITS, lr=LR, parallel_chunks=parallel)
    opt_state = jopt.OptimState(
        features=w["table"].features + 0, weights=w["table"].weights + 0,
        opt_state=__import__("optax").adam(LR).init(w["table"].features))
    jstate, jloss = jstep(opt_state, w["table"], jnp.asarray(f["depth"]),
                          jnp.asarray(f["T_wc"]), jnp.asarray(f["intr_mat"]),
                          jnp.asarray(w["mn"]), jnp.asarray(w["n_xyz"]),
                          jnp.asarray(w["delta"]), w["key"],
                          lr_scale=LR_SCALE)

    t = torch.as_tensor
    tstep = topt.make_optimize_step(
        tnn.params_from_numpy(w["params"]), VOXEL, MIN_PTS, UNITS, TRUNC,
        RAY_MAX, N_RAYS, SPLITS, lr=LR, parallel_chunks=parallel)
    state = topt.init_optim_state(w["ttable"])
    state, tloss = tstep(
        state, w["ttable"], t(f["depth"]), t(f["T_wc"]), t(f["intr_mat"]),
        t(w["mn"]), w["n_xyz"], t(w["delta"]), pixel_ids=t(w["pixel_ids"]),
        uniforms=[tuple(t(u) for u in us) for us in w["uniforms"]],
        lr_scale=LR_SCALE)

    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jw = np.asarray(jstate.weights)
    np.testing.assert_array_equal(state.weights.numpy(), jw)
    assert (jw > np.asarray(w["table"].weights)).any()
    jf = np.asarray(jstate.features)
    moved = np.abs(jf - np.asarray(w["table"].features)).max()
    assert moved > 0.5 * LR * LR_SCALE
    jgrad = np.asarray(jstate.opt_state[0].mu) / 0.1
    tgrad = state.mu.numpy() / 0.1
    off = np.abs(tgrad - jgrad).max(1) > 1e-4 * np.abs(jgrad).max()
    assert off.sum() <= 0.005 * (np.abs(jgrad).max(1) > 0).sum()

    ref = topt.init_optim_state(w["ttable"])
    topt._adam_update(ref, t(jgrad), LR, LR_SCALE)
    np.testing.assert_allclose(ref.features.numpy(), jf, rtol=2.4e-7,
                               atol=1e-9)
    near0 = np.where(np.sign(tgrad) == np.sign(jgrad),
                     np.minimum(np.abs(tgrad), np.abs(jgrad)), 0.0)
    slope = LR_SCALE * LR * EPS / (near0 + EPS) ** 2
    bound = slope * np.abs(tgrad - jgrad) + 1e-9 + 2.4e-7 * np.abs(jf)
    assert np.all(np.abs(state.features.numpy() - jf) <= bound)
