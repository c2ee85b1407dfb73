"""Port parity: the global optimization's options against the JAX package:
``model.optim_dtype=bfloat16``, ``model.error_guided_sampling`` and
``trainer.optim_early_stop`` (with ``last_optimize_iters``).

Map: 3 frames of the synthetic stream at 60x80, fused by the JAX package
(voxel 0.03, min_pts_in_grid 0) and loaded into the port's table in the same
slot order, with its TSDF prior; weights ``init_model(1, bias_std=0.1)``;
200 rays in 2 chunks.  JAX's pixel ids and jitter uniforms are injected into
the port, and the JAX functions run eagerly (``jax.disable_jit``), so both
sides take the same branches.

Tolerances:
* bf16 chunk loss: rtol 2e-6 (8.1e-7 measured); row cotangents: at least
  95% of the entries that are nonzero on either side within 1e-5 relative
  (+ 1e-6 * max|g|) of JAX's (97.1% / 97.3% measured).  Operands are rounded
  to bfloat16 on both sides and products summed in float32 in another
  order, so a value near a rounding boundary can round the other way; such
  a flip moves a row's entries by about 2^-8 relative;
* bf16 step: loss rtol 2e-6 (1.4e-7 measured); the Adam first moment (the
  summed row cotangents): at least 90% of its nonzero entries within 1e-3
  relative (+ 1e-6 * max) of JAX's (93.1% measured; the scatter sums rows
  in another order, and a sum that cancels keeps the flips' error);
  bumped weights exact, latents within the first Adam step's slope bound of
  tests/test_torch_optimize.py taken on the two gradients.  Products
  rounded to bfloat16 (torch's own bf16 matmul), one hidden layer left
  unrounded, and a float32 decode each fail these checks: at most 44% of
  the cotangents and 31% of the moments close, loss rel up to 1.1e-4;
* decode_layout=fm step: bit-equal to the rows step, loss rtol 1e-5
  against JAX's fm step;
* error-guided step: loss rtol 1e-5, per-ray errors atol 1e-6 (rtol 1e-5),
  the new error map atol 1e-6 (rtol 1e-5);
* early stopping: iteration counts equal to the JAX package's, exactly.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bnv_fusion_tpu import fusion as jfusion
from bnv_fusion_tpu import optimize as jopt
from bnv_fusion_tpu import pipeline as jpipe
from bnv_fusion_tpu import render as jrender
from bnv_fusion_tpu import sampler as jsampler
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu import tsdf as jtsdf
from bnv_fusion_tpu import voxel as jvoxel
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu.pipeline import NeuralMap as JNeuralMap
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import optimize as topt
from bnv_fusion_tpu_torch import render as trender
from bnv_fusion_tpu_torch import table_dense as ttd
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

VOXEL, MIN_PTS = 0.03, 0
N_RAYS, SPLITS = 200, 100
UNITS, RAY_MAX = 10, 3.0
TRUNC = min(UNITS * VOXEL * 0.5, 0.1)
N_FINE, N_COARSE = 2 * UNITS, int(RAY_MAX * 5)
LR, LR_SCALE, EPS = 1e-3, 0.5, 1e-8
t = torch.as_tensor


@pytest.fixture(scope="module")
def world():
    cfg = jload_config(["dataset.img_res=[60,80]", "dataset.num_images=6",
                        f"model.voxel_size={VOXEL}"])
    ds = SyntheticDemoDataset(cfg, "val")
    frames = [ds[i] for i in range(3)]
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
    ttable = ttd.load_entries(n_xyz, table.capacity, keys, feats, w, h)
    return dict(table=table, ttable=ttable, params=params,
                tparams=tnn.params_from_numpy(params), delta=delta,
                frame=frames[1], mn=mn, n_xyz=n_xyz)


def _draws(key, n_rays=N_RAYS, pixel_ids=None):
    """The pixel ids (unless given) and per-chunk uniforms JAX's step draws
    from ``key``."""
    k_rays, k_chunks = jax.random.split(key)
    if pixel_ids is None:
        pixel_ids = jax.random.choice(k_rays, 60 * 80, (n_rays,),
                                      replace=False)
    uniforms = [tuple(np.asarray(u) for u in jrender.draw_sampling_uniforms(
        k, SPLITS, N_FINE, N_COARSE))
        for k in jax.random.split(k_chunks, n_rays // SPLITS)]
    return np.array(pixel_ids), uniforms


def _jax_step(w, key, *, error_map=None, **kw):
    """One JAX optimize step, run eagerly, from a fresh Adam state (the
    sequential chunk schedule, whose eager ops are those of ``_chunk``)."""
    _, jstep, _ = jopt.make_optimize_step(
        jax.tree.map(jnp.asarray, w["params"]), VOXEL, MIN_PTS, UNITS, TRUNC,
        RAY_MAX, N_RAYS, SPLITS, lr=LR, **kw)
    f = w["frame"]
    state = jopt.OptimState(
        features=w["table"].features + 0, weights=w["table"].weights + 0,
        opt_state=optax.adam(LR).init(w["table"].features))
    args = (state, w["table"], jnp.asarray(f["depth"]), jnp.asarray(f["T_wc"]),
            jnp.asarray(f["intr_mat"]), jnp.asarray(w["mn"]),
            jnp.asarray(w["n_xyz"]), jnp.asarray(w["delta"]), key)
    with jax.disable_jit():
        if error_map is not None:
            return jstep(*args, jnp.asarray(error_map), lr_scale=LR_SCALE)
        return jstep(*args, lr_scale=LR_SCALE)


def _port_step(w, pixel_ids, uniforms, *, error_map=None, **kw):
    tstep = topt.make_optimize_step(
        w["tparams"], VOXEL, MIN_PTS, UNITS, TRUNC, RAY_MAX, N_RAYS, SPLITS,
        lr=LR, **kw)
    f = w["frame"]
    state = topt.init_optim_state(w["ttable"])
    return tstep(state, w["ttable"], t(f["depth"]), t(f["T_wc"]),
                 t(f["intr_mat"]), t(w["mn"]), w["n_xyz"], t(w["delta"]),
                 pixel_ids=t(pixel_ids),
                 uniforms=[tuple(t(u) for u in us) for us in uniforms],
                 lr_scale=LR_SCALE,
                 error_map=None if error_map is None else t(error_map))


def _chunk(w, pixel_ids, uniforms, c, compute_dtype, per_ray=False):
    """Chunk c's (loss[, per-ray errors], row cotangents) on both sides."""
    f = w["frame"]
    jparams = jax.tree.map(jnp.asarray, w["params"])
    sl = slice(c * SPLITS, (c + 1) * SPLITS)
    with jax.disable_jit():
        rays = jopt.build_rays_from_frame(
            None, jnp.asarray(f["depth"]), jnp.asarray(f["T_wc"]),
            jnp.asarray(f["intr_mat"]), RAY_MAX, N_RAYS,
            pixel_ids=jnp.asarray(pixel_ids))
        chunk = jrender.Rays(*(x[sl] for x in rays[:5]), rays.T_wc, rays.intr)
        prep, pts, cam = jrender.prepare_render(
            w["table"], chunk, None, jnp.asarray(w["mn"]), VOXEL, UNITS, TRUNC,
            RAY_MAX, jnp.asarray(w["delta"]), jnp.asarray(w["n_xyz"]),
            ts=tuple(jnp.asarray(u) for u in uniforms[c]))
        jdt = jnp.bfloat16 if compute_dtype == torch.bfloat16 else jnp.float32

        def jtail(gf):
            return jrender.eval_render_loss(
                gf, prep, jparams, chunk, pts, cam, VOXEL, MIN_PTS, TRUNC,
                compute_dtype=jdt, per_ray=per_ray)

        jout, jg = jax.value_and_grad(jtail, has_aux=per_ray)(
            w["table"].features[prep.slots])
    trays = topt.build_rays_from_frame(
        t(f["depth"]), t(f["T_wc"]), t(f["intr_mat"]), RAY_MAX, N_RAYS,
        pixel_ids=t(pixel_ids))
    tchunk = trender.Rays(*(x[sl] for x in trays[:5]), trays.T_wc, trays.intr)
    tprep, tpts, tcam = trender.prepare_render(
        w["ttable"], tchunk, t(w["mn"]), VOXEL, UNITS, TRUNC, RAY_MAX,
        t(w["delta"]), w["n_xyz"], ts=tuple(t(u) for u in uniforms[c]))
    gf = w["ttable"].features[tprep.slots].clone().requires_grad_(True)
    tout = trender.eval_render_loss(gf, tprep, w["tparams"], tchunk, tpts,
                                    tcam, VOXEL, MIN_PTS, TRUNC,
                                    compute_dtype=compute_dtype,
                                    per_ray=per_ray)
    tloss = tout[0] if per_ray else tout
    (tg,) = torch.autograd.grad(tloss, gf)
    tout = (tout[0].detach(), tout[1].detach()) if per_ray else tout.detach()
    return jout, np.asarray(jg), tout, tg.numpy()


def _close_share(got, want, rtol):
    """Share of the entries nonzero on either side with |got - want| <=
    rtol * |want| + 1e-6 * max|want|."""
    nz = (got != 0) | (want != 0)
    ok = np.abs(got - want) <= rtol * np.abs(want) + 1e-6 * np.abs(want).max()
    return float(ok[nz].mean())


@pytest.mark.parametrize("c", [0, 1])
def test_bf16_chunk_loss_and_cotangents_match_jax(world, c):
    pixel_ids, uniforms = _draws(jax.random.key(7))
    jloss, jg, tloss, tg = _chunk(world, pixel_ids, uniforms, c,
                                  torch.bfloat16)
    assert float(jloss) > 0 and np.abs(jg).max() > 0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-6)
    share = _close_share(tg, jg, 1e-5)
    assert share >= 0.95, share
    # and bf16 is not float32: the f32 loss differs
    f32 = _chunk(world, pixel_ids, uniforms, c, torch.float32)[2]
    assert float(f32) != float(tloss)


def test_bf16_step_matches_jax(world):
    key = jax.random.key(11)
    pixel_ids, uniforms = _draws(key)
    jstate, jloss = _jax_step(world, key, compute_dtype=jnp.bfloat16)
    state, tloss = _port_step(world, pixel_ids, uniforms,
                              compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-6)
    np.testing.assert_array_equal(state.weights.numpy(),
                                  np.asarray(jstate.weights))
    share = _close_share(state.mu.numpy(), np.asarray(jstate.opt_state[0].mu),
                         1e-3)
    assert share >= 0.90, share
    jf = np.asarray(jstate.features)
    assert np.abs(jf - np.asarray(world["table"].features)).max() > \
        0.5 * LR * LR_SCALE
    jgrad = np.asarray(jstate.opt_state[0].mu) / 0.1
    tgrad = state.mu.numpy() / 0.1
    near0 = np.where(np.sign(tgrad) == np.sign(jgrad),
                     np.minimum(np.abs(tgrad), np.abs(jgrad)), 0.0)
    slope = LR_SCALE * LR * EPS / (near0 + EPS) ** 2
    bound = slope * np.abs(tgrad - jgrad) + 1e-9 + 2.4e-7 * np.abs(jf)
    assert np.all(np.abs(state.features.numpy() - jf) <= bound)
    # the latents and Adam's moments stay float32
    assert state.features.dtype == state.mu.dtype == torch.float32


def test_decode_layout_leaves_the_step_unchanged(world):
    """make_optimize_step takes decode_layout and, as the JAX package's
    single-device step, decodes the loss in the rows layout whatever it
    says: the fm step equals the rows step bit for bit, and its loss JAX's
    fm step's (rtol 1e-5, float32)."""
    key = jax.random.key(13)
    pixel_ids, uniforms = _draws(key)
    _, jloss = _jax_step(world, key, decode_layout="fm")
    rows, rloss = _port_step(world, pixel_ids, uniforms)
    fm, floss = _port_step(world, pixel_ids, uniforms, decode_layout="fm")
    np.testing.assert_allclose(float(floss), float(jloss), rtol=1e-5)
    assert float(floss) == float(rloss)
    for a, b in ((fm.features, rows.features), (fm.mu, rows.mu),
                 (fm.weights, rows.weights)):
        assert torch.equal(a, b)


def test_error_guided_step_matches_jax(world):
    key = jax.random.key(5)
    em = np.random.RandomState(2).uniform(0.2, 2.0, (3, 5)).astype(np.float32)
    k_rays, _ = jax.random.split(key)
    ids = jsampler.sample_pixels(k_rays, jnp.asarray(em), (60, 80), N_RAYS)
    pixel_ids, uniforms = _draws(key, pixel_ids=ids)
    jstate, jloss, jmap = _jax_step(world, key, error_map=em,
                                    error_guided=True)
    state, tloss, tmap = _port_step(world, pixel_ids, uniforms, error_map=em,
                                    error_guided=True)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tmap.numpy(), np.asarray(jmap), atol=1e-6,
                               rtol=1e-5)
    assert np.abs(np.asarray(jmap) - em).max() > 1e-3
    np.testing.assert_array_equal(state.weights.numpy(),
                                  np.asarray(jstate.weights))
    for c in range(N_RAYS // SPLITS):
        (jl, jerr), _, (tl, terr), _ = _chunk(world, pixel_ids, uniforms, c,
                                              torch.float32, per_ray=True)
        np.testing.assert_allclose(terr.numpy(), np.asarray(jerr),
                                   atol=1e-6, rtol=1e-5)
        assert float(np.asarray(jerr).max()) > 0


# --------------------------------------------------------------------------
# early stopping and the error maps inside NeuralMap.optimize
# --------------------------------------------------------------------------

BASE = ["model.voxel_size=0.05", "dataset.num_pixels=128",
        "model.train_ray_splits=64", "model.table_capacity=16384",
        "model.min_pts_in_grid=1"]
DIMS = np.array([2.0, 2.0, 2.0], np.float32)


def _es_frame(seed=7, h=48, w=64):
    rng = np.random.RandomState(seed)
    depth = (1.0 + 0.3 * rng.rand(h, w)).astype(np.float32)
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [0, 0, -1.2]
    intr = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]],
                    np.float32)
    return {"depth": depth, "T_wc": T_wc, "intr_mat": intr, "frame_id": 0}


def _both(extra, n_iters, lr):
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(0, bias_std=0.1))
    out = []
    for nm_cls, load in ((JNeuralMap, jload_config),
                         (TNeuralMap, tload_config)):
        cfg = load(BASE + extra + (["device_type=cpu"]
                                   if nm_cls is TNeuralMap else []))
        nm = nm_cls(DIMS, cfg, params)
        nm.integrate(_es_frame())
        nm.optimize(n_iters, lr=lr)
        out.append(nm)
    return out


@pytest.mark.parametrize("case,extra,n_iters,lr,want", [
    ("plateau", ["trainer.optim_early_stop=true",
                 "trainer.optim_es_patience=2"], 64, 0.0, 16),
    ("off", [], 12, 1e-3, 12),
    ("keeps_improving", ["trainer.optim_early_stop=true",
                         "trainer.optim_es_patience=3"], 24, 1e-2, None),
], ids=lambda v: v if isinstance(v, str) else None)
def test_early_stop_counts_match_jax(case, extra, n_iters, lr, want):
    """tests/test_optim_schedule.py's three cases in both packages: lr=0 on
    one frame with patience 2 stops at 4 groups (the first group is judged
    one group late, the second sets the best, the third and fourth go
    stale); off runs the budget; a falling loss runs on past the earliest
    stop (5 groups at patience 3)."""
    jnm, tnm = _both(extra, n_iters, lr)
    assert tnm.last_optimize_iters == jnm.last_optimize_iters
    assert len(tnm.optimize_losses) == tnm.last_optimize_iters
    assert np.all(np.isfinite(tnm.optimize_losses))
    if want is not None:
        assert tnm.last_optimize_iters == want
    else:
        assert tnm.last_optimize_iters >= 20


def _scripted_map(extra, losses, n_iters, record=None):
    """A port NeuralMap whose optimize step returns ``losses`` in order (and
    under error-guided sampling a map one above the map it was given,
    recording the maps it was given)."""
    cfg = tload_config(BASE + extra + ["device_type=cpu"])
    nm = TNeuralMap(DIMS, cfg, tnn.init_model(0))
    nm.integrate(_es_frame())
    it = iter(losses)

    def step(state, *a, error_map=None, **k):
        loss = torch.tensor(next(it), dtype=torch.float32)
        if error_map is None:
            return state, loss
        record.append(error_map)
        return state, loss, error_map + 1.0

    nm._optim_lr, nm._optim_step = 1e-3, step
    nm.optimize(n_iters, lr=1e-3)
    return nm


@pytest.mark.parametrize("groups,patience,rel,want_groups", [
    # group means 10, 9, 9, 9, 9: judged one group late -> best 10 (g1), 9
    # (g2), stale g3, g4 -> stop after g5 is queued
    ([10, 9, 9, 9, 9, 9, 9], 2, 0.005, 5),
    # an improvement below the relative threshold is stale
    ([10, 9.99, 9.98, 9.97, 9.96], 2, 0.005, 4),
    # steady improvement never stops; the last group is never judged
    ([10, 9, 8, 7, 6, 5], 1, 0.005, 6),
    # patience 3: stale run broken by one improvement
    ([10, 10, 10, 5, 5, 5, 5, 5], 3, 0.005, 8),
])
def test_early_stop_rule_scripted(groups, patience, rel, want_groups):
    """Scripted group means through the rule of
    bnv_fusion_tpu/pipeline.py:1046-1059: the counts worked out by hand."""
    stop = topt.EarlyStop(rel, patience)
    n = 0
    for g in groups:
        n += 1
        if stop.update([g] * 4):
            break
    assert n == want_groups
    # the same through NeuralMap.optimize (group 4), with a remainder group
    # of 2 that is never judged: the budget 4 * len(groups) + 2
    losses = [v for g in groups for v in [g] * 4] + [1.0, 1.0]
    nm = _scripted_map(["trainer.optim_early_stop=true",
                        f"trainer.optim_es_patience={patience}",
                        f"trainer.optim_es_rel={rel}"], losses,
                       4 * len(groups) + 2)
    stopped = want_groups < len(groups) or (want_groups == len(groups)
                                            and stop.stale >= patience)
    want = 4 * want_groups if stopped else 4 * len(groups) + 2
    assert nm.last_optimize_iters == want
    assert len(nm.optimize_losses) == want


def test_error_maps_are_read_as_they_stood_before_the_group():
    """One frame, so every draw is frame 0: within a launch group each
    iteration reads the pre-group map and the group's last write stays
    (JAX stacks the maps before the group and writes them back in order);
    the remainder group reads the pre-group map too."""
    seen = []
    nm = _scripted_map(["model.error_guided_sampling=true"], [1.0] * 10, 10,
                       record=seen)
    assert len(seen) == 10
    want = [1.0] * 4 + [2.0] * 4 + [3.0] * 2     # groups of 4, 4, 2
    assert [float(m.mean()) for m in seen] == want
    assert list(nm.error_maps) == [0]
    assert float(nm.error_maps[0].mean()) == 4.0
    assert tuple(nm.error_maps[0].shape) == (3, 4)   # 48x64 at patch 16


def test_error_guided_neural_map_moves_its_maps():
    """The real step inside NeuralMap.optimize: maps per frame index, kept
    across calls, moved away from 1; finite latents."""
    cfg = tload_config(BASE + ["device_type=cpu",
                               "model.error_guided_sampling=true"])
    nm = TNeuralMap(DIMS, cfg, tnn.init_model(0, bias_std=0.1))
    nm.integrate(_es_frame(7))
    nm.integrate(_es_frame(8))
    nm.optimize(6)
    assert set(nm.error_maps) <= {0, 1} and nm.error_maps
    assert any((m != 1.0).any() for m in nm.error_maps.values())
    before = {k: v.clone() for k, v in nm.error_maps.items()}
    nm.optimize(4, last_frame=1)
    assert set(nm.error_maps) >= set(before) and 1 in nm.error_maps
    assert torch.isfinite(nm.table.features).all()
