"""Port parity of the data-parallel optimize and pretrain steps: 4 gloo ranks
on the CPU (bnv_fusion_tpu_torch.parallel, one process each) against the
JAX package's sharded steps on make_mesh(4) of the conftest's 8 virtual
devices, and the port's DP NeuralMap and trainer against their
single-device runs.  Counterparts of tests/test_parallel.py's optimize,
pretrain and trainer-knob tests (:72, :123, :177, :216, :267).

The ranks are spawned once for the file (parallel.dryrun.run_ranks) on
the same numpy inputs and nn.init_model(seed, bias_std=0.1) weights the JAX
side gets; the JAX side's pixel ids and sampling uniforms are injected
into the port, as tests/test_torch_optimize.py does.  Tolerances, as
tests/test_torch_optimize.py and tests/test_torch_pretrain.py hold the
single-device steps (float32 on both sides, sums in other orders):
* losses rtol 1e-5; count_optim-bumped weights exact (integer bumps);
* the first Adam step's gradient, read back from the first moment
  (mu = (1 - b1) g): at most 0.5% of the rows beyond 1e-4 * max|g|; its
  latents within lr * eps / (|g| + eps)^2 * |dg| (the slope of the first
  Adam step, at the end of [g_port, g_jax] nearest 0) plus 2 ulp;
* pretraining: losses rtol 1e-5, weights after one Adam step atol 2e-6;
* the port's DP runs against its single-device runs over several Adam
  steps: latents atol 2e-3 (tests/test_parallel.py's bound: reduction
  order only, amplified by Adam where |g| ~ eps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bnv_fusion_tpu import fusion as jfusion
from bnv_fusion_tpu import optimize as jopt
from bnv_fusion_tpu import render as jrender
from bnv_fusion_tpu import tables as jtables
from bnv_fusion_tpu.parallel import (make_mesh as jmake_mesh,
                                     make_sharded_optimize_iter as jdp_iter,
                                     make_sharded_optimize_step as jdp_step,
                                     make_sharded_pretrain_step as jdp_pre)
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import optimize as topt
from bnv_fusion_tpu_torch import table_dense as ttd
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.models.local_point_fusion import \
    FusionPointNetTrainer as TTrainer
from bnv_fusion_tpu_torch.parallel import dryrun
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

RANKS = 4
LR, EPS = 1e-3, 1e-8
# the ray-DP iteration (tests/test_parallel.py:123's point)
IT = dict(vs=0.1, min_pts=1, units=2, trunc=0.1, ray_max=2.0, n_rays=128,
          splits=64, iters=3, lr_scale=0.5)
# the older per-chunk step (tests/test_parallel.py:72's point)
ST = dict(vs=0.1, min_pts=0, units=2, trunc=0.1, ray_max=2.0, n_rays=64)
PRE = dict(b=16, n=32, q=24, steps=4, reg=1e-3, step_size=10, gamma=0.5)
NM_OVERRIDES = ["model.voxel_size=0.05", "dataset.num_pixels=128",
                "model.train_ray_splits=64", "model.table_capacity=16384",
                "model.min_pts_in_grid=1", "model.parallel_ray_chunks=false"]
NM_ITERS = 3


def _params(seed):
    return jax.tree.map(lambda x: x.numpy(),
                        tnn.init_model(seed, bias_std=0.1))


def _flat(prefix, tree):
    return {f"{prefix}{net}/{k}": np.asarray(v) for net, d in tree.items()
            for k, v in d.items()}


def _frame(rng, h=48, w=64):
    depth = (1.0 + 0.3 * rng.rand(h, w)).astype(np.float32)
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [0, 0, -1.2]
    intr = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]],
                    np.float32)
    return depth, T_wc, intr


def _fused_table(params, rng, n, min_pts):
    """A JAX table fused from tests/test_parallel.py's random scene, and
    its entries in slot order (the port's table loads them in that order)."""
    pts = (rng.rand(n, 3).astype(np.float32) * 1.2 - 0.6)
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    t = jtables.create_table(8, 4096, n_xyz=[24, 24, 24])
    t, _ = jfusion.fuse_frame(
        t, jax.tree.map(jnp.asarray, params), jnp.asarray(pts),
        jnp.asarray(normals), jnp.ones((n,), bool),
        jnp.asarray(np.full(3, -1.0, np.float32)),
        jnp.asarray(np.full(3, 1.0, np.float32)), 0.1, min_pts)
    keys, feats, w, h, _ = jtables.active_entries(t)
    return t, {"keys": keys, "feats": feats, "weights": w, "hits": h,
               "n_xyz": np.array([24, 24, 24]), "capacity": np.array(4096),
               "bound_min": np.full(3, -1.0, np.float32)}


def _iter_draws(key, h, w):
    """JAX's draws of one optimize iteration: pixel ids from k_rays, one
    (fine, coarse) uniform pair per chunk from k_chunks."""
    k_rays, k_chunks = jax.random.split(key)
    pix = np.asarray(jax.random.choice(k_rays, h * w, (IT["n_rays"],),
                                       replace=False))
    ch = [jrender.draw_sampling_uniforms(k, IT["splits"], 2 * IT["units"],
                                         int(IT["ray_max"] * 5))
          for k in jax.random.split(k_chunks, IT["n_rays"] // IT["splits"])]
    return (pix, np.stack([np.asarray(c[0]) for c in ch]),
            np.stack([np.asarray(c[1]) for c in ch]))


def _pretrain_batches():
    out = []
    for i in range(PRE["steps"]):
        r = np.random.RandomState(100 + i)
        out.append((r.randn(PRE["b"], PRE["n"], 6).astype(np.float32),
                    r.randint(4, PRE["n"], size=(PRE["b"],)),
                    r.rand(PRE["b"], PRE["q"], 3).astype(np.float32) * 2 - 1,
                    r.rand(PRE["b"], PRE["q"]).astype(np.float32) - 0.5))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = _params(0)
    inp = _flat("params/", params)
    w = {"params": params}

    # the ray-DP iteration
    rng = np.random.RandomState(0)
    w["it_table"], tab = _fused_table(params, rng, 2048, IT["min_pts"])
    depth, T_wc, intr = _frame(rng)
    draws = [_iter_draws(jax.random.key(100 + i), *depth.shape)
             for i in range(IT["iters"])]
    w["it_frame"], w["it_draws"] = (depth, T_wc, intr), draws
    it = dict(tab, depth=depth, T_wc=T_wc, intr=intr,
              pixel_ids=np.stack([d[0] for d in draws]),
              uniforms_fine=np.stack([d[1] for d in draws]),
              uniforms_coarse=np.stack([d[2] for d in draws]),
              cfg=np.array([IT[k] for k in ("vs", "min_pts", "units",
                                            "trunc", "ray_max", "n_rays",
                                            "splits")] +
                           [LR, IT["lr_scale"]]))
    inp.update({f"optimize_iter/{k}": v for k, v in it.items()})

    # the older step: rays sharded, per-rank jitter from fold_in(key, rank)
    rng = np.random.RandomState(1)
    w["st_table"], tab = _fused_table(params, rng, 1024, 1)
    n = ST["n_rays"]
    gt = (rng.rand(n, 3).astype(np.float32) * 0.8 - 0.4)
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [0, 0, -1.5]
    rays = dict(uv=rng.rand(n, 2).astype(np.float32) * 100, gt_pts=gt,
                mask=np.ones(n, np.float32), neighbor_pts=gt[:, None, :],
                neighbor_masks=np.ones((n, 1), np.float32), T_wc=T_wc,
                intr=np.array([[100.0, 0, 50], [0, 100, 50], [0, 0, 1]],
                              np.float32))
    key = jax.random.key(7)
    uni = [jrender.draw_sampling_uniforms(
        jax.random.fold_in(key, d), n // RANKS, 2 * ST["units"],
        int(ST["ray_max"] * 5)) for d in range(RANKS)]
    w["st_rays"], w["st_key"] = rays, key
    inp.update({f"optimize_step/{k}": v for k, v in dict(
        tab, **rays,
        uniforms_fine=np.stack([np.asarray(u[0]) for u in uni]),
        uniforms_coarse=np.stack([np.asarray(u[1]) for u in uni]),
        cfg=np.array([ST[k] for k in ("vs", "min_pts", "units", "trunc",
                                      "ray_max")] + [LR])).items()})

    # NeuralMap under optimize_devices=4
    rng = np.random.RandomState(2)
    frames = [_frame(rng) for _ in range(2)]
    w["nm_frames"] = frames
    inp.update({"nm_optimize/overrides": np.array(NM_OVERRIDES),
                "nm_optimize/dims": np.full(3, 2.0, np.float32),
                "nm_optimize/depth": np.stack([f[0] for f in frames]),
                "nm_optimize/T_wc": np.stack([f[1] for f in frames]),
                "nm_optimize/intr": np.stack([f[2] for f in frames]),
                "nm_optimize/n_iters": np.array(NM_ITERS)})

    # pretraining: the DP step, and the trainer knob
    batches = _pretrain_batches()
    w["pre_params"], w["pre_batches"] = _params(3), batches
    inp.update(_flat("pretrain:p/params/", w["pre_params"]))
    inp.update({f"pretrain:p/{k}": np.stack([b[i] for b in batches])
                for i, k in enumerate(("input_pts", "n_keep", "training_pts",
                                       "gt"))})
    inp["pretrain:p/cfg"] = np.array([LR, PRE["step_size"], PRE["gamma"],
                                      PRE["reg"]])
    b0 = batches[0]
    inp.update({f"trainer/{k}": v for k, v in zip(
        ("input_pts", "n_keep", "training_pts", "gt"), b0)})
    w["res"] = dryrun.run_ranks(
        RANKS, ["optimize_iter", "optimize_step", "nm_optimize", "pretrain:p",
                "trainer"], inp, str(tmp_path_factory.mktemp("ranks")))
    return w


def _grad_rows_ok(tgrad, jgrad):
    """At most 0.5% of the nonzero gradient rows beyond 1e-4 * max|g|."""
    assert np.abs(jgrad).max() > 0
    off = np.abs(tgrad - jgrad).max(1) > 1e-4 * np.abs(jgrad).max()
    assert off.sum() <= 0.005 * (np.abs(jgrad).max(1) > 0).sum()


def _first_adam_ok(tf, jf, tgrad, jgrad, lr_scale):
    near0 = np.where(np.sign(tgrad) == np.sign(jgrad),
                     np.minimum(np.abs(tgrad), np.abs(jgrad)), 0.0)
    slope = lr_scale * LR * EPS / (near0 + EPS) ** 2
    bound = slope * np.abs(tgrad - jgrad) + 1e-9 + 2.4e-7 * np.abs(jf)
    assert np.all(np.abs(tf - jf) <= bound)


def test_sharded_optimize_iter_matches_jax(world):
    """The first ray-DP iteration against the JAX package's on the same
    draws: loss, bumped weights, gradient rows (from the first moment) and
    latents."""
    t = world["it_table"]
    depth, T_wc, intr = world["it_frame"]
    opt, step = jdp_iter(jmake_mesh(RANKS),
                         jax.tree.map(jnp.asarray, world["params"]),
                         IT["vs"], IT["min_pts"], IT["units"], IT["trunc"],
                         IT["ray_max"], n_rays=IT["n_rays"],
                         train_ray_splits=IT["splits"], example_table=t,
                         lr=LR)
    s = jopt.init_optim_state(opt, t)._replace(
        features=jnp.array(t.features), weights=jnp.array(t.weights))
    s, jl = step(s, t, jnp.asarray(depth), jnp.asarray(T_wc),
                 jnp.asarray(intr), jnp.asarray(np.full(3, -1.0, np.float32)),
                 jnp.asarray(np.array([22, 22, 22], np.int32)), None,
                 jax.random.key(100), lr_scale=IT["lr_scale"])
    r = world["res"][0]
    np.testing.assert_allclose(r["optimize_iter/losses"][0], float(jl),
                               rtol=1e-5)
    jw = np.asarray(s.weights)
    np.testing.assert_array_equal(r["optimize_iter/first/weights"], jw)
    assert (jw > np.asarray(t.weights)).any()
    jgrad = np.asarray(s.opt_state[0].mu) / 0.1
    tgrad = r["optimize_iter/first/mu"] / 0.1
    _grad_rows_ok(tgrad, jgrad)
    _first_adam_ok(r["optimize_iter/first/features"], np.asarray(s.features),
                   tgrad, jgrad, IT["lr_scale"])


def test_sharded_optimize_iter_matches_single_device(world):
    """Three ray-DP iterations against the port's single-device step on the
    same draws: losses, weights, latents."""
    depth, T_wc, intr = world["it_frame"]
    tab = {k: np.asarray(v) for k, v in
           zip(("keys", "feats", "weights", "hits"),
               jtables.active_entries(world["it_table"])[:4])}
    table = ttd.load_entries((24, 24, 24), 4096, tab["keys"], tab["feats"],
                             tab["weights"], tab["hits"])
    step = topt.make_optimize_step(
        tnn.params_from_numpy(world["params"]), IT["vs"], IT["min_pts"],
        IT["units"], IT["trunc"], IT["ray_max"], IT["n_rays"], IT["splits"],
        lr=LR)
    state = topt.init_optim_state(table)
    tt = torch.as_tensor
    losses = []
    for pix, uf, uc in world["it_draws"]:
        state, loss = step(state, table, tt(depth), tt(T_wc), tt(intr),
                           tt(np.full(3, -1.0, np.float32)), (24, 24, 24),
                           None, pixel_ids=tt(pix),
                           uniforms=[(tt(f), tt(c)) for f, c in zip(uf, uc)],
                           lr_scale=IT["lr_scale"])
        losses.append(float(loss))
    r = world["res"][0]
    np.testing.assert_allclose(r["optimize_iter/losses"], losses, rtol=1e-5)
    np.testing.assert_array_equal(r["optimize_iter/weights"],
                                  state.weights.numpy())
    np.testing.assert_allclose(r["optimize_iter/features"],
                               state.features.numpy(), atol=2e-3, rtol=0)


def test_sharded_optimize_step_matches_jax(world):
    """The older per-chunk step: rays sharded, each rank's jitter from
    fold_in(key, rank) (injected), dense gradients summed, bumps by MAX."""
    t, rays = world["st_table"], world["st_rays"]
    opt, step = jdp_step(jmake_mesh(RANKS),
                         jax.tree.map(jnp.asarray, world["params"]),
                         ST["vs"], ST["min_pts"], truncated_units=ST["units"],
                         truncated_dist=ST["trunc"],
                         ray_max_dist=ST["ray_max"], example_table=t, lr=LR)
    jrays = jrender.Rays(**{k: jnp.asarray(v) for k, v in rays.items()})
    feats, weights, opt_state, jl = step(
        t.features, t.weights, opt.init(t.features), t, jrays,
        world["st_key"], jnp.asarray(np.full(3, -1.0, np.float32)),
        jnp.asarray(np.array([22, 22, 22], np.int32)), None)
    r = world["res"][0]
    np.testing.assert_allclose(r["optimize_step/loss"], float(jl), rtol=1e-5)
    jw = np.asarray(weights)
    np.testing.assert_array_equal(r["optimize_step/weights"], jw)
    assert (jw > np.asarray(t.weights)).any()
    jgrad = np.asarray(opt_state[0].mu) / 0.1
    tgrad = r["optimize_step/mu"] / 0.1
    _grad_rows_ok(tgrad, jgrad)
    _first_adam_ok(r["optimize_step/features"], np.asarray(feats), tgrad,
                   jgrad, 1.0)


def test_neural_map_sharded_optimize(world):
    """NeuralMap.optimize under trainer.optimize_devices=4 against the
    port's single-device NeuralMap on the same seed: the same frames, pixels
    and uniforms, so the same trajectory up to reduction order."""
    cfg = tload_config(NM_OVERRIDES + ["device_type=cpu"])
    nm = TNeuralMap(np.full(3, 2.0, np.float32), cfg, world["params"])
    for i, (d, p, k) in enumerate(world["nm_frames"]):
        nm.integrate({"depth": d, "T_wc": p, "intr_mat": k, "frame_id": i})
    nm.optimize(NM_ITERS)
    r = world["res"][0]
    feats = nm.table.features.numpy()
    assert np.abs(feats).max() > 0 and np.all(np.isfinite(feats))
    np.testing.assert_allclose(r["nm_optimize/losses"], nm.optimize_losses,
                               rtol=1e-5)
    np.testing.assert_array_equal(r["nm_optimize/weights"],
                                  nm.table.weights.numpy())
    np.testing.assert_allclose(r["nm_optimize/features"], feats, atol=2e-3,
                               rtol=0)


def test_sharded_pretrain_matches_jax(world):
    """The DP pretrain step (batch sharded over 4 ranks) against the JAX
    package's on make_mesh(4): every step's loss and logs, and the weights
    after the first Adam step."""
    sched = optax.exponential_decay(LR, transition_steps=PRE["step_size"],
                                    decay_rate=PRE["gamma"], staircase=True)
    opt = optax.adam(sched)
    step = jdp_pre(jmake_mesh(RANKS), opt, reg_weight=PRE["reg"])
    p = jax.tree.map(jnp.asarray, world["pre_params"])
    s = opt.init(p)
    r = world["res"][0]
    for i, batch in enumerate(world["pre_batches"]):
        p, s, loss, logs = step(p, s, *(jnp.asarray(x) for x in batch))
        np.testing.assert_allclose(r["pretrain:p/losses"][i], float(loss),
                                   rtol=1e-5)
        for k in ("bce_loss", "reg_loss"):
            np.testing.assert_allclose(r[f"pretrain:p/{k}"][i],
                                       float(logs[k]), rtol=1e-5)
        if i == 0:
            for net, d in p.items():
                for k, v in d.items():
                    np.testing.assert_allclose(
                        r[f"pretrain:p/first/params/{net}/{k}"],
                        np.asarray(v), atol=2e-6, rtol=0, err_msg=k)


def test_trainer_pretrain_devices_knob(world):
    """FusionPointNetTrainer with trainer.pretrain_devices=4 (the global
    batch on every rank, each taking its share) against the single-device
    trainer on the same batch and draw."""
    r = world["res"][0]
    ip, nk, tp, gt = world["pre_batches"][0]
    tr = TTrainer(tload_config(["model=fusion_pointnet_model",
                                "dataset=synthetic_patches",
                                "device_type=cpu"]), params=world["params"])
    loss, logs = tr.train_step({"input_pts": ip, "training_pts": tp,
                                "gt": gt}, n_keep=nk)
    assert np.isfinite(r["trainer/loss"])
    np.testing.assert_allclose(r["trainer/loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(r["trainer/bce_loss"], logs["bce_loss"],
                               rtol=1e-5)
    for net, d in tr.params.items():
        for k, v in d.items():
            np.testing.assert_allclose(r[f"trainer/params/{net}/{k}"],
                                       v.detach().numpy(), atol=2e-6, rtol=0)


@pytest.mark.parametrize("case", ["optimize_iter", "optimize_step",
                                  "nm_optimize", "pretrain:p", "trainer"])
def test_replicas_bit_identical(world, case):
    """Every rank's replicated latents, weights, moments, losses and
    parameters are the same bits."""
    res = world["res"]
    keys = [k for k in res[0] if k.startswith(case + "/")]
    assert keys
    for r in res[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
