"""Port parity of embedding pretraining: the patch dataset, one Adam step of
the local-patch trainer, the dense-grid encode/decode and one
training_global step, against the JAX package on the same numpy inputs and
weights.

Weights: the port's ``init_model(seed, bias_std=0.1)`` handed to both
trainers (their own inits draw different bits).  The point-count truncation
is injected (``n_keep``): JAX draws it from its PRNG.  Tolerances: losses
rtol 1e-5 (float32 sums in another order); parameters after one Adam step
atol 2e-6 against a step of lr = 1e-3 per weight: Adam normalizes each
gradient, so a gradient within rounding noise of zero (|g| ~ eps) can move
its weight by a fraction of lr differently in the two frameworks
(observed: 1.2e-7, one float32 ulp of the weights).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import checkpoint as jckpt
from bnv_fusion_tpu import dense_grid as jdg
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.pointnet_patches import \
    SyntheticPatchDataset as JPatches
from bnv_fusion_tpu.models.local_point_fusion import \
    FusionPointNetTrainer as JTrainer
from bnv_fusion_tpu_torch import dense_grid as tdg
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import train as ttrain
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.datasets.pointnet_patches import \
    SyntheticPatchDataset as TPatches
from bnv_fusion_tpu_torch.datasets.synth_scene import \
    SyntheticFusionFramesDataset
from bnv_fusion_tpu_torch.models.local_point_fusion import (
    FusionPointNetTrainer as TTrainer, iterate_batches)

PATCH_CFG = ["model=fusion_pointnet_model", "dataset=synthetic_patches"]
PARAM_ATOL = 2e-6


def _params_np(seed):
    return jax.tree.map(lambda x: x.numpy(),
                        tnn.init_model(seed, bias_std=0.1))


def _assert_params_close(tparams, jparams, atol):
    for net in ("encoder", "decoder"):
        for k, v in tparams[net].items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       np.asarray(jparams[net][k]),
                                       atol=atol, rtol=0, err_msg=f"{net}/{k}")


@pytest.mark.parametrize("stage", ["train", "val"])
def test_synthetic_patches_bit_equal(stage):
    cfg = tload_config(PATCH_CFG)
    tds, jds = TPatches(cfg, stage), JPatches(jload_config(PATCH_CFG), stage)
    for i in range(12):
        a, b = tds[i], jds[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i}/{k}")


def test_synthetic_patch_without_surface_is_redrawn():
    """Train item 432's first primitive leaves no surface point in the
    patch cube: the JAX package raises there, the port draws the next
    primitive from the item's stream."""
    cfg = tload_config(PATCH_CFG)
    with pytest.raises(ValueError):
        JPatches(jload_config(PATCH_CFG), "train")[432]
    item = TPatches(cfg, "train")[432]
    assert item["input_pts"].shape == (64, 6)
    assert np.all(np.isfinite(item["input_pts"]))
    assert np.all(np.abs(item["input_pts"][:, :3]) < 1.0)
    np.testing.assert_allclose(
        np.linalg.norm(item["input_pts"][:, 3:], axis=-1), 1.0, atol=1e-5)


def test_train_step_matches_jax():
    params = _params_np(0)
    tcfg = tload_config(PATCH_CFG + ["device_type=cpu"])
    batch = next(iterate_batches(TPatches(tcfg, "train"), 8))
    n_keep = np.random.RandomState(5).randint(4, 64, size=8)

    jt = JTrainer(jload_config(PATCH_CFG))
    jparams = jax.tree.map(jnp.asarray, params)
    jp, _, jloss, jlogs = jt._step(
        jparams, jt.optimizer.init(jparams), jnp.asarray(batch["input_pts"]),
        jnp.asarray(n_keep), jnp.asarray(batch["training_pts"]),
        jnp.asarray(batch["gt"]))

    tt = TTrainer(tcfg, params=params)
    loss, logs = tt.train_step(batch, n_keep=n_keep)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    for k in ("bce_loss", "reg_loss"):
        np.testing.assert_allclose(logs[k], float(jlogs[k]), rtol=1e-5)
    # the step moved the weights by ~lr; both frameworks moved them alike
    moved = np.abs(tt.params["decoder"]["w1"].detach().numpy() -
                   params["decoder"]["w1"])
    assert np.median(moved) > 5e-4
    _assert_params_close(tt.params, jp, PARAM_ATOL)


def test_lr_schedule_is_staircase_decay():
    """StepLR(step_size, gamma) == optax.exponential_decay(staircase=True):
    the k-th update (0-based) uses lr * gamma ** (k // step_size)."""
    import optax

    cfg = tload_config(PATCH_CFG + ["device_type=cpu",
                                    "optimizer.lr_scheduler.step_size=2"])
    tt = TTrainer(cfg, params=_params_np(0))
    sched = optax.exponential_decay(1e-3, transition_steps=2, decay_rate=0.5,
                                    staircase=True)
    batch = next(iterate_batches(TPatches(cfg, "train"), 4))
    for k in range(5):
        assert tt.optimizer.param_groups[0]["lr"] == pytest.approx(
            float(sched(k)), rel=1e-6)
        tt.train_step(batch)


def test_pretrain_devices_refused():
    """trainer.pretrain_devices=2 without a 2-rank process group raises the
    launcher's ValueError (the DP step itself is held in
    tests/test_torch_parallel_optimize.py)."""
    cfg = tload_config(PATCH_CFG + ["device_type=cpu",
                                    "trainer.pretrain_devices=2"])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        TTrainer(cfg)


@pytest.fixture(scope="module")
def frame_batch():
    over = ["model.voxel_size=0.1", "model.min_pts_in_grid=4",
            "model.training_global=True", "dataset=synthetic_demo",
            "dataset.num_images=4", "dataset.img_res=[60,80]",
            "dataset.n_training_pts=512"]
    cfg = tload_config(over + ["device_type=cpu"])
    ds = SyntheticFusionFramesDataset(cfg, "train")
    return over, cfg, ds, ds[1]


def test_dense_grid_matches_jax(frame_batch):
    _, _, ds, item = frame_batch
    params = _params_np(2)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tnn.params_from_numpy(params)
    pts, valid = item["input_pts"], item["valid"]
    args = (ds.voxel_size, tuple(int(v) for v in ds.n_xyz), 4)
    jf, jc = jdg.encode_pointcloud_dense(
        jp, jnp.asarray(pts[:, :3]), jnp.asarray(pts[:, 3:]),
        jnp.asarray(valid), jnp.asarray(ds.bound_min),
        jnp.asarray(ds.bound_max), *args)
    tf, tc = tdg.encode_pointcloud_dense(
        tp, torch.as_tensor(pts[:, :3]), torch.as_tensor(pts[:, 3:]),
        torch.as_tensor(valid), torch.as_tensor(ds.bound_min),
        torch.as_tensor(ds.bound_max), *args)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tc.numpy() >= 4).sum() > 100
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5,
                               rtol=1e-5)

    coords = (item["training_pts"] - ds.bound_min) / ds.voxel_size
    jsdf = jdg.decode_dense_grid(jp, jf, jc, jnp.asarray(coords),
                                 ds.voxel_size, 4)
    tsdf = tdg.decode_dense_grid(tp, tf, tc, torch.as_tensor(coords),
                                 ds.voxel_size, 4)
    np.testing.assert_allclose(tsdf.numpy(), np.asarray(jsdf), atol=1e-6,
                               rtol=1e-5)
    feats = np.random.RandomState(3).randn(3, 8).astype(np.float32)
    q = np.random.RandomState(4).rand(3, 17, 3).astype(np.float32)
    np.testing.assert_allclose(
        tdg.global_feature_decode(tp, torch.as_tensor(feats),
                                  torch.as_tensor(q)).numpy(),
        np.asarray(jdg.global_feature_decode(jp, jnp.asarray(feats),
                                             jnp.asarray(q))),
        atol=1e-5, rtol=1e-5)


def test_train_step_global_matches_jax(frame_batch):
    over, cfg, ds, item = frame_batch
    params = _params_np(2)
    jt = JTrainer(jload_config(over))
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.opt_state = jt.optimizer.init(jt.params)
    tt = TTrainer(cfg, params=params)
    losses = []
    for _ in range(2):
        jl, _ = jt.train_step_global(item, ds.voxel_size, ds.n_xyz)
        tl, _ = tt.train_step_global(item, ds.voxel_size, ds.n_xyz)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        losses.append(tl)
    assert losses[1] < losses[0]
    _assert_params_close(tt.params, jt.params, PARAM_ATOL)


def test_train_cli_checkpoints_load_in_jax(tmp_path):
    """train.py writes last.npz / best.npz in the shared save_state format:
    JAX reads them and its encoder gives the port's features."""
    out = ttrain.run(PATCH_CFG + [
        "device_type=cpu", "dataset.num_patches=64", "trainer.max_epochs=1",
        f"output_dir={tmp_path}"])
    assert len(out["trainer"].step_losses) == 2
    assert np.all(np.isfinite(out["trainer"].step_losses))
    x = np.random.RandomState(0).randn(10, 6).astype(np.float32)
    for name in ("last.npz", "best.npz"):
        jparams = jckpt.load_state(str(tmp_path / "train" /
                                       "lit_fusion_pointnet" / name))
        jparams = jparams["params"]
        want = tnn.encoder_apply(out["trainer"].params,
                                 torch.as_tensor(x)).detach().numpy()
        from bnv_fusion_tpu import nn as jnn
        np.testing.assert_allclose(
            np.asarray(jnn.encoder_apply(
                jax.tree.map(jnp.asarray, jparams), jnp.asarray(x))),
            want, atol=1e-5, rtol=1e-5)


def test_export_validation_meshes_match_jax(tmp_path):
    """The per-epoch visual check: patch meshes decoded from the global
    latents and the normal-coloured input points, as the JAX trainer
    writes them (point clouds byte-equal, meshes of equal size)."""
    from bnv_fusion_tpu_torch import mesh as tmesh

    params = _params_np(0)
    cfg = tload_config(PATCH_CFG + ["device_type=cpu"])
    val = TPatches(cfg, "val")
    tt = TTrainer(cfg, params=params)
    tt.export_validation_meshes(val, str(tmp_path / "t"), epoch=0,
                                n_patches=2)
    jt = JTrainer(jload_config(PATCH_CFG))
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.export_validation_meshes(JPatches(jload_config(PATCH_CFG), "val"),
                                str(tmp_path / "j"), epoch=0, n_patches=2)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert "patch0_0_gt.ply" in names and "patch0_0.ply" in names
    for name in names:
        a, b = tmp_path / "t" / name, tmp_path / "j" / name
        if name.endswith("_gt.ply"):
            assert a.read_bytes() == b.read_bytes()
        else:
            ma, mb = tmesh.load_ply(str(a)), tmesh.load_ply(str(b))
            assert len(ma.faces) == len(mb.faces) > 0
            np.testing.assert_allclose(ma.vertices, mb.vertices, atol=1e-4)
