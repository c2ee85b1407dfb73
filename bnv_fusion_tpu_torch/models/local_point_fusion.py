"""Embedding pretraining: PointNet encoder + SDF decoder on local patches.

Counterpart of bnv_fusion_tpu/models/local_point_fusion.py:33-268
(``trainer.pretrain_devices`` > 1 shards the patch batch over the process
group, parallel/dp.py).  A local
oriented point set is mean-pooled into one latent, the decoder regresses SDF
at query points, trained with L1 plus a latent-norm regularizer; Adam with a
staircase step decay of the learning rate (``optimizer.lr_scheduler``).
Gradients come from ``torch.autograd`` (the JAX path has no kernel here).
The optimizer is ``torch.optim.Adam`` (eps 1e-8) with ``StepLR``, which is
``optax.adam(optax.exponential_decay(..., staircase=True))``: the same
update, rounded in another order.

Randomness: the per-patch point-count truncation is drawn from a numpy
``RandomState`` (JAX draws it from its PRNG; the bits differ), and
``train_step(..., n_keep=)`` injects it.  Initial weights are the port's
seeded ``nn.init_model``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from bnv_fusion_tpu_torch import nn as bnn
from bnv_fusion_tpu_torch.checkpoint import save_state
from bnv_fusion_tpu_torch.models.registry import register
from bnv_fusion_tpu_torch.pipeline import _to_numpy_tree, resolve_device
from bnv_fusion_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def pretrain_loss(params: Dict[str, Any], input_pts: torch.Tensor,
                  n_keep: torch.Tensor, training_pts: torch.Tensor,
                  gt_sdf: torch.Tensor, reg_weight: float = 1e-3
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Truncated-input global-feature loss.  input_pts [B, N, 6]; n_keep
    [B] leading points used per patch (a mask, not a shape change);
    training_pts [B, Q, 3] in normalized units; gt_sdf [B, Q]."""
    b, n, _ = input_pts.shape
    keep = torch.arange(n, device=input_pts.device)[None, :] < n_keep[:, None]
    feats = bnn.encoder_global_apply(params, input_pts, valid=keep)  # [B, F]
    q = training_pts.shape[1]
    feats_b = feats[:, None, :].expand(b, q, feats.shape[-1])
    pred = bnn.decoder_apply(params, training_pts, feats_b)[..., 0]  # [B, Q]
    bce = torch.mean(torch.abs(pred - gt_sdf))
    reg = torch.mean(torch.linalg.norm(feats, dim=-1))
    return bce + reg_weight * reg, {"bce_loss": bce, "reg_loss": reg}


def global_pretrain_loss(params: Dict[str, Any], input_pts: torch.Tensor,
                         normals: torch.Tensor, valid: torch.Tensor,
                         training_pts: torch.Tensor, gt_sdf: torch.Tensor,
                         bound_min, bound_max, voxel_size: float,
                         n_xyz, min_pts: int) -> Tuple[torch.Tensor, Dict]:
    """End-to-end (training_global) loss: a whole frame's points encoded
    into a dense grid, SDF regressed at world query points."""
    from bnv_fusion_tpu_torch import dense_grid

    feat_grid, cnt_grid = dense_grid.encode_pointcloud_dense(
        params, input_pts, normals, valid, bound_min, bound_max,
        voxel_size, n_xyz, min_pts)
    coords = (training_pts - bound_min) / voxel_size
    pred = dense_grid.decode_dense_grid(params, feat_grid, cnt_grid, coords,
                                        voxel_size, min_pts)
    bce = torch.mean(torch.abs(pred - gt_sdf))
    return bce, {"bce_loss": bce}


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@register("lit_fusion_pointnet")
class FusionPointNetTrainer:
    """The training loop (the reference's LightningModule + pl.Trainer
    role).  ``params`` is the nested dict of trainable tensors."""

    def __init__(self, cfg, params: Dict[str, Any] | None = None):
        from bnv_fusion_tpu_torch import parallel

        self.cfg = cfg
        # trainer.pretrain_devices > 1: the patch batch sharded over the
        # process group (parallel.dp.make_sharded_pretrain_step); "all" / 0
        # = the world size
        self.n_devices = parallel.resolve_count(
            getattr(cfg.trainer, "pretrain_devices", 1),
            "trainer.pretrain_devices")
        self.device = resolve_device(getattr(cfg, "device_type", "tpu"))
        self.min_pts = int(cfg.model.min_pts_in_grid)
        self.n_local = int(getattr(cfg.dataset, "n_local_samples", 64))
        self.reg_weight = float(cfg.model.loss.reg_loss)
        if params is None:
            params = bnn.init_model(int(getattr(cfg.trainer, "seed", 0)))
        self.params = bnn.params_from_numpy(_to_numpy_tree(params),
                                            self.device)
        for p in _leaves(self.params):
            p.requires_grad_(True)
        self.optimizer = torch.optim.Adam(
            list(_leaves(self.params)), lr=float(cfg.optimizer.lr.initial),
            betas=(0.9, 0.999), eps=1e-8)
        self.scheduler = torch.optim.lr_scheduler.StepLR(
            self.optimizer,
            step_size=int(cfg.optimizer.lr_scheduler.step_size),
            gamma=float(cfg.optimizer.lr_scheduler.gamma))
        self._rng = np.random.RandomState(1234)
        self.step_losses: list = []
        self._dp_step = (parallel.make_sharded_pretrain_step(
            parallel.make_mesh(self.n_devices), self.optimizer,
            reg_weight=self.reg_weight) if self.n_devices > 1 else None)

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _update(self, loss_fn):
        self.optimizer.zero_grad(set_to_none=True)
        loss, logs = loss_fn(self.params)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        return float(loss.detach()), {k: float(v.detach())
                                      for k, v in logs.items()}

    def train_step(self, batch: Dict[str, np.ndarray],
                   n_keep: np.ndarray | None = None):
        """One Adam step on a patch batch.  ``n_keep`` [B] (leading points
        kept per patch) defaults to a draw in [min_pts // 2, n_local).
        Under ``trainer.pretrain_devices`` > 1 every rank passes the same
        global batch and draw (the generators are seeded alike) and the DP
        step takes this rank's share (``launch.process_local_slice``)."""
        b = batch["input_pts"].shape[0]
        if n_keep is None:
            n_keep = self._rng.randint(self.min_pts // 2, self.n_local,
                                       size=b)
        x = self._tensor(batch["input_pts"])
        keep = self._tensor(n_keep, torch.int64)
        q = self._tensor(batch["training_pts"])
        gt = self._tensor(batch["gt"])
        if self._dp_step is not None:
            loss, logs = self._dp_step(self.params, x, keep, q, gt)
            self.scheduler.step()
            return float(loss), {k: float(v) for k, v in logs.items()}
        return self._update(lambda p: pretrain_loss(p, x, keep, q, gt,
                                                    self.reg_weight))

    def train_step_global(self, batch: Dict[str, np.ndarray],
                          voxel_size: float, n_xyz):
        """End-to-end training over one frame (training_global)."""
        pts = self._tensor(batch["input_pts"])
        valid = self._tensor(batch.get(
            "valid", np.ones(batch["input_pts"].shape[:-1], bool)),
            torch.bool)
        q = self._tensor(batch["training_pts"])
        gt = self._tensor(batch["gt"])
        mn = self._tensor(batch["bound_min"])
        mx = self._tensor(batch["bound_max"])
        n_xyz = tuple(int(v) for v in n_xyz)
        return self._update(lambda p: global_pretrain_loss(
            p, pts[..., :3], pts[..., 3:], valid, q, gt, mn, mx, voxel_size,
            n_xyz, self.min_pts))

    def eval_step(self, batch: Dict[str, np.ndarray]) -> float:
        x = self._tensor(batch["input_pts"])
        b, n, _ = x.shape
        with torch.no_grad():
            _, logs = pretrain_loss(
                self.params, x, torch.full((b,), n, device=self.device),
                self._tensor(batch["training_pts"]),
                self._tensor(batch["gt"]), self.reg_weight)
        return float(logs["bce_loss"])

    def export_validation_meshes(self, val_ds, out_dir: str, epoch: int,
                                 n_patches: int = 4, grid: int = 24):
        """Mesh a few validation patches from their global latents, plus
        their normal-colored input points (the reference's per-epoch visual
        check)."""
        from bnv_fusion_tpu_torch import dense_grid
        from bnv_fusion_tpu_torch.mesh import (Mesh, marching_tetrahedra,
                                               save_ply)
        from bnv_fusion_tpu_torch.utils.vis import (colorize_normals,
                                                    save_pointcloud_ply)

        os.makedirs(out_dir, exist_ok=True)
        lin = np.linspace(-1, 1, grid + 1, dtype=np.float32)
        gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
        q = self._tensor(np.stack([gx, gy, gz], -1).reshape(1, -1, 3))
        corner_off = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                               for z in (0, 1)])
        cells = np.stack(np.meshgrid(*[np.arange(grid)] * 3, indexing="ij"),
                         -1).reshape(-1, 3)
        for i in range(min(n_patches, len(val_ds))):
            item = val_ds[i]
            with torch.no_grad():
                feats = bnn.encoder_global_apply(
                    self.params, self._tensor(item["input_pts"][None]))
                sdf = dense_grid.global_feature_decode(
                    self.params, feats, q)[0].cpu().numpy()
            vol = sdf.reshape(grid + 1, grid + 1, grid + 1)
            cs = np.stack([vol[cells[:, 0] + o[0], cells[:, 1] + o[1],
                               cells[:, 2] + o[2]] for o in corner_off], -1)
            keep = (cs.min(1) < 0) & (cs.max(1) > 0)
            out = marching_tetrahedra(cells[keep], cs[keep])
            if len(out.vertices):
                verts = out.vertices / grid * 2 - 1
                save_ply(os.path.join(out_dir, f"patch{i}_{epoch}.ply"),
                         Mesh(verts.astype(np.float32), out.faces))
            ip = np.asarray(item["input_pts"])
            save_pointcloud_ply(
                os.path.join(out_dir, f"patch{i}_{epoch}_gt.ply"),
                ip[:, :3], colorize_normals(ip[:, 3:6]))

    def fit(self, train_ds, val_ds, max_epochs: int, batch_size: int,
            ckpt_dir: str, log_every: int = 50):
        """Epochs of shuffled training batches, a validation pass per epoch,
        ``last.npz`` every epoch and ``best.npz`` on a new best validation
        loss (the shared save_state format).  Step losses land in
        ``step_losses``.  Returns the best validation loss.  Under a process
        group every rank trains and validates its replica; rank 0 alone
        logs and writes."""
        from bnv_fusion_tpu_torch.parallel.launch import is_main_process

        main = is_main_process()
        if main:
            os.makedirs(ckpt_dir, exist_ok=True)
        terminate_on_nan = bool(getattr(self.cfg.trainer,
                                        "terminate_on_nan", True))
        best = float("inf")
        step = 0
        for epoch in range(max_epochs):
            for batch in iterate_batches(train_ds, batch_size, shuffle=True,
                                         seed=epoch):
                loss, logs = self.train_step(batch)
                self.step_losses.append(loss)
                if terminate_on_nan and not np.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss {loss} at epoch {epoch} step {step}")
                if main and step % log_every == 0:
                    log.info(f"epoch {epoch} step {step} "
                             f"loss {loss:.4f} bce {logs['bce_loss']:.4f}")
                step += 1
            val = np.mean([self.eval_step(b) for b in
                           iterate_batches(val_ds, batch_size)])
            improved = val < best
            best = min(best, val)
            if not main:
                continue
            log.info(f"epoch {epoch} val_loss {val:.4f}")
            if bool(getattr(self.cfg.trainer, "export_val_meshes", False)):
                self.export_validation_meshes(
                    val_ds, os.path.join(ckpt_dir, "plots"), epoch)
            state = {"params": _to_numpy_tree(self.params)}
            save_state(os.path.join(ckpt_dir, "last.npz"), state)
            if improved:
                save_state(os.path.join(ckpt_dir, "best.npz"), state)
        return best


def iterate_batches(dataset, batch_size: int, shuffle: bool = False,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    for s in range(0, len(idx) - batch_size + 1, batch_size):
        items = [dataset[int(i)] for i in idx[s:s + batch_size]]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}
