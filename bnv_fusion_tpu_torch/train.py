"""Training entry point: embedding pretraining, or refinement as training.

Counterpart of bnv_fusion_tpu/train.py:26-60, with the same CLI:

    python -m bnv_fusion_tpu_torch.train model=fusion_pointnet_model \\
        dataset=synthetic_patches
    python -m bnv_fusion_tpu_torch.train model=fusion_refiner_model \\
        dataset=synthetic_demo model.sparse_volume_path=...npz

Dispatches on the registered model name: ``lit_fusion_pointnet`` trains
the encoder and decoder on local patches (``last.npz``/``best.npz``);
``lit_fusion_refiner`` optimizes the latents of a saved map.
"""

from __future__ import annotations

import os
import sys

from bnv_fusion_tpu_torch.config import load_config
from bnv_fusion_tpu_torch.parallel import launch
from bnv_fusion_tpu_torch.utils.logging import get_logger, print_config

log = get_logger(__name__)


def run(overrides):
    """Dispatch on the model name; returns the trainer or the refiner (and
    the output directory) for callers that check them.  Under torchrun
    every rank trains its replica (``trainer.pretrain_devices``,
    ``optimize_devices``) and rank 0 alone logs and writes."""
    cfg = load_config(list(overrides))
    with launch.distributed(getattr(cfg, "device_type", "tpu")):
        return _run(cfg)


def _run(cfg):
    from bnv_fusion_tpu_torch.datasets import get_dataset
    from bnv_fusion_tpu_torch.models import get_model

    main = launch.is_main_process()
    if main:
        print_config(cfg)
    name = cfg.model.name
    out_dir = os.path.join(cfg.output_dir, "train", name)
    if main:
        os.makedirs(out_dir, exist_ok=True)

    if name == "lit_fusion_pointnet":
        trainer = get_model(name)(cfg)
        train_ds = get_dataset(cfg, "train")
        val_ds = get_dataset(cfg, "val")
        best = trainer.fit(
            train_ds, val_ds,
            max_epochs=int(cfg.trainer.max_epochs),
            batch_size=int(getattr(cfg.dataset, "train_batch_size", 32)),
            ckpt_dir=out_dir)
        if main:
            log.info(f"best val loss {best:.4f}; checkpoints in {out_dir}")
        return {"trainer": trainer, "best": best, "out_dir": out_dir}

    if name == "lit_fusion_refiner":
        from bnv_fusion_tpu_torch.run_e2e import load_params

        refiner = get_model(name)(cfg, load_params(cfg))
        refiner.run(get_dataset(cfg, "val"), out_dir,
                    n_epochs=int(cfg.trainer.max_epochs))
        return {"refiner": refiner, "out_dir": out_dir}

    raise KeyError(f"no training flow for model '{name}'")


def main(argv=None):
    run(argv if argv is not None else sys.argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
