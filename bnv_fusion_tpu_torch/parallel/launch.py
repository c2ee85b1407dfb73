"""Multi-process bring-up: ``torch.distributed`` for the DP group.

Counterpart of bnv_fusion_tpu/parallel/launch.py:23-67.  One process per
device, as ``torchrun`` starts them:

    torchrun --nproc_per_node=N -m bnv_fusion_tpu_torch.run_e2e \\
        trainer.fuse_devices=all trainer.optimize_devices=all

``initialize`` brings up the process group (NCCL when the rank's device is
CUDA, which is then ``cuda:{LOCAL_RANK}``; gloo on the CPU); the entry
points call it through ``distributed`` when torchrun's ``WORLD_SIZE`` is
above 1.  ``global_mesh`` is the DP group over every rank, and
``process_local_slice`` this rank's share of a global batch.
"""

from __future__ import annotations

import contextlib
import inspect
import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bnv_fusion_tpu_torch.parallel.mesh import DPGroup, make_mesh, world


def _init_method(coordinator_address: Optional[str]) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``,
    ``file://``) as it is; None -> torchrun's MASTER_ADDR / MASTER_PORT."""
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[str] = None) -> None:
    """Bring up the process group; a no-op when one is up.  With no
    arguments it reads torchrun's environment (MASTER_ADDR/PORT, RANK,
    WORLD_SIZE, LOCAL_RANK).  ``device`` "cpu" takes gloo; otherwise CUDA
    when there is a card (NCCL, the rank on ``cuda:{LOCAL_RANK}``, or on
    ``cuda:{process_id}`` when LOCAL_RANK is unset), else gloo."""
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    use_cuda = (str(device).lower() != "cpu" and torch.cuda.is_available())
    kwargs = {}
    if use_cuda:
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local)
        # bind the group to the rank's card where this torch can
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group("nccl" if use_cuda else "gloo",
                            init_method=_init_method(coordinator_address),
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)


def barrier() -> None:
    """Meet every rank (a no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Meet every rank at a barrier, then take the process group down."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


@contextlib.contextmanager
def distributed(device_type="tpu"):
    """The entry points' bring-up: under torchrun with WORLD_SIZE above 1
    (and no group up yet) initialize on ``device_type``'s device, keep the
    INFO log to rank 0, and at the end meet the other ranks at a barrier
    and take the group down."""
    owned = (int(os.environ.get("WORLD_SIZE", "1")) > 1 and
             not dist.is_initialized())
    if owned:
        initialize(device="cpu" if str(device_type).lower() == "cpu"
                   else None)
        if not is_main_process():
            logging.disable(logging.INFO)
    try:
        yield
    finally:
        if owned:
            shutdown()
            logging.disable(logging.NOTSET)


def is_main_process() -> bool:
    """True on rank 0 (and without a process group): the rank that
    meshes, evaluates, saves, logs and writes files."""
    return world()[1] == 0


def global_mesh(axis_names: Sequence[str] = ("dp",),
                axis_sizes: Optional[Tuple[int, ...]] = None) -> DPGroup:
    """The DP group over every rank.  1-D only: a multi-axis request
    raises, as do sizes whose product is not the world size."""
    size, _ = world()
    if len(axis_names) != 1:
        raise ValueError("only a 1-D data-parallel mesh is ported; give one "
                         "axis name")
    if axis_sizes is not None and int(np.prod(axis_sizes)) != size:
        raise ValueError(f"axis sizes {tuple(axis_sizes)} != device count "
                         f"{size}")
    return make_mesh(size, axis_name=axis_names[0])


def process_local_slice(n_items: int) -> slice:
    """This process's contiguous share of a global batch of ``n_items``."""
    size, rank = world()
    per = n_items // size
    return slice(rank * per, rank * per + per)
