"""The data-parallel group: one process per rank, and its collectives.

Counterpart of bnv_fusion_tpu/parallel/mesh.py:12-26.  The JAX package runs
its multi-device work in one process, ``shard_map`` over a 1-D ``Mesh``;
torch runs one process per rank (``torchrun``), so the mesh becomes the
``torch.distributed`` world: its size, this process's rank and the rank's
device.  The collectives map one to one, and every DP step in
``parallel/dp.py`` calls them through ``DPGroup``, which records each call's
element count (``traffic``):

* ``all_gather`` -> ``dist.all_gather_single`` (``all_gather_into_tensor``
  on torch versions without it), stacked on a new leading axis;
* ``psum`` / ``pmax`` -> ``all_reduce`` with SUM / MAX;
* ``pmean`` -> ``all_reduce(SUM) / size``.

Without a process group the world is one rank and every collective returns
its input.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def world() -> Tuple[int, int]:
    """(world size, rank) of this process: (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _launcher_hint(n: int) -> str:
    return (f"launch one process per device, e.g. "
            f"`torchrun --nproc_per_node={n} -m bnv_fusion_tpu_torch.run_e2e "
            f"...`")


def resolve_count(value, name: str = "devices") -> int:
    """A ``trainer.*_devices`` value -> the device count it asks for:
    ``all`` or 0 = the world size (1 without a process group), else the
    integer.  A count above 1 must equal the world size: a process-per-rank
    world cannot leave ranks idle without their replicas going stale, so
    (unlike the JAX package, which can take the first n of its devices) a
    count between 1 and the world size raises too."""
    size, _ = world()
    v = str(value).strip().lower()
    n = size if v in ("all", "0") else int(v)
    if n < 1:
        raise ValueError(f"{name}={value}: a device count is >= 1")
    if n > 1 and n != size:
        hint = (_launcher_hint(n) if size == 1 else
                "the count must be 1 or the world size")
        raise ValueError(f"{name}={value}: requested {n} devices, have "
                         f"{size} in the process group; {hint}")
    return n


@dataclass
class DPGroup:
    """A 1-D data-parallel group: the process group (None = the default
    world, or no group at all when ``size`` is 1 and none is up), its size,
    this process's rank and device.  ``traffic`` records every collective
    as (op, element count, shape), the gathered tensor's for a gather."""

    size: int
    rank: int
    device: torch.device
    axis_name: str = "dp"
    group: Optional[object] = None
    traffic: List[tuple] = field(default_factory=list)

    @property
    def distributed(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    def shard(self, n: int) -> slice:
        """This rank's contiguous share of a leading axis of length ``n``
        (how ``P(axis)`` splits it); ``n`` must divide by the size."""
        if n % self.size:
            raise ValueError(f"a leading axis of {n} does not divide over "
                             f"{self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def _record(self, op: str, t: torch.Tensor):
        self.traffic.append((op, int(t.numel()), tuple(t.shape)))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[*S] on every rank -> [size, *S], rank-major, on every rank."""
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        self._record("all_gather", out)
        if not self.distributed:
            out[0] = x
            return out
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        # the concatenated form: gloo takes no stacked output
        gather(out.view(-1), x.contiguous().view(-1), group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise SUM or MAX of ``x`` over the ranks (a new tensor)."""
        out = x.detach().clone().contiguous()
        self._record(f"all_reduce_{op}", out)
        if not self.distributed:
            return out
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(out, op=rop, group=self.group)
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """``pmean``: the SUM over the ranks divided by the size."""
        return self.all_reduce(x, "sum") / self.size


def group_device() -> torch.device:
    """The device a collective of this process runs on: the current CUDA
    device under NCCL, else the CPU."""
    if dist.is_available() and dist.is_initialized() and \
            dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "dp") -> DPGroup:
    """The 1-D DP group over the process group's ranks.  ``n_devices``
    (None = the world size) must equal the world size; without a process
    group the world is this one process."""
    size, rank = world()
    n = size if n_devices is None else int(n_devices)
    if n != size:
        raise ValueError(f"requested {n} devices, have {size}: "
                         + _launcher_hint(n))
    return DPGroup(size=size, rank=rank, device=group_device(),
                   axis_name=axis_name)
