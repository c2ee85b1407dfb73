"""Multi-device scaling over ``torch.distributed``: the DP group, the
launcher and the data-parallel fuse, optimize and pretrain steps.

Counterpart of bnv_fusion_tpu/parallel/ (its ``mesh``, ``launch`` and
``dp`` modules; the region-sharded ``spatial`` layout is ROADMAP Queue 1
item 14b).  One process per device (``torchrun``), gloo on the CPU, NCCL
on the cards.
"""

from bnv_fusion_tpu_torch.parallel.mesh import (  # noqa: F401
    DPGroup, make_mesh, resolve_count)
from bnv_fusion_tpu_torch.parallel.dp import (  # noqa: F401
    make_sharded_fuse_frame, make_sharded_optimize_iter,
    make_sharded_optimize_step, make_sharded_pretrain_step)
