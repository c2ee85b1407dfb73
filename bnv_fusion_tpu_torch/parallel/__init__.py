"""Multi-device scaling over ``torch.distributed``: the DP group, the
launcher, the data-parallel fuse, optimize and pretrain steps, and the
region-sharded map.

Counterpart of bnv_fusion_tpu/parallel/ (its ``mesh``, ``launch``, ``dp``
and ``spatial`` modules).  One process per device (``torchrun``), gloo on
the CPU, NCCL on the cards.
"""

from bnv_fusion_tpu_torch.parallel.mesh import (  # noqa: F401
    DPGroup, make_mesh, resolve_count)
from bnv_fusion_tpu_torch.parallel.dp import (  # noqa: F401
    make_sharded_fuse_frame, make_sharded_optimize_iter,
    make_sharded_optimize_step, make_sharded_pretrain_step)
from bnv_fusion_tpu_torch.parallel.spatial import (  # noqa: F401
    OwnerRows, SpatialTable, create_spatial_table, load_spatial_entries,
    make_spatial_decode, make_spatial_fuse_frame, spatial_active_entries)
