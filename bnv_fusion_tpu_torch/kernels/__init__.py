"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Launch counts live in ``LAUNCHES`` (kernel name -> launches since the last
``LAUNCHES.clear()``); ``build()`` compiles every kernel library up front.
"""

from bnv_fusion_tpu_torch.kernels._build import LAUNCHES, build  # noqa: F401
from bnv_fusion_tpu_torch.kernels.fused_decode import (  # noqa: F401
    fused_corner_decode, fused_corner_decode_torch, fused_decode_available)
from bnv_fusion_tpu_torch.kernels.fused_mlp import (  # noqa: F401
    FusedMLP, fused_mlp_torch)
from bnv_fusion_tpu_torch.kernels.seg_reduce import (  # noqa: F401
    seg_reduce_sorted, seg_reduce_sorted_torch)
