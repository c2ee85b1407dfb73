"""Dataset readers.  Importing this package registers them.

Ported so far: the analytic synthetic scenes and the pretraining patches;
the other readers of bnv_fusion_tpu/datasets are ROADMAP Queue 1 item 12.
"""

from bnv_fusion_tpu_torch.datasets.registry import get_dataset, register  # noqa: F401
from bnv_fusion_tpu_torch.datasets import synth_scene  # noqa: F401
from bnv_fusion_tpu_torch.datasets import pointnet_patches  # noqa: F401
