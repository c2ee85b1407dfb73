"""Dataset readers.  Importing this package registers them, in the order of
bnv_fusion_tpu/datasets/__init__.py:9-16."""

from bnv_fusion_tpu_torch.datasets.registry import get_dataset, register  # noqa: F401
from bnv_fusion_tpu_torch.datasets import canonical  # noqa: F401
from bnv_fusion_tpu_torch.datasets import synth_scene  # noqa: F401
from bnv_fusion_tpu_torch.datasets import scannet  # noqa: F401
from bnv_fusion_tpu_torch.datasets import synthetic_idr  # noqa: F401
from bnv_fusion_tpu_torch.datasets import arkit  # noqa: F401
from bnv_fusion_tpu_torch.datasets import pointnet_patches  # noqa: F401
from bnv_fusion_tpu_torch.datasets import fusion_windows  # noqa: F401
from bnv_fusion_tpu_torch.datasets import refiner  # noqa: F401
