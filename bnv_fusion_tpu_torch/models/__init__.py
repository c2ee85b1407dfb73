"""Model registry; importing registers the pretraining trainer and the
refiner (counterpart of bnv_fusion_tpu/models/__init__.py)."""

from bnv_fusion_tpu_torch.models.registry import get_model, register  # noqa: F401
from bnv_fusion_tpu_torch.models import local_point_fusion  # noqa: F401
from bnv_fusion_tpu_torch.models import fusion_refiner  # noqa: F401
