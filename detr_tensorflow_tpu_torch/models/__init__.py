"""DETR model in PyTorch: module, weights and construction API."""

from .api import DetrModel, build_detr, get_detr_model  # noqa: F401
from .detr import DETR, as_aux_list  # noqa: F401
