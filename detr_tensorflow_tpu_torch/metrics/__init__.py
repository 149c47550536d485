"""Evaluation metrics: COCO-style mAP under the reference's and the
COCOeval protocols, and panoptic quality (numpy, host side)."""

from .ap import APAccumulator, DEFAULT_IOU_THRESHOLDS, MeanAPEvaluator  # noqa: F401
from .coco_protocol import COCOProtocolEvaluator  # noqa: F401
from .pq import panoptic_quality, panoptic_quality_from_outputs  # noqa: F401
