"""Constants and target packing of the data pipeline that serving and
training need."""

from .coco import COCO_CLASS_NAME  # noqa: F401
from .processing import (  # noqa: F401
    CAFFE_MEAN, IMAGENET_MEAN, IMAGENET_STD, MAX_TARGETS, pad_targets,
)
