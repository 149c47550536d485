"""Constants of the data pipeline that the serving path needs."""

from .coco import COCO_CLASS_NAME  # noqa: F401
from .processing import CAFFE_MEAN, IMAGENET_MEAN, IMAGENET_STD  # noqa: F401
