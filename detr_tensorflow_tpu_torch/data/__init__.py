"""Host-side data pipelines: COCO, COCO panoptic and VOC loaders, augmentation,
normalization, fixed-slot target packing and a threaded prefetcher."""

from .coco import COCO_CLASS_NAME, get_coco_labels, load_coco_dataset  # noqa: F401
from .coco_api import CocoIndex  # noqa: F401
from .panoptic import load_coco_panoptic, load_coco_panoptic_train  # noqa: F401
from .pipeline import HostDataset  # noqa: F401
from .processing import (  # noqa: F401
    CAFFE_MEAN, IMAGENET_MEAN, IMAGENET_STD, MAX_TARGETS, denormalize_image, make_eval_example,
    normalized_images, pad_image_to_bucket, pad_labels, pad_targets, unpack_labels,
)
from .synthetic import make_synthetic_coco  # noqa: F401
from .transforms import detr_transform  # noqa: F401
from .voc import VOC_CLASS_NAME, load_voc_dataset  # noqa: F401
