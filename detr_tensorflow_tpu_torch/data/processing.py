"""Normalization constants and fixed-slot target packing, copied from
``detr_tensorflow_tpu/data/processing.py`` (that module imports JAX).

Every image carries exactly ``MAX_TARGETS`` target slots: ``boxes (T, 4)``,
``classes (T,)`` and a bool ``mask (T,)``, real targets first.
"""

from typing import Tuple

import numpy as np

MAX_TARGETS = 100

# ImageNet statistics used by the original PyTorch-trained DETR weights.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# Caffe-style means for TF-pretrained ResNet backbones.
CAFFE_MEAN = np.array([103.939, 116.779, 123.68], np.float32)


def pad_targets(t_bbox: np.ndarray, t_class: np.ndarray,
                max_targets: int = MAX_TARGETS) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad one image's targets to the fixed slot count.

    t_bbox: (n, 4) xcycwh normalized; t_class: (n,) or (n, 1) int ids.
    Returns (boxes (T, 4) f32, classes (T,) i32, mask (T,) bool).
    """
    t_class = np.asarray(t_class).reshape(-1)
    n = min(len(t_class), max_targets)
    boxes = np.zeros((max_targets, 4), np.float32)
    classes = np.zeros((max_targets,), np.int32)
    mask = np.zeros((max_targets,), bool)
    if n:
        boxes[:n] = np.asarray(t_bbox, np.float32)[:n]
        classes[:n] = t_class[:n]
        mask[:n] = True
    return boxes, classes, mask
