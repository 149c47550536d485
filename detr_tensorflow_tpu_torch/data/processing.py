"""Normalization constants, copied from
``detr_tensorflow_tpu/data/processing.py`` (that module imports JAX)."""

import numpy as np

# ImageNet statistics used by the original PyTorch-trained DETR weights.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# Caffe-style means for TF-pretrained ResNet backbones.
CAFFE_MEAN = np.array([103.939, 116.779, 123.68], np.float32)
