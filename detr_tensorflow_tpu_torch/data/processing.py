"""Image normalization, bucket padding and fixed-slot target packing
(port of ``detr_tensorflow_tpu/data/processing.py``, which imports JAX).

Every image carries exactly ``MAX_TARGETS`` target slots: ``boxes (T, 4)``,
``classes (T,)`` and a bool ``mask (T,)``, real targets first. The
reference's header-row layout (row 0 ``[n, 0, 0, 0]``, then the targets)
goes in with ``pad_labels`` and out with ``unpack_labels``. An evaluation
example may carry instance masks: ``t_masks`` at the mask head's stride-4
lattice of the bucket, and with ``full_res_masks`` ``t_masks_full`` in the
bucket frame.
"""

from typing import Tuple

import numpy as np
import torch

MAX_TARGETS = 100

# ImageNet statistics used by the original PyTorch-trained DETR weights.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# Caffe-style means for TF-pretrained ResNet backbones.
CAFFE_MEAN = np.array([103.939, 116.779, 123.68], np.float32)


def normalize_numpy(image: np.ndarray, method: str) -> np.ndarray:
    """The plain numpy normalization of an HWC image: ``torch_resnet`` is
    x / 255 then ImageNet mean/std, ``tf_resnet`` RGB -> BGR then the caffe
    mean. The plain version of the native kernels (``data/native.py``)."""
    if method == "torch_resnet":
        out = (image.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    elif method == "tf_resnet":
        out = image.astype(np.float32)[..., ::-1] - CAFFE_MEAN
    else:
        raise ValueError(f"unknown normalization method: {method}")
    return out.astype(np.float32)


def _is_rgb_u8(image: np.ndarray) -> bool:
    return image.dtype == np.uint8 and image.ndim == 3 and image.shape[-1] == 3


def normalized_images(image: np.ndarray, config) -> np.ndarray:
    """Normalize a uint8/float HWC image per ``config.normalized_method``.
    An (H, W, 3) uint8 image goes through the fused C++ kernel
    (``data/native.py``), anything else through ``normalize_numpy``."""
    method = getattr(config, "normalized_method", "torch_resnet")
    if _is_rgb_u8(image) and method in ("torch_resnet", "tf_resnet"):
        from . import native

        return (native.normalize_torch(image) if method == "torch_resnet"
                else native.normalize_caffe(image))
    return normalize_numpy(image, method)


def denormalize_image(image: np.ndarray, config) -> np.ndarray:
    """Invert ``normalized_images`` back to uint8 RGB for visualization."""
    method = getattr(config, "normalized_method", "torch_resnet")
    if method == "torch_resnet":
        out = (image * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    elif method == "tf_resnet":
        out = (image + CAFFE_MEAN)[..., ::-1]
    else:
        raise ValueError(f"unknown normalization method: {method}")
    return np.clip(out, 0, 255).astype(np.uint8)


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


def pad_labels(images, t_bbox, t_class, max_targets: int = MAX_TARGETS):
    """Reference-layout padding (reference processing.py:35-55): header row
    ``[n, 0, 0, 0]`` followed by up to ``max_targets - 1`` real boxes.
    Returns (images, bbox (T, 4) f32, classes (T, 1) int64)."""
    t_class = np.asarray(t_class).reshape(-1, 1)
    n = min(len(t_class), max_targets - 1)
    bbox_out = np.zeros((max_targets, 4), np.float32)
    cls_out = np.zeros((max_targets, 1), np.int64)
    bbox_out[0, 0] = n
    if n:
        bbox_out[1:n + 1] = np.asarray(t_bbox, np.float32)[:n]
        cls_out[1:n + 1] = t_class[:n]
    return images, bbox_out, cls_out


def unpack_labels(t_bbox, t_class):
    """The reference's header layout, batched, to the native (boxes,
    classes, mask) one, on the tensors' device with static shapes.

    Args:
      t_bbox: (B, T, 4) with header row 0.
      t_class: (B, T, 1) or (B, T).

    Returns (boxes (B, T-1, 4), classes (B, T-1) int32, mask (B, T-1) bool).
    """
    t_bbox, t_class = torch.as_tensor(t_bbox), torch.as_tensor(t_class)
    if t_class.dim() == 3:
        t_class = t_class[..., 0]
    counts = t_bbox[:, 0, 0].to(torch.int32)
    boxes = t_bbox[:, 1:, :]
    slot = torch.arange(boxes.shape[1], dtype=torch.int32, device=boxes.device)[None, :]
    return boxes, t_class[:, 1:].to(torch.int32), slot < counts[:, None]


def _bucket(n: int, divisor: int) -> int:
    return ((n + divisor - 1) // divisor) * divisor


def pad_image_to_bucket(image: np.ndarray, divisor: int = 128):
    """Zero-pad an image so H and W are multiples of ``divisor``.

    Returns (padded_image, pixel_mask (H', W') bool, (orig_h, orig_w)).
    """
    h, w = image.shape[:2]
    ph, pw = _bucket(h, divisor), _bucket(w, divisor)
    out = np.zeros((ph, pw) + image.shape[2:], image.dtype)
    out[:h, :w] = image
    mask = np.zeros((ph, pw), bool)
    mask[:h, :w] = True
    return out, mask, (h, w)


def make_eval_example(image: np.ndarray, t_bbox: np.ndarray, t_class: np.ndarray, config,
                      bucket_divisor: int = 128, inst_masks: np.ndarray = None,
                      full_res_masks: bool = False):
    """Original-size evaluation example: the normalized image zero-padded to
    its bucket, the pixel mask of its valid region and the padded targets,
    in one dict ready for ``stack_batch``.

    Ground truth stays in the original frame's normalized coordinates: the
    masked forward is padding-invariant, so its boxes are normalized to the
    valid region as well. An (H, W, 3) uint8 image under ``torch_resnet``
    is normalized straight into the bucket by the C++ kernel.

    ``inst_masks`` (n, H, W) uint8 adds ``t_masks``: the masks padded into
    the bucket and subsampled to its stride-4 lattice, slotted like the
    boxes, where the predicted masks live. ``full_res_masks`` adds
    ``t_masks_full``, the (n, PH, PW) masks in the bucket frame (ragged in
    n: batch 1 only), for scoring at the image's own size.
    """
    h, w = image.shape[:2]
    ph, pw = _bucket(h, bucket_divisor), _bucket(w, bucket_divisor)
    if getattr(config, "normalized_method", "torch_resnet") == "torch_resnet" \
            and _is_rgb_u8(image):
        from . import native

        padded = native.normalize_torch_into_bucket(image, ph, pw)
    else:
        padded, _, _ = pad_image_to_bucket(normalized_images(image, config), bucket_divisor)
    pixel_mask = np.zeros((ph, pw), bool)
    pixel_mask[:h, :w] = True
    max_t = getattr(config, "num_queries", MAX_TARGETS)
    boxes, classes, mask = pad_targets(t_bbox, t_class, max_targets=max_t)
    example = {"images": padded.astype(np.float32), "pixel_mask": pixel_mask, "boxes": boxes,
               "classes": classes, "mask": mask}
    if inst_masks is not None:
        from .masks import pad_instance_masks

        bucketed = np.zeros((len(inst_masks), ph, pw), np.uint8)
        bucketed[:, :h, :w] = inst_masks
        example["t_masks"] = pad_instance_masks(bucketed, max_t)
        if full_res_masks:
            example["t_masks_full"] = bucketed
    return example
