"""Box geometry (port of ``detr_tensorflow_tpu/ops/boxes.py``) over
``(..., 4)`` tensors: the format converters, pairwise intersection, IoU
and GIoU, and the aligned-pair GIoU of the loss.

Formats: ``xcycwh`` (x_center, y_center, width, height), ``xyxy``
(xmin, ymin, xmax, ymax), ``yxyx`` (ymin, xmin, ymax, xmax).
"""

from __future__ import annotations

import numpy as np
import torch


def xcycwh_to_xyxy(b: torch.Tensor, clip: bool = True) -> torch.Tensor:
    """[xc, yc, w, h] -> [xmin, ymin, xmax, ymax], clipped to [0, 1]."""
    xy, wh = b[..., :2], b[..., 2:]
    out = torch.cat([xy - wh / 2.0, xy + wh / 2.0], dim=-1)
    return out.clamp(0.0, 1.0) if clip else out


def xyxy_to_yxyx(b: torch.Tensor) -> torch.Tensor:
    """Swap the x/y pairs; also maps yxyx back to xyxy."""
    return b[..., [1, 0, 3, 2]]


def xcycwh_to_yxyx(b: torch.Tensor, clip: bool = True) -> torch.Tensor:
    return xyxy_to_yxyx(xcycwh_to_xyxy(b, clip=clip))


def area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, shape (...,)."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def intersect(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection area of xyxy sets: (..., A, 4) x (..., B, 4)
    -> (..., A, B)."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    wh = (max_xy - min_xy).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def jaccard(box_a: torch.Tensor, box_b: torch.Tensor, return_union: bool = False):
    """Pairwise IoU of xyxy sets -> (..., A, B) (and the union areas)."""
    inter = intersect(box_a, box_b)
    union = area(box_a)[..., :, None] + area(box_b)[..., None, :] - inter
    iou = inter / union
    return (iou, union) if return_union else iou


def merge(box_a: torch.Tensor, box_b: torch.Tensor):
    """Tile two sets to (..., A, B, 4) each."""
    shape = box_a.shape[:-2] + (box_a.shape[-2], box_b.shape[-2], 4)
    return box_a[..., :, None, :].expand(shape), box_b[..., None, :, :].expand(shape)


def giou(box_a: torch.Tensor, box_b: torch.Tensor, return_iou: bool = False):
    """Pairwise generalized IoU of xyxy sets -> (..., A, B):
    iou - (enclosing area - union) / enclosing area."""
    iou, union = jaccard(box_a, box_b, return_union=True)
    top_left = torch.minimum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    bottom_right = torch.maximum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    wh = (bottom_right - top_left).clamp(min=0.0)
    enclose = wh[..., 0] * wh[..., 1]
    g = iou - (enclose - union) / enclose
    return (g, iou) if return_iou else g


def elementwise_giou(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned pairs of xyxy boxes: (..., 4) x (..., 4) -> (...),
    the diagonal of ``giou`` without the pairwise matrix."""
    inter_wh = (torch.minimum(box_a[..., 2:], box_b[..., 2:])
                - torch.maximum(box_a[..., :2], box_b[..., :2])).clamp(min=0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = area(box_a) + area(box_b) - inter
    enc_wh = (torch.maximum(box_a[..., 2:], box_b[..., 2:])
              - torch.minimum(box_a[..., :2], box_b[..., :2])).clamp(min=0.0)
    enclose = enc_wh[..., 0] * enc_wh[..., 1]
    return inter / union - (enclose - union) / enclose


# numpy twins for the host data pipeline and the AP bookkeeping.
def np_xcycwh_to_xyxy(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b)
    return np.concatenate([b[..., :2] - b[..., 2:] / 2.0, b[..., :2] + b[..., 2:] / 2.0], axis=-1)


def np_xyxy_to_xcycwh(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b)
    return np.concatenate(
        [b[..., :2] + (b[..., 2:] - b[..., :2]) / 2.0, b[..., 2:] - b[..., :2]], axis=-1)


def np_yxyx_to_xyxy(b: np.ndarray) -> np.ndarray:
    """Swap the axes of corner boxes (involutive: xyxy -> yxyx as well)."""
    b = np.asarray(b)
    return np.stack([b[..., 1], b[..., 0], b[..., 3], b[..., 2]], axis=-1)
