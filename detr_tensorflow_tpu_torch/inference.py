"""Batched postprocess (port of ``detr_tensorflow_tpu/inference.py:postprocess``)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .ops import boxes as bbox_ops


def postprocess(m_outputs: Dict[str, torch.Tensor], background_class: int,
                bbox_format: str = "xy_center") -> Tuple[torch.Tensor, ...]:
    """Per query: box, label, score and ``keep`` (label is not background).

    Args:
      m_outputs: {'pred_logits': (B, Q, C), 'pred_boxes': (B, Q, 4)}.
      bbox_format: 'xy_center' | 'xyxy' | 'yxyx'.

    Returns (boxes (B, Q, 4), labels (B, Q), scores (B, Q), keep (B, Q)).
    Ties in the class scores go to the first index, as in JAX.
    """
    probs = torch.softmax(m_outputs["pred_logits"], dim=-1)
    scores, labels = probs.max(dim=-1)
    keep = labels != background_class
    pred_boxes = m_outputs["pred_boxes"]
    if bbox_format == "xy_center":
        out_boxes = pred_boxes
    elif bbox_format == "xyxy":
        out_boxes = bbox_ops.xcycwh_to_xyxy(pred_boxes, clip=True)
    elif bbox_format == "yxyx":
        out_boxes = bbox_ops.xcycwh_to_yxyx(pred_boxes, clip=True)
    else:
        raise NotImplementedError(bbox_format)
    return out_boxes, labels, scores, keep
