"""Batched postprocess and the reference's single-image inference (port of
``detr_tensorflow_tpu/inference.py``: ``postprocess``, ``get_model_inference``)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
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


def get_model_inference(m_outputs: Dict[str, torch.Tensor], background_class: int,
                        bbox_format: str = "xy_center"):
    """The reference's single-image inference (reference inference.py:68-95):
    batch element 0's non-background detections as numpy arrays (boxes,
    labels, scores)."""
    boxes, labels, scores, keep = postprocess(m_outputs, background_class, bbox_format)
    keep0 = keep[0].cpu().numpy()
    return tuple(np.asarray(t[0].cpu().numpy())[keep0] for t in (boxes, labels, scores))
