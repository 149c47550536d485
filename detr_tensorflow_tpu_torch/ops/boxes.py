"""Box format converters (port of ``detr_tensorflow_tpu/ops/boxes.py``),
the ones ``inference.postprocess`` uses, over ``(..., 4)`` tensors.

Formats: ``xcycwh`` (x_center, y_center, width, height), ``xyxy``
(xmin, ymin, xmax, ymax), ``yxyx`` (ymin, xmin, ymax, xmax).
"""

from __future__ import annotations

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
