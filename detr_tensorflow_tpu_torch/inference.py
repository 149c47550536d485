"""Batched postprocess, the instance masks' postprocess, the reference's
single-image inference and the drawing helpers (port of
``detr_tensorflow_tpu/inference.py``).

Mask probabilities leave the stride-4 head at the padded canvas's stride-4
lattice. COCO scores masks at each image's own size: the valid stride-4
cells are cropped, resized bilinearly with half-pixel centres (torch's
``F.interpolate(align_corners=False)``, cv2's INTER_LINEAR) to the image and
thresholded. ``bilinear_resize`` computes that resize on any device (the
``Predictor`` and ``eval`` run it on the card); ``np_bilinear_resize`` is
its numpy twin for the host (the JAX package takes cv2 there, which the
card's machine lacks; the two agree to float32 rounding). The panoptic
merge at full resolution, ``merge_full_res``, runs on the device too, twin
of the host's ``np_merge_full_res``.

Drawing is host work on uint8 RGB images: ``numpy_masks_to_image`` blends
instance masks, resized with ``data/transforms.resize_masks`` (cv2's
INTER_NEAREST bit for bit), so it needs no cv2; ``numpy_bbox_to_image``
draws boxes and labels with cv2, imported when it is called.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def mask_probs(pred_masks: torch.Tensor,
               pixel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sigmoid of ``pred_masks`` (B, Q, Hs, Ws), zero outside each image's
    valid stride-4 cells when a (B, H, W) ``pixel_mask`` is given."""
    from .models.layers import feature_valid_mask

    probs = torch.sigmoid(pred_masks.float())
    if pixel_mask is not None:
        probs = probs * feature_valid_mask(pixel_mask, *probs.shape[2:])[:, None]
    return probs


def kept_probs(probs: torch.Tensor, keep: np.ndarray, h: int, w: int,
               stride: int = 4) -> torch.Tensor:
    """One image's kept queries' probabilities at its own size, on their
    device: the (Q, Hs, Ws) probabilities of the queries ``keep`` marks,
    cropped to the valid ceil(h / s) x ceil(w / s) cells and resized
    bilinearly to (n, h, w) (``upsample_mask_probs`` on the device)."""
    with torch.inference_mode():
        sel = torch.from_numpy(np.nonzero(keep)[0]).to(probs.device)
        crop = probs.index_select(0, sel)[:, :-(-h // stride), :-(-w // stride)]
        return bilinear_resize(crop, h, w)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; from the card through pinned memory (PyTorch's
    caching host allocator): a copy into pageable memory of 100 masks at
    800x1333 took 44-49 ms on an H100, against the forward's 17.5."""
    if not t.is_cuda:
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t).numpy()


def kept_masks(probs: torch.Tensor, keep: np.ndarray, h: int, w: int, threshold: float = 0.5,
               stride: int = 4) -> np.ndarray:
    """One image's masks at its own size: ``kept_probs`` thresholded on
    their device, then (n, h, w) bool on the host."""
    with torch.inference_mode():
        return to_host(kept_probs(probs, keep, h, w, stride) > threshold)


def merge_full_res(up_probs: torch.Tensor, scores, threshold: float = 0.5) -> np.ndarray:
    """``np_merge_full_res`` of one image's kept queries on their device:
    up_probs (n, h, w) (``kept_probs``) weighted by the kept queries'
    ``scores`` (n,), the argmax over queries (ties to the first), -1 where
    the winner's probability is at most ``threshold``; only the (h, w)
    int32 map is copied to the host. Spares the host the (h, w, n) float
    array the JAX package builds there (427 MB for 100 queries at
    800x1333)."""
    n, h, w = up_probs.shape
    if n == 0:
        return np.full((h, w), -1, np.int32)
    with torch.inference_mode():
        scores = torch.as_tensor(scores, dtype=up_probs.dtype).to(up_probs.device)
        best = (up_probs * scores[:, None, None]).argmax(dim=0)
        best_prob = torch.gather(up_probs, 0, best[None])[0]
        return to_host(torch.where(best_prob > threshold, best, -1).to(torch.int32))


def postprocess_masks(m_outputs: Dict[str, torch.Tensor],
                      out_size: Optional[Tuple[int, int]] = None,
                      threshold: float = 0.5) -> torch.Tensor:
    """(B, Q, H, W) bool instance masks from ``pred_masks`` (B, Q, Hm, Wm)
    logits: the sigmoid, resized bilinearly (half-pixel centres, the
    triangle kernel widened when shrinking, as ``jax.image.resize``) to
    ``out_size`` when given, then thresholded."""
    probs = torch.sigmoid(m_outputs["pred_masks"].float())
    if out_size is not None and tuple(out_size) != tuple(probs.shape[2:]):
        probs = F.interpolate(probs, size=tuple(out_size), mode="bilinear",
                              align_corners=False, antialias=True)
    return probs > threshold


def merge_instance_masks(m_outputs: Dict[str, torch.Tensor], background_class: int,
                         mask_threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-overlapping merge of the per-query masks: each pixel goes to the
    non-background query with the largest class score x mask probability;
    a pixel whose winner's mask probability is at most ``mask_threshold``
    stays -1. Returns (seg_map (B, Hm, Wm) int32, keep (B, Q) bool)."""
    probs = torch.softmax(m_outputs["pred_logits"].float(), dim=-1)
    scores, labels = probs.max(dim=-1)
    keep = labels != background_class
    mprob = torch.sigmoid(m_outputs["pred_masks"].float())
    weighted = mprob * torch.where(keep, scores, 0.0)[:, :, None, None]
    best_q = weighted.argmax(dim=1)  # (B, Hm, Wm)
    best_prob = torch.gather(mprob, 1, best_q[:, None])[:, 0]
    best_kept = torch.gather(keep, 1, best_q.flatten(1)).reshape(best_q.shape)
    seg_map = torch.where((best_prob > mask_threshold) & best_kept, best_q, -1)
    return seg_map.to(torch.int32), keep


def _half_pixel_taps(n_out: int, n_in: int, device=None):
    """Half-pixel bilinear taps of one axis: (lo, hi, frac), the source
    position clamped to [0, n_in - 1]."""
    c = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    c = np.clip(c, 0, n_in - 1)
    lo = np.floor(c).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (c - lo).astype(np.float32)
    if device is None:
        return lo, hi, frac
    return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, frac))


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize of the last two axes of a float tensor,
    on its device, as ``np_bilinear_resize`` computes it: along the width,
    then the height, each ``a * (1 - f) + b * f``."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    xlo, xhi, fx = _half_pixel_taps(out_w, w, x.device)
    ylo, yhi, fy = _half_pixel_taps(out_h, h, x.device)
    x = x[..., xlo] * (1 - fx) + x[..., xhi] * fx
    fy = fy[:, None]
    return x[..., ylo, :] * (1 - fy) + x[..., yhi, :] * fy


def np_bilinear_resize(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel bilinear resize of an (H, W) or (H, W, C) float array:
    torch's ``F.interpolate(align_corners=False)`` and cv2's INTER_LINEAR
    on floats, computed in numpy float32."""
    x = np.ascontiguousarray(x, np.float32)
    h, w = x.shape[:2]
    if (h, w) == (out_h, out_w):
        return x
    ylo, yhi, wy = _half_pixel_taps(out_h, h)
    xlo, xhi, wx = _half_pixel_taps(out_w, w)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    wx = wx.reshape(shape)
    x = x[:, xlo] * (1 - wx) + x[:, xhi] * wx
    wy = wy.reshape((-1,) + (1,) * (x.ndim - 1))
    return x[ylo] * (1 - wy) + x[yhi] * wy


def upsample_mask_probs(probs: np.ndarray, orig_hw: Tuple[int, int],
                        stride: int = 4) -> np.ndarray:
    """(Q, Hs, Ws) mask probabilities on the (padded) stride-``stride``
    lattice -> (H, W, Q) float32 at the image's own size: the valid
    ceil(H / s) x ceil(W / s) cells cropped and resized bilinearly."""
    h, w = int(orig_hw[0]), int(orig_hw[1])
    probs = np.asarray(probs, np.float32)
    if probs.shape[0] == 0:
        return np.zeros((h, w, 0), np.float32)
    crop = probs[:, :-(-h // stride), :-(-w // stride)].transpose(1, 2, 0)
    return np_bilinear_resize(crop, h, w)


def np_merge_full_res(up_probs: np.ndarray, scores: np.ndarray, keep: np.ndarray,
                      mask_threshold: float = 0.5) -> np.ndarray:
    """``merge_instance_masks`` on the host at full resolution: up_probs
    (H, W, Q), scores (Q,), keep (Q,) -> (H, W) winning query or -1."""
    weighted = up_probs * np.where(keep, scores, 0.0)[None, None, :]
    best_q = weighted.argmax(-1).astype(np.int32)
    best_prob = np.take_along_axis(up_probs, best_q[..., None], axis=-1)[..., 0]
    return np.where((best_prob > mask_threshold) & keep[best_q], best_q, -1)


# A colour per class id (mod 200): the JAX package's draw, so both packages
# paint a class alike.
_CLASS_COLORS = np.random.RandomState(0).randint(0, 255, (200, 3))


def _as_uint8(image: np.ndarray, config, unnormalize: bool) -> np.ndarray:
    from .data.processing import denormalize_image

    image = np.asarray(image)
    if unnormalize and config is not None and image.dtype != np.uint8:
        return denormalize_image(image, config)
    if image.dtype != np.uint8:
        return np.clip(image * 255.0, 0, 255).astype(np.uint8)
    return image


def numpy_masks_to_image(image: np.ndarray, masks: np.ndarray, labels=None, alpha: float = 0.45,
                         config=None, unnormalize: bool = True) -> np.ndarray:
    """Alpha-blend instance masks onto an image; uint8 RGB out.

    ``image`` (H, W, 3) is uint8, or normalized float (denormalized by
    ``config``'s method, else scaled by 255); ``masks`` (N, h, w) bool or
    float at any size, a mask of another size cast to uint8 and
    nearest-resized to the image; ``labels`` (N,) pick each mask's colour
    (default: its index)."""
    from .data.transforms import resize_masks

    image = np.ascontiguousarray(_as_uint8(image, config, unnormalize)).astype(np.float32)
    h, w = image.shape[:2]
    masks = np.asarray(masks)
    if labels is None:
        labels = np.arange(len(masks))
    for i, m in enumerate(masks):
        if m.shape != (h, w):
            m = resize_masks(m.astype(np.uint8)[None], h, w)[0]
        sel = m > 0.5
        if not sel.any():
            continue
        color = _CLASS_COLORS[int(labels[i]) % 200].astype(np.float32)
        image[sel] = (1.0 - alpha) * image[sel] + alpha * color
    return np.clip(image, 0, 255).astype(np.uint8)


def numpy_bbox_to_image(image: np.ndarray, bbox_list: np.ndarray, labels=None, scores=None,
                        class_name=(), config=None, unnormalize: bool = True) -> np.ndarray:
    """Draw normalized xcycwh boxes, largest first, each with its class name
    (the id past ``class_name``) and score on a filled tab; uint8 RGB out.
    ``image`` as in ``numpy_masks_to_image``. Needs cv2."""
    import cv2

    image = np.ascontiguousarray(_as_uint8(image, config, unnormalize))
    h, w = image.shape[:2]
    bbox_list = np.asarray(bbox_list).reshape(-1, 4)
    if labels is None:
        labels = np.zeros((len(bbox_list),), int)
    xyxy = bbox_ops.np_xcycwh_to_xyxy(bbox_ops.np_rescale_bbox_xcycwh(bbox_list, (h, w)))
    areas = (xyxy[:, 2] - xyxy[:, 0]) * (xyxy[:, 3] - xyxy[:, 1])
    for b in np.argsort(areas)[::-1]:
        x1, y1, x2, y2 = (int(v) for v in xyxy[b])
        x1, y1 = max(0, x1), max(0, y1)
        x2, y2 = min(w, x2), min(h, y2)
        class_id = int(labels[int(b)])
        name = class_name[class_id] if class_id < len(class_name) else str(class_id)
        if scores is not None and len(scores) > 0:
            name = f"{name}:{float(scores[b]):.2f}"
        color = tuple(int(c) for c in _CLASS_COLORS[class_id % 200])
        cv2.rectangle(image, (x1, y1), (x2, y2), color, 2)
        cv2.rectangle(image, (x1, y1 - 14), (x1 + 8 * len(name), y1), color, -1)
        cv2.putText(image, name, (x1 + 1, y1 - 3), cv2.FONT_HERSHEY_SIMPLEX, 0.4, (0, 0, 0), 1)
    return image
