"""Host-side image and box augmentation without OpenCV (port of
``detr_tensorflow_tpu/data/transforms.py``, which resamples with cv2).

The training transform: horizontal flip p=0.5; with p=0.5 one of {resize
to the target size, random crop to it, scale about the center by
U(0.5, 1.5) per axis}; a final resize to the target size; boxes moved
alongside, dropped when more than 70% of their area falls outside,
clipped otherwise. Validation resizes only. Each step draws from the
numpy Generator exactly as the JAX transform does, so one seed picks the
same operations and the same boxes.

The resamplings are OpenCV's, rebuilt here as separable per-axis taps
(``axis_taps``), applied along the width, then the height, in float32:

* ``cv2.resize`` with INTER_NEAREST (the source index floor(x * scale),
  bit-equal), INTER_LINEAR and INTER_CUBIC (half-pixel centers, cubic
  a = -0.75, edge taps replicated) and INTER_AREA (exact box weights
  when shrinking both axes, its own linear weights otherwise);
* ``cv2.warpAffine`` for a scale about a point (INTER_LINEAR, zero
  border), with OpenCV 5's float32 source positions and a + f (b - a)
  interpolation.

uint8 INTER_LINEAR (and INTER_AREA where it does not shrink both axes)
runs OpenCV's 11-bit fixed point; it and INTER_AREA are bit-equal to
OpenCV's. Cubic sums in float32 where OpenCV keeps 11-bit weights, so a
result can land one level away (``tests/test_torch_data.py`` measures the
bound per mode).

Instance masks (n, H, W) uint8 ride along through every step with nearest
sampling, bit-equal to OpenCV 5.0's: ``cv2.resize`` with INTER_NEAREST
(``resize_masks``) and ``cv2.warpAffine`` with INTER_NEAREST for the scale
about the centre (``warp_scale_nearest``); flips and crops slice them, and
the boxes' keep mask drops their instances. Masks draw nothing from the
Generator, as in the JAX transform.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..ops import boxes as bbox_ops

NEAREST, LINEAR, CUBIC, AREA = "nearest", "linear", "cubic", "area"
# The order of cv2's INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA
# that the JAX transform draws from.
INTERPOLATIONS = (NEAREST, LINEAR, CUBIC, AREA)
_CUBIC_A = np.float32(-0.75)


def _cubic_weights(x: np.ndarray) -> np.ndarray:
    """OpenCV's interpolateCubic in float32: (n, 4) weights of the taps at
    floor - 1 .. floor + 2 for the fractions ``x``."""
    a, one = _CUBIC_A, np.float32(1.0)
    x = x.astype(np.float32)
    w0 = ((a * (x + one) - np.float32(5) * a) * (x + one) + np.float32(8) * a) * (x + one) \
        - np.float32(4) * a
    w1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    y = one - x
    w2 = ((a + np.float32(2)) * y - (a + np.float32(3))) * y * y + one
    w3 = one - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=1)


def _area_taps(n_in: int, n_out: int, scale: float):
    """OpenCV's computeResizeAreaTab: the source pixels each output pixel
    covers when shrinking, weighted by the covered fraction."""
    taps = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    k = max(len(r) for r in taps)
    idx = np.zeros((n_out, k), np.int64)
    w = np.zeros((n_out, k), np.float32)
    for d, row in enumerate(taps):
        for j, (s, a) in enumerate(row):
            idx[d, j], w[d, j] = s, np.float32(a)
    return idx, w


def axis_taps(n_in: int, n_out: int, mode: str, area: bool = False, rows: bool = False):
    """Source indices (n_out, K) and float32 weights (n_out, K) of one axis
    of ``cv2.resize`` from ``n_in`` to ``n_out`` pixels. ``area`` says that
    INTER_AREA shrinks both axes (box weights); otherwise INTER_AREA uses
    its linear weights on both axes, as OpenCV does. ``rows``: the height
    axis, where OpenCV keeps a linear weight that falls outside the image
    and reads the edge row through both taps (along the width it moves the
    whole weight onto the edge pixel)."""
    inv_scale = n_out / n_in
    scale = 1.0 / inv_scale
    d = np.arange(n_out, dtype=np.float64)
    if mode == NEAREST:
        return np.minimum(np.floor(d * scale).astype(np.int64), n_in - 1)[:, None], \
            np.ones((n_out, 1), np.float32)
    if mode == AREA and area:
        return _area_taps(n_in, n_out, scale)
    if mode == AREA:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv_scale).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = (f - s.astype(np.float32)).astype(np.float32)
    if mode == CUBIC:
        idx = np.clip(s[:, None] + np.arange(-1, 3), 0, n_in - 1)
        return idx, _cubic_weights(f)
    if not rows:
        low = s < 0
        f[low], s[low] = 0, 0
        high = s >= n_in - 1
        f[high], s[high] = 0, n_in - 1
    idx = np.clip(s[:, None] + np.arange(2), 0, n_in - 1)
    return idx, np.stack([np.float32(1) - f, f], axis=1)


def _columns(idx: np.ndarray, w: np.ndarray, c: int):
    """Width taps over an (H, W * C) view: each pixel's C interleaved
    channels as C columns (K, Wo * C) of indices and weights."""
    cols = (idx[:, :, None] * c + np.arange(c)).transpose(1, 0, 2).reshape(idx.shape[1], -1)
    return cols, np.repeat(w.T, c, axis=1)


def _apply_taps(x: np.ndarray, idx: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """sum_k w[:, k] * x[idx[:, k]] along ``axis`` of a 2-D float32 array
    (0: rows, weights (n, K); 1: columns, weights (K, n)), one tap at a
    time, accumulated in place."""
    out = None
    for k in range(idx.shape[1] if axis == 0 else idx.shape[0]):
        term = np.take(x, idx[:, k] if axis == 0 else idx[k], axis=axis)
        term *= w[:, k, None] if axis == 0 else w[k]
        out = term if out is None else np.add(out, term, out=out)
    return out


def _from_float(out: np.ndarray, dtype) -> np.ndarray:
    if dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(dtype)


def _resize_linear_u8(image: np.ndarray, out_h: int, out_w: int, mode: str) -> np.ndarray:
    """OpenCV's uint8 two-tap resize (INTER_LINEAR, and INTER_AREA where it
    does not shrink both axes) in its fixed point: weights rounded to 11
    bits, the width pass summed in integers, the height pass as its vector
    code computes it: ((S0 >> 4) b0 >> 16) + ((S1 >> 4) b1 >> 16), + 2 >> 2."""
    h, w = image.shape[:2]
    c = 1 if image.ndim == 2 else image.shape[2]
    x = image.reshape(h, w * c)
    ix, wx = axis_taps(w, out_w, mode)
    iy, wy = axis_taps(h, out_h, mode, rows=True)
    cols, ax = _columns(ix, np.rint(wx.astype(np.float64) * 2048).astype(np.int32), c)
    ay = np.rint(wy.astype(np.float64) * 2048).astype(np.int32)
    rows = np.take(x, cols[0], axis=1).astype(np.int32)
    rows *= ax[0]
    second = np.take(x, cols[1], axis=1).astype(np.int32)
    second *= ax[1]
    rows += second
    rows >>= 4
    out = np.take(rows, iy[:, 0], axis=0)
    out *= ay[:, 0, None]
    out >>= 16
    second = np.take(rows, iy[:, 1], axis=0)
    second *= ay[:, 1, None]
    second >>= 16
    out += second
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((out_h, out_w) + image.shape[2:])


def resize(image: np.ndarray, out_h: int, out_w: int, mode: str = LINEAR) -> np.ndarray:
    """``cv2.resize(image, (out_w, out_h), interpolation=mode)`` of an
    (H, W) or (H, W, C) uint8 or float32 image."""
    h, w = image.shape[:2]
    if mode not in INTERPOLATIONS:
        raise ValueError(f"unknown interpolation {mode!r}")
    if mode == NEAREST:
        rows = axis_taps(h, out_h, NEAREST)[0][:, 0]
        cols = axis_taps(w, out_w, NEAREST)[0][:, 0]
        return np.ascontiguousarray(image[rows][:, cols])
    if (h, w) == (out_h, out_w):
        return image.copy()
    area = mode == AREA and out_h <= h and out_w <= w
    if mode in (LINEAR, AREA) and not area and image.dtype == np.uint8:
        return _resize_linear_u8(image, out_h, out_w, mode)
    c = 1 if image.ndim == 2 else image.shape[2]
    x = image.reshape(h, w * c).astype(np.float32)
    x = _apply_taps(x, *_columns(*axis_taps(w, out_w, mode, area), c), axis=1)
    x = _apply_taps(x, *axis_taps(h, out_h, mode, area, rows=True), axis=0)
    return _from_float(x, image.dtype).reshape((out_h, out_w) + image.shape[2:])


def _lerp_axis(x: np.ndarray, n: int, inv: float, offset: float, axis: int, c: int = 1
               ) -> np.ndarray:
    """One axis of ``cv2.warpAffine``'s INTER_LINEAR sampling over a 2-D
    (H, W * C) float32 view: output pixel d reads the source at inv * d +
    offset (float32), as a + f * (b - a) between its two neighbours, zero
    outside the image."""
    pos = np.float32(inv) * np.arange(n, dtype=np.float32) + np.float32(offset)
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0.astype(np.float32)).astype(np.float32)
    size = x.shape[axis] // (c if axis == 1 else 1)

    def tap(i):
        inside = ((i >= 0) & (i < size)).astype(np.float32)
        i = np.clip(i, 0, size - 1)
        if axis == 1:
            i = (i[:, None] * c + np.arange(c)).reshape(-1)
            inside = np.repeat(inside, c)
        v = np.take(x, i, axis=axis)
        v *= inside[:, None] if axis == 0 else inside
        return v

    a, b = tap(i0), tap(i0 + 1)
    b -= a
    b *= frac[:, None] if axis == 0 else np.repeat(frac, c)
    a += b
    return a


def warp_scale(image: np.ndarray, sx: float, sy: float, cx: float, cy: float) -> np.ndarray:
    """``cv2.warpAffine(image, [[sx, 0, cx (1 - sx)], [0, sy, cy (1 - sy)]],
    (W, H), flags=INTER_LINEAR)``: a scale about (cx, cy), zero outside,
    with the source position in float32 as OpenCV 5 computes it."""
    h, w = image.shape[:2]
    c = 1 if image.ndim == 2 else image.shape[2]
    a11, b1, a22, b2 = _inverse_scale(sx, sy, cx, cy)
    x = image.reshape(h, w * c).astype(np.float32)
    x = _lerp_axis(x, w, a11, b1, axis=1, c=c)
    x = _lerp_axis(x, h, a22, b2, axis=0)
    return _from_float(x, image.dtype).reshape(image.shape)


def _inverse_scale(sx: float, sy: float, cx: float, cy: float):
    """OpenCV's invertAffineTransform of a scale about (cx, cy), in its
    order of operations: (a11, b1, a22, b2), the source position of output
    pixel d being a * d + b along each axis."""
    tx, ty = cx * (1 - sx), cy * (1 - sy)
    det = 1.0 / (sx * sy)
    a11, a22, a12, a21 = sy * det, sx * det, -0.0 * det, -0.0 * det
    return a11, -a11 * tx - a12 * ty, a22, -a21 * tx - a22 * ty


def warp_scale_nearest(masks: np.ndarray, sx: float, sy: float, cx: float,
                       cy: float) -> np.ndarray:
    """``cv2.warpAffine(mask, [[sx, 0, cx (1 - sx)], [0, sy, cy (1 - sy)]],
    (W, H), flags=INTER_NEAREST)`` of each (n, H, W) mask: the source
    pixel nearest (ties to even) to the float32 position OpenCV 5.0
    computes, zero outside. Its vector loop takes columns in blocks of 16
    and computes a * d + b with one rounding (a fused multiply-add); the
    last W mod 16 columns, and every row, round the product and the sum
    apart."""
    n, h, w = masks.shape
    a11, b1, a22, b2 = (np.float32(v) for v in _inverse_scale(sx, sy, cx, cy))
    d = np.arange(w)
    fused = (np.float64(a11) * d + np.float64(b1)).astype(np.float32)
    px = np.where(d < w - w % 16, fused, a11 * d.astype(np.float32) + b1)
    py = a22 * np.arange(h, dtype=np.float32) + b2
    ix, iy = np.rint(px).astype(np.int64), np.rint(py).astype(np.int64)
    vx, vy = (ix >= 0) & (ix < w), (iy >= 0) & (iy < h)
    out = np.zeros_like(masks)
    out[:, vy[:, None] & vx[None, :]] = masks[:, iy[vy]][:, :, ix[vx]].reshape(n, -1)
    return out


def resize_masks(masks: Optional[np.ndarray], out_h: int, out_w: int):
    """``cv2.resize(mask, (out_w, out_h), interpolation=INTER_NEAREST)`` of
    each (n, H, W) mask, in one gather."""
    if masks is None or len(masks) == 0:
        return masks
    rows = axis_taps(masks.shape[1], out_h, NEAREST)[0][:, 0]
    cols = axis_taps(masks.shape[2], out_w, NEAREST)[0][:, 0]
    return np.ascontiguousarray(masks[:, rows][:, :, cols])


def _resize(image, boxes_xyxy, out_h, out_w, rng: Optional[np.random.Generator] = None,
            masks=None):
    h, w = image.shape[:2]
    mode = INTERPOLATIONS[rng.integers(0, len(INTERPOLATIONS))] if rng is not None else LINEAR
    image = resize(image, out_h, out_w, mode)
    scale = np.array([out_w / w, out_h / h, out_w / w, out_h / h])
    return image, boxes_xyxy * scale, resize_masks(masks, out_h, out_w)


def _hflip(image, boxes_xyxy, masks=None):
    w = image.shape[1]
    flipped = boxes_xyxy.copy()
    flipped[:, 0] = w - boxes_xyxy[:, 2]
    flipped[:, 2] = w - boxes_xyxy[:, 0]
    if masks is not None:
        masks = np.ascontiguousarray(masks[:, :, ::-1])
    return np.ascontiguousarray(image[:, ::-1]), flipped, masks


def _crop_to_fixed_size(image, boxes_xyxy, out_h, out_w, rng, masks=None):
    h, w = image.shape[:2]
    ch, cw = min(out_h, h), min(out_w, w)
    top = int(rng.integers(0, h - ch + 1))
    left = int(rng.integers(0, w - cw + 1))
    image = image[top:top + ch, left:left + cw]
    if masks is not None:
        masks = np.ascontiguousarray(masks[:, top:top + ch, left:left + cw])
    return (np.ascontiguousarray(image), boxes_xyxy - np.array([left, top, left, top]),
            masks)


def _affine_scale(image, boxes_xyxy, rng, masks=None):
    h, w = image.shape[:2]
    sx = float(rng.uniform(0.5, 1.5))
    sy = float(rng.uniform(0.5, 1.5))
    cx, cy = w / 2.0, h / 2.0
    image = warp_scale(image, sx, sy, cx, cy)
    scaled = boxes_xyxy.copy().astype(np.float64)
    scaled[:, [0, 2]] = cx + sx * (scaled[:, [0, 2]] - cx)
    scaled[:, [1, 3]] = cy + sy * (scaled[:, [1, 3]] - cy)
    if masks is not None and len(masks):
        masks = warp_scale_nearest(masks, sx, sy, cx, cy)
    return image, scaled, masks


def _filter_and_clip(boxes_xyxy, classes, h, w, max_outside_fraction=0.7):
    """Drop boxes mostly outside the image; clip the rest. Returns the keep
    mask too, which drops the same instances' masks."""
    if len(boxes_xyxy) == 0:
        return boxes_xyxy, classes, np.zeros((0,), bool)
    area = np.maximum(boxes_xyxy[:, 2] - boxes_xyxy[:, 0], 0) * np.maximum(
        boxes_xyxy[:, 3] - boxes_xyxy[:, 1], 0)
    clipped = boxes_xyxy.copy()
    clipped[:, 0::2] = np.clip(clipped[:, 0::2], 0, w)
    clipped[:, 1::2] = np.clip(clipped[:, 1::2], 0, h)
    inside = np.maximum(clipped[:, 2] - clipped[:, 0], 0) * np.maximum(
        clipped[:, 3] - clipped[:, 1], 0)
    visible = np.where(area > 0, inside / np.maximum(area, 1e-9), 0.0)
    keep = (visible > (1.0 - max_outside_fraction)) & (inside > 0)
    return clipped[keep], np.asarray(classes)[keep], keep


def shortest_side_resize(image: np.ndarray, min_side: int = 800, max_side: int = 1333,
                         masks: Optional[np.ndarray] = None):
    """DETR-paper evaluation resize: the shortest side to ``min_side``,
    capped so the longest stays within ``max_side`` (bilinear). With
    ``masks`` ((n, H, W), resized nearest) returns (image, masks)."""
    h, w = image.shape[:2]
    scale = min(min_side / min(h, w), max_side / max(h, w))
    nh, nw = int(round(h * scale)), int(round(w * scale))
    image = resize(image, nh, nw, LINEAR)
    if masks is None:
        return image
    return image, resize_masks(masks, nh, nw)


def detr_transform(image: np.ndarray, bbox: np.ndarray, t_class: np.ndarray, config,
                   augmentation: bool, rng: Optional[np.random.Generator] = None,
                   masks: Optional[np.ndarray] = None,
                   image_size: Optional[Tuple[int, int]] = None) -> Tuple[np.ndarray, ...]:
    """Augment (or only resize) one image and its normalized xcycwh boxes.

    Returns (image, boxes normalized xcycwh, classes) at ``image_size``, or
    ``config.image_size`` when it is None; with ``masks`` ((n, H, W) uint8)
    a fourth element, the transformed masks of the kept instances.
    """
    if rng is None:
        rng = np.random.default_rng()
    out_h, out_w = image_size if image_size is not None else config.image_size
    h, w = image.shape[:2]
    t_class = np.asarray(t_class).reshape(-1)
    with_masks = masks is not None
    boxes_xyxy = bbox_ops.np_xcycwh_to_xyxy(np.asarray(bbox, np.float64)) * np.array(
        [w, h, w, h])
    if augmentation:
        if rng.random() < 0.5:
            image, boxes_xyxy, masks = _hflip(image, boxes_xyxy, masks)
        if rng.random() < 0.5:
            op = rng.integers(0, 3)
            if op == 0:
                image, boxes_xyxy, masks = _resize(image, boxes_xyxy, out_h, out_w, rng, masks)
            elif op == 1:
                image, boxes_xyxy, masks = _crop_to_fixed_size(image, boxes_xyxy, out_h, out_w,
                                                               rng, masks)
            else:
                image, boxes_xyxy, masks = _affine_scale(image, boxes_xyxy, rng, masks)
        image, boxes_xyxy, masks = _resize(image, boxes_xyxy, out_h, out_w, rng, masks)
    else:
        image, boxes_xyxy, masks = _resize(image, boxes_xyxy, out_h, out_w, masks=masks)
    boxes_xyxy, t_class, keep = _filter_and_clip(boxes_xyxy, t_class, image.shape[0],
                                                 image.shape[1])
    hh, ww = image.shape[:2]
    norm = boxes_xyxy / np.array([ww, hh, ww, hh])
    out_boxes = (bbox_ops.np_xyxy_to_xcycwh(norm).astype(np.float32) if len(norm)
                 else np.zeros((0, 4), np.float32))
    if with_masks:
        return image, out_boxes, t_class, masks[keep] if len(keep) else masks[:0]
    return image, out_boxes, t_class
