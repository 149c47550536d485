"""COCO segmentations to masks, without pycocotools or OpenCV (port of
``detr_tensorflow_tpu/data/masks.py``, which rasterizes polygons with
``cv2.fillPoly``).

COCO stores an instance's segmentation as polygons (flat [x0, y0, x1, y1,
...] rings), as uncompressed RLE ({"counts": [int, ...], "size": [h, w]},
column-major runs starting with a background run) or as compressed RLE (the
same runs in pycocotools' base-48 varint string, delta-coded from the
second-previous run). Each becomes an (H, W) uint8 {0, 1} mask.

``polygons_to_mask`` is OpenCV 5's ``fillPoly`` (8-connected, no shift) on
the rounded vertices, rebuilt bit for bit: every edge's outline drawn as
OpenCV's 8-connected ``LineIterator`` draws it (clipped by ``clipLine``),
then the even-odd scanline fill of all rings together in OpenCV's 16.16
fixed point: each edge covers the rows [y0, y1) from its x at y0, stepped
by the slope truncated toward zero (an edge with an end outside the image
runs between its clipped ends' columns), and each span fills the pixels
from ceil(left) to floor(right). The rules were read off cv2 5.0.0:
``tests/test_torch_masks.py`` holds them against it on convex, concave,
multi-ring and clipped polygons.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def decode_rle_counts(counts) -> np.ndarray:
    """A compressed-RLE counts string -> run lengths (int64)."""
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    out: List[int] = []
    p, n = 0, len(counts)
    while p < n:
        x = k = 0
        while True:
            c = counts[p] - 48
            x |= (c & 0x1F) << (5 * k)
            p += 1
            k += 1
            if not c & 0x20:
                if c & 0x10:  # sign-extend the last chunk
                    x |= -1 << (5 * k)
                break
        if len(out) > 2:
            x += out[-2]  # delta from the second-previous run
        out.append(x)
    return np.asarray(out, np.int64)


def rle_to_mask(rle: dict) -> np.ndarray:
    """An RLE dict (compressed or uncompressed) -> (H, W) uint8."""
    h, w = rle["size"]
    counts = rle["counts"]
    runs = (decode_rle_counts(counts) if isinstance(counts, (str, bytes))
            else np.asarray(counts, np.int64))
    values = np.zeros(len(runs), np.uint8)
    values[1::2] = 1  # runs alternate background / foreground
    flat = np.repeat(values, runs)
    if flat.size < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - flat.size, np.uint8)])
    return flat[:h * w].reshape(w, h).T  # column-major


def _clip_line(w: int, h: int, p1: List[int], p2: List[int]) -> bool:
    """OpenCV's ``clipLine`` on a (w, h) image, in place on [x, y] lists:
    each end moved onto the border, first in y then in x, by the double
    division it computes, truncated. Returns whether any part is inside."""
    right, bottom = w - 1, h - 1

    def code(x, y, with_y=True):
        c = (x < 0) + (x > right) * 2
        return c + ((y < 0) * 4 + (y > bottom) * 8 if with_y else 0)

    c1, c2 = code(*p1), code(*p2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            p1[0] += int(float(a - p1[1]) * float(p2[0] - p1[0]) / float(p2[1] - p1[1]))
            p1[1] = a
            c1 = code(*p1, with_y=False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            p2[0] += int(float(a - p2[1]) * float(p2[0] - p1[0]) / float(p2[1] - p1[1]))
            p2[1] = a
            c2 = code(*p2, with_y=False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                p1[1] += int(float(a - p1[0]) * float(p2[1] - p1[1]) / float(p2[0] - p1[0]))
                p1[0] = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                p2[1] += int(float(a - p2[0]) * float(p2[1] - p1[1]) / float(p2[0] - p1[0]))
                p2[0] = a
                c2 = 0
    return (c1 | c2) == 0


def _outside(w: int, h: int, *points) -> bool:
    return any(not (0 <= x < w and 0 <= y < h) for x, y in points)


def _line_pixels(w: int, h: int, p1, p2) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels OpenCV's 8-connected ``LineIterator`` (left to right)
    visits from p1 to p2: (rows, cols). Its error term steps the minor axis
    at major step j exactly floor((2 j dy + dx - 1) / (2 dx)) times."""
    p1, p2 = list(p1), list(p2)
    if _outside(w, h, p1, p2) and not _clip_line(w, h, p1, p2):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = max(dx, dy), min(dx, dy)
    j = np.arange(major + 1, dtype=np.int64)
    m = (2 * j * minor + major - 1) // (2 * major) if major else j
    if dy > dx:  # the major axis is y
        return p1[1] + sy * j, p1[0] + m
    return p1[1] + sy * m, p1[0] + j


def polygons_to_mask(polygons: Sequence, h: int, w: int) -> np.ndarray:
    """Rasterize polygon rings (flat [x0, y0, x1, y1, ...]; rings of fewer
    than 3 points are skipped) to one (H, W) uint8 mask, bit-equal to
    ``cv2.fillPoly(mask, rounded rings, 1)``."""
    mask = np.zeros((h, w), np.uint8)
    rings = [np.round(np.asarray(p, np.float64)).astype(np.int64).reshape(-1, 2)
             for p in polygons if len(p) >= 6]
    edges = []  # (y0, y1, x at y0 in 16.16, dx in 16.16)
    for ring in rings:
        for i in range(len(ring)):
            (x0, y0), (x1, y1) = (int(v) for v in ring[i - 1]), (int(v) for v in ring[i])
            rows, cols = _line_pixels(w, h, (x0, y0), (x1, y1))
            mask[rows, cols] = 1
            f0, f1 = [x0 << _XY_SHIFT, y0], [x1 << _XY_SHIFT, y1]
            if _outside(w, h, (x0, y0), (x1, y1)):
                # The edge runs between the clipped ends' columns; their rows
                # only where the clipped segment is not a single row.
                t0, t1 = [x0, y0], [x1, y1]
                _clip_line(w, h, t0, t1)
                f0[0], f1[0] = t0[0] << _XY_SHIFT, t1[0] << _XY_SHIFT
                if t0[1] != t1[1]:
                    f0[1], f1[1] = t0[1], t1[1]
            if y0 == y1:
                continue
            num, den = f1[0] - f0[0], f1[1] - f0[1]
            dx = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)  # C division
            if y0 < y1:
                edges.append((y0, y1, f0[0] + (y0 - f0[1]) * dx, dx))
            else:
                edges.append((y1, y0, f1[0] + (y1 - f1[1]) * dx, dx))
    if len(edges) < 2:
        return mask
    e = np.asarray(edges, np.int64)
    lo, hi = np.maximum(e[:, 0], 0), np.minimum(e[:, 1], h)
    n = np.maximum(hi - lo, 0)
    which = np.repeat(np.arange(len(e)), n)
    rows = np.repeat(lo, n) + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    xs = e[which, 2] + (rows - e[which, 0]) * e[which, 3]
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    # Crossings pair up left to right within each row (even-odd).
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    rank = np.arange(len(rows)) - np.repeat(starts, np.diff(np.r_[starts, len(rows)]))
    left = np.flatnonzero((rank % 2 == 0)[:-1] & (rows[1:] == rows[:-1]))
    y, x1, x2 = rows[left], (xs[left] + _XY_ONE - 1) >> _XY_SHIFT, xs[left + 1] >> _XY_SHIFT
    draw = (x1 < w) & (x2 >= 0)
    y, x1, x2 = y[draw], np.maximum(x1[draw], 0), np.minimum(x2[draw], w - 1)
    diff = np.zeros((h, w + 1), np.int32)
    np.add.at(diff, (y, x1), 1)
    np.add.at(diff, (y, x2 + 1), -1)
    mask[np.cumsum(diff[:, :w], axis=1) > 0] = 1
    return mask


def ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    """One COCO annotation's segmentation -> (H, W) uint8."""
    seg = ann.get("segmentation")
    if seg is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(seg, dict):
        return rle_to_mask(seg)
    return polygons_to_mask(seg, h, w)


def pad_instance_masks(masks: np.ndarray, max_targets: int, stride: int = 4) -> np.ndarray:
    """(n, H, W) uint8 instance masks -> (max_targets, ceil(H / stride),
    ceil(W / stride)) uint8: the first ``max_targets`` masks subsampled at
    every ``stride``-th pixel (the mask head's output lattice), the other
    slots zero."""
    masks = np.asarray(masks)
    if masks.ndim != 3:
        raise ValueError(f"pad_instance_masks needs (n, H, W) masks, got {masks.shape}")
    n, h, w = masks.shape
    out = np.zeros((max_targets, -(-h // stride), -(-w // stride)), np.uint8)
    k = min(n, max_targets)
    if k:
        ds = masks[:k, ::stride, ::stride]
        out[:k, :ds.shape[1], :ds.shape[2]] = ds
    return out
