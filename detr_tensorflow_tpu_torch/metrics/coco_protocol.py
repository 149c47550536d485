"""COCOeval-protocol average precision, the pycocotools protocol (copy of
``detr_tensorflow_tpu/metrics/coco_protocol.py``).

The reference evaluates with a Yolact-derived greedy AP
(detr_tf/loss/compute_map.py, reimplemented in metrics/ap.py), but its
north-star number — box AP 36.53 (the reference's README.md:85-89) — is
quoted against the *pycocotools* AP table convention every detection
paper uses. The two protocols differ in small but measurable ways:

* **category averaging**: COCOeval averages over categories that have
  ground truth anywhere in the dataset (a category with GT but zero
  detections contributes AP 0); the Yolact protocol averages over
  categories that appear in GT *or* predictions of an image.
* **maxDets**: COCOeval scores at most 100 detections per image per
  category (sorted by score); the Yolact protocol has no cap.
* **crowd regions**: COCOeval treats ``iscrowd`` ground truth as ignore
  regions — a crowd box can absorb any number of detections, and
  detections matched to it are dropped from both TP and FP; the Yolact
  protocol has no ignore concept (the reference filters crowd images
  out of eval entirely, detr_tf/data/coco.py:118).
* **matching order**: both match detections in score order to the
  not-yet-claimed ground truth of highest IoU >= threshold; COCOeval
  additionally prefers non-ignored GT and lets a matched crowd GT be
  re-used.

This module implements the COCOeval bbox protocol (areaRng "all",
maxDets 100, IoU .50:.05:.95, 101-point interpolation) in vectorized
numpy with no pycocotools dependency, so the framework can report the
convention the paper numbers use. tests/test_coco_protocol.py pins it
against hand-computed tables, quantifies the protocol delta vs
metrics/ap.py on synthetic datasets, and — when pycocotools is
importable — asserts exact agreement with ``COCOeval`` itself.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np

from .ap import DEFAULT_IOU_THRESHOLDS, box_iou_matrix

RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _crowd_iou_matrix(p_boxes: np.ndarray, t_boxes: np.ndarray,
                      iscrowd: np.ndarray) -> np.ndarray:
    """IoU where crowd ground truth uses intersection-over-DETECTION
    area (pycocotools ``iou(dt, gt) = inter / area(dt)`` when
    ``iscrowd``): a detection fully inside a crowd region scores 1
    regardless of the region's size."""
    iou = box_iou_matrix(p_boxes, t_boxes)
    if not iscrowd.any() or len(p_boxes) == 0:
        return iou
    b1 = p_boxes[:, None, :]
    b2 = t_boxes[None, :, :]
    lo = np.maximum(b1[..., :2], b2[..., :2])
    hi = np.minimum(b1[..., 2:], b2[..., 2:])
    wh = np.clip(hi - lo, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    det_area = (
        (p_boxes[:, 2] - p_boxes[:, 0]) * (p_boxes[:, 3] - p_boxes[:, 1])
    )
    iod = np.where(det_area[:, None] > 0, inter / np.maximum(
        det_area[:, None], 1e-12), 0.0)
    return np.where(iscrowd[None, :], iod, iou)


class COCOProtocolEvaluator:
    """Box AP under the pycocotools COCOeval protocol.

    Accumulate with :meth:`add_image` (corner-format boxes, any
    consistent axis order), then :meth:`compute` returns the same table
    layout as :class:`metrics.ap.MeanAPEvaluator` (``{"box": {"all": m,
    50: m, 55: m, ...}}``, percentages) so callers can switch protocol
    with one flag.
    """

    def __init__(
        self,
        num_classes: int,
        iou_thresholds: Sequence[float] = DEFAULT_IOU_THRESHOLDS,
        max_dets: int = 100,
    ):
        self.num_classes = int(num_classes)
        self.iou_thresholds = np.asarray(list(iou_thresholds), np.float64)
        self.max_dets = int(max_dets)
        T = len(self.iou_thresholds)
        # Per category: detection scores + per-threshold matched/ignored
        # flags (grown per image), and the non-ignored GT count.
        self._scores = [[] for _ in range(self.num_classes)]
        self._matched = [[] for _ in range(self.num_classes)]  # (T, n) bools
        self._ignored = [[] for _ in range(self.num_classes)]  # (T, n) bools
        self._n_gt = np.zeros(self.num_classes, np.int64)
        self._cat_has_gt = np.zeros(self.num_classes, bool)
        self._T = T

    # -- accumulation ------------------------------------------------------

    def add_image(
        self,
        p_boxes: np.ndarray,
        p_labels: np.ndarray,
        p_scores: np.ndarray,
        t_boxes: np.ndarray,
        t_labels: np.ndarray,
        t_crowd: Optional[np.ndarray] = None,
    ) -> None:
        p_boxes = np.asarray(p_boxes, np.float64).reshape(-1, 4)
        t_boxes = np.asarray(t_boxes, np.float64).reshape(-1, 4)
        p_labels = np.asarray(p_labels).astype(int).reshape(-1)
        t_labels = np.asarray(t_labels).astype(int).reshape(-1)
        p_scores = np.asarray(p_scores, np.float64).reshape(-1)
        if t_crowd is None:
            t_crowd = np.zeros(len(t_boxes), bool)
        t_crowd = np.asarray(t_crowd).astype(bool).reshape(-1)

        cats = {
            c for c in set(p_labels.tolist()) | set(t_labels.tolist())
            if 0 <= c < self.num_classes
        }
        for c in cats:
            det_idx = np.where(p_labels == c)[0]
            gt_idx = np.where(t_labels == c)[0]
            if len(gt_idx):
                self._cat_has_gt[c] = True
            # Score-sorted, capped at maxDets (COCOeval evaluateImg
            # truncates per image per category). Stable sort like
            # pycocotools' kind='mergesort'.
            det_idx = det_idx[np.argsort(-p_scores[det_idx],
                                         kind="stable")][: self.max_dets]
            # Non-ignored (non-crowd) GT first, like COCOeval's gtind
            # sort over the ignore flag.
            gt_idx = gt_idx[np.argsort(t_crowd[gt_idx], kind="stable")]
            crowd = t_crowd[gt_idx]
            self._n_gt[c] += int((~crowd).sum())

            iou = _crowd_iou_matrix(
                p_boxes[det_idx], t_boxes[gt_idx], crowd)
            D, G = len(det_idx), len(gt_idx)
            matched = np.zeros((self._T, D), bool)
            ignored = np.zeros((self._T, D), bool)
            for ti, thr in enumerate(self.iou_thresholds):
                gt_claimed = np.full(G, -1, np.int64)
                for di in range(D):
                    best_iou = min(thr, 1 - 1e-10)
                    best_g = -1
                    for gi in range(G):
                        # A non-crowd GT can be claimed once; crowd GT
                        # absorbs any number of detections.
                        if gt_claimed[gi] >= 0 and not crowd[gi]:
                            continue
                        # GTs are sorted non-ignored first: once we hold
                        # a real match and reach the ignore block, stop
                        # (COCOeval's break) — a real match beats any
                        # higher-IoU ignore match.
                        if crowd[gi] and best_g >= 0 and not crowd[best_g]:
                            break
                        if iou[di, gi] < best_iou:
                            continue
                        best_iou = iou[di, gi]
                        best_g = gi
                    if best_g >= 0:
                        gt_claimed[best_g] = di
                        if crowd[best_g]:
                            ignored[ti, di] = True
                        else:
                            matched[ti, di] = True
            self._scores[c].append(p_scores[det_idx])
            self._matched[c].append(matched)
            self._ignored[c].append(ignored)

    def add_batch(self, p, t) -> None:
        for (pb, pl, ps), (tb, tl) in zip(p, t):
            self.add_image(pb, pl, ps, tb, tl)

    # -- reporting ---------------------------------------------------------

    def _ap_per_cat(self) -> np.ndarray:
        """(T, K) AP array; -1 where the category has no ground truth
        (excluded from the mean, exactly COCOeval's convention)."""
        T, K = self._T, self.num_classes
        ap = np.full((T, K), -1.0)
        for c in range(K):
            if not self._cat_has_gt[c]:
                continue
            n_gt = self._n_gt[c]
            if self._scores[c]:
                scores = np.concatenate(self._scores[c])
                matched = np.concatenate(self._matched[c], axis=1)
                ignored = np.concatenate(self._ignored[c], axis=1)
            else:
                scores = np.zeros(0)
                matched = np.zeros((T, 0), bool)
                ignored = np.zeros((T, 0), bool)
            order = np.argsort(-scores, kind="stable")
            matched = matched[:, order]
            ignored = ignored[:, order]
            for ti in range(T):
                m = matched[ti][~ignored[ti]]
                tp = np.cumsum(m)
                fp = np.cumsum(~m)
                if n_gt == 0:
                    continue
                rc = tp / n_gt
                pr = tp / np.maximum(tp + fp, np.spacing(1))
                # Monotone envelope then 101-point sample, searchsorted
                # left — pycocotools accumulate().
                pr = np.maximum.accumulate(pr[::-1])[::-1]
                idx = np.searchsorted(rc, RECALL_POINTS, side="left")
                q = np.zeros(len(RECALL_POINTS))
                valid = idx < len(pr)
                q[valid] = pr[idx[valid]]
                ap[ti, c] = q.mean()
        return ap

    def compute(self) -> Dict[str, "OrderedDict"]:
        ap = self._ap_per_cat()
        table: Dict[str, OrderedDict] = {"box": OrderedDict()}
        per_thr = []
        for ti, thr in enumerate(self.iou_thresholds):
            vals = ap[ti][ap[ti] > -1]
            m = 100.0 * float(vals.mean()) if len(vals) else 0.0
            per_thr.append(m)
            table["box"][int(round(thr * 100))] = m
        # COCOeval's AP@[.5:.95] is the mean over the full (T, K) slab
        # of non-(-1) entries; with a constant category set per
        # threshold that equals the mean of per-threshold means.
        all_vals = ap[ap > -1]
        table["box"]["all"] = (
            100.0 * float(all_vals.mean()) if len(all_vals) else 0.0
        )
        table["box"].move_to_end("all", last=False)
        return table
