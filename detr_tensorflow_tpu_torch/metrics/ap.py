"""COCO-style mean average precision (copy of ``detr_tensorflow_tpu/metrics/ap.py``).

Implements the same greedy AP protocol as the reference's Yolact-derived
evaluator (detr_tf/loss/compute_map.py): per class and per IoU threshold
(.50:.05:.95), predictions sorted by score greedily claim the unused
ground-truth box of highest IoU above the threshold
(compute_map.py:225-272); AP is the 101-point-interpolated integral of
the smoothed precision-recall curve (compute_map.py:35-83); per-threshold
mAPs average over classes that appear, and 'all' averages the thresholds
(compute_map.py:141-168). Box and mask tables are both maintained; the
reference always feeds zero masks (eval.py:54) so its mask row is 0 —
here mask IoU is actually computed when masks are supplied.

Host-side numpy on purpose: this is bookkeeping over tiny arrays between
device steps, not device math; the IoU matrices are vectorized.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_IOU_THRESHOLDS = tuple(x / 100.0 for x in range(50, 100, 5))


def box_iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU for corner-format boxes (any consistent axis order)."""
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)))
    b1 = boxes1[:, None, :]
    b2 = boxes2[None, :, :]
    lo = np.maximum(b1[..., :2], b2[..., :2])
    hi = np.minimum(b1[..., 2:], b2[..., 2:])
    wh = np.clip(hi - lo, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    a2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    union = a1[:, None] + a2[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def mask_iou_matrix(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """Pairwise IoU for (H, W, N) binary masks (compute_map.py:85-105)."""
    if masks1.shape[-1] == 0 or masks2.shape[-1] == 0:
        return np.zeros((masks1.shape[-1], masks2.shape[-1]))
    m1 = (masks1 > 0.5).reshape(-1, masks1.shape[-1]).astype(np.float32)
    m2 = (masks2 > 0.5).reshape(-1, masks2.shape[-1]).astype(np.float32)
    inter = m1.T @ m2
    union = m1.sum(0)[:, None] + m2.sum(0)[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


class APAccumulator:
    """Scores + true/false flags for one (class, IoU threshold) cell."""

    def __init__(self):
        self.scores: List[float] = []
        self.trues: List[bool] = []
        self.num_gt_positives = 0

    def push(self, score: float, is_true: bool) -> None:
        self.scores.append(float(score))
        self.trues.append(bool(is_true))

    def add_gt_positives(self, n: int) -> None:
        self.num_gt_positives += int(n)

    def is_empty(self) -> bool:
        return not self.scores and self.num_gt_positives == 0

    def average_precision(self) -> float:
        """101-point interpolated AP (compute_map.py:35-83 protocol)."""
        if self.num_gt_positives == 0 or not self.scores:
            return 0.0
        order = np.argsort(-np.asarray(self.scores))
        trues = np.asarray(self.trues)[order]
        tp = np.cumsum(trues)
        fp = np.cumsum(~trues)
        precisions = tp / np.maximum(tp + fp, 1)
        recalls = tp / self.num_gt_positives
        # Monotone smoothing: precision[i] = max(precision[i:]).
        precisions = np.maximum.accumulate(precisions[::-1])[::-1]
        # Nearest-from-the-left precision sample at 101 recall points.
        x = np.arange(101) / 100.0
        idx = np.searchsorted(recalls, x, side="left")
        y = np.where(idx < len(precisions), precisions[np.minimum(idx, len(precisions) - 1)], 0.0)
        return float(y.mean())


class MeanAPEvaluator:
    """Accumulates detections over a dataset and reports the mAP table."""

    def __init__(
        self,
        num_classes: int,
        iou_thresholds: Sequence[float] = DEFAULT_IOU_THRESHOLDS,
        class_names: Optional[Sequence[str]] = None,
    ):
        self.iou_thresholds = list(iou_thresholds)
        self.num_classes = num_classes
        self.class_names = class_names
        self.data = {
            kind: [
                [APAccumulator() for _ in range(num_classes)]
                for _ in self.iou_thresholds
            ]
            for kind in ("box", "mask")
        }

    # -- accumulation ------------------------------------------------------

    def add_image(
        self,
        p_boxes: np.ndarray,
        p_labels: np.ndarray,
        p_scores: np.ndarray,
        t_boxes: np.ndarray,
        t_labels: np.ndarray,
        p_masks: Optional[np.ndarray] = None,
        t_masks: Optional[np.ndarray] = None,
    ) -> None:
        """Add one image's detections and ground truth.

        Boxes are corner format (xyxy or yxyx, consistently); labels int;
        masks optional (H, W, N).
        """
        p_boxes = np.asarray(p_boxes).reshape(-1, 4)
        t_boxes = np.asarray(t_boxes).reshape(-1, 4)
        p_labels = np.asarray(p_labels).astype(int).reshape(-1)
        t_labels = np.asarray(t_labels).astype(int).reshape(-1)
        p_scores = np.asarray(p_scores).astype(float).reshape(-1)

        box_iou = box_iou_matrix(p_boxes, t_boxes)
        have_masks = p_masks is not None and t_masks is not None
        mask_iou = (
            mask_iou_matrix(p_masks, t_masks)
            if have_masks
            else np.zeros_like(box_iou)
        )
        order = np.argsort(-p_scores)

        # Predicted labels outside the evaluator's class range can never
        # match ground truth (e.g. a 92-class COCO model evaluated on a
        # smaller dataset); skip them instead of indexing out of range.
        classes = {
            c for c in set(p_labels.tolist()) | set(t_labels.tolist())
            if 0 <= c < self.num_classes
        }
        for _class in classes:
            n_gt_class = int((t_labels == _class).sum())
            gt_candidates = np.where(t_labels == _class)[0]
            pred_candidates = [i for i in order if p_labels[i] == _class]
            for iou_idx, thr in enumerate(self.iou_thresholds):
                for kind, iou in (("box", box_iou), ("mask", mask_iou)):
                    # without masks, mask IoUs are all zero -> every mask
                    # detection is a false positive and mask AP is 0,
                    # matching the reference's zero-mask placeholders.
                    acc = self.data[kind][iou_idx][_class]
                    acc.add_gt_positives(n_gt_class)
                    used = set()
                    for i in pred_candidates:
                        best, best_j = thr, -1
                        for j in gt_candidates:
                            if j in used:
                                continue
                            if iou[i, j] > best:
                                best, best_j = iou[i, j], j
                        if best_j >= 0:
                            used.add(best_j)
                            acc.push(p_scores[i], True)
                        else:
                            acc.push(p_scores[i], False)

    def add_batch(self, p, t) -> None:
        """Add a batch of postprocessed outputs (lists of per-image arrays)."""
        for (pb, pl, ps), (tb, tl) in zip(p, t):
            self.add_image(pb, pl, ps, tb, tl)

    # -- reporting ---------------------------------------------------------

    def compute(self) -> Dict[str, "OrderedDict"]:
        """mAP table keyed like the reference ``calc_map``
        (compute_map.py:141-168): {'box'|'mask': {'all': m, 50: m, ...}}."""
        per_thr = [{"box": [], "mask": []} for _ in self.iou_thresholds]
        for kind in ("box", "mask"):
            for iou_idx in range(len(self.iou_thresholds)):
                for c in range(self.num_classes):
                    acc = self.data[kind][iou_idx][c]
                    if not acc.is_empty():
                        per_thr[iou_idx][kind].append(acc.average_precision())

        table: Dict[str, OrderedDict] = {"box": OrderedDict(), "mask": OrderedDict()}
        for kind in ("box", "mask"):
            table[kind]["all"] = 0.0
            for i, thr in enumerate(self.iou_thresholds):
                vals = per_thr[i][kind]
                table[kind][int(thr * 100)] = (
                    100.0 * sum(vals) / len(vals) if vals else 0.0
                )
            table[kind]["all"] = sum(
                v for k, v in table[kind].items() if k != "all"
            ) / (len(table[kind]) - 1)
        return table

    def print_table(self) -> Dict[str, "OrderedDict"]:
        """ASCII table in the reference's format (compute_map.py:170-181)."""
        table = self.compute()
        cols = list(table["box"].keys())
        header = " " * 7 + "|" + "".join(
            f" {('.%d' % c if isinstance(c, int) else c):>5} |" for c in cols
        )
        sep = "-------+" * (len(cols) + 1)
        print()
        print(header)
        print(sep)
        for kind in ("box", "mask"):
            row = f" {kind:>5} |" + "".join(
                f" {table[kind][c]:5.2f} |" for c in cols
            )
            print(row)
        print(sep)
        print()
        return table
