"""Panoptic quality (PQ = SQ x RQ), the Kirillov et al. protocol (port of
``detr_tensorflow_tpu/metrics/pq.py``, host numpy, copied and held equal by
the tests).

As panopticapi's evaluation: IoU > 0.5 matches are unique per segment, so
a greedy scan is exact; the prediction's overlap with VOID leaves the
union; crowd segments take no part in matching and act as class-specific
VOID for the false-positive test; an unmatched prediction with more than
half its area on ignored pixels is no false positive; ``stuff_classes``
adds the ``things`` and ``stuff`` sub-tables. Without VOID, crowd or stuff
inputs it is a things-only PQ over the given instance masks, an internal
metric; the panoptic loader (``data/panoptic.py``) gives the published
protocol's inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _segments_from_map(seg_map: np.ndarray, labels: np.ndarray):
    """(H, W) id-map (-1 = unassigned) + per-id class -> list of
    (class, bool-mask). Empty ids are skipped."""
    out = []
    for sid in np.unique(seg_map):
        if sid < 0:
            continue
        mask = seg_map == sid
        out.append((int(labels[sid]), mask))
    return out


def _summarize(per_class: Dict[int, Dict[str, float]]):
    n = len(per_class)
    agg = lambda k: (  # noqa: E731
        sum(v[k] for v in per_class.values()) / n if n else 0.0
    )
    return {"pq": agg("pq"), "sq": agg("sq"), "rq": agg("rq"), "n_classes": n}


def panoptic_quality(
    pred_seg_maps: Sequence[np.ndarray],   # per image: (H, W) int, -1=void
    pred_labels: Sequence[np.ndarray],     # per image: (Q,) class per id
    gt_masks: Sequence[np.ndarray],        # per image: (N, H, W) bool
    gt_classes: Sequence[np.ndarray],      # per image: (N,) int
    gt_iscrowd: Optional[Sequence[np.ndarray]] = None,  # per image: (N,) bool
    void_masks: Optional[Sequence[np.ndarray]] = None,  # per image: (H, W) bool
    stuff_classes: Optional[Sequence[int]] = None,
) -> Dict[str, object]:
    """Dataset PQ/SQ/RQ, class-averaged (and per class).

    Returns ``{"pq", "sq", "rq", "n_classes", "per_class":
    {cls: {"pq", "sq", "rq", "tp", "fp", "fn"}}}`` plus ``"things"`` /
    ``"stuff"`` sub-summaries when ``stuff_classes`` is given. Classes
    absent from both prediction and ground truth contribute nothing
    (standard protocol). Ground-truth segments with empty masks are
    ignored.
    """
    iou_sum: Dict[int, float] = {}
    tp: Dict[int, int] = {}
    fp: Dict[int, int] = {}
    fn: Dict[int, int] = {}

    def bump(d, c, v=1):
        d[c] = d.get(c, 0) + v

    n_img = len(pred_seg_maps)
    gt_iscrowd = gt_iscrowd if gt_iscrowd is not None else [None] * n_img
    void_masks = void_masks if void_masks is not None else [None] * n_img

    for seg_map, labels, gmasks, gclasses, icrowd, void in zip(
        pred_seg_maps, pred_labels, gt_masks, gt_classes, gt_iscrowd,
        void_masks,
    ):
        seg_map = np.asarray(seg_map)
        preds = _segments_from_map(seg_map, np.asarray(labels))
        icrowd = (
            np.asarray(icrowd).astype(bool)
            if icrowd is not None
            else np.zeros(len(gmasks), bool)
        )
        gts: List = []
        crowd_by_class: Dict[int, np.ndarray] = {}
        # Void region: unlabeled pixels plus every crowd segment
        # (panopticapi folds crowd into the void for the FP test).
        void_all = (
            np.asarray(void).astype(bool)
            if void is not None
            else np.zeros(seg_map.shape, bool)
        )
        for c, m, cr in zip(np.asarray(gclasses), np.asarray(gmasks), icrowd):
            m = np.asarray(m).astype(bool)
            if not m.any():
                continue
            if cr:
                c = int(c)
                crowd_by_class[c] = crowd_by_class.get(
                    c, np.zeros(seg_map.shape, bool)
                ) | m
                void_all = void_all | m
            else:
                gts.append((int(c), m))

        matched_pred = set()
        matched_gt = set()
        for gi, (gc, gm) in enumerate(gts):
            g_area = gm.sum()
            for pi, (pc, pm) in enumerate(preds):
                if pc != gc or pi in matched_pred:
                    continue
                inter = np.logical_and(gm, pm).sum()
                if inter == 0:
                    continue
                # panopticapi: the pred's void overlap doesn't count
                # against the union.
                p_void = np.logical_and(pm, void_all).sum()
                union = g_area + pm.sum() - inter - p_void
                iou = inter / union if union > 0 else 0.0
                if iou > 0.5:
                    # IoU > 0.5 matches are provably unique per segment.
                    matched_pred.add(pi)
                    matched_gt.add(gi)
                    bump(tp, gc)
                    bump(iou_sum, gc, float(iou))
                    break
        for gi, (gc, _) in enumerate(gts):
            if gi not in matched_gt:
                bump(fn, gc)
        for pi, (pc, pm) in enumerate(preds):
            if pi in matched_pred:
                continue
            # FP exclusion: majority overlap with void or same-class
            # crowd means the prediction sits on ignore territory.
            ignore = void_all
            if pc in crowd_by_class:
                ignore = ignore | crowd_by_class[pc]
            if np.logical_and(pm, ignore).sum() / pm.sum() > 0.5:
                continue
            bump(fp, pc)

    per_class = {}
    classes = sorted(set(tp) | set(fp) | set(fn))
    for c in classes:
        t, f_p, f_n = tp.get(c, 0), fp.get(c, 0), fn.get(c, 0)
        denom = t + 0.5 * f_p + 0.5 * f_n
        sq = iou_sum.get(c, 0.0) / t if t else 0.0
        rq = t / denom if denom else 0.0
        per_class[c] = {
            "pq": sq * rq, "sq": sq, "rq": rq, "tp": t, "fp": f_p, "fn": f_n,
        }
    out: Dict[str, object] = _summarize(per_class)
    out["per_class"] = per_class
    if stuff_classes is not None:
        stuff = set(int(c) for c in stuff_classes)
        out["stuff"] = _summarize(
            {c: v for c, v in per_class.items() if c in stuff}
        )
        out["things"] = _summarize(
            {c: v for c, v in per_class.items() if c not in stuff}
        )
    return out


def panoptic_quality_from_outputs(
    m_outputs,
    gt_masks: Sequence[np.ndarray],
    gt_classes: Sequence[np.ndarray],
    background_class: int,
    mask_threshold: float = 0.5,
    **kwargs,
) -> Dict[str, object]:
    """PQ straight from model outputs (torch tensors): the pixel-argmax
    merge ``inference.merge_instance_masks`` scored against ground truth at
    the model's mask resolution. Extra kwargs (gt_iscrowd / void_masks /
    stuff_classes) go to ``panoptic_quality``."""
    from ..inference import merge_instance_masks

    seg_map, _ = merge_instance_masks(m_outputs, background_class, mask_threshold)
    labels = m_outputs["pred_logits"].float().argmax(-1).cpu().numpy()  # (B, Q)
    seg_map = seg_map.cpu().numpy()
    return panoptic_quality(
        [seg_map[i] for i in range(seg_map.shape[0])],
        [labels[i] for i in range(labels.shape[0])],
        gt_masks,
        gt_classes,
        **kwargs,
    )
