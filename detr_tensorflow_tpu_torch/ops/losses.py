"""DETR set loss (port of ``detr_tensorflow_tpu/ops/losses.py``, box and
class terms).

  * weighted softmax CE over all queries, weight 0.1 for unmatched
    ("no object") queries and 1.0 for matched ones, normalised by the sum
    of weights;
  * L1 on xcycwh and GIoU on clipped xyxy over matched pairs, normalised
    by the batch-global number of matched pairs;
  * total = 1 * CE + 2 * GIoU + 5 * L1 over the final decoder layer and
    every auxiliary one, each with its own matching (all solved in one
    batched LAP call);
  * metrics true_neg / true_pos / pos_accuracy.

Everything is gathers and selects on fixed shapes: no boolean indexing
and no ``.item()``, so matching and loss never wait on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import boxes
from .matcher import hungarian_match_batch

LOSS_WEIGHTS = {"label_cost": 1.0, "giou_loss": 2.0, "l1_loss": 5.0}
_LOG_KEYS = ("label_cost", "giou_loss", "l1_loss", "true_neg", "true_pos", "pos_accuracy")


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sparse softmax cross-entropy, elementwise over leading dims."""
    logits = logits.float()
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def global_loss_normalizers(t_mask: torch.Tensor, num_queries: int,
                            eos_weight: float = 0.1) -> Dict[str, torch.Tensor]:
    """Batch-global normalizers from the targets alone (every real target is
    matched, so the matched count is known before matching)."""
    n = t_mask.sum()
    bq = t_mask.shape[0] * num_queries
    return {"n_matched": n, "n_unmatched": bq - n, "sum_weights": n + eos_weight * (bq - n)}


def single_layer_loss(p_logits, p_boxes, t_bbox, t_class, t_mask, background_class: int,
                      eos_weight: float = 0.1, match: Optional[Dict[str, torch.Tensor]] = None,
                      lap_impl: str = "auto",
                      norm: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Set loss of one decoder layer over a batch.

    p_logits (B, Q, C), p_boxes (B, Q, 4) xcycwh; t_bbox (B, T, 4),
    t_class (B, T), t_mask (B, T) bool. ``match`` is a precomputed
    ``hungarian_match_batch`` result for this layer; without it the layer
    is matched here. ``norm`` replaces the batch-local normalizers
    (``global_loss_normalizers``). Returns a dict of 0-dim tensors.
    """
    if match is None:
        match = hungarian_match_batch(p_boxes, p_logits, t_bbox, t_class, t_mask, impl=lap_impl)
    t_of_p = match["target_of_pred"]  # (B, Q)
    matched = match["pred_matched"]

    safe_idx = t_of_p.long().clamp(0, t_bbox.shape[1] - 1)
    gathered_class = torch.gather(t_class.long(), 1, safe_idx)
    gathered_bbox = torch.gather(t_bbox, 1, safe_idx[..., None].expand(-1, -1, 4))

    targets = torch.where(matched, gathered_class, background_class)
    ce = _softmax_ce(p_logits, targets)
    weights = torch.where(matched, 1.0, eos_weight)
    norm = norm or {}
    sum_weights = norm.get("sum_weights")
    if sum_weights is None:
        sum_weights = weights.sum()
    label_cost = (ce * weights).sum() / sum_weights

    pred_cls = p_logits.argmax(dim=-1)
    n_matched = norm.get("n_matched")
    if n_matched is None:
        n_matched = matched.sum()
    n_matched = n_matched.clamp(min=1)
    n_unmatched = norm.get("n_unmatched")
    if n_unmatched is None:
        n_unmatched = (~matched).sum()
    n_unmatched = n_unmatched.clamp(min=1)
    true_neg = ((pred_cls == background_class) & ~matched).sum() / n_unmatched
    true_pos = ((pred_cls != background_class) & matched).sum() / n_matched
    pos_accuracy = ((pred_cls == targets) & matched).sum() / n_matched

    l1_per = (p_boxes - gathered_bbox).abs().sum(dim=-1)
    l1_loss = torch.where(matched, l1_per, 0.0).sum() / n_matched
    giou_per = boxes.elementwise_giou(boxes.xcycwh_to_xyxy(p_boxes, clip=True),
                                      boxes.xcycwh_to_xyxy(gathered_bbox, clip=True))
    giou_loss = torch.where(matched, 1.0 - giou_per, 0.0).sum() / n_matched

    return {"label_cost": label_cost, "giou_loss": giou_loss, "l1_loss": l1_loss,
            "true_neg": true_neg, "true_pos": true_pos, "pos_accuracy": pos_accuracy}


def total_from_log(log: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Weighted sum over every entry whose name contains a loss key, aux
    suffixes included."""
    total = 0.0
    for key, value in log.items():
        for loss_name, weight in LOSS_WEIGHTS.items():
            if loss_name in key:
                total = total + weight * value
    return total


def match_all_layers(outputs, t_bbox, t_class, t_mask, lap_impl: str = "auto"):
    """One matching for the final and every auxiliary decoder layer: a
    dict of (A + 1, B, ...) tensors, layer 0 the final one."""
    all_logits = torch.cat([outputs["pred_logits"][None], outputs["aux_logits"]], dim=0)
    all_boxes = torch.cat([outputs["pred_boxes"][None], outputs["aux_boxes"]], dim=0)
    n = all_logits.shape[0]

    def bcast(x):
        return x[None].expand((n,) + x.shape)

    return hungarian_match_batch(all_boxes, all_logits, bcast(t_bbox), bcast(t_class),
                                 bcast(t_mask), impl=lap_impl)


def detr_loss(outputs, t_bbox, t_class, t_mask, background_class: int,
              lap_impl: str = "auto", norm: Optional[Dict[str, torch.Tensor]] = None,
              match: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full DETR loss: final layer + auxiliary decoder layers.

    ``outputs`` holds 'pred_logits' (B, Q, C), 'pred_boxes' (B, Q, 4) and
    optionally 'aux_logits' (A, B, Q, C), 'aux_boxes' (A, B, Q, 4). All
    layers are matched in one LAP call, unless ``match`` (a
    ``match_all_layers`` result) is given. Returns (total, log) with the
    reference's key names: plain for the final layer, ``_i`` per aux layer.
    """
    has_aux = outputs.get("aux_logits") is not None and outputs["aux_logits"].shape[0] > 0
    if has_aux and match is None:
        match = match_all_layers(outputs, t_bbox, t_class, t_mask, lap_impl)
    layer = (lambda a: {k: m[a] for k, m in match.items()}) if match is not None else None

    log = single_layer_loss(outputs["pred_logits"], outputs["pred_boxes"], t_bbox, t_class,
                            t_mask, background_class, match=layer(0) if layer else None,
                            lap_impl=lap_impl, norm=norm)
    if has_aux:
        for a in range(outputs["aux_logits"].shape[0]):
            aux = single_layer_loss(outputs["aux_logits"][a], outputs["aux_boxes"][a], t_bbox,
                                    t_class, t_mask, background_class, match=layer(a + 1),
                                    norm=norm)
            for key in _LOG_KEYS:
                log[f"{key}_{a}"] = aux[key]
    return total_from_log(log), log
