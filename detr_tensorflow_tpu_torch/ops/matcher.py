"""Hungarian matching for DETR set prediction, on the device (port of
``detr_tensorflow_tpu/ops/matcher.py``).

The cost of every (query, target) pair follows the reference matcher:
5 * L1 over xcycwh - softmax probability of the target class - 2 * GIoU
over clipped xyxy boxes, with padded target slots at zero cost. All
decoder layers and images are solved in one batched LAP call: on a CUDA
tensor that is one launch of the LAP kernel (``ops/lap.py``), with no
host round trip and no host sync; a CPU tensor takes its plain version.

``lap_impl`` is ``"auto" | "kernel" | "plain"``: "auto" and "kernel" call
``lap.solve_lap_masked`` (the kernel for a CUDA tensor, the plain version
for a CPU tensor), "plain" always the plain version.

``solve_lap_masked``, ``solve_lap`` and ``hungarian_match`` are the JAX
package's one-problem forms: each is one batch-of-one call into the batch
forms, so on the card it launches the LAP kernel once.
"""

from __future__ import annotations

import torch

from . import boxes, lap

LAP_IMPLS = ("auto", "kernel", "plain")


def cost_matrix(p_bbox, p_logits, t_bbox, t_class, t_mask, cost_class: float = 1.0,
                cost_bbox: float = 5.0, cost_giou: float = 2.0) -> torch.Tensor:
    """DETR matching cost (..., Q, T), padded target columns zeroed.

    p_bbox (..., Q, 4) xcycwh, p_logits (..., Q, C), t_bbox (..., T, 4)
    xcycwh, t_class (..., T) int, t_mask (..., T) bool (True = real).
    """
    prob = torch.softmax(p_logits.float(), dim=-1)
    idx = t_class.long()[..., None, :].expand(prob.shape[:-1] + t_class.shape[-1:])
    c_class = -torch.gather(prob, -1, idx)  # (..., Q, T)
    l1 = (p_bbox[..., :, None, :] - t_bbox[..., None, :, :]).abs().sum(dim=-1)
    c_giou = -boxes.giou(boxes.xcycwh_to_xyxy(p_bbox, clip=True),
                         boxes.xcycwh_to_xyxy(t_bbox, clip=True))
    cost = cost_bbox * l1 + cost_class * c_class + cost_giou * c_giou
    # Padded target columns cost nothing, so they never move the optimum;
    # degenerate padded boxes must not leave NaN or inf behind.
    cost = torch.where(t_mask[..., None, :], cost, 0.0)
    return torch.where(torch.isfinite(cost), cost, 0.0)


def solve_lap_masked_batch(cost: torch.Tensor, row_mask: torch.Tensor,
                           impl: str = "auto") -> torch.Tensor:
    """Partial LAP over arbitrary leading dims: (..., R, C) costs and
    (..., R) bool prefix-form row masks -> (..., R) int32 column per row,
    -1 for masked rows. One solver call for all problems."""
    if impl not in LAP_IMPLS:
        raise ValueError(f"unknown LAP impl {impl!r}")
    lead, (r, c) = cost.shape[:-2], cost.shape[-2:]
    flat_cost = cost.reshape(-1, r, c)
    flat_mask = row_mask.reshape(-1, r)
    solve = lap.reference_solve_lap_masked if impl == "plain" else lap.solve_lap_masked
    return solve(flat_cost, flat_mask).reshape(lead + (r,))


def solve_lap_masked(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """One partial LAP: (R, C) costs, R <= C, and an (R,) bool prefix-form
    row mask -> (R,) int32 column per real row, -1 for masked rows."""
    return solve_lap_masked_batch(cost[None], row_mask[None])[0]


def solve_lap(cost: torch.Tensor) -> torch.Tensor:
    """One square LAP: the column assigned to every row of (N, N) costs."""
    n = cost.shape[0]
    if cost.shape != (n, n):
        raise ValueError(f"solve_lap needs a square cost matrix, got {tuple(cost.shape)}")
    return solve_lap_masked(cost, torch.ones(n, dtype=torch.bool, device=cost.device))


def hungarian_match(p_bbox, p_logits, t_bbox, t_class, t_mask):
    """``hungarian_match_batch`` of one image: (Q, 4), (Q, C), (T, 4), (T,)
    and (T,) in; target_of_pred (Q,), pred_of_target (T,) and pred_matched
    (Q,) out."""
    match = hungarian_match_batch(p_bbox[None], p_logits[None], t_bbox[None], t_class[None],
                                  t_mask[None])
    return {k: v[0] for k, v in match.items()}


def hungarian_match_batch(p_bbox, p_logits, t_bbox, t_class, t_mask, impl: str = "auto"):
    """Match Q predictions to the (masked) targets over arbitrary leading
    dims, with one batched LAP solve (targets as rows: only real targets
    are augmented). No gradient flows through the matching.

    Returns a dict of int32/bool tensors:
      target_of_pred (..., Q): target slot matched to each query, or -1;
      pred_of_target (..., T): query matched to each target slot, or -1;
      pred_matched (..., Q): the query is matched to a real target.
    """
    q, t = p_bbox.shape[-2], t_bbox.shape[-2]
    if t > q:
        raise ValueError(f"more target slots than queries: {t} > {q}")
    with torch.no_grad():
        cost = cost_matrix(p_bbox.detach(), p_logits.detach(), t_bbox, t_class, t_mask)
        pred_of_target = solve_lap_masked_batch(cost.transpose(-1, -2), t_mask, impl=impl)
        # Invert: unmatched target slots scatter into a spare column q.
        scatter_idx = torch.where(pred_of_target >= 0, pred_of_target, q).long()
        slots = torch.arange(t, dtype=torch.int32, device=p_bbox.device)
        target_of_pred = torch.full(pred_of_target.shape[:-1] + (q + 1,), -1,
                                    dtype=torch.int32, device=p_bbox.device)
        target_of_pred.scatter_(-1, scatter_idx, slots.expand_as(pred_of_target).contiguous())
        target_of_pred = target_of_pred[..., :q]
    return {
        "target_of_pred": target_of_pred,
        "pred_of_target": pred_of_target,
        "pred_matched": target_of_pred >= 0,
    }
