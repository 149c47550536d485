"""The port's box ops, LAP solver, matcher and set loss
(detr_tensorflow_tpu_torch/ops/{boxes,lap,matcher,losses}.py) against the
JAX package's, on the same numpy inputs, and the LAP against scipy.

On the CPU the port's LAP runs its plain version; the CUDA kernel is held
against that plain version and against scipy on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from detr_tensorflow_tpu.data import processing as jax_processing
from detr_tensorflow_tpu.ops import boxes as jax_boxes
from detr_tensorflow_tpu.ops import losses as jax_losses
from detr_tensorflow_tpu.ops import matcher as jax_matcher
from detr_tensorflow_tpu.ops.pallas.lap import solve_lap_masked_pallas
from detr_tensorflow_tpu_torch.data import processing
from detr_tensorflow_tpu_torch.ops import boxes, lap, losses, matcher
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

# fp32, the same formulas in another framework: summation order only.
ATOL, RTOL = 1e-5, 1e-5


def _xyxy(rng, shape):
    lo = rng.uniform(0.0, 0.6, size=shape + (2,))
    return np.concatenate([lo, lo + rng.uniform(0.05, 0.4, size=shape + (2,))], -1).astype(np.float32)


def test_giou_and_gradients_match_jax():
    """Pairwise giou/jaccard/intersect and aligned elementwise_giou, values
    and gradients (of a weighted sum) against jax.grad."""
    rng = np.random.default_rng(0)
    a, b = _xyxy(rng, (2, 5)), _xyxy(rng, (2, 7))
    w = rng.normal(size=(2, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(boxes.intersect(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_boxes.intersect(a, b)), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(boxes.jaccard(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_boxes.jaccard(a, b)), atol=ATOL, rtol=RTOL)
    ma, mb = boxes.merge(torch.from_numpy(a), torch.from_numpy(b))
    ja, jb = jax_boxes.merge(a, b)
    np.testing.assert_array_equal(ma.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(mb.numpy(), np.asarray(jb))

    jgrad = jax.grad(lambda x, y: jnp.sum(jax_boxes.giou(x, y) * w), argnums=(0, 1))(a, b)
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    g = boxes.giou(ta, tb)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jax_boxes.giou(a, b)),
                               atol=ATOL, rtol=RTOL)
    (g * torch.from_numpy(w)).sum().backward()
    for ours, ref in zip((ta.grad, tb.grad), jgrad):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)

    c = _xyxy(rng, (2, 5))
    we = rng.normal(size=(2, 5)).astype(np.float32)
    jgrad = jax.grad(lambda x, y: jnp.sum(jax_boxes.elementwise_giou(x, y) * we),
                     argnums=(0, 1))(a, c)
    ta, tc = torch.from_numpy(a).requires_grad_(), torch.from_numpy(c).requires_grad_()
    e = boxes.elementwise_giou(ta, tc)
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(jax_boxes.elementwise_giou(a, c)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(e.detach().numpy(),
                               np.diagonal(np.asarray(jax_boxes.giou(a, c)), axis1=1, axis2=2),
                               atol=ATOL, rtol=RTOL)
    (e * torch.from_numpy(we)).sum().backward()
    for ours, ref in zip((ta.grad, tc.grad), jgrad):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _problems(seed, p, r, c, ties):
    rng = np.random.default_rng(seed)
    if ties:
        cost = rng.integers(0, 3, size=(p, r, c)).astype(np.float32)
    else:
        cost = rng.normal(size=(p, r, c)).astype(np.float32)
    n_real = rng.integers(0, r + 1, size=p)
    n_real[0], n_real[-1] = 0, r
    mask = np.arange(r)[None, :] < n_real[:, None]
    return cost, mask, n_real


def _total(cost, cols, n):
    return float(cost[np.arange(n), cols[:n]].sum())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,r,c", [(6, 12, 12), (8, 10, 25)])
def test_plain_lap_matches_jax_solvers_and_scipy(p, r, c, ties):
    """The plain LAP against matcher.solve_lap_masked_batch (xla), the
    Pallas kernel in interpret mode and scipy. Continuous costs have one
    optimum: assignments must be equal. Tied costs: equal optimal cost,
    a valid assignment, -1 exactly on masked rows."""
    cost, mask, n_real = _problems(p * r + c + ties, p, r, c, ties)
    ours = lap.solve_lap_masked(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
    assert ours.dtype == np.int32 and ours.shape == (p, r)
    xla = np.asarray(jax_matcher.solve_lap_masked_batch(jnp.asarray(cost), jnp.asarray(mask)))
    pallas = np.asarray(solve_lap_masked_pallas(jnp.asarray(cost), jnp.asarray(mask),
                                                interpret=True))
    for i, n in enumerate(n_real):
        assert (ours[i, n:] == -1).all()
        assert len(set(ours[i, :n].tolist())) == n and (ours[i, :n] >= 0).all()
        rows, cols = linear_sum_assignment(cost[i, :n])
        best = float(cost[i, rows, cols].sum())
        for other in (ours, xla, pallas):
            assert abs(_total(cost[i], other[i], n) - best) <= 1e-4
        if not ties:
            np.testing.assert_array_equal(ours[i, :n], cols)
            np.testing.assert_array_equal(ours[i], xla[i])
            np.testing.assert_array_equal(ours[i], pallas[i])


@pytest.mark.parametrize("case", ["rows_above_cols", "mask_dtype", "device"])
def test_lap_rejects_what_the_kernel_does_not_take(case):
    cost, mask = torch.zeros((2, 3, 4)), torch.ones((2, 3), dtype=torch.bool)
    if case == "rows_above_cols":
        cost, mask = torch.zeros((2, 5, 4)), torch.ones((2, 5), dtype=torch.bool)
    elif case == "mask_dtype":
        mask = mask.int()
    else:
        cost, mask = cost.to("meta"), mask.to("meta")
    with pytest.raises(ValueError):
        lap.solve_lap_masked(cost, mask)


def _predictions(rng, lead, q, ncls):
    logits = rng.normal(size=lead + (q, ncls)).astype(np.float32)
    xy = rng.uniform(0.2, 0.8, size=lead + (q, 2))
    wh = rng.uniform(0.05, 0.5, size=lead + (q, 2))
    return logits, np.concatenate([xy, wh], -1).astype(np.float32)


def _targets(rng, b, t, ncls, counts):
    tb = np.zeros((b, t, 4), np.float32)
    tc = np.zeros((b, t), np.int32)
    tm = np.zeros((b, t), bool)
    for i, n in enumerate(counts):
        boxes_i = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.5, (n, 2))], -1)
        tb[i], tc[i], tm[i] = processing.pad_targets(boxes_i, rng.integers(1, ncls, size=n), t)
    return tb, tc, tm


def test_pad_targets_matches_jax():
    rng = np.random.default_rng(1)
    bx, cl = rng.uniform(size=(7, 4)), rng.integers(0, 9, size=(7, 1))
    for max_t in (3, 7, 12):
        for ours, ref in zip(processing.pad_targets(bx, cl, max_t),
                             jax_processing.pad_targets(bx, cl, max_t)):
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)
    assert processing.MAX_TARGETS == jax_processing.MAX_TARGETS


def test_cost_matrix_and_hungarian_match_batch_match_jax():
    """Matching of 3 decoder layers x 4 images in one solve: the cost
    matrix to fp32 rounding, the assignments exactly."""
    rng = np.random.default_rng(2)
    logits, pboxes = _predictions(rng, (3, 4), 12, 6)
    tb, tc, tm = _targets(rng, 4, 12, 6, [0, 1, 5, 12])
    bc = lambda x: np.broadcast_to(x, (3,) + x.shape)  # noqa: E731
    ours_cost = matcher.cost_matrix(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        pboxes[0], logits[0], tb, tc, tm)))
    ref_cost = jax.vmap(jax_matcher.cost_matrix)(pboxes[0], logits[0], tb, tc, tm)
    np.testing.assert_allclose(ours_cost.numpy(), np.asarray(ref_cost), atol=ATOL, rtol=RTOL)

    ours = matcher.hungarian_match_batch(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        pboxes, logits, bc(tb), bc(tc), bc(tm))))
    ref = jax_matcher.hungarian_match_batch(pboxes, logits, bc(tb), bc(tc), bc(tm))
    for key in ("target_of_pred", "pred_of_target", "pred_matched"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))
    plain = matcher.hungarian_match_batch(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        pboxes, logits, bc(tb), bc(tc), bc(tm))), impl="plain")
    assert torch.equal(plain["target_of_pred"], ours["target_of_pred"])
    assert int(ours["pred_matched"].sum()) == 3 * tm.sum()


@pytest.mark.parametrize("use_norm", [False, True])
def test_detr_loss_and_gradients_match_jax(use_norm):
    """detr_loss over final + 2 aux layers: the total, every log key (with
    the _i suffixes) and the gradients w.r.t. logits and boxes."""
    rng = np.random.default_rng(3)
    logits, pboxes = _predictions(rng, (3, 3), 10, 7)
    tb, tc, tm = _targets(rng, 3, 10, 7, [2, 0, 6])
    bg = 0
    jnorm = jax_losses.global_loss_normalizers(jnp.asarray(tm), 10) if use_norm else None
    tnorm = losses.global_loss_normalizers(torch.from_numpy(tm), 10) if use_norm else None

    def jax_total(lg, bx):
        out = {"pred_logits": lg[-1], "pred_boxes": bx[-1], "aux_logits": lg[:-1],
               "aux_boxes": bx[:-1]}
        return jax_losses.detr_loss(out, tb, tc, tm, bg, norm=jnorm)

    (jtotal, jlog), jgrads = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        logits, pboxes)
    tl, tbx = torch.from_numpy(logits).requires_grad_(), torch.from_numpy(pboxes).requires_grad_()
    out = {"pred_logits": tl[-1], "pred_boxes": tbx[-1], "aux_logits": tl[:-1],
           "aux_boxes": tbx[:-1]}
    total, log = losses.detr_loss(out, *(torch.from_numpy(x) for x in (tb, tc, tm)), bg,
                                  norm=tnorm)
    assert set(log) == set(jlog)
    for key in jlog:
        np.testing.assert_allclose(float(log[key].detach()), float(jlog[key]), atol=ATOL, rtol=RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), atol=ATOL, rtol=RTOL)
    total.backward()
    for ours, ref in zip((tl.grad, tbx.grad), jgrads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_single_layer_loss_takes_a_precomputed_match():
    """``match=`` replaces the layer's own matching: the same match gives the
    same loss, another match another loss."""
    rng = np.random.default_rng(4)
    logits, pboxes = _predictions(rng, (2,), 8, 5)
    tb, tc, tm = (torch.from_numpy(x) for x in _targets(rng, 2, 8, 5, [3, 4]))
    lg, bx = torch.from_numpy(logits), torch.from_numpy(pboxes)
    own = losses.single_layer_loss(lg, bx, tb, tc, tm, 0)
    match = matcher.hungarian_match_batch(bx, lg, tb, tc, tm)
    given = losses.single_layer_loss(lg, bx, tb, tc, tm, 0, match=match)
    for key in own:
        assert torch.equal(own[key], given[key])
    shifted = {k: torch.roll(v, 1, dims=-1) for k, v in match.items()}
    other = losses.single_layer_loss(lg, bx, tb, tc, tm, 0, match=shifted)
    assert not torch.equal(other["l1_loss"], own["l1_loss"])


@pytest.mark.parametrize("ties", [False, True])
def test_plain_lap_matches_jax_at_300_columns(ties):
    """Past the 255 columns of the LAP kernel's register instances, where
    the card runs its generic instance: the plain LAP at 2 x 300 x 300
    (Deformable-DETR's 300 queries and target slots) with a few real rows
    scattered over the slots, against the JAX package's default solver
    (matcher.solve_lap_masked_batch) and scipy: assignments equal on
    continuous costs, the optimal cost (within 1e-4) on tied ones."""
    rng = np.random.default_rng(300 + ties)
    shape = (2, 300, 300)
    cost = (rng.integers(0, 4, size=shape) if ties else rng.normal(size=shape)).astype(np.float32)
    mask = np.zeros((2, 300), bool)
    for i, n in enumerate((7, 23)):
        mask[i, rng.permutation(300)[:n]] = True
    ours = lap.solve_lap_masked(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
    xla = np.asarray(jax_matcher.solve_lap_masked_batch(jnp.asarray(cost), jnp.asarray(mask)))
    for i, m in enumerate(mask):
        n = int(m.sum())
        assert (ours[i, ~m] == -1).all() and len(set(ours[i, m].tolist())) == n
        rows, cols = linear_sum_assignment(cost[i, m])
        best = float(cost[i, m][rows, cols].sum())
        for other in (ours, xla):
            assert abs(float(cost[i, m][np.arange(n), other[i, m]].sum()) - best) <= 1e-4
        if not ties:
            np.testing.assert_array_equal(ours[i, m], cols)
            np.testing.assert_array_equal(ours[i], xla[i])
