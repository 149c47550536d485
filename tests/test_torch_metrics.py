"""The port's AP evaluators (``detr_tensorflow_tpu_torch/metrics``) against
the JAX package's on the same seeded predictions, on the CPU: the
reference's greedy protocol (box and mask rows) and the COCOeval protocol
(crowd regions, the 100-detection cap, categories without detections).
Both are numpy; the tables must be identical."""

import numpy as np
import pytest

from detr_tensorflow_tpu.metrics import ap as jax_ap
from detr_tensorflow_tpu.metrics import coco_protocol as jax_cp
from detr_tensorflow_tpu_torch.metrics import ap, coco_protocol


def _images(seed, n_images=12, num_classes=6, crowd=False, many=False):
    """Seeded images: ground truth boxes, and predictions that are jittered
    copies of them (some mislabeled) plus false positives; ties in score
    on purpose (scores rounded to 0.05)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_images):
        g = int(rng.integers(0, 6))
        lo = rng.uniform(0, 60, (g, 2))
        t_boxes = np.concatenate([lo, lo + rng.uniform(5, 40, (g, 2))], -1)
        t_labels = rng.integers(0, num_classes, g)
        t_crowd = rng.random(g) < 0.2 if crowd else np.zeros(g, bool)
        p = [t_boxes + rng.normal(0, 3, t_boxes.shape)]
        n_fp = int(rng.integers(120, 160)) if many else int(rng.integers(0, 6))
        lo = rng.uniform(0, 60, (n_fp, 2))
        p.append(np.concatenate([lo, lo + rng.uniform(5, 40, (n_fp, 2))], -1))
        p_boxes = np.concatenate(p)
        p_labels = np.concatenate([np.where(rng.random(g) < 0.8, t_labels,
                                            rng.integers(0, num_classes, g)),
                                   rng.integers(0, num_classes + 1, n_fp)])
        p_scores = np.round(rng.uniform(0.05, 1.0, len(p_boxes)) * 20) / 20
        masks = None
        if not crowd:
            grid = np.zeros((32, 32), bool)
            t_masks = np.stack([np.roll(grid | (np.arange(32)[:, None] < 8 + k), k, 1)
                                for k in range(g)], -1) if g else np.zeros((32, 32, 0))
            p_masks = np.stack([np.roll(t_masks[..., i % g] if g else grid, int(s), 0)
                                for i, s in enumerate(rng.integers(0, 3, len(p_boxes)))]
                               + [grid], -1)[..., :len(p_boxes)]
            masks = (p_masks, t_masks)
        out.append((p_boxes, p_labels, p_scores, t_boxes, t_labels, t_crowd, masks))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mean_ap_tables_equal_jax(seed):
    """``MeanAPEvaluator``: identical box and mask tables to the JAX
    evaluator's over the same images (labels outside the class range
    included), and the same printed table."""
    ours, ref = ap.MeanAPEvaluator(6), jax_ap.MeanAPEvaluator(6)
    for pb, pl, ps, tb, tl, _, (pm, tm) in _images(seed):
        for ev in (ours, ref):
            ev.add_image(pb, pl, ps, tb, tl, p_masks=pm, t_masks=tm)
    got, want = ours.compute(), ref.compute()
    assert got == want and got["box"]["all"] > 0 and got["mask"]["all"] > 0
    assert ours.print_table() == ref.print_table()
    for a, b in ((np.random.default_rng(seed).uniform(0, 9, (5, 4)),) * 2,):
        np.testing.assert_array_equal(ap.box_iou_matrix(a, b), jax_ap.box_iou_matrix(a, b))


@pytest.mark.parametrize("crowd, many", [(False, False), (True, False), (True, True)],
                         ids=["plain", "crowd", "crowd_over_100_detections"])
def test_cocoeval_tables_equal_jax(crowd, many):
    """``COCOProtocolEvaluator``: identical tables to the JAX evaluator's,
    with crowd regions and with more than 100 detections an image."""
    ours, ref = coco_protocol.COCOProtocolEvaluator(6), jax_cp.COCOProtocolEvaluator(6)
    for pb, pl, ps, tb, tl, tc, _ in _images(7, crowd=crowd, many=many):
        for ev in (ours, ref):
            ev.add_image(pb, pl, ps, tb, tl, t_crowd=tc)
    got, want = ours.compute(), ref.compute()
    assert got == want and 0 < got["box"]["all"] < 100
    assert list(got["box"]) == list(want["box"])
