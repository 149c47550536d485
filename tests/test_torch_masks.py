"""Instance masks on the host and the mask losses (detr_tensorflow_tpu_torch/
data/masks.py, the masks' path through data/transforms.py, processing.py
and coco.py, the mask helpers of inference.py and ops/losses.py) against
the JAX package's and OpenCV 5.0's, on the CPU.

The rasterizer and the nearest mask resamplings are held bit-equal to
cv2 (the JAX package's): ``fillPoly`` on convex, concave, multi-ring,
edge-touching and clipped polygons, ``resize`` and ``warpAffine`` with
INTER_NEAREST. Inputs come from numpy seeds; tolerances are stated at each
comparison.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu import inference as jax_inference
from detr_tensorflow_tpu.data import coco as jax_coco
from detr_tensorflow_tpu.data import masks as jax_masks
from detr_tensorflow_tpu.data import processing as jax_processing
from detr_tensorflow_tpu.data import transforms as jax_transforms
from detr_tensorflow_tpu.ops import losses as jax_losses
from detr_tensorflow_tpu.train import DataConfig as JaxDataConfig
from detr_tensorflow_tpu.train import TrainingConfig as JaxConfig
from detr_tensorflow_tpu_torch import inference
from detr_tensorflow_tpu_torch.data import coco, masks, processing, synthetic, transforms
from detr_tensorflow_tpu_torch.ops import losses
from detr_tensorflow_tpu_torch.train import DataConfig, TrainingConfig

PROB_ATOL = 1e-5  # resized mask probabilities against cv2's float resize
LOSS_RTOL = 1e-6


def t(x):
    return torch.from_numpy(np.array(x))


def _rle_string(counts):
    """pycocotools' compressed RLE string of run lengths (an encoder
    independent of the decoder under test)."""
    out = []
    for i, x in enumerate(int(c) for c in counts):
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def _column_runs(mask):
    flat = mask.T.reshape(-1)
    change = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    return [0] + runs if flat[0] else runs


def test_rle_decoding_matches_jax():
    """Compressed (including runs longer than 2^15 and deltas of both
    signs) and uncompressed RLE decode to the source mask, equal to JAX's
    decoder; ``ann_to_mask`` of RLE, polygon and missing segmentations
    equal to JAX's."""
    rng = np.random.default_rng(0)
    for h, w, p in ((37, 53, 0.3), (300, 240, 0.002), (1, 9, 0.9)):
        m = (rng.random((h, w)) < p).astype(np.uint8)
        m[h // 2:, :w // 3] = 1
        counts = _column_runs(m)
        s = _rle_string(counts)
        np.testing.assert_array_equal(masks.decode_rle_counts(s), jax_masks.decode_rle_counts(s))
        np.testing.assert_array_equal(masks.decode_rle_counts(s.encode()), counts)
        for rle in ({"size": [h, w], "counts": s}, {"size": [h, w], "counts": counts}):
            np.testing.assert_array_equal(masks.rle_to_mask(rle), m)
            np.testing.assert_array_equal(masks.ann_to_mask({"segmentation": rle}, h, w),
                                          jax_masks.ann_to_mask({"segmentation": rle}, h, w))
    poly = {"segmentation": [[2.3, 3.1, 30.7, 5.0, 17.5, 29.9], [1, 1, 4, 1, 4]]}
    np.testing.assert_array_equal(masks.ann_to_mask(poly, 33, 41),
                                  jax_masks.ann_to_mask(poly, 33, 41))
    np.testing.assert_array_equal(masks.ann_to_mask({}, 4, 5), np.zeros((4, 5), np.uint8))


def _rings(rng, kind, h, w):
    n = int(rng.integers(3, 12))
    if kind == "convex":
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(2, min(h, w) / 2)
        c = rng.uniform(r, [w - r, h - r])
        return [np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1).ravel()]
    if kind == "concave":  # star-shaped, random radii: concave and self-touching
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(1, min(h, w) / 2, n)
        c = np.array([w, h]) / 2
        return [np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1).ravel()]
    if kind == "multi_ring":  # overlapping rings fill even-odd
        return [np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], 1).ravel()
                for _ in range(int(rng.integers(2, 4)))]
    if kind == "edge_touching":  # vertices on 0 and on w, h (one past the last pixel)
        x = np.where(rng.random(n) < 0.5, rng.choice([0.0, w], n), rng.uniform(0, w, n))
        y = np.where(rng.random(n) < 0.5, rng.choice([0.0, h], n), rng.uniform(0, h, n))
        return [np.stack([x, y], 1).ravel()]
    return [np.stack([rng.uniform(-10, w + 10, n), rng.uniform(-10, h + 10, n)], 1).ravel()]


@pytest.mark.parametrize("kind", ["convex", "concave", "multi_ring", "edge_touching", "clipped"])
def test_polygons_to_mask_equals_cv2_fill_poly(kind):
    """The rebuilt ``fillPoly`` bit-equal to cv2's (and to the JAX
    package's rasterizer, which calls it) on 300 random polygons of each
    kind, 5-60 px images."""
    rng = np.random.default_rng(["convex", "concave", "multi_ring", "edge_touching",
                                 "clipped"].index(kind))
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(5, 60, 2))
        rings = [r.tolist() for r in _rings(rng, kind, h, w)]
        ours = masks.polygons_to_mask(rings, h, w)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [np.round(np.asarray(r)).astype(np.int32).reshape(-1, 2)
                            for r in rings], 1)
        np.testing.assert_array_equal(ours, want)
        np.testing.assert_array_equal(ours, jax_masks.polygons_to_mask(rings, h, w))


def test_pad_instance_masks_matches_jax():
    rng = np.random.default_rng(1)
    for n, h, w in ((3, 37, 50), (0, 9, 13), (7, 16, 16)):
        m = (rng.random((n, h, w)) < 0.5).astype(np.uint8)
        np.testing.assert_array_equal(masks.pad_instance_masks(m, 5),
                                      jax_masks.pad_instance_masks(m, 5))
    with pytest.raises(ValueError):
        masks.pad_instance_masks(np.zeros((4, 4), np.uint8), 5)


def test_nearest_mask_resamplings_equal_cv2():
    """``resize_masks`` and ``warp_scale_nearest`` bit-equal to cv2's
    INTER_NEAREST ``resize`` and ``warpAffine``, the latter at random
    scales and at scales whose positions land on exact halves (the ties
    of its rounding), at widths on and off its 16-column blocks."""
    rng = np.random.default_rng(2)
    ties = [0.5, 1.0, 0.8, 8 / 7, 4 / 3, 2 / 3, 1.25, 0.75]
    for i in range(400):
        h, w = (int(v) for v in rng.integers(2, 120, 2))
        m = (rng.random((2, h, w)) < 0.5).astype(np.uint8)
        if i % 4 == 0:
            oh, ow = (int(v) for v in rng.integers(1, 150, 2))
            want = np.stack([cv2.resize(x, (ow, oh), interpolation=cv2.INTER_NEAREST)
                             for x in m])
            np.testing.assert_array_equal(transforms.resize_masks(m, oh, ow), want)
        sx, sy = ((float(rng.choice(ties)), float(rng.choice(ties))) if i % 4
                  else tuple(float(v) for v in rng.uniform(0.5, 1.5, 2)))
        cx, cy = w / 2.0, h / 2.0
        mat = np.array([[sx, 0.0, cx * (1 - sx)], [0.0, sy, cy * (1 - sy)]])
        want = np.stack([cv2.warpAffine(x, mat, (w, h), flags=cv2.INTER_NEAREST) for x in m])
        np.testing.assert_array_equal(transforms.warp_scale_nearest(m, sx, sy, cx, cy), want)


def test_detr_transform_masks_match_jax():
    """Masks through ``detr_transform`` under one seed, 40 seeds with
    augmentation (flips, crops, nearest resizes, the nearest scale about
    the centre) and one without: the same Generator state after, the same
    kept instances, masks equal, boxes within 1e-6."""
    rng = np.random.default_rng(3)
    config = JaxConfig(image_size=(48, 80))
    for seed in range(41):
        img = rng.integers(0, 256, (70, 90, 3)).astype(np.uint8)
        n = int(rng.integers(1, 6))
        boxes = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.4, (n, 2))],
                               -1).astype(np.float32)
        inst = (rng.random((n, 70, 90)) < 0.4).astype(np.uint8)
        classes = rng.integers(1, 9, n)
        aug = seed < 40
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_transforms.detr_transform(img, boxes, classes, config, aug, rng=r1,
                                             masks=inst)
        got = transforms.detr_transform(img, boxes, classes, config, aug, rng=r2, masks=inst)
        assert r1.bit_generator.state == r2.bit_generator.state
        assert len(got) == len(want) == 4
        np.testing.assert_allclose(got[1], want[1], atol=1e-6)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])


@pytest.fixture(scope="module")
def mask_root(tmp_path_factory):
    """A synthetic COCO set with polygon segmentations, COCO-like odd
    sizes and 1-4 instances an image."""
    root = tmp_path_factory.mktemp("masks")
    synthetic.make_synthetic_coco(str(root), n_images=6, seed=4, masks=True,
                                  sizes=[(70, 90), (57, 83), (90, 70)], boxes_per_image=(1, 4))
    return root


@pytest.mark.parametrize("augmentation, full_res", [(True, False), (False, False),
                                                    (None, False), (None, True)],
                         ids=["augment", "resize", "eval", "eval_full_res"])
def test_coco_loader_masks_equal_jax(mask_root, augmentation, full_res):
    """``load_coco_dataset(include_masks=True)`` against the JAX loader on
    the same files, one worker: ``t_masks`` (T, H/4, W/4), and at original
    size with ``full_res_masks`` ``t_masks_full`` in the bucket frame,
    equal; boxes within 1e-6, images within one uint8 level."""
    data = dict(data_dir=str(mask_root), img_dir="images", ann_file="ann.json", ann_dir="ann")
    kw = dict(augmentation=augmentation, bucket_divisor=64, num_workers=1, seed=5,
              include_masks=True, full_res_masks=full_res)
    batch = 1 if augmentation is None else 2
    ours, _ = coco.load_coco_dataset(TrainingConfig(data=DataConfig(**data), image_size=(48, 80),
                                                    num_queries=10), batch, **kw)
    ref, _ = jax_coco.load_coco_dataset(JaxConfig(data=JaxDataConfig(**data),
                                                  image_size=(48, 80), num_queries=10),
                                        batch, **kw)
    level = 1.0 / (255.0 * float(processing.IMAGENET_STD.min())) + 1e-6
    pairs = list(zip(ours, ref))
    assert len(pairs) == len(list(ref)) > 0
    for got, want in pairs:
        assert got.keys() == want.keys() and "t_masks" in got
        assert ("t_masks_full" in got) == full_res
        for k in want:
            if k == "images":
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=level)
            elif k == "boxes":
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any(b["t_masks"].any() for b, _ in pairs)


def test_make_eval_example_masks_equal_jax():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (70, 90, 3)).astype(np.uint8)
    inst = (rng.random((3, 70, 90)) < 0.5).astype(np.uint8)
    boxes = np.array([[0.5, 0.5, 0.2, 0.2]] * 3, np.float32)
    cfg = JaxConfig(num_queries=5)
    got = processing.make_eval_example(img, boxes, np.arange(3), cfg, 64, inst_masks=inst,
                                       full_res_masks=True)
    want = jax_processing.make_eval_example(img, boxes, np.arange(3), cfg, 64, inst_masks=inst,
                                            full_res_masks=True)
    assert got.keys() == want.keys()
    assert got["t_masks"].shape == (5, 32, 32) and got["t_masks_full"].shape == (3, 128, 128)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _mask_outputs(seed, b=2, q=6, h=18, w=25):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, q, 7)).astype(np.float32)
    logits[0, 1, 6] = 9.0  # a background query
    return {"pred_logits": logits,
            "pred_masks": (3 * rng.normal(size=(b, q, h, w))).astype(np.float32)}


def _bool_masks_agree(ours, probs_ref, threshold=0.5):
    """Bool masks equal wherever the reference probability is not within
    1e-5 of the threshold."""
    near = np.abs(probs_ref - threshold) < PROB_ATOL
    assert np.array_equal(ours[~near], (probs_ref > threshold)[~near])


def test_mask_postprocess_matches_jax():
    """``postprocess_masks`` (up and down), ``merge_instance_masks``,
    ``upsample_mask_probs`` / ``bilinear_resize`` (against the JAX
    package's cv2 resize, 1e-5; the torch and numpy versions equal) and
    ``np_merge_full_res`` against JAX's on the same outputs."""
    out = _mask_outputs(7)
    jout = {k: jnp.asarray(v) for k, v in out.items()}
    tout = {k: t(v) for k, v in out.items()}
    for size in ((72, 100), (9, 13), None):
        ref = np.asarray(jax_inference.postprocess_masks(jout, size))
        got = inference.postprocess_masks(tout, size).numpy()
        probs = jax.nn.sigmoid(jout["pred_masks"])
        if size is not None:
            probs = jax.image.resize(probs, probs.shape[:2] + size, "bilinear")
        _bool_masks_agree(got, np.asarray(probs))
        assert got.shape == ref.shape
    seg, keep = inference.merge_instance_masks(tout, 6)
    seg_ref, keep_ref = jax_inference.merge_instance_masks(jout, 6)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(seg_ref))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_ref))
    probs = 1 / (1 + np.exp(-out["pred_masks"][0]))
    for hw in ((70, 100), (57, 83), (4, 4)):
        ref = jax_inference.upsample_mask_probs(probs, hw)
        got = inference.upsample_mask_probs(probs, hw)
        np.testing.assert_allclose(got, ref, atol=PROB_ATOL, rtol=0)
        crop = probs[:, :-(-hw[0] // 4), :-(-hw[1] // 4)]
        np.testing.assert_array_equal(
            inference.bilinear_resize(t(crop), *hw).numpy().transpose(1, 2, 0), got)
        scores = np.linspace(0.2, 0.9, 6).astype(np.float32)
        keep = np.array([1, 1, 0, 1, 1, 1], bool)
        np.testing.assert_array_equal(inference.np_merge_full_res(ref, scores, keep),
                                      jax_inference.np_merge_full_res(ref, scores, keep))
    assert inference.upsample_mask_probs(probs[:0], (9, 9)).shape == (9, 9, 0)


def _loss_inputs(seed, t_hw=(18, 25)):
    rng = np.random.default_rng(seed)
    b, q, tn = 2, 6, 4
    p_masks = (3 * rng.normal(size=(b, q, 18, 25))).astype(np.float32)
    t_masks = (rng.random((b, tn) + t_hw) < 0.3).astype(np.uint8)
    t_of_p = rng.integers(-1, tn, (b, q)).astype(np.int32)
    matched = t_of_p >= 0
    return p_masks, t_masks, t_of_p, matched


@pytest.mark.parametrize("t_hw", [(18, 25), (36, 50), (11, 13)], ids=["same", "up", "down"])
def test_mask_losses_match_jax(t_hw):
    """Focal and dice losses over matched pairs to 1e-6 relative, the
    targets at the prediction's lattice and resized with
    ``jax.image.resize``'s half-pixel nearest (from twice and from less
    than the lattice)."""
    args = _loss_inputs(8, t_hw)
    ref = jax.jit(jax_losses.mask_losses)(*(jnp.asarray(a) for a in args))
    ours = losses.mask_losses(*(t(a) for a in args))
    for k in ("mask_loss", "dice_loss"):
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=LOSS_RTOL, err_msg=k)
    assert losses.LOSS_WEIGHTS["mask_loss"] == jax_losses.LOSS_WEIGHTS["mask_loss"]
    assert losses.LOSS_WEIGHTS["dice_loss"] == jax_losses.LOSS_WEIGHTS["dice_loss"]


def test_detr_loss_with_masks_matches_jax():
    """``detr_loss`` with ``pred_masks`` and ``t_masks``: the mask terms on
    the final layer only (no ``mask_loss_0``), every log entry and the
    total to 1e-6 relative."""
    rng = np.random.default_rng(9)
    b, q, tn = 2, 6, 4
    outputs = {"pred_logits": rng.normal(size=(b, q, 7)).astype(np.float32),
               "pred_boxes": rng.uniform(0.1, 0.9, (b, q, 4)).astype(np.float32),
               "aux_logits": rng.normal(size=(1, b, q, 7)).astype(np.float32),
               "aux_boxes": rng.uniform(0.1, 0.9, (1, b, q, 4)).astype(np.float32),
               "pred_masks": (3 * rng.normal(size=(b, q, 18, 25))).astype(np.float32)}
    t_bbox = rng.uniform(0.2, 0.6, (b, tn, 4)).astype(np.float32)
    t_class = rng.integers(0, 6, (b, tn)).astype(np.int32)
    t_mask = np.array([[1, 1, 1, 0], [1, 0, 0, 0]], bool)
    t_masks = (rng.random((b, tn, 18, 25)) < 0.3).astype(np.uint8)
    total_ref, log_ref = jax.jit(jax_losses.detr_loss, static_argnums=4)(
        {k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(t_bbox),
        jnp.asarray(t_class), jnp.asarray(t_mask), 6, t_masks=jnp.asarray(t_masks))
    total, log = losses.detr_loss({k: t(v) for k, v in outputs.items()}, t(t_bbox), t(t_class),
                                  t(t_mask), 6, t_masks=t(t_masks))
    assert set(log) == set(log_ref) and "mask_loss" in log and "mask_loss_0" not in log
    for k, v in log_ref.items():
        np.testing.assert_allclose(float(log[k]), float(v), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total), float(total_ref), rtol=LOSS_RTOL)
