"""The port's box converters, drawing helpers and webcam inference
(``detr_tensorflow_tpu_torch/ops/boxes.py``, ``inference.py``,
``webcam_inference.py``) against the JAX package's, on the same numpy
inputs and the same converted weights.

Tolerances: the numpy converters and both drawing helpers bit-equal (the
port's mask resize is cv2's INTER_NEAREST bit for bit, its boxes are drawn
by cv2 as JAX's are); the torch converters to 1e-6 (float32 arithmetic in
another framework); detections to the golden tolerances, boxes 5e-4 and
scores 5e-3, with equal labels and keep masks.
"""

import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu import inference as jax_inference
from detr_tensorflow_tpu.models import DETR as JaxDETR
from detr_tensorflow_tpu.models.api import DetrModel as JaxDetrModel
from detr_tensorflow_tpu.ops import boxes as jax_boxes
from detr_tensorflow_tpu.train import TrainingConfig as JaxConfig
from detr_tensorflow_tpu_torch import inference, webcam_inference
from detr_tensorflow_tpu_torch.models import DETR, DetrModel
from detr_tensorflow_tpu_torch.models.weights import from_jax_variables
from detr_tensorflow_tpu_torch.ops import boxes
from detr_tensorflow_tpu_torch.train import TrainingConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import webcam_inference as jax_webcam  # noqa: E402  (the JAX package's root script)
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

BOX_ATOL, SCORE_ATOL = 5e-4, 5e-3
# A reduced DETR: 92 COCO classes (the webcam path's background is 91),
# head dim 32 (the port's attention takes 32 or 64), one layer a side.
TINY = dict(num_classes=92, num_queries=8, model_dim=64, num_heads=2, num_encoder_layers=1,
            num_decoder_layers=1, dim_feedforward=64, backbone_stage_sizes=(1, 1, 1, 1))
CLASS_NAMES = ("zero", "one", "two", "three")


def _boxes(rng, n):
    xy = rng.uniform(0.1, 0.9, (n, 2))
    return np.concatenate([xy, rng.uniform(0.05, 0.6, (n, 2))], -1).astype(np.float32)


def test_torch_box_converters_match_jax():
    rng = np.random.default_rng(0)
    corners = np.sort(rng.uniform(0, 1, (3, 5, 2, 2)), axis=2).transpose(0, 1, 3, 2).reshape(
        3, 5, 4).astype(np.float32)  # xmin <= xmax, ymin <= ymax
    names = ["xyxy_to_xcycwh", "yxyx_to_xyxy", "yxyx_to_xcycwh", "xy_min_xy_max_to_xcycwh",
             "xy_min_xy_max_to_yx_min_yx_max", "yx_min_yx_max_to_xy_min_xy_max",
             "yx_min_yx_max_to_xcycwh"]
    for name in names:
        ours = getattr(boxes, name)(torch.from_numpy(corners)).numpy()
        ref = np.asarray(getattr(jax_boxes, name)(jnp.asarray(corners)))
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0, err_msg=name)
    centres = _boxes(rng, 7)
    for name in ("xcycwh_to_xy_min_xy_max", "xcycwh_to_yx_min_yx_max"):
        ours = getattr(boxes, name)(torch.from_numpy(centres)).numpy()
        ref = np.asarray(getattr(jax_boxes, name)(jnp.asarray(centres)))
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0, err_msg=name)
    back = boxes.yxyx_to_xcycwh(boxes.xcycwh_to_yxyx(torch.from_numpy(centres), clip=False))
    np.testing.assert_allclose(back.numpy(), centres, atol=1e-6)


def test_numpy_box_helpers_equal_jax():
    rng = np.random.default_rng(1)
    b = rng.uniform(0, 1, (2, 6, 4))
    for size in ((480, 640), (37, 91)):
        for name in ("np_rescale_bbox_xcycwh", "np_rescale_bbox_xy_min_xy_max",
                     "np_rescale_bbox_yx_min_yx_max"):
            ours, ref = getattr(boxes, name)(b, size), getattr(jax_boxes, name)(b, size)
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref, err_msg=name)
    for name in ("np_xcycwh_to_xy_min_xy_max", "np_yx_min_yx_max_to_xy_min_xy_max"):
        np.testing.assert_array_equal(getattr(boxes, name)(b), getattr(jax_boxes, name)(b))
    pixels = b * 300.0
    ours, ref = boxes.bbox_xcycwh_to_x1y1x2y2(pixels), jax_boxes.bbox_xcycwh_to_x1y1x2y2(pixels)
    assert ours.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)


def test_class_colors_are_jax_draw():
    np.testing.assert_array_equal(inference._CLASS_COLORS, jax_inference._CLASS_COLORS)


@pytest.mark.parametrize("image_hw,mask_hw,kind", [
    ((48, 64), (12, 16), "bool"),  # stride 4, a resize of each mask
    ((50, 70), (17, 23), "float"),  # uneven ratios; float masks go through uint8 first
    ((40, 56), (40, 56), "float"),  # no resize: thresholded as they are
])
def test_numpy_masks_to_image_equals_jax(image_hw, mask_hw, kind):
    rng = np.random.default_rng(sum(image_hw))
    masks = rng.uniform(0, 1.6, (5,) + mask_hw)
    masks = masks > 0.8 if kind == "bool" else masks.astype(np.float32)
    masks[2] = 0  # an empty mask is skipped
    labels = np.array([3, 91, 7, 250, 3])
    u8 = rng.integers(0, 256, image_hw + (3,)).astype(np.uint8)
    for labels_ in (labels, None):
        ours = inference.numpy_masks_to_image(u8, masks, labels=labels_)
        ref = jax_inference.numpy_masks_to_image(u8, masks, labels=labels_)
        assert ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)
    # A normalized float image: denormalized by the config's method.
    normalized = rng.normal(size=image_hw + (3,)).astype(np.float32)
    for method in ("torch_resnet", "tf_resnet"):
        ours = inference.numpy_masks_to_image(normalized, masks, alpha=0.3,
                                              config=TrainingConfig(normalized_method=method))
        ref = jax_inference.numpy_masks_to_image(normalized, masks, alpha=0.3,
                                                 config=JaxConfig(normalized_method=method))
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("case", ["scores", "no_scores", "unnamed_class"])
def test_numpy_bbox_to_image_equals_jax(case):
    rng = np.random.default_rng(2)
    bbox = _boxes(rng, 6)
    labels = rng.integers(0, len(CLASS_NAMES), 6)
    scores = rng.uniform(0, 1, 6).astype(np.float32) if case != "no_scores" else None
    if case == "unnamed_class":
        labels[[1, 4]] = [len(CLASS_NAMES), 205]  # past class_name: drawn as the id
    image = rng.integers(0, 256, (90, 120, 3)).astype(np.uint8)
    ours = inference.numpy_bbox_to_image(image.copy(), bbox, labels, scores, CLASS_NAMES)
    ref = jax_inference.numpy_bbox_to_image(image.copy(), bbox, labels, scores, CLASS_NAMES)
    assert ours.dtype == np.uint8 and not np.array_equal(ours, image)
    np.testing.assert_array_equal(ours, ref)
    # A [0, 1] float image without a config, and no labels.
    unit = rng.uniform(0, 1, (90, 120, 3)).astype(np.float32)
    np.testing.assert_array_equal(inference.numpy_bbox_to_image(unit, bbox),
                                  jax_inference.numpy_bbox_to_image(unit, bbox))


def _tiny_pair(seed, **overrides):
    """The reduced JAX DETR with seeded variables (nonzero FrozenBN
    buffers), and the port's model with the same weights, on the CPU."""
    from test_torch_models import random_variables

    cfg = dict(TINY, **overrides)
    module = JaxDETR(dropout=0.0, attn_impl="xla", **cfg)
    variables = random_variables(module, jnp.zeros((1, 64, 96, 3)), seed=seed)
    port = DETR(dropout=0.0, **cfg)
    port.load_state_dict(from_jax_variables(jax.device_get(variables)), strict=True)
    return module, variables, port


@pytest.fixture(scope="module")
def tiny_models():
    return _tiny_pair(3)


@pytest.mark.parametrize("method,masks", [("torch_resnet", False), ("tf_resnet", False),
                                          ("torch_resnet", True)])
def test_make_run_inference_matches_jax(tiny_models, method, masks):
    """uint8 frames through the port's and JAX's webcam programs: the same
    normalization, forward and postprocess; a segmentation model's
    thresholded stride-4 masks agree but for pixels within float32 rounding
    of the threshold (at most 0.1% of them)."""
    module, variables, port = _tiny_pair(6, masks=True) if masks else tiny_models
    frames = np.random.default_rng(4).integers(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    (b, l, s, k), got_masks = webcam_inference.make_run_inference(
        DetrModel(port, normalized_method=method), 91)(frames)
    (rb, rl, rs, rk), ref_masks = jax_webcam.make_run_inference(
        JaxDetrModel(module, variables, normalized_method=method), 91)(frames)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), atol=BOX_ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(l.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(k.numpy(), np.asarray(rk))
    assert k.numpy().any()  # something is detected, so the comparison reads boxes
    if masks:
        assert got_masks.dtype == torch.bool and got_masks.shape == (2, 8, 16, 24)
        assert (got_masks.numpy() != np.asarray(ref_masks)).mean() <= 1e-3
    else:
        assert got_masks is None and ref_masks is None
    with pytest.raises(ValueError):
        webcam_inference.make_run_inference(DetrModel(port, normalized_method="bgr"), 91)


def test_run_webcam_inference_matches_jax_on_a_video(tiny_models, tmp_path):
    """Three frames of an MJPG ``.avi`` that cv2 writes: both loops read,
    convert, resize (the port's cv2-equal resize against cv2's), detect and
    draw; the drawn frames are equal, and every frame of the port's loop is
    the JAX loop's frame."""
    module, variables, port = tiny_models
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5, (120, 80))
    rng = np.random.default_rng(5)
    for _ in range(4):
        writer.write(rng.integers(0, 256, (80, 120, 3)).astype(np.uint8))
    writer.release()
    ours, ref = [], []
    n = webcam_inference.run_webcam_inference(DetrModel(port), path, image_size=(64, 96),
                                              display=False, frame_callback=ours.append,
                                              max_frames=3)
    n_ref = jax_webcam.run_webcam_inference(JaxDetrModel(module, variables), path,
                                            image_size=(64, 96), display=False,
                                            frame_callback=ref.append, max_frames=3)
    assert n == n_ref == 3 and len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert a.shape == (64, 96, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_webcam_main_runs_a_local_checkpoint(tiny_models, tmp_path):
    """``python -m detr_tensorflow_tpu_torch.webcam_inference``'s ``main``
    on a video with a local ``.npz`` (no download), on the CPU, no window."""
    _, _, port = tiny_models
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5, (96, 64))
    for frame in np.random.default_rng(6).integers(0, 256, (3, 64, 96, 3)).astype(np.uint8):
        writer.write(frame)
    writer.release()
    weights = str(tmp_path / "tiny.npz")
    DetrModel(port).save(weights)
    kw = {k: v for k, v in TINY.items() if k != "num_classes"}
    n = webcam_inference.main(["--source", path, "--weights", weights, "--device", "cpu",
                               "--image_size", "64", "96", "--max_frames", "2", "--no_display"],
                              **kw)
    assert n == 2
    with pytest.raises(FileNotFoundError):
        webcam_inference.main(["--source", path, "--weights", str(tmp_path / "none.npz"),
                               "--device", "cpu", "--no_display"], **kw)

