"""Serving path: raw images in, detections and instance masks out (port
of ``detr_tensorflow_tpu/predictor.py``).

Images of any size are zero-padded up to shape buckets (multiples of
``bucket_divisor``) with a pixel mask, and images of one bucket run as one
batch. Normalization happens on the model's device, and padded pixels are
zeroed after it; with that and the model's masking, a padded image gives
the same detections as the image alone.

With ``masks=True`` (a model built with ``masks=True``) each detection
carries a bool mask at its image's size: the stride-4 mask probabilities,
zeroed outside the valid stride-4 cells, cropped to them, resized
bilinearly to the image and thresholded, all on the model's device; only
the bool masks come back (``inference.mask_probs``, ``kept_masks``).

Each bucket's device work is one program, ``_get_program(shape, masked)``:
frames (and a pixel mask) in, the postprocessed detections (and mask
probabilities) out. The live Predictor's program is ``serve_forward``, the
model's forward at any shape; ``export.ExportedPredictor`` overrides
``_get_program`` with the programs of an artifact, and shares the rest.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import inference
from .data.processing import CAFFE_MEAN, IMAGENET_MEAN, IMAGENET_STD


class Detection:
    """One image's detections (ragged, on the host)."""

    __slots__ = ("boxes", "labels", "scores", "masks")

    def __init__(self, boxes, labels, scores, masks=None):
        self.boxes = boxes  # (n, 4), normalized to the image's own frame
        self.labels = labels  # (n,)
        self.scores = scores  # (n,)
        # (n, H, W) bool instance masks at the image's own size, or None when
        # the predictor serves boxes only.
        self.masks = masks


class Predictor:
    """Batched, bucketed DETR inference.

    Args:
      model: a ``models.api.DetrModel``.
      background_class: class id to suppress.
      bucket_divisor: H and W are padded up to multiples of this.
      score_threshold: detections scoring below it are dropped.
      bbox_format: 'xy_center' | 'xyxy' | 'yxyx'.
      masks: serve each detection's instance mask (a model built with
        ``masks=True``), thresholded at ``mask_threshold``.

    ``buckets`` records every (height, width) bucket served or warmed.
    """

    def __init__(self, model, background_class: int, bucket_divisor: int = 128,
                 score_threshold: float = 0.0, bbox_format: str = "xy_center",
                 masks: bool = False, mask_threshold: float = 0.5):
        if masks and not model.module.masks:
            raise ValueError("masks=True needs a model built with masks=True")
        self.model = model
        self.background_class = int(background_class)
        self.bucket_divisor = int(bucket_divisor)
        self.score_threshold = float(score_threshold)
        self.bbox_format = bbox_format
        self.masks = bool(masks)
        self.mask_threshold = float(mask_threshold)
        self.buckets: set = set()
        device = model.device
        if model.normalized_method == "torch_resnet":
            self._shift = torch.as_tensor(IMAGENET_MEAN, device=device)
            self._scale = torch.as_tensor(IMAGENET_STD, device=device)
        else:
            self._shift = torch.as_tensor(CAFFE_MEAN, device=device)
            self._scale = None

    @property
    def unmasked_route(self) -> bool:
        """Whether a batch that fills its bucket (run without a pixel mask)
        takes other kernels than a masked one: kernel E runs only
        unmasked, so a ``fuse_bottleneck`` model does."""
        return bool(self.model.module.fuse_bottleneck)

    def normalize(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 (B, H, W, 3) frames on the device -> normalized float32."""
        x = frames.float()
        if self._scale is not None:
            return (x / 255.0 - self._shift) / self._scale
        return x.flip(-1) - self._shift  # RGB -> BGR, caffe means

    def _bucket(self, h: int, w: int) -> Tuple[int, int]:
        d = self.bucket_divisor
        return ((h + d - 1) // d) * d, ((w + d - 1) // d) * d

    def serve_forward(self, frames: torch.Tensor, pixel_mask: Optional[torch.Tensor] = None):
        """The device work of one batch: uint8 (B, H, W, 3) ``frames`` and an
        optional bool (B, H, W) ``pixel_mask`` on the model's device ->
        (``inference.postprocess``'s (boxes, labels, scores, keep), mask
        probabilities or None). Call it without autograd (``_run`` holds
        inference mode; ``export.export_predictor`` traces it under no_grad)."""
        x = self.normalize(frames)
        if pixel_mask is not None:
            # Zero padded pixels after normalization: the model's
            # padding invariance assumes zeros there, like the
            # implicit padding of an unpadded SAME convolution.
            x = x * pixel_mask[..., None]
        outputs = self.model.module(x, pixel_mask)
        post = inference.postprocess(outputs, self.background_class, self.bbox_format)
        if not self.masks:
            return post, None
        return post, inference.mask_probs(outputs["pred_masks"], pixel_mask)

    def _get_program(self, shape: Tuple[int, int], masked: bool):
        """The program that serves bucket ``shape``: called with the frames,
        and with the pixel mask when ``masked``, as ``serve_forward`` is.
        The live model serves every bucket with ``serve_forward``."""
        return self.serve_forward

    def _run(self, frames: np.ndarray, masks: Optional[np.ndarray]):
        device = self.model.device
        with torch.inference_mode():
            program = self._get_program(frames.shape[1:3], masks is not None)
            inputs = [torch.from_numpy(frames).to(device)]
            if masks is not None:
                inputs.append(torch.from_numpy(masks).to(device))
            return program(*inputs)

    def warmup(self, shapes: Sequence[Tuple[int, int]], batch: int = 1) -> None:
        """Run each (height, width) bucket once on ``batch`` zero images, so
        the first request of that batch does not pay for a kernel build, a
        library set-up at its shapes (cuDNN's plans, the allocator's
        blocks) or, in a bf16 model, the casts of its float32 parameters
        (the copies are cached until the weights change,
        ``models/layers.py``). A model with ``fuse_bottleneck`` also runs it
        without a pixel mask, at the same batch: a batch that fills its
        bucket runs unmasked, the only route of kernel E; every other model
        runs the same kernels either way. With ``masks`` the warm-up also
        resizes one image's masks to the bucket."""
        if batch < 1:
            raise ValueError(f"warmup batch must be at least 1, got {batch}")
        for h, w in shapes:
            ph, pw = self._bucket(h, w)
            frames = np.zeros((batch, ph, pw, 3), np.uint8)
            _, probs = self._run(frames, np.ones((batch, ph, pw), bool))
            if probs is not None:
                inference.kept_masks(probs[0], np.ones(probs.shape[1], bool), h, w,
                                     self.mask_threshold)
            if self.unmasked_route:
                self._run(frames, None)
            self.buckets.add((ph, pw))

    def __call__(self, images: List[np.ndarray]) -> List[Detection]:
        """Detect on a list of uint8 RGB (H, W, 3) images of any sizes.
        Returned boxes are normalized to each image's own frame."""
        buckets: dict = {}
        for i, img in enumerate(images):
            if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
                raise ValueError(
                    f"image {i}: expected uint8 (H, W, 3), got {img.dtype} {img.shape}"
                )
            buckets.setdefault(self._bucket(*img.shape[:2]), []).append(i)

        results: List[Optional[Detection]] = [None] * len(images)
        for (ph, pw), idxs in buckets.items():
            frames = np.zeros((len(idxs), ph, pw, 3), np.uint8)
            masks = np.zeros((len(idxs), ph, pw), bool)
            for row, i in enumerate(idxs):
                h, w = images[i].shape[:2]
                frames[row, :h, :w] = images[i]
                masks[row, :h, :w] = True
            exact = bool(masks.all())
            post, probs = self._run(frames, None if exact else masks)
            boxes, labels, scores, keep = (t.cpu().numpy() for t in post)
            self.buckets.add((ph, pw))
            keep = keep & (scores >= self.score_threshold)
            for row, i in enumerate(idxs):
                k = keep[row]
                det_masks = None
                if probs is not None:
                    det_masks = inference.kept_masks(probs[row], k, *images[i].shape[:2],
                                                     self.mask_threshold)
                # No rescale: boxes are already normalized to the valid
                # frame, because the model is padding invariant.
                results[i] = Detection(boxes[row][k], labels[row][k], scores[row][k],
                                       masks=det_masks)
        return results  # type: ignore[return-value]
