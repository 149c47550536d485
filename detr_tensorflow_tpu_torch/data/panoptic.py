"""COCO panoptic loaders: things, stuff, crowd and VOID (port of
``detr_tensorflow_tpu/data/panoptic.py``).

``panoptic_{split}.json`` and its segment-id PNGs, where each pixel's
segment id is ``R + 256*G + 256**2*B`` and id 0 marks unlabeled (VOID)
pixels. The training loader makes every non-crowd segment, stuff included,
a (box, class, mask) target; the evaluation loader yields bucket-padded
examples with the full-resolution segments, their crowd flags and the VOID
region for ``metrics.panoptic_quality``. Images and segment PNGs are read by
``data/image_io.py`` (the JAX package reads them with cv2, which the card's
machine lacks).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from . import masks as seg_masks
from . import processing, transforms
from .image_io import read_image
from .pipeline import HostDataset, WorkerRNG


class PanopticIndex:
    """Minimal index over a COCO ``panoptic_*.json`` file."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.images = {img["id"]: img for img in data.get("images", [])}
        self.anns = {a["image_id"]: a for a in data.get("annotations", [])}
        self.categories = {c["id"]: c for c in data.get("categories", [])}

    @property
    def stuff_classes(self):
        return sorted(cid for cid, c in self.categories.items() if not c.get("isthing", 1))

    @property
    def thing_classes(self):
        return sorted(cid for cid, c in self.categories.items() if c.get("isthing", 1))

    def image_ids(self):
        return sorted(self.anns.keys())


def decode_segment_png(png: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB panoptic PNG -> (H, W) int32 segment-id map."""
    png = png.astype(np.int32)
    return png[..., 0] + 256 * png[..., 1] + (256 * 256) * png[..., 2]


def segments_to_masks(id_map: np.ndarray, segments_info
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Segment-id map + segments_info -> (masks (N, H, W) uint8, classes
    (N,) int32, iscrowd (N,) bool, void (H, W) bool). ``void`` covers id-0
    pixels and every pixel whose id has no segments_info entry."""
    known = np.zeros(id_map.shape, bool)
    masks, classes, iscrowd = [], [], []
    for seg in segments_info:
        m = id_map == int(seg["id"])
        known |= m
        masks.append(m.astype(np.uint8))
        classes.append(int(seg["category_id"]))
        iscrowd.append(bool(seg.get("iscrowd", 0)))
    h, w = id_map.shape
    return (np.stack(masks) if masks else np.zeros((0, h, w), np.uint8),
            np.asarray(classes, np.int32), np.asarray(iscrowd, bool), ~known)


def _open(config, ann_file, png_dir, img_dir):
    """The index, directories, class names and background class of a set."""
    ann_file = ann_file or config.data.full_ann_file
    img_dir = img_dir or config.data.full_img_dir
    if png_dir is None:
        png_dir = os.path.splitext(ann_file)[0]  # COCO's convention
    index = PanopticIndex(ann_file)
    max_id = max(index.categories) if index.categories else 0
    class_names = ["N/A"] * (max_id + 2)
    class_names[-1] = "back"
    for cid, c in index.categories.items():
        class_names[cid] = c["name"]
    return index, png_dir, img_dir, class_names, max_id + 1


def _read_segments(index, img_id, png_dir, img_dir):
    """An image and its segments (``segments_to_masks``' four arrays)."""
    ann = index.anns[img_id]
    image = read_image(os.path.join(img_dir, index.images[img_id]["file_name"]))
    id_map = decode_segment_png(read_image(os.path.join(png_dir, ann["file_name"])))
    return image, ann, segments_to_masks(id_map, ann["segments_info"])


def _with_attributes(dataset, index, background_class):
    dataset.background_class = background_class
    dataset.stuff_classes = index.stuff_classes
    dataset.thing_classes = index.thing_classes
    return dataset


def load_coco_panoptic_train(config, batch_size: int, ann_file: Optional[str] = None,
                             png_dir: Optional[str] = None, img_dir: Optional[str] = None,
                             num_workers: int = 4, shuffle: bool = True, seed: int = 0):
    """Panoptic training set, the DETR-panoptic recipe: every non-crowd
    segment, stuff included, is one (box, class, mask) target, its box taken
    from its mask. Yields the detection train batches (images, boxes,
    classes, mask, and ``t_masks`` at stride 4 slotted like the boxes,
    ``config.num_queries`` slots), augmented as the detection train path
    with the masks carried through; the ordinary ``Trainer`` with the mask
    losses trains on them. Size the head past the stuff ids.

    Returns (dataset, class_names); the dataset carries
    ``background_class``, ``stuff_classes`` and ``thing_classes``.
    """
    index, png_dir, img_dir, class_names, background_class = _open(config, ann_file, png_dir,
                                                                   img_dir)
    worker_rng = WorkerRNG(seed)
    max_t = getattr(config, "num_queries", 100)

    def load_example(img_id):
        image, _, (masks, classes, iscrowd, _) = _read_segments(index, img_id, png_dir, img_dir)
        keep = ~iscrowd
        masks, classes = masks[keep], classes[keep]
        if len(masks) == 0:
            return None
        h, w = image.shape[:2]
        boxes = []
        for m in masks:
            ys, xs = np.nonzero(m)
            x0, x1 = xs.min(), xs.max() + 1
            y0, y1 = ys.min(), ys.max() + 1
            boxes.append([(x0 + x1) / 2 / w, (y0 + y1) / 2 / h, (x1 - x0) / w, (y1 - y0) / h])
        image, t_bbox, t_class, masks = transforms.detr_transform(
            image, np.asarray(boxes, np.float32), classes, config, augmentation=True,
            rng=worker_rng.get(), masks=masks)
        if len(t_bbox) == 0:
            return None
        b, c, mask = processing.pad_targets(t_bbox, t_class, max_targets=max_t)
        return {"images": processing.normalized_images(image, config).astype(np.float32),
                "boxes": b, "classes": c, "mask": mask,
                "t_masks": seg_masks.pad_instance_masks(masks, max_t)}

    dataset = HostDataset(index.image_ids(), load_example, batch_size, shuffle=shuffle,
                          seed=seed, num_workers=num_workers)
    return _with_attributes(dataset, index, background_class), class_names


def load_coco_panoptic(config, batch_size: int = 1, ann_file: Optional[str] = None,
                       png_dir: Optional[str] = None, img_dir: Optional[str] = None,
                       bucket_divisor: int = 128, num_workers: int = 4, shuffle: bool = False):
    """Panoptic evaluation set, batch 1 (the ground truth is ragged).

    Yields ``make_eval_example`` batches (images, pixel_mask, boxes,
    classes, mask, t_masks) with the full-resolution panoptic ground truth
    in the bucket frame:

      * ``t_masks_full`` (n, PH, PW) uint8: every segment, things and stuff,
        crowd included;
      * ``gt_is_crowd`` (n,) bool;
      * ``void_mask`` (PH, PW) bool: the unlabeled pixels (the bucket's
        padding is not void).

    Returns (dataset, class_names); the dataset carries
    ``background_class``, ``stuff_classes`` and ``thing_classes``.
    """
    if batch_size != 1:
        raise ValueError("panoptic eval is batch-1 (ragged ground truth)")
    index, png_dir, img_dir, class_names, background_class = _open(config, ann_file, png_dir,
                                                                   img_dir)

    def load_example(img_id):
        image, ann, (masks, classes, iscrowd, void) = _read_segments(index, img_id, png_dir,
                                                                     img_dir)
        if len(masks) == 0:
            return None
        h, w = image.shape[:2]
        boxes = []  # from segments_info when it has them, else from the masks
        for seg, m in zip(ann["segments_info"], masks):
            if "bbox" in seg:
                x, y, bw, bh = seg["bbox"]
            else:
                ys, xs = np.nonzero(m)
                x, y = xs.min(), ys.min()
                bw, bh = xs.max() - x + 1, ys.max() - y + 1
            boxes.append([(x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h])
        example = processing.make_eval_example(
            image, np.asarray(boxes, np.float32), classes, config, bucket_divisor,
            inst_masks=masks, full_res_masks=True)
        ph, pw = example["pixel_mask"].shape
        void_padded = np.zeros((ph, pw), bool)
        void_padded[:h, :w] = void
        example["gt_is_crowd"] = iscrowd
        example["void_mask"] = void_padded
        return example

    dataset = HostDataset(index.image_ids(), load_example, batch_size, shuffle=shuffle,
                          num_workers=num_workers)
    return _with_attributes(dataset, index, background_class), class_names
