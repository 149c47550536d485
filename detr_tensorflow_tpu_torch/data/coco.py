"""COCO dataset loader (port of ``detr_tensorflow_tpu/data/coco.py``).

The class-name table with N/A gaps and a trailing "back" background class
at max category id + 1, relative xcycwh boxes, crowd and empty images
dropped, shuffled fixed-slot batches; images read by ``data/image_io.py``
(COCO's JPEGs by ``data/jpeg.py``, bit-equal to the JAX loader's imageio)
and transformed by ``data/transforms.py``. ``include_masks`` rasterizes each
annotation's segmentation (``data/masks.py``) and carries the instance masks
through the transforms as ``t_masks`` (T, H/4, W/4); ``full_res_masks`` adds
``t_masks_full`` to an evaluation example.
"""

import os
from typing import Optional, Tuple

import numpy as np

from . import masks as seg_masks
from . import processing, transforms
from .coco_api import CocoIndex
from .image_io import read_image
from .multiscale import MultiScalePlan
from .pipeline import HostDataset, WorkerRNG

# Display names for the standard 91-id COCO category space + "back".
COCO_CLASS_NAME = [
    "N/A", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "N/A",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "N/A", "backpack",
    "umbrella", "N/A", "N/A", "handbag", "tie", "suitcase", "frisbee", "skis",
    "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
    "skateboard", "surfboard", "tennis racket", "bottle", "N/A", "wine glass",
    "cup", "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich",
    "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake",
    "chair", "couch", "potted plant", "bed", "N/A", "dining table", "N/A",
    "N/A", "toilet", "N/A", "tv", "laptop", "mouse", "remote", "keyboard",
    "cell phone", "microwave", "oven", "toaster", "sink", "refrigerator",
    "N/A", "book", "clock", "vase", "scissors", "teddy bear", "hair drier",
    "toothbrush", "back",
]


def get_coco_labels(coco: CocoIndex, img_id: int, image_shape, include_masks: bool = False):
    """Boxes (n, 4) relative xcycwh, classes (n,) and the is_crowd flag of
    one image; with ``include_masks`` also its instance masks, (n, H, W)
    uint8."""
    h, w = float(image_shape[0]), float(image_shape[1])
    ih, iw = int(image_shape[0]), int(image_shape[1])
    bbox, cls, crowd, masks = [], [], 0, []
    for ann in coco.loadAnnsForImage(img_id):
        x, y, bw, bh = ann["bbox"]
        if ann.get("iscrowd", 0):
            crowd = 1
        bbox.append([(x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h])
        cls.append(ann["category_id"])
        if include_masks:
            masks.append(seg_masks.ann_to_mask(ann, ih, iw))
    out = (np.asarray(bbox, np.float32).reshape(-1, 4), np.asarray(cls, np.int32).reshape(-1),
           crowd)
    if include_masks:
        return out + (np.stack(masks) if masks else np.zeros((0, ih, iw), np.uint8),)
    return out


def load_coco_dataset(config, batch_size: int, augmentation: Optional[bool] = False,
                      ann_dir: Optional[str] = None, ann_file: Optional[str] = None,
                      img_dir: Optional[str] = None, shuffle: bool = True,
                      bucket_divisor: int = 128, num_workers: int = 8, seed: int = 0,
                      include_masks: bool = False,
                      paper_protocol: Optional[Tuple[int, int]] = None,
                      full_res_masks: bool = False,
                      multi_scale: Optional[Tuple[Tuple[int, int], ...]] = None):
    """Build (dataset, class_names); ``dataset.background_class`` is max
    category id + 1.

    augmentation:
      * True: train transforms and resize to ``config.image_size`` (or a
        ``multi_scale`` rung, batches bucketed by shape);
      * False: resize only;
      * None: original size, bucket-padded with a pixel mask (evaluation);
        with ``batch_size`` > 1, batches are bucketed by padded shape and
        each bucket's last batch is padded (``batch_valid``) so every image
        is scored once. ``paper_protocol=(min_side, max_side)`` resizes the
        shortest side first.

    ``include_masks`` adds ``t_masks`` (T, H/4, W/4) uint8, the instance
    masks slotted like the boxes at the mask head's stride-4 lattice; with
    ``augmentation=None``, ``full_res_masks`` adds ``t_masks_full`` (n, PH,
    PW) in the bucket frame (batch 1).
    """
    del ann_dir
    ann_file = ann_file or config.data.full_ann_file
    img_dir = img_dir or config.data.full_img_dir
    coco = CocoIndex(ann_file)

    cats = coco.loadCats(coco.getCatIds())
    max_id = max(c["id"] for c in cats)
    class_names = ["N/A"] * (max_id + 2)
    class_names[-1] = "back"
    for c in cats:
        class_names[c["id"]] = c["name"]

    worker_rng = WorkerRNG(seed)
    if multi_scale is None:
        multi_scale = getattr(config, "multi_scale", None)
    plan = MultiScalePlan(multi_scale, seed) if (multi_scale and augmentation is True) else None
    max_t = getattr(config, "num_queries", processing.MAX_TARGETS)

    def load_example(img_id):
        img = coco.loadImgs([img_id])[0]
        image = read_image(os.path.join(img_dir, img["file_name"]))
        labels = get_coco_labels(coco, img["id"], image.shape, include_masks=include_masks)
        t_bbox, t_class, is_crowd = labels[:3]
        inst_masks = labels[3] if include_masks else None
        if is_crowd or len(t_bbox) == 0:
            return None
        if augmentation is not None:
            out = transforms.detr_transform(
                image, t_bbox, t_class, config, augmentation, rng=worker_rng.get(),
                masks=inst_masks, image_size=plan.size_for(img_id) if plan else None)
            image, t_bbox, t_class = out[:3]
            if len(t_bbox) == 0:
                return None
            boxes, classes, mask = processing.pad_targets(t_bbox, t_class, max_targets=max_t)
            example = {"images": processing.normalized_images(image, config).astype(np.float32),
                       "boxes": boxes, "classes": classes, "mask": mask}
            if include_masks:
                example["t_masks"] = seg_masks.pad_instance_masks(out[3], max_t)
            return example
        if paper_protocol is not None:
            image = transforms.shortest_side_resize(image, paper_protocol[0], paper_protocol[1],
                                                    masks=inst_masks)
            if include_masks:
                image, inst_masks = image
        return processing.make_eval_example(image, t_bbox, t_class, config, bucket_divisor,
                                            inst_masks=inst_masks,
                                            full_res_masks=full_res_masks)

    eval_batched = augmentation is None and batch_size > 1
    dataset = HostDataset(
        coco.getImgIds(), load_example, batch_size, shuffle=shuffle, seed=seed,
        num_workers=num_workers,
        bucket_key=(plan.bucket_key if plan
                    else (lambda ex: ex["images"].shape) if eval_batched else None),
        batch_transform=plan.batch_transform if plan else None,
        on_epoch_start=plan.set_epoch if plan else None,
        pad_remainder=eval_batched)
    dataset.background_class = max_id + 1
    return dataset, class_names
