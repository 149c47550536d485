"""Pascal-VOC dataset loader (port of ``detr_tensorflow_tpu/data/voc.py``).

XML annotations with the 1-pixel origin offset, class names discovered by
scanning every annotation file, background class 0, empty images dropped.
VOC's ``.jpg`` images decode through ``imageio`` where it is installed
(``data/image_io.py``).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from . import processing, transforms
from .image_io import read_image
from .multiscale import MultiScalePlan
from .pipeline import HostDataset, WorkerRNG

VOC_CLASS_NAME = [
    "back", "aeroplane", "bicycle", "bird", "boat",
    "bottle", "bus", "car", "cat", "chair",
    "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
]


def load_voc_labels(ann_path: str, class_names):
    """Parse one VOC XML into (boxes rel-xcycwh, classes)."""
    root = ET.parse(ann_path)
    size = root.find("size")
    width = float(size.find("width").text)
    height = float(size.find("height").text)
    bbox, cls = [], []
    for obj in root.findall("object"):
        name = obj.find("name").text.lower().strip()
        bnd = obj.find("bndbox")
        xmin = (float(bnd.find("xmin").text) - 1) / width
        ymin = (float(bnd.find("ymin").text) - 1) / height
        xmax = (float(bnd.find("xmax").text) - 1) / width
        ymax = (float(bnd.find("ymax").text) - 1) / height
        bbox.append([xmin + (xmax - xmin) / 2, ymin + (ymax - ymin) / 2, xmax - xmin,
                     ymax - ymin])
        cls.append(class_names.index(name))
    return (np.asarray(bbox, np.float32).reshape(-1, 4), np.asarray(cls, np.int32).reshape(-1))


def load_voc_dataset(config, batch_size: int, augmentation: Optional[bool] = False,
                     ann_dir: Optional[str] = None, ann_file: Optional[str] = None,
                     img_dir: Optional[str] = None, shuffle: bool = True,
                     bucket_divisor: int = 128, num_workers: int = 8, seed: int = 0):
    """Build (dataset, class_names). Background class is 0."""
    del ann_file
    img_dir_full = os.path.join(config.data.data_dir, img_dir or config.data.img_dir)
    ann_dir_full = os.path.join(config.data.data_dir, ann_dir or config.data.ann_dir)
    ids = [os.path.splitext(f)[0] for f in os.listdir(img_dir_full)]

    class_names = ["back"]
    for img_id in ids:
        path = os.path.join(ann_dir_full, img_id + ".xml")
        if not os.path.exists(path):
            continue
        for obj in ET.parse(path).findall("object"):
            name = obj.find("name").text.lower().strip()
            if name not in class_names:
                class_names.append(name)

    worker_rng = WorkerRNG(seed)
    ladder = getattr(config, "multi_scale", None) if augmentation is True else None
    plan = MultiScalePlan(ladder, seed) if ladder else None
    max_t = getattr(config, "num_queries", processing.MAX_TARGETS)

    def load_example(img_id):
        img_path = os.path.join(img_dir_full, img_id + ".jpg")
        ann_path = os.path.join(ann_dir_full, img_id + ".xml")
        if not (os.path.exists(img_path) and os.path.exists(ann_path)):
            return None
        image = read_image(img_path)
        t_bbox, t_class = load_voc_labels(ann_path, class_names)
        if len(t_bbox) == 0:
            return None
        if augmentation is None:
            return processing.make_eval_example(image, t_bbox, t_class, config, bucket_divisor)
        image, t_bbox, t_class = transforms.detr_transform(
            image, t_bbox, t_class, config, augmentation, rng=worker_rng.get(),
            image_size=plan.size_for(img_id) if plan else None)
        if len(t_bbox) == 0:
            return None
        boxes, classes, mask = processing.pad_targets(t_bbox, t_class, max_targets=max_t)
        return {"images": processing.normalized_images(image, config).astype(np.float32),
                "boxes": boxes, "classes": classes, "mask": mask}

    dataset = HostDataset(
        ids, load_example, batch_size, shuffle=shuffle, seed=seed, num_workers=num_workers,
        bucket_key=plan.bucket_key if plan else None,
        batch_transform=plan.batch_transform if plan else None,
        on_epoch_start=plan.set_epoch if plan else None)
    dataset.background_class = 0
    return dataset, class_names
