"""CSV-annotation dataset loader (port of ``detr_tensorflow_tpu/data/tfcsv.py``),
the "TensorFlow object detection CSV" format of the Hard Hat set:
``filename,width,height,class,xmin,ymin,xmax,ymax``, one row a box.

The JAX loader reads the file with pandas, which the card's machine lacks;
this one reads it with the standard library's ``csv`` and keeps the same
semantics: the class exclusion list, sorted unique class names with
"background" at 0, files in order of first appearance (``pandas.unique``),
absolute xyxy divided by each file's width and height, then xcycwh. Images
are decoded by ``data/image_io.py`` (the set's JPEGs by ``data/jpeg.py``).
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional

import numpy as np

from ..ops.boxes import np_xyxy_to_xcycwh
from . import processing, transforms
from .image_io import read_image
from .multiscale import MultiScalePlan
from .pipeline import HostDataset, WorkerRNG

_BOX_FIELDS = ("xmin", "ymin", "xmax", "ymax")


def load_tfcsv_dataset(config, batch_size: int, augmentation: Optional[bool] = False,
                       exclude: Optional[List[str]] = None, ann_dir: Optional[str] = None,
                       ann_file: Optional[str] = None, img_dir: Optional[str] = None,
                       shuffle: bool = True, num_workers: int = 8, seed: int = 0):
    """Build (dataset, class_names) from a CSV annotation file; background is
    class 0. ``augmentation`` True: train transforms at ``config.image_size``
    (or a ``config.multi_scale`` rung); False: resize only; None: the
    image as it is."""
    del ann_dir
    ann_file = ann_file or config.data.ann_file
    img_dir = img_dir or config.data.img_dir
    excluded = set(exclude or [])
    with open(os.path.join(config.data.data_dir, ann_file), newline="") as f:
        rows = [r for r in csv.DictReader(f) if r["class"] not in excluded]

    class_names = ["background"] + sorted({r["class"] for r in rows})
    by_file = {}  # filename -> its rows, files in order of first appearance
    for r in rows:
        by_file.setdefault(r["filename"], []).append(r)
    filenames = list(by_file)

    worker_rng = WorkerRNG(seed)
    ladder = getattr(config, "multi_scale", None) if augmentation is True else None
    plan = MultiScalePlan(ladder, seed) if ladder else None
    max_t = getattr(config, "num_queries", processing.MAX_TARGETS)

    def load_example(filename):
        image = read_image(os.path.join(config.data.data_dir, img_dir, filename))
        file_rows = by_file[filename]
        t_class = np.asarray([class_names.index(r["class"]) for r in file_rows], np.int32)
        w, h = float(file_rows[0]["width"]), float(file_rows[0]["height"])
        xyxy = np.asarray([[float(r[k]) for k in _BOX_FIELDS] for r in file_rows], np.float64)
        t_bbox = np_xyxy_to_xcycwh(xyxy / np.array([w, h, w, h])).astype(np.float32)
        if augmentation is not None:
            image, t_bbox, t_class = transforms.detr_transform(
                image, t_bbox, t_class, config, augmentation, rng=worker_rng.get(),
                image_size=plan.size_for(filename) if plan else None)
            if len(t_bbox) == 0:
                return None
        boxes, classes, mask = processing.pad_targets(t_bbox, t_class, max_targets=max_t)
        return {"images": processing.normalized_images(image, config).astype(np.float32),
                "boxes": boxes, "classes": classes, "mask": mask}

    dataset = HostDataset(
        filenames, load_example, batch_size, shuffle=shuffle, seed=seed, num_workers=num_workers,
        bucket_key=plan.bucket_key if plan else None,
        batch_transform=plan.batch_transform if plan else None,
        on_epoch_start=plan.set_epoch if plan else None)
    dataset.background_class = 0
    return dataset, class_names
