#!/usr/bin/env python3
"""Time the port's host loader, stage by stage, on this machine's CPU.

  python3 scripts/torch_loader_probe.py [--images 6] [--repeat 5]

Writes a synthetic COCO set at COCO-like sizes (480x640, 427x640, 640x480,
1-20 boxes), then prints the milliseconds per image of each stage at the
training size 376x672: PNG decode, each resampling mode, the scale warp,
normalization and the whole augmentation (``detr_transform``), and the
images/s of one ``load_coco_dataset`` epoch with 1 and 8 worker threads.
CPU times only: they say nothing about the card.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from detr_tensorflow_tpu_torch.data import (  # noqa: E402
    image_io, load_coco_dataset, make_synthetic_coco, processing, transforms,
)
from detr_tensorflow_tpu_torch.train import DataConfig, TrainingConfig  # noqa: E402

SIZES = [(480, 640), (427, 640), (640, 480)]
TRAIN_HW = (376, 672)


def per_call_ms(fn, repeat):
    fn()
    t = time.perf_counter()
    for _ in range(repeat):
        fn()
    return 1e3 * (time.perf_counter() - t) / repeat


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--repeat", type=int, default=5)
    args = p.parse_args()
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_coco(root, n_images=args.images, seed=0, sizes=SIZES,
                            boxes_per_image=(1, 20))
        path = os.path.join(root, "images", "img0.png")
        image = image_io.read_image(path)
        config = TrainingConfig(data=DataConfig(data_dir=root, img_dir="images",
                                                ann_file="ann.json"),
                                image_size=TRAIN_HW, batch_size=8)
        h, w = TRAIN_HW
        rows = [("PNG decode", lambda: image_io.read_image(path))]
        rows += [(f"resize {m}", lambda m=m: transforms.resize(image, h, w, m))
                 for m in transforms.INTERPOLATIONS]
        rows.append(("warp_scale", lambda: transforms.warp_scale(image, 0.8, 1.2, 320, 240)))
        rows.append(("normalize", lambda: processing.normalized_images(image, config)))
        boxes = np.array([[0.5, 0.5, 0.2, 0.2]] * 5, np.float32)
        rng = np.random.default_rng(0)
        rows.append(("detr_transform", lambda: transforms.detr_transform(
            image, boxes, np.arange(5), config, True, rng=rng)))
        for name, fn in rows:
            print(f"{name:>16}: {per_call_ms(fn, args.repeat):8.2f} ms an image "
                  f"({image.shape[0]}x{image.shape[1]}"
                  + (f" -> {h}x{w})" if name.startswith(("resize", "detr")) else ")"))
        for workers in (1, 8):
            loader, _ = load_coco_dataset(config, 8, augmentation=True, num_workers=workers)
            t, n = time.perf_counter(), 0
            for _ in range(2):
                for batch in loader:
                    n += len(batch["images"])
            print(f"load_coco_dataset, {workers} thread(s): {n / (time.perf_counter() - t):.1f} "
                  "images/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
