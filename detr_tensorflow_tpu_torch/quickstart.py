"""The whole port end to end on a synthetic set, with nothing to download
(twin of the repository's ``examples/quickstart_synthetic.py``).

  python -m detr_tensorflow_tpu_torch.quickstart [--device cpu] [--epochs 120]

Writes a small synthetic COCO set, trains a small DETR on it from scratch,
prints the box AP table of the trained model on that set, and serves two
images of other sizes through ``Predictor``.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

from .data import load_coco_dataset, make_synthetic_coco
from .eval import eval_model
from .models import build_detr
from .predictor import Predictor
from .train import DataConfig, Trainer, TrainingConfig, fit


def main(argv=None) -> dict:
    """Run the quickstart; returns the AP table."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="where the model runs: the card (cuda, the default) or cpu")
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--root", default=None, help="where to write the set (default: a new "
                                                "temporary directory)")
    args = p.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="detr_torch_quickstart_")
    make_synthetic_coco(root)
    print(f"synthetic COCO dataset at {root}")

    config = TrainingConfig(
        data=DataConfig(data_dir=root, img_dir="images", ann_file="ann.json"),
        image_size=(128, 128), batch_size=4, target_batch=None, train_backbone=True,
        train_transformers=True, backbone_lr=3e-3, transformers_lr=3e-3, num_queries=8)
    train_dt, class_names = load_coco_dataset(config, config.batch_size, augmentation=False,
                                              num_workers=2)
    config = config.replace(background_class=train_dt.background_class)
    print("classes:", class_names, "| background:", config.background_class)

    # A small DETR (the full architecture at shrunken widths) from scratch.
    model = build_detr(num_classes=len(class_names), num_queries=8, head="detr", model_dim=64,
                       num_heads=4, num_encoder_layers=2, num_decoder_layers=2,
                       dim_feedforward=128, dropout=0.0, backbone_stage_sizes=(1, 1, 1, 1),
                       device=args.device)
    trainer = Trainer(model.module, config)
    for epoch in range(args.epochs):
        fit(trainer, train_dt, config, epoch, log_every=10 if epoch % 20 == 0 else 10**9)

    table = eval_model(model, config, class_names, train_dt)

    predictor = Predictor(model, config.background_class, bucket_divisor=64,
                          score_threshold=0.5)
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 60, size=(100, 150, 3)).astype(np.uint8),
              rng.integers(0, 60, size=(128, 128, 3)).astype(np.uint8)]
    for i, det in enumerate(predictor(frames)):
        print(f"image {i}: {len(det.boxes)} detections above 0.5")
    print("quickstart complete.")
    return table


if __name__ == "__main__":
    main(sys.argv[1:])
