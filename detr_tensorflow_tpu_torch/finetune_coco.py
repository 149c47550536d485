"""Finetune DETR with its COCO heads on COCO, transformers only, with the
port (twin of the repository's ``finetune_coco.py``).

  python -m detr_tensorflow_tpu_torch.finetune_coco --data_dir /path/coco \\
      --img_dir train2017 --ann_file annotations/instances_train2017.json \\
      --batch_size 8 --weights detr_r50.npz [--device cpu]

``--weights`` is the pretrained model: a JAX-format ``.npz``, a facebook
(``detr-r50-e632da11.pth``) or HuggingFace torch checkpoint, or a short
name (``detr``) under ``weights/detr`` or ``$DETR_TPU_WEIGHTS``; without it
the model starts from its seeded initialization.
"""

from __future__ import annotations

import sys

from .data import load_coco_dataset
from .models import get_detr_model
from .train import Trainer, TrainingConfig
from .train.workflow import (
    SPAWNED, data_parallel_mesh, entry_parser, run_epochs, shard_loaders,
)


def main(argv=None, **model_kwargs) -> Trainer:
    """Parse ``argv`` and finetune; returns the trainer (None in a process
    that spawned ``--data_parallel`` ranks). ``model_kwargs``
    go to ``get_detr_model``."""
    args = entry_parser("Finetune DETR on COCO (PyTorch port)").parse_args(argv)
    config = TrainingConfig(train_transformers=True, batch_size=8,
                            target_batch=32).update_from_args(args)
    mesh = data_parallel_mesh(main, argv, model_kwargs, config, args)
    if mesh is SPAWNED:
        return None
    train_dt, class_names = load_coco_dataset(config, config.batch_size, augmentation=True,
                                              num_workers=args.num_workers, seed=args.seed)
    valid_dt, _ = load_coco_dataset(config, config.batch_size, augmentation=False,
                                    shuffle=False, num_workers=args.num_workers)
    config = config.replace(background_class=train_dt.background_class)
    model_kwargs.setdefault("device", args.device)
    model = get_detr_model(config, include_top=True, weights=config.weights, **model_kwargs)
    shard_loaders(mesh, train_dt, valid_dt)
    trainer = Trainer(model.module, config, seed=args.seed, mesh=mesh)
    run_epochs(trainer, train_dt, valid_dt, config, args, evaluation_step=200,
               class_names=class_names)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
