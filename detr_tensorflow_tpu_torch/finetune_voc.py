"""Finetune DETR on Pascal VOC with fresh heads and a staged unfreeze, with
the port (twin of the repository's ``finetune_voc.py``): epoch 0 trains the
heads only at 1e-3, from epoch 1 the transformer joins at 1e-4.

  python -m detr_tensorflow_tpu_torch.finetune_voc --data_dir /path/VOC2012 \\
      --img_dir JPEGImages --ann_dir Annotations --batch_size 8 \\
      --target_batch 32 --weights detr_r50.npz [--device cpu]

``--weights`` takes a JAX-format ``.npz``, a facebook or HuggingFace torch
checkpoint or a short name (its trunk loads, the heads start fresh). VOC's
JPEG images decode through ``data/jpeg.py``.
"""

from __future__ import annotations

import sys

from .data import load_voc_dataset
from .models import get_detr_model
from .train import Trainer, TrainingConfig
from .train.workflow import (
    SPAWNED, data_parallel_mesh, entry_parser, run_epochs, shard_loaders,
)


def main(argv=None, **model_kwargs) -> Trainer:
    """Parse ``argv`` and finetune; returns the trainer (None in a process
    that spawned ``--data_parallel`` ranks). ``model_kwargs``
    go to ``get_detr_model``."""
    args = entry_parser("Finetune DETR on Pascal VOC (PyTorch port)").parse_args(argv)
    config = TrainingConfig(background_class=0, train_nlayers=True, nlayers_lr=1e-3,
                            batch_size=8, target_batch=32,
                            image_size=(480, 720)).update_from_args(args)
    mesh = data_parallel_mesh(main, argv, model_kwargs, config, args)
    if mesh is SPAWNED:
        return None
    train_dt, class_names = load_voc_dataset(config, config.batch_size, augmentation=True,
                                             num_workers=args.num_workers, seed=args.seed)
    valid_dt, _ = load_voc_dataset(config, config.batch_size, augmentation=False,
                                   shuffle=False, num_workers=args.num_workers)
    model_kwargs.setdefault("device", args.device)
    model = get_detr_model(config, include_top=False, nb_class=len(class_names),
                           weights=config.weights, **model_kwargs)
    shard_loaders(mesh, train_dt, valid_dt)
    trainer = Trainer(model.module, config, seed=args.seed, mesh=mesh)

    def unfreeze(epoch: int) -> None:
        if epoch == 1:
            trainer.set_trainable(train_transformers=True)
            trainer.set_learning_rates(transformers=1e-4, nlayers=1e-4)

    run_epochs(trainer, train_dt, valid_dt, config, args, evaluation_step=100,
               before_epoch=unfreeze, class_names=class_names)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
