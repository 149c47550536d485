"""Train DETR from scratch on COCO with the port (twin of the repository's
``train_coco.py``): backbone and transformer trained, the fresh heads too,
one validation pass then one training epoch per outer iteration.

  python -m detr_tensorflow_tpu_torch.train_coco --data_dir /path/coco \\
      --img_dir train2017 --ann_file annotations/instances_train2017.json \\
      --batch_size 8 --target_batch 32 [--backbone_weights resnet50.pth] \\
      [--checkpoint_dir DIR] [--device cpu]

``--backbone_weights`` starts the backbone from a local torchvision
ImageNet ResNet, with the torch input normalization; without it the
backbone starts from the seeded initialization and takes the caffe-style
``tf_resnet`` normalization, as the JAX script does.
"""

from __future__ import annotations

import sys

from .data import load_coco_dataset
from .data.coco_api import CocoIndex
from .models import get_detr_model
from .train import Trainer, TrainingConfig
from .train.workflow import (
    SPAWNED, data_parallel_mesh, entry_parser, run_epochs, shard_loaders,
)


def main(argv=None, **model_kwargs) -> Trainer:
    """Parse ``argv`` and train; returns the trainer (None in a process that
    spawned ``--data_parallel`` ranks). ``model_kwargs`` go
    to ``get_detr_model`` (a smaller model for tests)."""
    args = entry_parser("Train DETR on COCO (PyTorch port)").parse_args(argv)
    config = TrainingConfig(train_backbone=True, train_transformers=True, batch_size=8,
                            target_batch=32).update_from_args(args)
    mesh = data_parallel_mesh(main, argv, model_kwargs, config, args)
    if mesh is SPAWNED:
        return None
    n_class = max(CocoIndex(config.data.full_ann_file).getCatIds()) + 2
    model_kwargs.setdefault("device", args.device)
    model = get_detr_model(config, include_top=False, nb_class=n_class, weights=config.weights,
                           tf_backbone=config.backbone_weights is None, **model_kwargs)
    config = config.replace(normalized_method=model.normalized_method, train_nlayers=True)
    train_dt, class_names = load_coco_dataset(config, config.batch_size, augmentation=True,
                                              num_workers=args.num_workers, seed=args.seed)
    valid_dt, _ = load_coco_dataset(config, config.batch_size, augmentation=False,
                                    shuffle=False, num_workers=args.num_workers)
    config = config.replace(background_class=train_dt.background_class)
    shard_loaders(mesh, train_dt, valid_dt)
    trainer = Trainer(model.module, config, seed=args.seed, mesh=mesh)
    run_epochs(trainer, train_dt, valid_dt, config, args, evaluation_step=200,
               class_names=class_names)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
