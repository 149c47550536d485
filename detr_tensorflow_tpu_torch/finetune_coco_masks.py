"""Train the instance-segmentation head on COCO with the detector frozen,
with the port (twin of the repository's ``finetune_coco_masks.py``): the
DETR paper's recipe, the detector trained first, then the mask head alone
on top of its frozen weights. The mask head and the attention-map
projections are the "nlayers" optimizer group, so training that group
alone is frozen-detector mask training: the backbone and the transformer
take no gradient and no Adam step.

  python -m detr_tensorflow_tpu_torch.finetune_coco_masks --data_dir /path/coco \\
      --img_dir train2017 --ann_file annotations/instances_train2017.json \\
      --batch_size 8 --weights detr-r50.pth [--device cpu]

``--weights`` is the detector (or a segmentation checkpoint to continue
from): a JAX-format ``.npz``, a facebook or HuggingFace torch checkpoint,
or a short name under ``weights/detr`` or ``$DETR_TPU_WEIGHTS``; a
detection checkpoint leaves the mask head at its seeded initialization.

With ``--panoptic_ann panoptic_train2017.json [--panoptic_png_dir DIR]``
the targets come from COCO's panoptic annotations instead
(``data/panoptic.py``): every segment, stuff included, is a (box, class,
mask) target, the DETR-panoptic recipe; size the head past the stuff ids
(202 logits for COCO panoptic: ``main(argv, num_classes=202)``). There is
no evaluation set then: panoptic metrics are ``eval --masks --pq
--panoptic_ann``.
"""

from __future__ import annotations

import sys

from .data import load_coco_dataset, load_coco_panoptic_train
from .models import get_detr_model
from .train import Trainer, TrainingConfig
from .train.workflow import (
    SPAWNED, data_parallel_mesh, entry_parser, run_epochs, shard_loaders,
)


def main(argv=None, **model_kwargs) -> Trainer:
    """Parse ``argv`` and train the mask head; returns the trainer (None in a
    process that spawned ``--data_parallel`` ranks).
    ``model_kwargs`` go to ``get_detr_model``."""
    p = entry_parser("Train DETR's mask head on COCO, the detector frozen (PyTorch port)",
                     epochs=25)
    p.add_argument("--panoptic_ann", default=None,
                   help="a COCO panoptic_*.json: train on its things and stuff segments "
                        "instead of the instance masks")
    p.add_argument("--panoptic_png_dir", default=None,
                   help="the panoptic segment-id PNGs (default: the annotation path without "
                        ".json)")
    args = p.parse_args(argv)
    config = TrainingConfig(train_backbone=False, train_transformers=False, train_nlayers=True,
                            batch_size=8, target_batch=32).update_from_args(args)
    mesh = data_parallel_mesh(main, argv, model_kwargs, config, args)
    if mesh is SPAWNED:
        return None
    if args.panoptic_ann:
        train_dt, class_names = load_coco_panoptic_train(
            config, config.batch_size, ann_file=args.panoptic_ann,
            png_dir=args.panoptic_png_dir, num_workers=args.num_workers, seed=args.seed)
        valid_dt = None  # panoptic metrics: eval --masks --pq --panoptic_ann
    else:
        train_dt, class_names = load_coco_dataset(config, config.batch_size, augmentation=True,
                                                  include_masks=True,
                                                  num_workers=args.num_workers, seed=args.seed)
        valid_dt, _ = load_coco_dataset(config, config.batch_size, augmentation=False,
                                        shuffle=False, include_masks=True,
                                        num_workers=args.num_workers)
    config = config.replace(background_class=train_dt.background_class)
    model_kwargs.setdefault("device", args.device)
    model = get_detr_model(config, include_top=True, weights=config.weights, masks=True,
                           **model_kwargs)
    shard_loaders(mesh, train_dt, valid_dt)
    trainer = Trainer(model.module, config, seed=args.seed, mesh=mesh)
    run_epochs(trainer, train_dt, valid_dt, config, args, evaluation_step=200,
               class_names=class_names)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
