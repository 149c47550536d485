"""Training configuration (port of ``detr_tensorflow_tpu/train/config.py``).

A frozen dataclass: what a component discovers (the dataset's background
class) is returned and folded into a new config with ``replace``.
Learning rates are runtime values: the trainer reads them at every step,
so a change (``Trainer.set_learning_rates``) takes effect at once. The
TPU-only knob of the JAX config (``auto_input_layout``) has no field here.
``data_parallel`` is the number of DDP ranks the entry points train on
(``train/workflow.py``: torchrun's ranks, or as many local ranks spawned).
``weights`` (a JAX-format
``.npz``, a torch DETR checkpoint or a short name) feeds
``build_detr(weights=)``; ``dilation`` (DC5) and ``backbone_weights`` (a
local torchvision ResNet) feed ``get_detr_model``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths."""

    data_dir: Optional[str] = None
    img_dir: Optional[str] = None
    ann_file: Optional[str] = None
    ann_dir: Optional[str] = None

    @property
    def full_img_dir(self) -> Optional[str]:
        if self.data_dir and self.img_dir:
            return os.path.join(self.data_dir, self.img_dir)
        return self.img_dir

    @property
    def full_ann_file(self) -> Optional[str]:
        if self.data_dir and self.ann_file:
            return os.path.join(self.data_dir, self.ann_file)
        return self.ann_file

    @property
    def full_ann_dir(self) -> Optional[str]:
        if self.data_dir and self.ann_dir:
            return os.path.join(self.data_dir, self.ann_dir)
        return self.ann_dir


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    background_class: int = 0
    image_size: Tuple[int, int] = (376, 672)  # (height, width)

    # What to train
    train_backbone: bool = False
    train_transformers: bool = False
    train_nlayers: bool = False

    # How to train
    finetuning: bool = False
    batch_size: int = 1
    gradient_norm_clipping: float = 0.1  # per tensor (Keras clipnorm)
    target_batch: Optional[int] = 1  # virtual batch via accumulation

    # Learning rates (read at every step)
    backbone_lr: float = 1e-5
    transformers_lr: float = 1e-4
    nlayers_lr: float = 1e-4

    log: bool = False
    normalized_method: str = "torch_resnet"  # "torch_resnet" | "tf_resnet"
    # A ladder of (H, W) train sizes: each example trains at one rung and
    # batches are bucketed by shape (data/multiscale.py). None: image_size.
    multi_scale: Optional[Tuple[Tuple[int, int], ...]] = None

    backbone_depth: int = 50  # 50 | 101
    dilation: bool = False  # DC5: stride-16 C5 via dilated convs
    compute_dtype: str = "float32"
    attn_impl: str = "auto"  # "auto" | "kernel" | "plain" (models/transformer.py)
    lap_impl: str = "auto"  # "auto" | "kernel" | "plain" (ops/matcher.py)
    num_queries: int = 100
    checkpoint_dir: Optional[str] = None
    # DDP ranks; batch_size is the global batch and must divide by it.
    data_parallel: int = 1
    weights: Optional[str] = None  # build_detr(weights=): .npz, torch checkpoint or name
    # Local torchvision resnet checkpoint for ImageNet backbone init.
    backbone_weights: Optional[str] = None

    @property
    def gradient_aggregate(self) -> int:
        """Micro-steps per applied update: target_batch // batch_size."""
        if self.target_batch is None:
            return 1
        return max(1, int(self.target_batch) // int(self.batch_size))

    def replace(self, **kw) -> "TrainingConfig":
        return dataclasses.replace(self, **kw)

    def update_from_args(self, args: argparse.Namespace) -> "TrainingConfig":
        """Fold parsed CLI args (None = not given) into a new config."""
        kw = {}
        for f in dataclasses.fields(self):
            if f.name == "data" or getattr(args, f.name, None) is None:
                continue
            v = getattr(args, f.name)
            if f.name == "image_size":
                v = tuple(v)
            elif f.name == "multi_scale":
                if len(v) % 2:
                    raise SystemExit("--multi_scale takes H W pairs (even count)")
                v = tuple((int(v[i]), int(v[i + 1])) for i in range(0, len(v), 2))
            kw[f.name] = v
        data = DataConfig(data_dir=getattr(args, "data_dir", None),
                          img_dir=getattr(args, "img_dir", None),
                          ann_file=getattr(args, "ann_file", None),
                          ann_dir=getattr(args, "ann_dir", None))
        return self.replace(data=data, **kw)


def training_config_parser() -> argparse.ArgumentParser:
    """The JAX package's training flags, with the port's own values for
    ``--attn_impl`` and ``--lap_impl`` and ``--weights`` for a local
    checkpoint."""
    p = argparse.ArgumentParser(description="detr_tensorflow_tpu_torch training")
    # Dataset
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--img_dir", type=str, default=None)
    p.add_argument("--ann_file", type=str, default=None)
    p.add_argument("--ann_dir", type=str, default=None)
    p.add_argument("--background_class", type=int, default=None)
    p.add_argument("--image_size", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="fixed train/resize size (default 376 672)")
    p.add_argument("--multi_scale", type=int, nargs="+", default=None, metavar="N",
                   help="multi-scale training size ladder as H W pairs, e.g. "
                        "--multi_scale 320 576 376 672 432 768; batches are grouped by size")
    # What to train
    p.add_argument("--train_backbone", action="store_true", default=None)
    p.add_argument("--train_transformers", action="store_true", default=None)
    p.add_argument("--train_nlayers", action="store_true", default=None)
    # How to train
    p.add_argument("--finetuning", action="store_true", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--gradient_norm_clipping", type=float, default=None)
    p.add_argument("--target_batch", type=int, default=None)
    # Learning rates
    p.add_argument("--backbone_lr", type=float, default=None)
    p.add_argument("--transformers_lr", type=float, default=None)
    p.add_argument("--nlayers_lr", type=float, default=None)
    # Logging
    p.add_argument("--log", action="store_true", default=None)
    # Model and kernels
    p.add_argument("--compute_dtype", type=str, default=None, choices=["float32", "bfloat16"])
    p.add_argument("--attn_impl", type=str, default=None, choices=["auto", "kernel", "plain"],
                   help="attention: the CUDA kernels on the card (auto, kernel) or plain torch")
    p.add_argument("--lap_impl", type=str, default=None, choices=["auto", "kernel", "plain"],
                   help="Hungarian-matching LAP solver: the CUDA kernel or the plain version")
    p.add_argument("--backbone_depth", type=int, default=None, choices=[50, 101],
                   help="ResNet depth: DETR-R50 (default) or DETR-R101")
    p.add_argument("--dilation", action="store_true", default=None,
                   help="DC5 variant: dilated stride-16 final stage")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--data_parallel", type=int, default=None,
                   help="train on N DDP ranks: under torchrun its ranks, otherwise N local "
                        "ranks spawned (one per card; Gloo ranks with --device cpu); "
                        "--batch_size is the global batch and must divide by N")
    p.add_argument("--backbone_weights", type=str, default=None,
                   help="local torchvision resnet50/101 .pth for ImageNet "
                        "backbone initialization")
    p.add_argument("--weights", type=str, default=None,
                   help="the model's weights: a JAX-format .npz (DetrModel.save), a facebook "
                        "or HuggingFace DETR .pth/.bin, or a short name under weights/detr "
                        "or $DETR_TPU_WEIGHTS")
    return p
