"""Training configuration (port of ``detr_tensorflow_tpu/train/config.py``).

A frozen dataclass with the fields the port's model and training step
read. Learning rates are runtime values: the trainer reads them at every
step, so a change (``Trainer.set_learning_rates``) takes effect at once.
The TPU-only knobs of the JAX config (``auto_input_layout``,
``data_parallel``) have no counterpart here; the data fields
(``image_size``, ``normalized_method``, the dataset paths, ``log``) come
with the data entry points.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    background_class: int = 0

    # What to train
    train_backbone: bool = False
    train_transformers: bool = False
    train_nlayers: bool = False

    # How to train
    batch_size: int = 1
    gradient_norm_clipping: float = 0.1  # per tensor (Keras clipnorm)
    target_batch: Optional[int] = 1  # virtual batch via accumulation

    # Learning rates (read at every step)
    backbone_lr: float = 1e-5
    transformers_lr: float = 1e-4
    nlayers_lr: float = 1e-4

    backbone_depth: int = 50  # 50 | 101
    compute_dtype: str = "float32"
    attn_impl: str = "auto"  # "auto" | "kernel" | "plain" (models/transformer.py)
    lap_impl: str = "auto"  # "auto" | "kernel" | "plain" (ops/matcher.py)
    num_queries: int = 100
    checkpoint_dir: Optional[str] = None

    @property
    def gradient_aggregate(self) -> int:
        """Micro-steps per applied update: target_batch // batch_size."""
        if self.target_batch is None:
            return 1
        return max(1, int(self.target_batch) // int(self.batch_size))

    def replace(self, **kw) -> "TrainingConfig":
        return dataclasses.replace(self, **kw)
