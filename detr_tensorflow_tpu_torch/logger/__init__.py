"""Observability (port of ``detr_tensorflow_tpu/logger``): scalar and
image logging to Weights & Biases, box-overlay images, and the validation
mAP accumulated over an evaluation pass."""

from .training_logging import train_log, valid_log  # noqa: F401
from .wandb_logging import WandbSender  # noqa: F401
