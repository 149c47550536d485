"""The training step, its optimizer, checkpoints and the fit/eval loops."""

from .checkpoint import latest_step, restore_checkpoint, restore_latest, save_checkpoint  # noqa: F401
from .config import DataConfig, TrainingConfig, training_config_parser  # noqa: F401
from .engine import (  # noqa: F401
    PreemptionGuard, Trainer, eval_loop, fit, make_eval_step, make_train_step,
)
