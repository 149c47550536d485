"""The training step, its optimizer and checkpoints."""

from .checkpoint import latest_step, restore_checkpoint, restore_latest, save_checkpoint  # noqa: F401
from .config import TrainingConfig  # noqa: F401
from .engine import Trainer, eval_loop, fit, make_eval_step, make_train_step  # noqa: F401
