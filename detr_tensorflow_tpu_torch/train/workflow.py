"""What the training entry points share (``train_coco``, ``finetune_coco``,
``finetune_voc``): their flags beyond the training config's, and the outer
loop of one validation pass then one training epoch, checkpointed after
each epoch when ``--checkpoint_dir`` is set."""

from __future__ import annotations

import argparse
import itertools
from typing import Callable, Optional

from .checkpoint import save_checkpoint
from .config import training_config_parser
from .engine import Trainer, eval_loop, fit


def entry_parser(description: str, epochs: int = 100) -> argparse.ArgumentParser:
    """``training_config_parser`` with the entry points' run flags."""
    p = training_config_parser()
    p.description = description
    p.add_argument("--device", default="cuda",
                   help="where the model runs: the card (cuda, the default) or cpu")
    p.add_argument("--epochs", type=int, default=epochs)
    p.add_argument("--steps_per_epoch", type=int, default=None,
                   help="stop each epoch after this many steps (default: the whole set)")
    p.add_argument("--evaluation_steps", type=int, default=None,
                   help="validation batches before each epoch (default: the script's)")
    p.add_argument("--num_workers", type=int, default=8, help="data loading threads")
    p.add_argument("--seed", type=int, default=0,
                   help="the data order's and the dropout generator's seed")
    return p


def run_epochs(trainer: Trainer, train_dt, valid_dt, config, args, evaluation_step: int,
               before_epoch: Optional[Callable[[int], None]] = None) -> bool:
    """``args.epochs`` times: a validation pass over at most
    ``evaluation_step`` batches (``--evaluation_steps`` overrides it), then
    one training epoch (at most ``--steps_per_epoch`` steps). A
    ``valid_dt`` of None skips the validation pass. Returns False when an
    epoch was preempted."""
    if args.evaluation_steps is not None:
        evaluation_step = args.evaluation_steps
    for epoch in range(args.epochs):
        if before_epoch is not None:
            before_epoch(epoch)
        if evaluation_step > 0 and valid_dt is not None:
            eval_loop(trainer, valid_dt, config, evaluation_step=evaluation_step)
        data = (train_dt if args.steps_per_epoch is None
                else itertools.islice(train_dt, args.steps_per_epoch))
        if not fit(trainer, data, config, epoch):
            return False
        if config.checkpoint_dir:
            save_checkpoint(trainer, config.checkpoint_dir)
    return True
