"""Checkpointing with resume (port of ``detr_tensorflow_tpu/train/checkpoint.py``,
``torch.save`` in place of Orbax).

A checkpoint is ``<ckpt_dir>/<step>.pt`` holding ``Trainer.state_dict()``:
parameters, FrozenBN buffers, the Adam moments of all three groups,
accumulation buffers, the step count and the dropout generator's state.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def save_checkpoint(trainer, ckpt_dir: str, step: Optional[int] = None) -> str:
    """Write the trainer's full state as ``ckpt_dir/<step>.pt``."""
    step = trainer.steps if step is None else int(step)
    os.makedirs(_abs(ckpt_dir), exist_ok=True)
    path = os.path.join(_abs(ckpt_dir), f"{step}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(trainer.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    ckpt_dir = _abs(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f[:-3]) for f in os.listdir(ckpt_dir) if f.endswith(".pt") and f[:-3].isdigit()]
    return max(steps) if steps else None


def restore_checkpoint(trainer, ckpt_dir: str, step: int):
    """Load ``ckpt_dir/<step>.pt`` into ``trainer`` (built with the same
    model and config) and return it."""
    path = os.path.join(_abs(ckpt_dir), f"{int(step)}.pt")
    trainer.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return trainer


def restore_latest(trainer, ckpt_dir: str):
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    return restore_checkpoint(trainer, ckpt_dir, step)
