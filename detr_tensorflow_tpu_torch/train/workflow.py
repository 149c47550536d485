"""What the training entry points share (``train_coco``, ``finetune_coco``,
``finetune_voc``, ``finetune_hardhat``, ``finetune_coco_masks``): their
flags beyond the training config's, the ranks they train on, and the outer
loop of one validation pass then one training epoch, checkpointed after
each epoch when ``--checkpoint_dir`` is set.

``--data_parallel N`` (``data_parallel_mesh``): under torchrun's
environment each process is a rank of the process group it names; without
it, N > 1 spawns N local ranks, each running the entry point itself: one
per card (NCCL), or Gloo ranks with ``--device cpu`` (one thread each:
CPU ranks are for tests). ``--batch_size`` is the global batch: each rank
loads the same examples and keeps its rows of every batch
(``HostDataset.set_shard``), and only rank 0 prints and writes checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import os
import tempfile
from typing import Callable, Optional

import torch

from ..parallel import mesh as mesh_lib
from ..parallel import multihost
from .checkpoint import save_checkpoint
from .config import training_config_parser
from .engine import Trainer, eval_loop, fit

SPAWNED = "spawned"  # data_parallel_mesh: the ranks ran in processes of their own


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
               before_epoch: Optional[Callable[[int], None]] = None,
               class_names=None) -> bool:
    """``args.epochs`` times: a validation pass over at most
    ``evaluation_step`` batches (``--evaluation_steps`` overrides it), then
    one training epoch (at most ``--steps_per_epoch`` steps), each given the
    dataset's ``class_names`` as the JAX entry points give them. A
    ``valid_dt`` of None skips the validation pass. Returns False when an
    epoch was preempted."""
    if args.evaluation_steps is not None:
        evaluation_step = args.evaluation_steps
    for epoch in range(args.epochs):
        if before_epoch is not None:
            before_epoch(epoch)
        if evaluation_step > 0 and valid_dt is not None:
            eval_loop(trainer, valid_dt, config, class_names, evaluation_step=evaluation_step)
        data = (train_dt if args.steps_per_epoch is None
                else itertools.islice(train_dt, args.steps_per_epoch))
        if not fit(trainer, data, config, epoch, class_names):
            return False
        if config.checkpoint_dir:
            save_checkpoint(trainer, config.checkpoint_dir)
    return True


@contextlib.contextmanager
def _environ(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rank_main(rank, entry, argv, model_kwargs, world, device, init_method):
    """A spawned rank: join the process group, run the entry point."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    multihost.initialize(init_method=init_method, num_processes=world, process_id=rank,
                         device=device)
    try:
        entry(argv, **model_kwargs)
    finally:
        multihost.shutdown()


def spawn_ranks(entry: Callable, argv, model_kwargs: dict, world: int, device: str) -> None:
    """Run ``entry(argv, **model_kwargs)`` in ``world`` spawned local ranks
    joined by a file rendezvous in a temporary directory: NCCL ranks one
    per card, or single-threaded Gloo ranks on the CPU. Raises if a rank
    fails (the others are stopped)."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda" and torch.cuda.device_count() < world:
        raise ValueError(f"{world} ranks need {world} cards, {torch.cuda.device_count()} "
                         "present (torchrun places ranks on other hosts)")
    threads = {"OMP_NUM_THREADS": "1"} if torch.device(device).type == "cpu" else {}
    with tempfile.TemporaryDirectory(prefix="detr_ranks_") as tmp, _environ(**threads):
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(entry, list(argv or []), dict(model_kwargs), world, device, init),
            nprocs=world, join=False, start_method="spawn")
        while not ctx.join():
            pass


def data_parallel_mesh(entry: Callable, argv, model_kwargs: dict, config, args):
    """The mesh this process trains on (None at one process), or
    ``SPAWNED`` once ``config.data_parallel`` local ranks, spawned here,
    have each run ``entry(argv, **model_kwargs)`` to its end."""
    n = int(config.data_parallel)
    if n < 1 or config.batch_size % n:
        raise ValueError(f"--batch_size {config.batch_size} does not split over "
                         f"--data_parallel {n} ranks")
    if not torch.distributed.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            if n == 1:
                return None
            spawn_ranks(entry, argv, model_kwargs, n, args.device)
            return SPAWNED
        multihost.initialize(device=args.device)
    if multihost.world_size() != n:
        raise ValueError(f"--data_parallel {n} in a world of {multihost.world_size()} ranks")
    return mesh_lib.make_mesh(n)


def shard_loaders(mesh, *datasets) -> None:
    """Make each ``HostDataset`` (None skipped) yield this rank's rows."""
    _, index, size = mesh_lib.axis(mesh, "data")
    for dataset in datasets:
        if dataset is not None and size > 1:
            dataset.set_shard(index, size)
