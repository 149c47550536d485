"""The multi-process runtime (port of ``detr_tensorflow_tpu/parallel/multihost.py``).

One process per rank, joined by ``torch.distributed``: NCCL between ranks
on cards of their own, Gloo between CPU ranks, and Gloo on CUDA tensors
when asked (two ranks sharing one card: NCCL refuses two ranks on one
device). The genuinely multi-process concerns are the same three as in the
JAX package, with one helper each: starting the runtime
(``initialize``), feeding each rank its slice of the global batch
(``process_shard``), and keeping host side effects, printing and writing
checkpoints, to one rank (``is_primary``).

Usage, the same script on every rank (``torchrun --nproc_per_node N`` sets
the environment ``initialize`` reads):

    from detr_tensorflow_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize()                 # no-op at one process
    mesh = make_mesh(multihost.world_size())
    trainer = Trainer(model, config, mesh=mesh)
    lo, hi = multihost.process_shard(global_batch_size)
    for batch in loader:                   # global batches, same order on every rank
        log = trainer.step({k: v[lo:hi] for k, v in batch.items()})
        if multihost.is_primary():
            print(log)

JAX's ``global_batch`` has no counterpart: there every process hands its
local rows to one global array that the jitted step consumes; under DDP
each rank keeps its local batch, runs the model on it, and the gradient
all-reduce (and the loss normalizers, ``Trainer``) join the ranks.

No failure falls back to another backend: an NCCL error raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# Collectives and the rendezvous give up after this long unless the caller
# or the environment (DETR_DIST_TIMEOUT_S) says otherwise; NCCL's own default
# is 10 minutes as well.
DEFAULT_TIMEOUT_S = 600.0
TIMEOUT_ENV = "DETR_DIST_TIMEOUT_S"


def default_backend(device=None) -> str:
    """``nccl`` for ranks on the card, ``gloo`` for CPU ranks. ``device``
    None means the card when there is one."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device=None,
               init_method: Optional[str] = None,
               timeout_s: Optional[float] = None) -> bool:
    """Start the process group; a no-op returning False at one process.

    ``coordinator_address`` is rank 0's ``host:port`` (``tcp://`` is
    added); ``init_method`` may instead name any ``torch.distributed``
    rendezvous, such as ``file:///shared/path``. With neither, torchrun's
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` are read,
    and without ``WORLD_SIZE`` this is one process: nothing starts, as in
    the JAX package. ``backend`` defaults to ``default_backend(device)``; a
    rank on the card first makes its card the current device
    (``LOCAL_RANK``, else its rank modulo the cards present). ``timeout_s``
    bounds the rendezvous and every collective (default ``$DETR_DIST_TIMEOUT_S``,
    else DEFAULT_TIMEOUT_S). Returns True when the process group was
    started."""
    env = os.environ
    if coordinator_address is None and init_method is None:
        if "WORLD_SIZE" not in env and num_processes in (None, 1):
            return False
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    backend = backend or default_backend(device)
    if backend == "nccl" or (device is not None and torch.device(device).type == "cuda"):
        local = int(env.get("LOCAL_RANK", process_id % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(
            timeout_s or env.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))))
    return True


def shutdown() -> None:
    """Destroy the process group, if one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of ranks; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that owns logging, printing and checkpoint writes."""
    return rank() == 0


def process_shard(n: int, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> Tuple[int, int]:
    """This rank's contiguous [start, stop) range of ``n`` examples: the
    JAX package's arithmetic. ``n`` must divide by the rank count (the
    static-shape batch contract); otherwise ValueError."""
    pi = rank() if process_index is None else int(process_index)
    pc = world_size() if process_count is None else int(process_count)
    if n % pc:
        raise ValueError(f"{n} examples do not split evenly over {pc} ranks")
    per = n // pc
    return pi * per, (pi + 1) * per
