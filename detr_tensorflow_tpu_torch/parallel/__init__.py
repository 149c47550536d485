"""Parallelism across processes (port of ``detr_tensorflow_tpu/parallel``):
DDP data parallelism on a ``DeviceMesh`` (``mesh``), the multi-process
runtime (``multihost``), Megatron tensor parallelism of the transformer
(``tp``) and elastic relaunch after a lost worker (``elastic``). The
pipeline schedules (GPipe, 1F1B) are not ported yet."""

from .mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    replicate,
)
from .tp import detr_param_shardings, shard_params  # noqa: F401
from . import elastic, multihost  # noqa: F401
