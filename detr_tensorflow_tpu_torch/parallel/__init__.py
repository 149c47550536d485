"""Parallelism across processes (port of ``detr_tensorflow_tpu/parallel``):
DDP data parallelism on a ``DeviceMesh`` (``mesh``), the multi-process
runtime (``multihost``), Megatron tensor parallelism of the transformer
(``tp``), pipeline parallelism over a ``stage`` axis, GPipe and 1F1B
(``pp``, ``detr_1f1b``, with stage boundaries sent by ``p2p``), and elastic
relaunch after a lost worker (``elastic``)."""

from .mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    replicate,
)
from .tp import detr_param_shardings, shard_params  # noqa: F401
from .pp import (  # noqa: F401
    PipelineSpec,
    choose_n_micro,
    pipeline_forward,
    pipeline_train_1f1b,
    pipeline_transformer_encoder,
    split_layers_into_stages,
)
from .detr_1f1b import detr_1f1b_value_and_grad  # noqa: F401
from . import elastic, multihost, p2p  # noqa: F401
