"""The hand-written kernels of the serving paths as ``torch.library``
custom operators of the ``detr_torch`` namespace, so that a program
exported with ``torch.export`` (``export.py``) calls them.

Each op has three implementations, registered by ``define``:

* on CUDA tensors, the kernel's launch. The route pick (A's
  ``forward_route``, D's and E's ``route``, F's and G's ``plan``) and the
  launch counters live there, so an exported program picks and counts as
  eager code does;
* on CPU tensors, the kernel's plain version;
* a fake one, which gives the exact shape, dtype and strides of the output
  for tracing (C, D and E return ``torch.channels_last`` tensors).

Any other device raises. There is no fallback from one implementation to
another: a failed build or launch raises.

The ops are defined beside their wrappers: ``mha_forward``
(kernel A, ``flash_attention.py``), ``max_pool_3x3_s2`` (C, ``maxpool.py``),
``conv1x1_bn_residual_relu`` (D, ``fused_residual.py``),
``fused_bottleneck`` (E, ``fused_bottleneck.py``), ``int8_matmul`` (F,
``int8_matmul.py``) and ``int8_conv3x3`` (G, ``int8_conv.py``). Importing
this module registers all of them, which ``torch.export.load`` of a program
that calls them needs. B and A' run only in training and stay plain Python
calls.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "detr_torch"


def define(name: str, schema: str, *, cpu: Callable, cuda: Callable, fake: Callable):
    """Register ``detr_torch::<name>`` with ``schema`` (arguments and
    returns, as in ``torch.library``), its CPU and CUDA implementations and
    its fake one; any other device raises. Returns the op."""

    def other_device(*args):
        devices = sorted({str(a.device) for a in args if isinstance(a, torch.Tensor)})
        raise ValueError(f"{NAMESPACE}::{name} has no kernel for device {', '.join(devices)}")

    op = torch.library.custom_op(f"{NAMESPACE}::{name}", other_device, mutates_args=(),
                                 schema=schema)
    op.register_kernel("cpu", cpu)
    op.register_kernel("cuda", cuda)
    op.register_fake(fake)
    return op


def check_device(t: torch.Tensor, kernel: str) -> None:
    """Raise ValueError unless ``t`` lies on the CPU or a CUDA device, the
    two with an implementation (a fake tensor reports the device it
    stands for)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {kernel} kernel for device {t.device}")


# The wrappers' modules define the ops; importing them registers every op.
from . import (  # noqa: E402,F401
    flash_attention,
    fused_bottleneck,
    fused_residual,
    int8_conv,
    int8_matmul,
    maxpool,
)
