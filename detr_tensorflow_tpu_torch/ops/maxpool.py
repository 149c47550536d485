"""The ResNet stem's 3x3/s2/p1 max pool: the hand-written Hopper kernel
(C), its plain PyTorch version and the first-max backward.

Port of ``detr_tensorflow_tpu/ops/maxpool.py`` (``max_pool_3x3_s2``) and
of the TPU kernel ``max_pool_3x3_s2_pallas`` of
``detr_tensorflow_tpu/ops/pallas/maxpool.py``, on (B, C, H, W) tensors
in ``torch.channels_last`` memory, as the port's backbone holds them (NHWC
in memory, the TPU kernel's layout). The CUDA source is
``csrc/maxpool.cu``.

``max_pool_3x3_s2(x, nonneg=True)`` is the stem's call: its input is
post-ReLU, so x >= 0, the TPU kernel's contract. A CUDA tensor launches
kernel C (which equals ``F.max_pool2d(x, 3, 2, 1)`` bit for bit at any H
and W; float32 or bfloat16, any other dtype raises); a CPU tensor takes the
plain version; there is no fallback from one to the other. ``nonneg=False`` is the general pool, ``F.max_pool2d``
on any device, as the JAX package keeps XLA's ``reduce_window`` there.
Both give the gradient of the JAX custom VJP: the first maximum in
row-major window order takes the whole gradient. ``max_pool_3x3_s2.
launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_SOURCE = "maxpool.cu"
DTYPES = (torch.float32, torch.bfloat16)


def reference_max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.max_pool2d(x, 3, 2, 1)`` over NCHW ``x``."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def _library() -> ctypes.CDLL:
    from .nvcc_build import load_library

    lib = load_library(_SOURCE)
    fn = lib.max_pool_3x3_s2
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _forward(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 4 or not x.is_floating_point():
        raise TypeError(f"x must be a floating (B, C, H, W) tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return reference_max_pool_3x3_s2(x)  # any float dtype: float64 for diagnosis
    if x.device.type != "cuda":
        raise ValueError(f"no max pool kernel for device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"the max pool kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the max pool kernel takes a channels_last tensor")
    b, c, h, w = x.shape
    out = torch.empty((b, c, (h - 1) // 2 + 1, (w - 1) // 2 + 1), device=x.device, dtype=x.dtype,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _library().max_pool_3x3_s2(
            x.data_ptr(), out.data_ptr(), b, h, w, c, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"max_pool_3x3_s2 launch failed: cudaError {err}")
    max_pool_3x3_s2.launches += 1
    return out


def _first_max_backward(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The gradient of the pool at ``x``: recompute the indices of the first
    maxima (ATen's pool takes a tap only when it is greater, in row-major
    order) and send each output's gradient there, summing where one input
    wins two windows."""
    _, indices = F.max_pool2d(x, 3, stride=2, padding=1, return_indices=True)
    return torch.ops.aten.max_pool2d_with_indices_backward(
        grad, x, [3, 3], [2, 2], [1, 1], [1, 1], False, indices)


class _NonnegMaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _forward(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return _first_max_backward(x, grad)


def max_pool_3x3_s2(x: torch.Tensor, nonneg: bool = False) -> torch.Tensor:
    """3x3 stride-2 pad-1 max pool of (B, C, H, W) ``x`` -> (B, C,
    (H-1)//2+1, (W-1)//2+1), equal to ``F.max_pool2d(x, 3, 2, 1)``.

    ``nonneg=True`` states that x >= 0 (the stem's post-ReLU activations)
    and runs kernel C on a CUDA tensor; the kernel gives the right answer
    on any input, but the contract is the TPU kernel's.
    """
    if not nonneg:
        return reference_max_pool_3x3_s2(x)
    return _NonnegMaxPool.apply(x)


max_pool_3x3_s2.launches = 0
