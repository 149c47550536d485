"""int8 SAME 3x3 convolution with the requantization epilogue: the
hand-written Hopper kernel and its plain PyTorch version.

Replaces the TPU kernel ``_conv_kernel`` / ``conv3x3_int8`` of
``detr_tensorflow_tpu/ops/pallas/int8_conv.py`` (stride 1) and, at stride
2, the XLA int8 convolution ``_conv3x3_int8_xla`` that
``detr_tensorflow_tpu/models/quantized.py`` gives the three strided 3x3s
of ResNet-50. NHWC int8 input, OHWI int8 weights (K, 3, 3, C) (converted
once from the JAX package's HWIO by ``models/weights.py:from_jax_quant``),
pad 1 read as zeros, int32 accumulation over the nine taps, then the
epilogue of ``ops/int8_matmul.py``. The CUDA source is
``csrc/int8_conv.cu``.

A CUDA tensor launches the kernel (C a multiple of 64, K of 8) and a CPU
tensor takes the plain version; there is no fallback from one to the
other. ``conv3x3_int8.launches`` counts kernel launches per stride.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .int8_matmul import OUT_DTYPES, check_kernel_operands, epilogue

_SOURCE = "int8_conv.cu"
_CHUNK = 64
STRIDES = (1, 2)


def _int_conv3x3(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME 3x3 convolution of int8 NHWC x with int8 (K, 3, 3, C) w as exact
    integers in float64 (|acc| <= 9 * C * 128^2 < 2^53), NHWC out."""
    acc = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(0, 3, 1, 2),
                   stride=stride, padding=1)
    return acc.permute(0, 2, 3, 1)


def reference_conv3x3_int8(x, w, scale, bias=None, *, stride=1, relu=False,
                           out_dtype=torch.int8, precise=True):
    """Plain version of ``conv3x3_int8``, on any device."""
    if bias is None:
        bias = torch.zeros_like(scale)
    return epilogue(_int_conv3x3(x, w, stride), scale, bias, relu=relu, out_dtype=out_dtype,
                    precise=precise)


def _library() -> ctypes.CDLL:
    from .nvcc_build import load_library

    lib = load_library(_SOURCE)
    fn = lib.int8_conv3x3
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def conv3x3_int8(x, w, scale, bias=None, *, stride=1, relu=False, out_dtype=torch.int8,
                 precise=True):
    """Quantized SAME 3x3 convolution: int8 (N, H, W, C) x (K, 3, 3, C) ->
    (N, Ho, Wo, K) int8 (or bf16), Ho = (H - 1) // stride + 1.

    ``scale``/``bias`` (float32 (K,)) fold dequantization, BatchNorm and
    requantization into one per-channel affine of the int32 accumulator.
    """
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.dim() != 4:
        raise TypeError(f"x must be int8 (N, H, W, C) and w int8, got {x.dtype} "
                        f"{tuple(x.shape)} and {w.dtype}")
    n, h, width, c = x.shape
    k = w.shape[0]
    if tuple(w.shape) != (k, 3, 3, c):
        raise ValueError(f"weights {tuple(w.shape)} are not (K, 3, 3, {c})")
    if bias is None:
        bias = torch.zeros_like(scale)
    for name, v in (("scale", scale), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (k,):
            raise ValueError(f"{name} must be float32 ({k},), got {v.dtype} {tuple(v.shape)}")
    if stride not in STRIDES:
        raise ValueError(f"stride must be one of {STRIDES}, got {stride}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    if len({t.device for t in (x, w, scale, bias)}) != 1:
        raise ValueError("operands lie on different devices")
    kw = dict(stride=stride, relu=relu, out_dtype=out_dtype, precise=precise)
    if x.device.type == "cpu":
        return reference_conv3x3_int8(x, w, scale, bias, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {x.device}")
    if c % _CHUNK or k % 8:
        raise ValueError(f"the int8 conv kernel takes C a multiple of {_CHUNK} and K a multiple "
                         f"of 8, got C={c}, K={k}")
    check_kernel_operands(x, w, scale, bias)
    out = torch.empty((n, (h - 1) // stride + 1, (width - 1) // stride + 1, k), device=x.device,
                      dtype=out_dtype)
    with torch.cuda.device(x.device):
        err = _library().int8_conv3x3(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, width, c, k, stride, int(relu), int(out_dtype == torch.bfloat16),
            int(precise), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_conv3x3 launch failed: cudaError {err}")
    conv3x3_int8.launches[stride] += 1
    return out


conv3x3_int8.launches = {s: 0 for s in STRIDES}
