"""The whole identity bottleneck in one kernel: the hand-written Hopper
kernel (E) and its plain PyTorch version.

Replaces the TPU kernel ``_kernel`` / ``fused_bottleneck`` of
``detr_tensorflow_tpu/ops/pallas/fused_bottleneck.py``:
relu(conv3(relu(conv2(relu(conv1(x))))) + x) for a stride-1 identity
bottleneck (Cin == Cout), frozen BN folded into the convs, with the two
intermediate maps T1 and T2 kept on chip. x is (N, C, H, W) in
``torch.channels_last`` memory, as the port's backbone holds it (NHWC in
memory, the TPU kernel's layout). The CUDA source is
``csrc/fused_bottleneck.cu``.

Numerics of the TPU kernel: ``fold_bn_params`` folds the BN scale into
the weights in float32, and only then are the weights cast to the compute
type; the biases (the BN shifts) stay float32. Each contraction
accumulates in float32; T1 and T2 go through ReLU in float32 and are
rounded to the compute type before the next one; T1 is zero outside the
image, where the unfused conv2 reads its zero padding; the residual is
added in float32.

The weights enter in the kernel's layouts, which are the JAX package's
HWIO kernels flattened: ``w1t`` (C, M), ``w2t`` (9, M, M) as (tap, in,
out) with tap = 3 * dy + dx, ``w3t`` (M, C); ``pack_weights`` makes them
from the port's folded OIHW conv weights.

Inference only, as in the JAX package (no VJP): the function raises when
autograd would record it. A CUDA tensor launches the kernel and a CPU
tensor takes the plain version; there is no fallback from one to the
other. ``fused_bottleneck.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .fused_residual import DTYPES, check_inference

_SOURCE = "fused_bottleneck.cu"
_CHUNK, MAX_WIDTH = 16, 512  # the kernel takes C, M multiples of 16 and M <= 512


def fold_bn_params(weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    """Fold a frozen-BN affine (y = conv(x) * scale + shift) into the conv:
    (weight * scale over its output channels, shift), in float32."""
    return weight.float() * scale.float().view(-1, *([1] * (weight.dim() - 1))), shift.float()


def pack_weights(w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor, dtype: torch.dtype):
    """The kernel's layouts, in ``dtype``, from OIHW conv weights (folded):
    w1 (M, C, 1, 1), w2 (M, M, 3, 3), w3 (C, M, 1, 1) -> (w1t, w2t, w3t)."""
    m, c = w1.shape[:2]
    w1t = w1.reshape(m, c).t()
    w2t = w2.permute(2, 3, 1, 0).reshape(9, m, m)
    w3t = w3.reshape(c, m).t()
    return tuple(t.to(dtype).contiguous() for t in (w1t, w2t, w3t))


def reference_fused_bottleneck(x, w1t, b1, w2t, b2, w3t, b3):
    """Plain version of ``fused_bottleneck``, on any device: the three
    convolutions with the kernel's rounding points."""
    dt, m = x.dtype, w1t.shape[1]
    xf = x.float()
    t1 = F.conv2d(xf, w1t.float().t()[:, :, None, None]) + b1[:, None, None]
    t1 = F.relu(t1).to(dt).float()
    w2 = w2t.float().reshape(3, 3, m, m).permute(3, 2, 0, 1)
    t2 = F.relu(F.conv2d(t1, w2, padding=1) + b2[:, None, None]).to(dt).float()
    y = F.conv2d(t2, w3t.float().t()[:, :, None, None]) + b3[:, None, None] + xf
    return F.relu(y).to(dt)


def _library() -> ctypes.CDLL:
    from .nvcc_build import load_library

    lib = load_library(_SOURCE)
    fn = lib.fused_bottleneck
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fused_bottleneck(x, w1t, b1, w2t, b2, w3t, b3):
    """relu(conv3(relu(conv2(relu(conv1(x))))) + x) with T1 and T2 on chip.

    x: (N, C, H, W) float32 or bfloat16, channels_last for the kernel; w1t
    (C, M), w2t (9, M, M), w3t (M, C) in x's dtype, BN folded
    (``pack_weights``); b1, b2 (M,) and b3 (C,) float32. Returns (N, C, H,
    W) in x's dtype and memory format.
    """
    operands = (x, w1t, b1, w2t, b2, w3t, b3)
    check_inference("fused_bottleneck", *operands)
    if x.dim() != 4 or x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16 (N, C, H, W), got {x.dtype} "
                        f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    m = w1t.shape[-1]
    for name, v, shape in (("w1t", w1t, (c, m)), ("w2t", w2t, (9, m, m)), ("w3t", w3t, (m, c))):
        if v.dtype != x.dtype or tuple(v.shape) != shape:
            raise ValueError(f"{name} must be {x.dtype} {shape}, got {v.dtype} {tuple(v.shape)}")
    for name, v, k in (("b1", b1, m), ("b2", b2, m), ("b3", b3, c)):
        if v.dtype != torch.float32 or tuple(v.shape) != (k,):
            raise ValueError(f"{name} must be float32 ({k},), got {v.dtype} {tuple(v.shape)}")
    if len({t.device for t in operands}) != 1:
        raise ValueError("operands lie on different devices")
    if x.device.type == "cpu":
        return reference_fused_bottleneck(*operands)
    if x.device.type != "cuda":
        raise ValueError(f"no fused bottleneck kernel for device {x.device}")
    if c % _CHUNK or m % _CHUNK or m > MAX_WIDTH:
        raise ValueError(f"the fused bottleneck kernel takes C and M multiples of {_CHUNK} and "
                         f"M <= {MAX_WIDTH}, got C={c}, M={m}")
    if not (x.is_contiguous(memory_format=torch.channels_last)
            and all(t.is_contiguous() for t in operands[1:])):
        raise ValueError("the fused bottleneck kernel takes x in channels_last memory and "
                         "contiguous weights and biases")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().fused_bottleneck(
            *(t.data_ptr() for t in operands), out.data_ptr(), n, c, m, h, w,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_bottleneck launch failed: cudaError {err}")
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
