"""The fused bottleneck tail, relu(conv1x1(x) * scale + shift + identity):
the hand-written Hopper kernel (D) and its plain PyTorch version.

Replaces the TPU kernel ``_kernel`` / ``matmul_bn_residual_relu`` of
``detr_tensorflow_tpu/ops/pallas/fused_residual.py`` (and its NHWC wrapper
``conv1x1_bn_residual_relu``), on (B, C, H, W) tensors in
``torch.channels_last`` memory, as the port's backbone holds them: NHWC in
memory, so the 1x1 convolution is the TPU kernel's GEMM, (B*H*W, Cin)
times the weights' (Cin, Cout). Numerics of the TPU kernel: the weight in
the compute type, scale and shift float32, the product accumulated in
float32, then
``((acc * scale) + shift) + identity`` in float32, ReLU, one rounding to
the output type. The CUDA source is ``csrc/fused_residual.cu``.

Inference only, as in the JAX package (no VJP): the function raises when
autograd would record it. A CUDA tensor launches the kernel and a CPU
tensor takes the plain version; there is no fallback from one to the
other. ``conv1x1_bn_residual_relu.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_SOURCE = "fused_residual.cu"
DTYPES = (torch.float32, torch.bfloat16)


def check_inference(name: str, *tensors) -> None:
    """Raise when autograd would record a call of the inference-only
    kernel ``name`` on ``tensors``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward (inference only, as in the JAX package): "
                           "call it under torch.no_grad() or torch.inference_mode()")


def reference_conv1x1_bn_residual_relu(x, weight, scale, shift, identity):
    """Plain version of ``conv1x1_bn_residual_relu``, on any device."""
    cout, cin = weight.shape[0], x.shape[1]
    acc = torch.matmul(x.permute(0, 2, 3, 1).float(), weight.reshape(cout, cin).float().t())
    y = acc * scale + shift + identity.permute(0, 2, 3, 1).float()
    return F.relu(y).to(x.dtype).permute(0, 3, 1, 2)  # channels_last, like x


def _library() -> ctypes.CDLL:
    from .nvcc_build import load_library

    lib = load_library(_SOURCE)
    fn = lib.conv1x1_bn_residual_relu
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def conv1x1_bn_residual_relu(x, weight, scale, shift, identity):
    """relu(conv1x1(x, weight) * scale + shift + identity) without the conv
    output in device memory.

    x: (B, Cin, H, W); weight: (Cout, Cin) or (Cout, Cin, 1, 1) in x's
    dtype; scale, shift: float32 (Cout,); identity: (B, Cout, H, W) in x's
    dtype. float32 or bfloat16; the kernel takes x and identity in
    channels_last memory. Returns (B, Cout, H, W) in x's dtype,
    channels_last.
    """
    check_inference("conv1x1_bn_residual_relu", x, weight, scale, shift, identity)
    if x.dim() != 4 or x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16 (B, C, H, W), got {x.dtype} "
                        f"{tuple(x.shape)}")
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if weight.numel() != cout * cin or weight.dtype != x.dtype:
        raise ValueError(f"weight {weight.dtype} {tuple(weight.shape)} is not ({cout}, {cin}) "
                         f"{x.dtype}")
    if identity.dtype != x.dtype or tuple(identity.shape) != (b, cout, h, w):
        raise ValueError(f"identity {identity.dtype} {tuple(identity.shape)} is not "
                         f"({b}, {cout}, {h}, {w}) {x.dtype}")
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or tuple(v.shape) != (cout,):
            raise ValueError(f"{name} must be float32 ({cout},), got {v.dtype} {tuple(v.shape)}")
    if len({t.device for t in (x, weight, scale, shift, identity)}) != 1:
        raise ValueError("operands lie on different devices")
    if x.device.type == "cpu":
        return reference_conv1x1_bn_residual_relu(x, weight, scale, shift, identity)
    if x.device.type != "cuda":
        raise ValueError(f"no fused residual kernel for device {x.device}")
    if not (x.is_contiguous(memory_format=torch.channels_last)
            and identity.is_contiguous(memory_format=torch.channels_last)
            and all(t.is_contiguous() for t in (weight, scale, shift))):
        raise ValueError("the fused residual kernel takes x and identity in channels_last "
                         "memory and contiguous weight, scale and shift")
    out = torch.empty((b, cout, h, w), device=x.device, dtype=x.dtype,
                      memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        err = _library().conv1x1_bn_residual_relu(
            x.data_ptr(), weight.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            identity.data_ptr(), out.data_ptr(), b * h * w, cin, cout,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv1x1_bn_residual_relu launch failed: cudaError {err}")
    conv1x1_bn_residual_relu.launches += 1
    return out


conv1x1_bn_residual_relu.launches = 0
