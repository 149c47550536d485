"""The fused bottleneck tail, relu(conv1x1(x) * scale + shift + identity):
the hand-written Hopper kernels (D-tf32, D-mma and the SIMT D) and their
plain PyTorch version.

Replaces the TPU kernel ``_kernel`` / ``matmul_bn_residual_relu`` of
``detr_tensorflow_tpu/ops/pallas/fused_residual.py`` (and its NHWC wrapper
``conv1x1_bn_residual_relu``), on (B, C, H, W) tensors in
``torch.channels_last`` memory, as the port's backbone holds them: NHWC in
memory, so the 1x1 convolution is the TPU kernel's GEMM, (B*H*W, Cin)
times the weights' (Cin, Cout). Numerics of the TPU kernel: the weight in
the compute type, scale and shift float32, the product accumulated in
float32, then
``((acc * scale) + shift) + identity`` in float32, ReLU, one rounding to
the output type.

Three kernels. ``route`` picks one from the dtype alone: fp32 runs D-tf32
(``csrc/fused_residual_tf32.cu``: TF32 tensor cores with fp32-accurate
3xTF32 products; a 128-pixel by 64-channel tile), bf16 runs D-mma
(``csrc/fused_residual_mma.cu``: bf16 tensor cores; a 128-pixel by
128-channel tile). Both stage the output tile in shared memory, so that the
identity is read and y written 16 bytes a thread. The SIMT kernel
(``csrc/fused_residual.cu``) runs on no path; ``launch_simt`` calls it at
either dtype, for timing. ``conv1x1_bn_residual_relu.tf32_launches``,
``.mma_launches`` and ``.launches`` count their launches.

Inference only, as in the JAX package (no VJP): the function raises when
autograd would record it. It calls the custom op
``detr_torch::conv1x1_bn_residual_relu`` (``ops/library.py``): a CUDA
tensor launches the kernel ``route`` picks and a CPU tensor takes the plain
version; there is no fallback from one to the other, and a failed build or
launch raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import library

_SOURCE, _MMA_SOURCE, _TF32_SOURCE = ("fused_residual.cu", "fused_residual_mma.cu",
                                      "fused_residual_tf32.cu")
_ENTRIES = {_SOURCE: "conv1x1_bn_residual_relu", _MMA_SOURCE: "conv1x1_bn_residual_relu_mma",
            _TF32_SOURCE: "conv1x1_bn_residual_relu_tf32"}
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


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA call takes: "mma" (D-mma, bf16 tensor cores,
    ``csrc/fused_residual_mma.cu``) for bf16, "tf32" (D-tf32, TF32 tensor
    cores with 3xTF32 products, ``csrc/fused_residual_tf32.cu``) for fp32."""
    return "mma" if dtype == torch.bfloat16 else "tf32"


def check_mma_shape(cin: int, cout: int) -> None:
    """Raise ValueError unless D-mma takes ``cin`` input and ``cout`` output
    channels: multiples of 8 (16-byte rows)."""
    if cin % 8 or cout % 8:
        raise ValueError(f"the bf16 fused residual kernel takes Cin and Cout multiples of 8 "
                         f"(16-byte rows), got Cin={cin}, Cout={cout}")


def check_tf32_shape(cin: int, cout: int) -> None:
    """Raise ValueError unless D-tf32 takes ``cin`` input and ``cout``
    output channels: multiples of 4 (16-byte rows)."""
    if cin % 4 or cout % 4:
        raise ValueError(f"the fp32 fused residual kernel takes Cin and Cout multiples of 4 "
                         f"(16-byte rows), got Cin={cin}, Cout={cout}")


def _entry(source: str, name: str, ints: int):
    """The ctypes entry point ``name`` of ``csrc/<source>``, built on first
    use: six pointers, P, then ``ints`` ints (Cin, Cout, ...) and a stream."""
    from .nvcc_build import load_library

    fn = getattr(load_library(source), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x, weight, scale, shift, identity):
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
    library.check_device(x, "fused residual")


def _check_kernel_inputs(x, weight, scale, shift, identity):
    if x.device.type != "cuda":
        raise ValueError(f"no fused residual kernel for device {x.device}")
    if not (x.is_contiguous(memory_format=torch.channels_last)
            and identity.is_contiguous(memory_format=torch.channels_last)
            and all(t.is_contiguous() for t in (weight, scale, shift))):
        raise ValueError("the fused residual kernel takes x and identity in channels_last "
                         "memory and contiguous weight, scale and shift")


def _launch(source, operands, *args):
    """One launch of ``csrc/<source>``'s entry point on CUDA operands, with
    its trailing arguments ``args`` (none for D-mma and D-tf32); returns y."""
    x, weight, scale, shift, identity = operands
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    out = _output(*operands)
    name = _ENTRIES[source]
    with torch.cuda.device(x.device):
        err = _entry(source, name, 2 + len(args))(
            x.data_ptr(), weight.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            identity.data_ptr(), out.data_ptr(), b * h * w, cin, cout, *args,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def conv1x1_bn_residual_relu(x, weight, scale, shift, identity):
    """relu(conv1x1(x, weight) * scale + shift + identity) without the conv
    output in device memory.

    x: (B, Cin, H, W); weight: (Cout, Cin) or (Cout, Cin, 1, 1) in x's
    dtype; scale, shift: float32 (Cout,); identity: (B, Cout, H, W) in x's
    dtype. float32 or bfloat16; the kernels take x and identity in
    channels_last memory. Returns (B, Cout, H, W) in x's dtype,
    channels_last. A CPU tensor takes the plain version, a CUDA tensor the
    kernel ``route`` picks.
    """
    _check(x, weight, scale, shift, identity)
    return residual_op(x, weight, scale, shift, identity)


def _output(x, weight, scale, shift, identity):
    b, _, h, w = x.shape
    return torch.empty((b, weight.shape[0], h, w), device=x.device, dtype=x.dtype,
                       memory_format=torch.channels_last)


def _residual_cpu(*operands):
    return _output(*operands).copy_(reference_conv1x1_bn_residual_relu(*operands))


def _residual_cuda(*operands):
    if route(operands[0].dtype) == "mma":
        return launch_mma(*operands)
    return launch_tf32(*operands)


residual_op = library.define(
    "conv1x1_bn_residual_relu",
    "(Tensor x, Tensor weight, Tensor scale, Tensor shift, Tensor identity) -> Tensor",
    cpu=_residual_cpu, cuda=_residual_cuda, fake=_output)
"""``detr_torch::conv1x1_bn_residual_relu``: kernel D, channels_last out."""


def launch_simt(x, weight, scale, shift, identity):
    """One launch of the SIMT kernel on CUDA tensors, fp32 or bf16. No route
    takes it: it is called directly, for timing beside D-tf32 and D-mma."""
    operands = (x, weight, scale, shift, identity)
    _check(*operands)
    _check_kernel_inputs(*operands)
    out = _launch(_SOURCE, operands, int(x.dtype == torch.bfloat16))
    conv1x1_bn_residual_relu.launches += 1
    return out


def _launch_tensor_cores(source, dtype, check_shape, operands):
    """One launch of the tensor-core kernel of ``csrc/<source>``, which
    takes ``dtype`` and the channel counts ``check_shape`` accepts; returns
    y."""
    x, weight, scale, shift, identity = operands
    name = _ENTRIES[source]
    _check(*operands)
    if x.dtype != dtype:
        raise TypeError(f"the {name} kernel takes {str(dtype).removeprefix('torch.')}, "
                        f"got {x.dtype}")
    _check_kernel_inputs(*operands)
    check_shape(x.shape[1], weight.shape[0])
    if any(t.data_ptr() % 16 for t in (x, weight, identity)) or any(
            t.data_ptr() % 8 for t in (scale, shift)):
        raise ValueError(f"the {name} kernel takes 16-byte aligned x, weight and identity and "
                         "8-byte aligned scale and shift")
    return _launch(source, operands)


def launch_mma(x, weight, scale, shift, identity):
    """One launch of D-mma on bf16 CUDA tensors. Cin and Cout must be
    multiples of 8 (16-byte rows)."""
    out = _launch_tensor_cores(_MMA_SOURCE, torch.bfloat16, check_mma_shape,
                               (x, weight, scale, shift, identity))
    conv1x1_bn_residual_relu.mma_launches += 1
    return out


def launch_tf32(x, weight, scale, shift, identity):
    """One launch of D-tf32 on fp32 CUDA tensors. Cin and Cout must be
    multiples of 4 (16-byte rows)."""
    out = _launch_tensor_cores(_TF32_SOURCE, torch.float32, check_tf32_shape,
                               (x, weight, scale, shift, identity))
    conv1x1_bn_residual_relu.tf32_launches += 1
    return out


conv1x1_bn_residual_relu.launches = 0
conv1x1_bn_residual_relu.mma_launches = 0
conv1x1_bn_residual_relu.tf32_launches = 0
