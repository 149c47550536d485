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
other. ``plan`` picks the kernel's configuration (output patch, cluster)
from the shape alone. ``conv3x3_int8.launches`` counts kernel launches per
stride.

DC5's dilated 3x3s (dilation 2, stride 1) do not go through the kernel,
as in the JAX package, which gives them to XLA's int8 convolution
(``_conv3x3_int8_xla``): ``dilated_conv3x3_int8`` gathers the nine taps
into (M, 9C) int8 rows and contracts them with ``torch._int_mm`` into exact
int32 sums, then applies the same epilogue (``dilated_conv3x3_int8.calls``
counts them).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .int8_matmul import OUT_DTYPES, check_kernel_operands, epilogue

_SOURCE = "int8_conv.cu"
_CHUNK = 64
STRIDES = (1, 2)

# The kernel's compiled tiles (``csrc/int8_conv.cu``, ``Cfg``): per stride,
# the output patch (rows x columns of pixels) of a CTA, which covers
# CHANNELS output channels with 8 warps, the contraction in KC-byte chunks,
# a W_STAGES-stage ring of W slices (the three taps of one kernel row)
# beside a 2-stage ring of input windows.
TILES = {1: (8, 16), 2: (8, 16)}
CHANNELS = 64
KC = 64
W_STAGES = 3
CLUSTERS = (1, 2, 4, 8)
# Where a launch's tiles are fewer than FILL (two waves on the H100's 132
# SMs at stride 1, one at stride 2), a cluster's ranks split each tile's
# contraction into whole chunks: two ranks, or the fewest that reach WAVE
# CTAs, or as many as the chunks allow. A split adds an exchange of partial
# sums; it pays only where few tiles leave SMs idle.
FILL = {1: 264, 2: 132}
WAVE = 132


class Plan(NamedTuple):
    """The kernel's configuration at one shape: the output patch of a CTA
    (rows x columns of pixels), its output channels, the thread-block
    cluster that splits each tile's contraction, and the CTAs it launches."""

    patch_h: int
    patch_w: int
    channels: int
    cluster: int
    ctas: int


def _tiles(n, ho, wo, k, patch):
    return n * -(-ho // patch[0]) * -(-wo // patch[1]) * -(-k // CHANNELS)


def plan(n: int, h: int, w: int, c: int, k: int, stride: int) -> Plan:
    """The kernel's configuration for an (N, H, W, C) input, K output
    channels and a stride, from the shape alone: the stride's patch of
    ``TILES`` and, where the tiles are fewer than ``FILL``, a cluster
    splitting C into whole 64-byte chunks. Raises unless C is a multiple of
    64 and K of 8."""
    if stride not in STRIDES:
        raise ValueError(f"stride must be one of {STRIDES}, got {stride}")
    if c <= 0 or c % _CHUNK or k <= 0 or k % 8:
        raise ValueError(f"the int8 conv kernel takes C a multiple of {_CHUNK} and K a multiple "
                         f"of 8, got C={c}, K={k}")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    patch = TILES[stride]
    tiles = _tiles(n, ho, wo, k, patch)
    splits = [m for m in CLUSTERS if c % (_CHUNK * m) == 0]
    cluster = 1
    if tiles < FILL[stride] and len(splits) > 1:
        cluster = next((m for m in splits[1:] if tiles * m >= WAVE), splits[-1])
    return Plan(*patch, CHANNELS, cluster, tiles * cluster)


def smem_bytes(stride: int, patch, out_dtype=torch.int8) -> int:
    """Dynamic shared memory of one CTA, the kernel's ``Cfg::smem_bytes``:
    the ring (two halo'd input windows of 64-byte pixels, each one block of
    rows at stride 1 and two at stride 2, a block rounded up to whole
    kilobytes; W_STAGES W slices of 3 taps x CHANNELS rows), or, if larger,
    the cluster's exchange of int32 partial sums over the tile followed by
    the staged output tile (rows padded by 16 bytes); then scale and bias
    over the tile's channels and a full and an empty mbarrier for each W
    stage."""
    ph, pw = patch
    rows = ((ph - 1) * stride + 3) * (pw + 2 if stride == 1 else pw + 1)
    ring = 2 * stride * -(-rows * KC // 1024) * 1024 + W_STAGES * 3 * CHANNELS * KC
    row = 2 * CHANNELS + 16 if out_dtype == torch.bfloat16 else CHANNELS + 16
    return (max(ring, ph * pw * CHANNELS * 4 + ph * pw * row) + 2 * CHANNELS * 4
            + 2 * W_STAGES * 8)


def _int_conv3x3(x: torch.Tensor, w: torch.Tensor, stride: int,
                 dilation: int = 1) -> torch.Tensor:
    """SAME 3x3 convolution of int8 NHWC x with int8 (K, 3, 3, C) w as exact
    integers in float64 (|acc| <= 9 * C * 128^2 < 2^53), NHWC out."""
    acc = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(0, 3, 1, 2),
                   stride=stride, padding=dilation, dilation=dilation)
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
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
    p = plan(n, h, width, c, k, stride)
    check_kernel_operands(x, w, scale, bias)
    out = torch.empty((n, (h - 1) // stride + 1, (width - 1) // stride + 1, k), device=x.device,
                      dtype=out_dtype)
    with torch.cuda.device(x.device):
        err = _library().int8_conv3x3(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, width, c, k, stride, int(relu), int(out_dtype == torch.bfloat16),
            int(precise), p.patch_h, p.patch_w, p.cluster,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_conv3x3 launch failed: cudaError {err}")
    conv3x3_int8.launches[stride] += 1
    return out


conv3x3_int8.launches = {s: 0 for s in STRIDES}


def dilated_conv3x3_int32(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """Exact int32 sums of the SAME 3x3 convolution at ``dilation``, stride
    1, of int8 (N, H, W, C) x with int8 (K, 3, 3, C) w: the taps gathered
    into (N*H*W, 9C) rows (zeros past the image) and one ``torch._int_mm``
    against the (9C, K) weights. NHWC int32 out."""
    n, h, width, c = x.shape
    k = w.shape[0]
    d = dilation
    xp = F.pad(x, (0, 0, d, d, d, d))
    cols = torch.stack([xp[:, i * d:i * d + h, j * d:j * d + width, :]
                        for i in range(3) for j in range(3)], dim=3)
    rows = cols.reshape(n * h * width, 9 * c)
    m = rows.shape[0]
    if m <= 16:  # torch._int_mm takes more than 16 rows
        rows = F.pad(rows, (0, 0, 0, 17 - m))
    acc = torch._int_mm(rows, w.reshape(k, 9 * c).t())[:m]
    return acc.reshape(n, h, width, k)


def dilated_conv3x3_int8(x, w, scale, bias=None, *, dilation=2, relu=False,
                         out_dtype=torch.int8, precise=True):
    """Quantized SAME 3x3 convolution at ``dilation``, stride 1: int8
    (N, H, W, C) x (K, 3, 3, C) -> (N, H, W, K) int8 (or bf16), the int32
    sums of ``dilated_conv3x3_int32`` through ``conv3x3_int8``'s epilogue.
    Equal to ``reference_dilated_conv3x3_int8`` on every device."""
    if bias is None:
        bias = torch.zeros_like(scale)
    dilated_conv3x3_int8.calls += 1
    return epilogue(dilated_conv3x3_int32(x, w, dilation), scale, bias, relu=relu,
                    out_dtype=out_dtype, precise=precise)


dilated_conv3x3_int8.calls = 0


def reference_dilated_conv3x3_int8(x, w, scale, bias=None, *, dilation=2, relu=False,
                                   out_dtype=torch.int8, precise=True):
    """Plain version of ``dilated_conv3x3_int8``: the float64 convolution."""
    if bias is None:
        bias = torch.zeros_like(scale)
    return epilogue(_int_conv3x3(x, w, 1, dilation), scale, bias, relu=relu,
                    out_dtype=out_dtype, precise=precise)
