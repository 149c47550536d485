"""The whole identity bottleneck in one kernel: the hand-written Hopper
kernel (E) and its plain PyTorch version.

Replaces the TPU kernel ``_kernel`` / ``fused_bottleneck`` of
``detr_tensorflow_tpu/ops/pallas/fused_bottleneck.py``:
relu(conv3(relu(conv2(relu(conv1(x))))) + x) for a stride-1 identity
bottleneck (Cin == Cout), frozen BN folded into the convs, with the two
intermediate maps T1 and T2 kept on chip. x is (N, C, H, W) in
``torch.channels_last`` memory, as the port's backbone holds it (NHWC in
memory, the TPU kernel's layout).

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

Three kernels. ``route`` picks one from the dtype alone: bf16 runs E-mma
(``csrc/fused_bottleneck_mma.cu``: tensor cores, thread-block clusters
splitting the wide blocks' channels, one compiled plan per width,
``MMA_PLANS``), fp32 runs E-tf32 (``csrc/fused_bottleneck_tf32.cu``: the
same design on the TF32 tensor cores with fp32-accurate 3xTF32 products,
its own plans, ``TF32_PLANS``). The SIMT kernel (``csrc/fused_bottleneck.cu``)
runs on no path; ``launch_simt`` calls it at either dtype, for timing.
``fused_bottleneck.mma_launches``, ``fused_bottleneck.tf32_launches`` and
``fused_bottleneck.launches`` count their launches.

Inference only, as in the JAX package (no VJP): the function raises when
autograd would record it. It calls the custom op
``detr_torch::fused_bottleneck`` (``ops/library.py``): a CUDA tensor
launches the kernel ``route`` picks and a CPU tensor takes the plain
version; there is no fallback from one to the other, and a failed build or
launch raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import library
from .fused_residual import DTYPES, check_inference

_SOURCE, _MMA_SOURCE = "fused_bottleneck.cu", "fused_bottleneck_mma.cu"
_TF32_SOURCE = "fused_bottleneck_tf32.cu"
_CHUNK, MAX_WIDTH = 16, 512  # the SIMT kernel takes C, M multiples of 16 and M <= 512

# E-mma's compiled plan, (tile_h, tile_w, cluster), per M;
# csrc/fused_bottleneck_mma.cu:with_plan lists the same.
MMA_PLANS = {64: (8, 16, 1), 128: (8, 8, 1), 256: (8, 8, 2), 512: (8, 8, 8)}
# The kernel's constants: contraction rows a chunk of stages 1-3, stages of
# the cp.async ring, and the most shared memory a CTA can have.
_KC1, _KC2, _KC3, _RING = 32, 64, 32, 3
MAX_SMEM = 232448
# E-tf32's compiled plan, (tile_h, tile_w, cluster), per M;
# csrc/fused_bottleneck_tf32.cu:with_plan lists the same. Its chunks are 32
# contraction rows in stages 1 and 3 and 64 in stage 2, and a CTA's product
# pass holds at most 64 accumulator blocks of 16 x 8.
TF32_PLANS = {64: (8, 8, 1), 128: (8, 8, 2), 256: (8, 8, 4), 512: (4, 8, 4)}
_KC_TF32, _KC2_TF32, _TF32_BLOCKS = 32, 64, 64


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


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA call takes: "mma" (E-mma, bf16 tensor cores,
    ``csrc/fused_bottleneck_mma.cu``) for bf16, "tf32" (E-tf32, TF32 tensor
    cores with 3xTF32 products, ``csrc/fused_bottleneck_tf32.cu``) for
    fp32. No dtype takes the SIMT kernel."""
    return "mma" if dtype == torch.bfloat16 else "tf32"


def _stage3_pass(m: int) -> int:
    """y channels E-mma's stage 3 takes a pass at width M."""
    return 128 if m <= 128 else 256


def mma_smem_bytes(m: int) -> int:
    """Shared memory of one E-mma CTA at width M, the kernel's
    ``Plan::kSmem``: T1 over the halo and T2 over the tile at all M channels
    (rows padded by 8 bf16), and the cp.async ring's stages, each the
    largest of stage 1's x and W1 chunks, stage 2's W2 chunk and stage 3's
    W3 chunk."""
    tile_h, tile_w, cluster = MMA_PLANS[m]
    halo, tile = (tile_h + 2) * (tile_w + 2), tile_h * tile_w
    nk = m // cluster
    ring = max(halo * (_KC1 + 8) + _KC1 * (nk + 8), _KC2 * (nk + 8),
               _KC3 * (_stage3_pass(m) + 8))
    return 2 * ((halo + tile) * (m + 8) + _RING * ring)


def mma_plan(c: int, m: int) -> tuple:
    """E-mma's plan (tile_h, tile_w, cluster) at width M, for C input
    channels: C must come in whole chunks of stage 1 and in whole stage-3
    passes of each rank."""
    return _plan("bf16", MMA_PLANS, _stage3_pass, c, m)


def tf32_stage3_pass(m: int) -> int:
    """y channels E-tf32's stage 3 takes a pass at width M: a CTA's 64
    accumulator blocks over its tile's pixels."""
    tile_h, tile_w, _ = TF32_PLANS[m]
    return 8 * _TF32_BLOCKS // (tile_h * tile_w // 16)


def tf32_smem_bytes(m: int) -> int:
    """Shared memory of one E-tf32 CTA at width M, the kernel's
    ``Plan::kSmem``: T1 over the halo at all M channels (rows padded by 4
    floats; T2 over the tile is written over it), and the cp.async ring's
    stages, each the largest of stage 1's x and W1 chunks, stage 2's W2
    chunk and stage 3's W3 chunk (weight rows padded by 8 floats)."""
    tile_h, tile_w, cluster = TF32_PLANS[m]
    halo, kc = (tile_h + 2) * (tile_w + 2), _KC_TF32
    nk = m // cluster
    ring = max(halo * (kc + 4) + kc * (nk + 8), _KC2_TF32 * (nk + 8),
               kc * (tf32_stage3_pass(m) + 8))
    return 4 * (halo * (m + 4) + _RING * ring)


def tf32_plan(c: int, m: int) -> tuple:
    """E-tf32's plan (tile_h, tile_w, cluster) at width M, for C input
    channels: C must come in whole chunks and in whole stage-3 passes of
    each rank."""
    return _plan("fp32", TF32_PLANS, tf32_stage3_pass, c, m)


def _plan(name, plans, stage3_pass, c, m):
    plan = plans.get(m)
    if plan is None or c % 32 or c % (plan[2] * stage3_pass(m)):
        raise ValueError(f"the {name} fused bottleneck kernel takes M in {sorted(plans)} and C a "
                         f"multiple of 32 and of its plan's cluster times its stage-3 pass "
                         f"({stage3_pass(m) if plan else 'no plan'}), got C={c}, M={m}")
    return plan


def _library(source: str) -> ctypes.CDLL:
    from .nvcc_build import load_library

    lib = load_library(source)
    if source == _SOURCE and lib.fused_bottleneck.argtypes is None:
        lib.fused_bottleneck.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                         + [ctypes.c_void_p])
        lib.fused_bottleneck.restype = ctypes.c_int
    # The tensor-core kernels' entry points: fused_bottleneck_{mma,tf32} and
    # their _occupancy functions.
    entry = source[:-len(".cu")]
    if source in (_MMA_SOURCE, _TF32_SOURCE) and getattr(lib, entry).argtypes is None:
        launch, occupancy = getattr(lib, entry), getattr(lib, f"{entry}_occupancy")
        launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        occupancy.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2
        launch.restype = occupancy.restype = ctypes.c_int
    return lib


def _check(x, w1t, b1, w2t, b2, w3t, b3):
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
    library.check_device(x, "fused bottleneck")


def _check_kernel_inputs(x, *weights):
    if x.device.type != "cuda":
        raise ValueError(f"no fused bottleneck kernel for device {x.device}")
    if not (x.is_contiguous(memory_format=torch.channels_last)
            and all(t.is_contiguous() for t in weights)):
        raise ValueError("the fused bottleneck kernel takes x in channels_last memory and "
                         "contiguous weights and biases")


def fused_bottleneck(x, w1t, b1, w2t, b2, w3t, b3):
    """relu(conv3(relu(conv2(relu(conv1(x))))) + x) with T1 and T2 on chip.

    x: (N, C, H, W) float32 or bfloat16, channels_last for the kernels; w1t
    (C, M), w2t (9, M, M), w3t (M, C) in x's dtype, BN folded
    (``pack_weights``); b1, b2 (M,) and b3 (C,) float32. Returns (N, C, H,
    W) in x's dtype and memory format. A CPU tensor takes the plain
    version, a CUDA tensor the kernel ``route`` picks.
    """
    _check(x, w1t, b1, w2t, b2, w3t, b3)
    return bottleneck_op(x, w1t, b1, w2t, b2, w3t, b3)


def _output(x, *weights):
    return torch.empty_like(x)


def _bottleneck_cpu(*operands):
    return _output(*operands).copy_(reference_fused_bottleneck(*operands))


def _bottleneck_cuda(*operands):
    if route(operands[0].dtype) == "mma":
        return launch_mma(*operands)
    return launch_tf32(*operands)


bottleneck_op = library.define(
    "fused_bottleneck",
    "(Tensor x, Tensor w1t, Tensor b1, Tensor w2t, Tensor b2, Tensor w3t, Tensor b3) -> Tensor",
    cpu=_bottleneck_cpu, cuda=_bottleneck_cuda, fake=_output)
"""``detr_torch::fused_bottleneck``: kernel E, out in x's memory format."""


def launch_simt(x, w1t, b1, w2t, b2, w3t, b3):
    """One launch of the SIMT kernel on CUDA tensors, fp32 or bf16. No path
    takes it; a direct call times it beside E-mma and E-tf32."""
    operands = (x, w1t, b1, w2t, b2, w3t, b3)
    _check(*operands)
    _check_kernel_inputs(*operands)
    n, c, h, w = x.shape
    m = w1t.shape[-1]
    if c % _CHUNK or m % _CHUNK or m > MAX_WIDTH:
        raise ValueError(f"the fused bottleneck kernel takes C and M multiples of {_CHUNK} and "
                         f"M <= {MAX_WIDTH}, got C={c}, M={m}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library(_SOURCE).fused_bottleneck(
            *(t.data_ptr() for t in operands), out.data_ptr(), n, c, m, h, w,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_bottleneck launch failed: cudaError {err}")
    fused_bottleneck.launches += 1
    return out


def _launch_tensor_cores(source, dtype, plan, operands):
    """One launch of the tensor-core kernel of ``source`` on CUDA tensors of
    ``dtype``, at ``plan``'s plan; returns the output."""
    name = source[:-len(".cu")]
    _check(*operands)
    x, w1t, w2t, w3t = operands[0], operands[1], operands[3], operands[5]
    if x.dtype != dtype:
        raise TypeError(f"the {name} kernel takes {str(dtype)[6:]}, got {x.dtype}")
    _check_kernel_inputs(*operands)
    n, c, h, w = x.shape
    m = w1t.shape[-1]
    plan(c, m)
    if any(t.data_ptr() % 16 for t in (x, w1t, w2t, w3t)):
        raise ValueError(f"the {name} kernel takes 16-byte aligned x and weights")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = getattr(_library(source), name)(
            *(t.data_ptr() for t in operands), out.data_ptr(), n, c, m, h, w,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def launch_mma(x, w1t, b1, w2t, b2, w3t, b3):
    """One launch of E-mma on bf16 CUDA tensors, at ``mma_plan``'s plan."""
    out = _launch_tensor_cores(_MMA_SOURCE, torch.bfloat16, mma_plan,
                               (x, w1t, b1, w2t, b2, w3t, b3))
    fused_bottleneck.mma_launches += 1
    return out


def launch_tf32(x, w1t, b1, w2t, b2, w3t, b3):
    """One launch of E-tf32 on fp32 CUDA tensors, at ``tf32_plan``'s plan."""
    out = _launch_tensor_cores(_TF32_SOURCE, torch.float32, tf32_plan,
                               (x, w1t, b1, w2t, b2, w3t, b3))
    fused_bottleneck.tf32_launches += 1
    return out


def _occupancy(source, m):
    name = source[:-len(".cu")] + "_occupancy"
    clusters, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = getattr(_library(source), name)(m, ctypes.addressof(clusters), ctypes.addressof(smem))
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    return clusters.value, smem.value


def mma_occupancy(m: int) -> tuple:
    """(clusters the current card holds at once, shared-memory bytes a CTA)
    of E-mma's plan at width M (``cudaOccupancyMaxActiveClusters``)."""
    return _occupancy(_MMA_SOURCE, m)


def tf32_occupancy(m: int) -> tuple:
    """The same for E-tf32's plan at width M."""
    return _occupancy(_TF32_SOURCE, m)


fused_bottleneck.launches = 0
fused_bottleneck.mma_launches = 0
fused_bottleneck.tf32_launches = 0
