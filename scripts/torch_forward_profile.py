#!/usr/bin/env python3
"""Where the device time of one DETR-R50 forward goes, on one NVIDIA GPU.

  python3 scripts/torch_forward_profile.py [--dtype float32|bfloat16] [--fused [--masked]]
                                           [--int8] [--root DIR]

Builds the full-width DETR-R50 (seeded random weights), runs it on one
masked 800x1333 image on the 896x1408 canvas (b1, the served bucket) or,
with ``--fused``, the fused-backbone model (``fuse_residual``,
``fuse_bottleneck``) on one bucket-exact 768x1280 image without a mask
(the route of kernel E; with ``--masked``, on the masked 800x1333 image,
the route of kernel D on every block) or, with ``--int8``, the int8
backbone at bf16 compute (``backbone_quant``, quantized from its own fp32
backbone on two seeded 800x1333 images; kernels F and G) on the masked
image, under ``torch.profiler`` for 3 forwards after a warm-up, and prints
per forward: the device time summed over every kernel, the attention
forward kernels' share of it (with their launches), the hand-written
backbone kernels' (C, D, D-mma, D-tf32, E, E-mma, E-tf32, F, G), and the
ten kernels that take the most time. TF32 is off for fp32 matmuls and
convolutions, as on the served path of ``chip_smoke.py``. ``--root`` takes
the package from another checkout (a ``git archive`` of another commit),
to compare two commits on one card.
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

import torch

CALLS = 3


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    parser.add_argument("--fused", action="store_true",
                        help="the fused-backbone model at a bucket-exact 768x1280 image")
    parser.add_argument("--masked", action="store_true",
                        help="with --fused: at the masked 800x1333 image instead")
    parser.add_argument("--int8", action="store_true",
                        help="the int8 backbone at bf16 compute, at the masked 800x1333 image")
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                        help="the checkout whose detr_tensorflow_tpu_torch to run")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    sys.path.insert(0, str(args.root.resolve()))
    from detr_tensorflow_tpu_torch.models import api, quantized

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    flags = dict(fuse_residual=True, fuse_bottleneck=True) if args.fused else {}
    if args.int8:
        args.dtype, flags = "bfloat16", dict(backbone_quant=True)
    model = api.build_detr(seed=0, device="cuda", dtype=args.dtype, **flags)
    gen = torch.Generator(device="cuda").manual_seed(1)
    if args.int8:
        quantized.quantize_model(
            model, torch.randn((2, 800, 1333, 3), device="cuda", generator=gen))
    if args.fused and not args.masked:
        x, mask = torch.randn((1, 768, 1280, 3), device="cuda", generator=gen), None
    else:
        x = torch.zeros((1, 896, 1408, 3), device="cuda")
        x[:, :800, :1333] = torch.randn((1, 800, 1333, 3), device="cuda", generator=gen)
        mask = torch.zeros((1, 896, 1408), dtype=torch.bool, device="cuda")
        mask[:, :800, :1333] = True
    with torch.inference_mode():
        for _ in range(2):
            model(x, mask)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                model(x, mask)
            torch.cuda.synchronize()
    times, counts = collections.Counter(), collections.Counter()
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if t and evt.device_type == torch.autograd.DeviceType.CUDA:
            times[evt.key] += t / 1e3 / CALLS
            counts[evt.key] += evt.count // CALLS
    total = sum(times.values())
    attn = {k: v for k, v in times.items() if "flash_attention" in k}
    attn_ms = sum(attn.values())
    where = ("fused " if args.fused else "int8 backbone " if args.int8 else "") + (
        "768x1280 bucket-exact" if args.fused and not args.masked else "896x1408 masked")
    print(f"{torch.cuda.get_device_name(0)}, DETR-R50 {args.dtype} b1 {where}, per "
          f"forward: device time {total:.3f} ms over {sum(counts.values())} kernels; attention "
          f"forward {attn_ms:.3f} ms ({100 * attn_ms / total:.1f}%) in "
          f"{sum(counts[k] for k in attn)} launches", flush=True)
    for label, name in (("C", "max_pool_3x3_s2_kernel"),
                        ("D (SIMT)", "conv1x1_bn_residual_relu_kernel"),
                        ("D-mma", "conv1x1_bn_residual_relu_mma_kernel"),
                        ("D-tf32", "conv1x1_bn_residual_relu_tf32_kernel"),
                        ("E (SIMT)", "fused_bottleneck_kernel"),
                        ("E-mma", "fused_bottleneck_mma_kernel"),
                        ("E-tf32", "fused_bottleneck_tf32_kernel"),
                        ("F", "int8_matmul_kernel"), ("G", "int8_conv3x3_kernel")):
        keys = [k for k in times if name in k]
        if keys:
            print(f"  kernel {label}: {sum(times[k] for k in keys):.3f} ms in "
                  f"{sum(counts[k] for k in keys)} launches", flush=True)
    for key, ms in times.most_common(10):
        print(f"  {ms:8.3f} ms  x{counts[key]:<4d} {key[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
