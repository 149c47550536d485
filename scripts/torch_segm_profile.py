#!/usr/bin/env python3
"""Where the device time of one masked DETR-R50 request goes, on one NVIDIA GPU.

  python3 scripts/torch_segm_profile.py [--dtype float32|bfloat16 ...] [--top 12]

Builds the full-width DETR-R50 with its segmentation head (seeded random
weights, ``build_detr(masks=True)``) behind ``Predictor(masks=True)`` and
serves one 800x1333 image (the 896x1408 bucket, stride-4 masks of 224x352)
after a warm-up. Under ``torch.profiler``, 3 calls each of: the same
detector's forward without the head (``masks=False``, the same seed); the
model's forward; the segmentation head alone (``bbox_attention`` and
``mask_head`` on the inputs that forward gives them); the ``Predictor``'s
mask postprocess alone (the kept queries' probabilities cropped, resized
bilinearly to 800x1333 and thresholded on the device, and the bool masks
copied to the host); and the whole request. For each it prints the wall
and device-busy ms per call (busy: the union of the card's kernel and copy
intervals), the kernels and copies per call, and for the head and the
request the kernels that take the most device time. TF32 is off for fp32
matmuls and convolutions, as on the served path of ``chip_smoke.py``.

``--convs`` also times each convolution of the segmentation head alone on
the input the request gives it (CUDA events, 5 calls after 2), as the head
runs it (an NHWC tensor seen as channels_last NCHW) and as a contiguous
NCHW tensor, each with cuDNN's heuristic choice and with
``torch.backends.cudnn.benchmark`` (the fastest algorithm measured), and
prints the kernels the heuristic choice launches.
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
CALLS = 3


def profiled(fn):
    """(wall ms, busy ms, events, {kernel name: (ms, launches)}) per call
    of ``fn`` over CALLS calls."""
    from torch.profiler import ProfilerActivity, profile
    import time

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / CALLS
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / CALLS
        by_name[e.name][1] += 1
    return wall, busy / 1e3 / CALLS, len(events) / CALLS, {
        k: (v[0], v[1] // CALLS) for k, v in by_name.items()}


def time_convs(model):
    """Each conv of the mask head on its served input: ms per call for
    (channels_last, NCHW) x (heuristic, benchmark)."""
    from torch.profiler import ProfilerActivity, profile

    inputs = {}
    convs = {n: m for n, m in model.module.mask_head.named_children()
             if isinstance(m, torch.nn.Conv2d)}
    hooks = [m.register_forward_hook(lambda mod, a, o, n=n: inputs.__setitem__(n, a[0]))
             for n, m in convs.items()]
    frames = torch.zeros((1, 896, 1408, 3), device="cuda")
    pm = torch.zeros((1, 896, 1408), dtype=torch.bool, device="cuda")
    pm[0, :800, :1333] = True
    with torch.inference_mode():
        model(frames, pm)
    for h in hooks:
        h.remove()

    def ms(fn, iters=5):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    print("  conv (input shape, dtype): ms channels_last heuristic / benchmark, NCHW heuristic "
          "/ benchmark; heuristic kernels (channels_last)")
    x, conv = inputs["lay2"], convs["lay2"]
    d = model.module.model_dim
    w = conv.weight.to(x.dtype)
    b = conv.bias.to(x.dtype)

    def split():
        return (torch.nn.functional.conv2d(x[:, :d], w[:, :d], b, padding=1)
                + torch.nn.functional.conv2d(x[:, d:], w[:, d:], None, padding=1))

    with torch.inference_mode():
        err = float((split() - conv(x)).abs().max())
        print(f"    lay2 as two convs over its first {d} and last {x.shape[1] - d} input channels, "
              f"summed: {ms(split):.3f} ms (max |delta| against one conv {err:.2e})")
    for name, x in inputs.items():
        conv = convs[name]
        row = []
        with torch.inference_mode():
            for layout in (x, x.contiguous()):
                for bench in (False, True):
                    with torch.backends.cudnn.flags(enabled=True, benchmark=bench,
                                                    deterministic=False, allow_tf32=False):
                        row.append(ms(lambda: conv(layout)))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                conv(x)
                torch.cuda.synchronize()
        kernels = collections.Counter(e.name[:60] for e in prof.events()
                                      if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"    {name:>10} {tuple(x.shape)} {str(x.dtype)[6:]}: "
              + " / ".join(f"{v:.3f}" for v in row[:2]) + ", "
              + " / ".join(f"{v:.3f}" for v in row[2:]) + f"; {dict(kernels)}")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"],
                        choices=("float32", "bfloat16"))
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--convs", action="store_true",
                        help="time each conv of the head alone, per layout and cuDNN choice")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    from detr_tensorflow_tpu_torch import inference
    from detr_tensorflow_tpu_torch.models import api
    from detr_tensorflow_tpu_torch.predictor import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}, torch {torch.__version__}")
    img = np.random.default_rng(52).integers(0, 256, (800, 1333, 3), dtype=np.uint8)
    frames = np.zeros((1, 896, 1408, 3), np.uint8)
    frames[0, :800, :1333] = img
    for dtype in args.dtype:
        model = api.build_detr(masks=True, dtype=dtype, device="cuda")
        pred = Predictor(model, background_class=91, masks=True)
        pred.warmup([(800, 1333)])
        pm = torch.zeros((1, 896, 1408), dtype=torch.bool, device="cuda")
        pm[0, :800, :1333] = True
        with torch.inference_mode():
            x = pred.normalize(torch.from_numpy(frames).cuda()) * pm[..., None]
        head_args = {}
        hooks = [getattr(model.module, n).register_forward_hook(
            lambda m, a, o, n=n: head_args.__setitem__(n, a))
            for n in ("bbox_attention", "mask_head")]
        with torch.inference_mode():
            model(x, pm)
        for h in hooks:
            h.remove()
        (_, _, _, keep), probs = pred._run(frames, pm.cpu().numpy())
        keep = keep[0].cpu().numpy()

        def head():
            with torch.inference_mode():
                model.module.mask_head(*head_args["mask_head"])
                model.module.bbox_attention(*head_args["bbox_attention"])

        if args.convs:
            time_convs(model)
        detector = api.build_detr(dtype=dtype, device="cuda")
        runs = {"detector alone": lambda: detector(x, pm), "forward": lambda: model(x, pm),
                "segmentation head": head,
                "mask postprocess": lambda: inference.kept_masks(probs[0], keep, 800, 1333),
                "request": lambda: pred([img])}
        print(f"\n{dtype}: DETR-R50 with masks, 800x1333 b1, {int(keep.sum())} kept queries")
        for name, fn in runs.items():
            fn()
            wall, busy, events, kernels = profiled(fn)
            print(f"  {name:>17}: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
                  f"{events:.0f} kernels and copies a call")
            if name in ("segmentation head", "request"):
                for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:args.top]:
                    print(f"      {ms:8.3f} ms  x{n:<4d} {k[:110]}")
        del model, pred, probs, head_args, detector
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
