#!/usr/bin/env python3
"""What a served request and a training step of full-width DETR-R50 cost at
fp32 and at bf16 compute, on one NVIDIA GPU, for this checkout and another.

  python3 scripts/torch_dtype_cost_probe.py [--root DIR] [--requests N] [--steps N]

For each package, in a process of its own: the median wall time of N b1
800x1333 requests through ``Predictor`` (the 896x1408 bucket, seeded random
weights, TF32 off) and of N b8 376x672 training steps through ``Trainer``
(dropout 0.1, ``TrainingConfig``'s default rates), at float32 and at
bfloat16; for each, the wall time, device-busy time and device events
(kernels and copies) per call over 3 calls under ``torch.profiler``, and
the steps' peak device memory. A ``Trainer`` that refuses a dtype is
reported as refusing it. With ``--root`` (a ``git archive`` of another
commit) the two packages run in turns, other, this, this, other, so that
both are read on one card within one call; the card's name and power limit
are printed first. Each process prints one JSON line, and a table of all
of them ends the output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
REQUEST_HW, BUCKET = (800, 1333), (896, 1408)
TRAIN_BATCH, TRAIN_HW = 8, (376, 672)
BACKGROUND = 91  # DETR-R50's "no object" logit of 92
# The kernels of these four paths: served fp32 (A-tf32, C), served bf16
# (A-mma, C), the fp32 step (A-tf32, the tensor-core A', B, C) and the bf16
# step (the SIMT A and A', B, C).
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "flash_attention_fwd_mma.cu",
           "flash_attention_bwd_mma.cu", "flash_attention_fwd_tf32.cu", "lap.cu", "maxpool.cu")
MARK = "RESULT "


def device_busy(torch, fn, calls: int = 3):
    """(wall ms, device-busy ms, device events) per call of ``fn`` over
    ``calls`` calls under torch.profiler; busy is the union of the card's
    kernel and copy intervals."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return {"profiled_wall_ms": wall_ms, "busy_ms": busy_us / 1e3 / calls,
            "events": len(spans) / calls}


def train_batch(seed, pad_targets, max_targets):
    """A native b8 376x672 batch: normalized-scale images and 1-20 boxes an
    image, padded with ``pad_targets``."""
    rng = np.random.default_rng(seed)
    boxes, classes, mask = zip(*(
        pad_targets(np.concatenate([rng.uniform(0.1, 0.9, (n, 2)),
                                    rng.uniform(0.05, 0.5, (n, 2))], -1),
                    rng.integers(0, BACKGROUND, size=n), max_targets)
        for n in rng.integers(1, 21, size=TRAIN_BATCH)))
    images = rng.normal(size=(TRAIN_BATCH,) + TRAIN_HW + (3,)).astype(np.float32)
    return {"images": images, "boxes": np.stack(boxes), "classes": np.stack(classes),
            "mask": np.stack(mask)}


def measure(root: Path, requests: int, steps: int) -> dict:
    """Every reading of the package under ``root``, in this process."""
    sys.path.insert(0, str(root))
    import torch

    import detr_tensorflow_tpu_torch as pkg
    from detr_tensorflow_tpu_torch import train
    from detr_tensorflow_tpu_torch.data import MAX_TARGETS, pad_targets
    from detr_tensorflow_tpu_torch.models import api
    from detr_tensorflow_tpu_torch.ops import nvcc_build
    from detr_tensorflow_tpu_torch.predictor import Predictor
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    if not Path(pkg.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {pkg.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc_build.build_all(SOURCES)
    image = np.random.default_rng(1).integers(0, 256, size=REQUEST_HW + (3,), dtype=np.uint8)
    batch = batch_to_device(train_batch(6, pad_targets, MAX_TARGETS), "cuda")
    out = {"root": str(root)}
    for dtype in ("float32", "bfloat16"):
        predictor = Predictor(api.build_detr(seed=0, device="cuda", dtype=dtype),
                              background_class=BACKGROUND)
        predictor.warmup([REQUEST_HW])
        lat = []
        for _ in range(requests):
            t0 = time.perf_counter()
            predictor([image])
            lat.append(1e3 * (time.perf_counter() - t0))
        out[f"request {dtype}"] = {"median_ms": statistics.median(lat), "ms": lat,
                                   **device_busy(torch, lambda: predictor([image]))}
        del predictor
        torch.cuda.empty_cache()

        config = train.TrainingConfig(background_class=BACKGROUND, train_backbone=True,
                                      train_transformers=True, batch_size=TRAIN_BATCH)
        model = api.build_detr(seed=0, device="cuda", dtype=dtype).module  # dropout 0.1
        try:
            trainer = train.Trainer(model, config, seed=0)
        except (NotImplementedError, ValueError) as err:
            out[f"step {dtype}"] = {"refused": str(err)}
            del model
            continue

        def step():
            trainer.step(batch)
            torch.cuda.synchronize()

        step()  # cuDNN plans and kernel loads
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            times.append(1e3 * (time.perf_counter() - t0))
        out[f"step {dtype}"] = {"median_ms": statistics.median(times), "ms": times,
                                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                                **device_busy(torch, step)}
        del trainer, model
        torch.cuda.empty_cache()
    return out


def run_child(root: Path, requests: int, steps: int) -> dict:
    cmd = [sys.executable, __file__, "--child", str(root), "--requests", str(requests),
           "--steps", str(steps)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode:
        raise SystemExit(f"{' '.join(cmd)} exited {proc.returncode}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith(MARK))
    print(line, flush=True)
    return json.loads(line[len(MARK):])


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path, default=None,
                        help="another checkout, run in turns with this one")
    parser.add_argument("--requests", type=int, default=20)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        print(MARK + json.dumps(measure(args.child.resolve(), args.requests, args.steps)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    roots = [("this", HERE)]
    if args.root is not None:
        other = ("other", args.root.resolve())
        roots = [other, roots[0], roots[0], other]
    results = [(name, run_child(root, args.requests, args.steps)) for name, root in roots]
    print(f"{'package':8s} {'what':17s} {'median ms':>10s} {'busy ms':>9s} {'events':>8s} "
          f"{'peak GiB':>9s}")
    for name, res in results:
        for what, r in res.items():
            if what == "root":
                continue
            if "refused" in r:
                print(f"{name:8s} {what:17s} refused: {r['refused'][:60]}")
                continue
            peak = f"{r['peak_gib']:9.3f}" if "peak_gib" in r else f"{'':9s}"
            print(f"{name:8s} {what:17s} {r['median_ms']:10.2f} {r['busy_ms']:9.2f} "
                  f"{r['events']:8.0f} {peak}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
