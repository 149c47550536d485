#!/usr/bin/env python3
"""Host cost of the serving artifacts' two layers, on the CPU: a call of a
``detr_torch`` custom op against its implementation called directly, and a
loaded bucket program against the live ``Predictor.serve_forward`` it was
traced from.

  python3 scripts/torch_artifact_host_probe.py [--calls N]

One intra-op thread. The op: kernel C's ``detr_torch::max_pool_3x3_s2`` on a
(1, 4, 6, 6) channels_last input (the work is ~nothing, so the gap is the
dispatcher's round trip through Python). The program: the reduced model of
``tests/test_torch_export.py`` at its (64, 128) bucket, exported and loaded
on the CPU, called in turns with ``serve_forward`` on the same b1 input; its
graph's ATen and ``detr_torch`` calls are counted. Medians over N calls in
µs and ms; a host reading, not a device one.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from detr_tensorflow_tpu_torch import export  # noqa: E402
from detr_tensorflow_tpu_torch.models import api  # noqa: E402
from detr_tensorflow_tpu_torch.ops import maxpool  # noqa: E402
from detr_tensorflow_tpu_torch.predictor import Predictor  # noqa: E402

CONFIG = dict(num_classes=5, num_queries=6, head="detr", backbone_stage_sizes=(1, 1, 1, 1),
              model_dim=64, num_heads=2, num_encoder_layers=1, num_decoder_layers=1,
              dim_feedforward=64)


def medians(fns: dict, calls: int) -> dict:
    """Median wall ms of each function, called in turns after a warm-up."""
    times = {k: [] for k in fns}
    for fn in fns.values():
        for _ in range(10):
            fn()
    for i in range(calls):
        for key in list(fns)[::1 if i % 2 == 0 else -1]:
            t0 = time.perf_counter()
            fns[key]()
            times[key].append(1e3 * (time.perf_counter() - t0))
    return {k: statistics.median(v) for k, v in times.items()}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--calls", type=int, default=200)
    args = parser.parse_args()
    torch.set_num_threads(1)

    x = torch.rand(1, 4, 6, 6).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        op = medians({"op": lambda: maxpool.pool_op(x),
                      "implementation": lambda: maxpool._pool_cpu(x)}, 50 * args.calls)
    print(f"C's op {1e3 * op['op']:.2f} µs a call, its implementation "
          f"{1e3 * op['implementation']:.2f} µs: {1e3 * (op['op'] - op['implementation']):.2f} "
          "µs of dispatch")

    live = Predictor(api.build_detr(device="cpu", seed=1, **CONFIG), background_class=0,
                     bucket_divisor=64)
    with tempfile.TemporaryDirectory() as path:
        export.export_predictor(live, path, [(64, 128)])
        program = export.load_predictor(path, device="cpu")._programs[(64, 128), True]
    graph = program.module.graph
    calls = sum(n.op == "call_function" for n in graph.nodes)
    frames = torch.zeros((1, 64, 128, 3), dtype=torch.uint8)
    mask = torch.ones((1, 64, 128), dtype=torch.bool)
    with torch.inference_mode():
        ms = medians({"program": lambda: program(frames, mask),
                      "live": lambda: live.serve_forward(frames, mask)}, args.calls)
    print(f"b1 (64, 128): loaded program {ms['program']:.3f} ms ({calls} calls in its graph), "
          f"live serve_forward {ms['live']:.3f} ms: {ms['program'] - ms['live']:.3f} ms more, "
          f"{1e3 * (ms['program'] - ms['live']) / calls:.2f} µs a graph call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
