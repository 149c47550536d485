#!/usr/bin/env python3
"""Kernel E's bf16 path (E-mma) on one NVIDIA GPU, shape by shape.

  python3 scripts/torch_fused_bottleneck_probe.py [--no-time]

Builds ``csrc/fused_bottleneck_mma.cu``, prints nvcc's ptxas report and
the HMMA (tensor-core) instructions in its SASS, and for each width's plan
the clusters the card holds at once (``cudaOccupancyMaxActiveClusters``)
and a CTA's shared memory. Then, at the four ResNet-50 widths on the maps of
a 768x1280 bucket-exact forward and at ragged maps, bf16, with nonzero
biases: E-mma against the plain version (error relative to the largest
plain value, tolerance 2e-2 as in ``chip_smoke.py``), and, unless
``--no-time``, the device time of one call of E-mma, of the SIMT kernel
called at bf16, of the plain version and of the unfused cuDNN chain, from
CUDA graphs. Needs a card; exits non-zero if a shape disagrees.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from detr_tensorflow_tpu_torch.ops import fused_bottleneck as fb  # noqa: E402
from detr_tensorflow_tpu_torch.ops import nvcc_build  # noqa: E402

RTOL = 2e-2
# (n, C, M, H, W): the 768x1280 bucket's maps, then ragged ones (partial
# tiles, a map smaller than one tile).
SHAPES = [(1, 256, 64, 192, 320), (1, 512, 128, 96, 160), (1, 1024, 256, 48, 80),
          (1, 2048, 512, 24, 40), (2, 256, 64, 13, 21), (2, 512, 128, 9, 11),
          (2, 1024, 256, 7, 5), (1, 2048, 512, 5, 7)]


def graph_ms(fn, iters=20, replays=3):
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def operands(n, c, m, h, w, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(n, c, h, w, device="cuda", generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w1, w3 = (torch.randn(s, device="cuda", generator=gen) * s[0] ** -0.5 for s in ((c, m), (m, c)))
    w2 = torch.randn(9, m, m, device="cuda", generator=gen) * (9 * m) ** -0.5
    b1 = torch.rand(m, device="cuda", generator=gen) + 0.5  # > 0: the halo is tested
    b2, b3 = (torch.randn(k, device="cuda", generator=gen) * 0.1 for k in (m, c))
    ops = (w1.to(torch.bfloat16), b1, w2.to(torch.bfloat16), b2, w3.to(torch.bfloat16), b3)
    return x, ops


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-time", action="store_true", help="check every shape, time none")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    build = nvcc_build.build("fused_bottleneck_mma.cu")
    print(f"nvcc {build.seconds:.1f} s", flush=True)
    for line in build.log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    cuobjdump = Path(nvcc_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    print(f"HMMA instructions in the SASS: {sum('HMMA' in ln for ln in sass.splitlines())}")
    for m, plan in fb.MMA_PLANS.items():
        clusters, smem = fb.mma_occupancy(m)
        print(f"M={m} plan {plan}: {smem} bytes of shared memory a CTA, at most {clusters} "
              f"clusters of {plan[2]} at once", flush=True)
    failed = []
    for n, c, m, h, w in SHAPES:
        x, ops = operands(n, c, m, h, w, seed=c + h)
        ref = fb.reference_fused_bottleneck(x, *ops)
        k1, k2, k3 = (ops[0].t()[:, :, None, None], ops[2].reshape(3, 3, m, m).permute(3, 2, 0, 1),
                      ops[4].t()[:, :, None, None])
        bd = [b.to(torch.bfloat16)[:, None, None] for b in ops[1::2]]

        def chain():
            t = F.relu(F.conv2d(x, k1) + bd[0])
            t = F.relu(F.conv2d(t, k2, padding=1) + bd[1])
            return F.relu(F.conv2d(t, k3) + bd[2] + x)

        got = fb.launch_mma(x, *ops)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max()) / max(
            1.0, float(ref.float().abs().max()))
        ok = err <= RTOL and bool(torch.isfinite(got).all())
        if not ok:
            failed.append((n, c, m, h, w, err))
        ms = "" if args.no_time else f" {graph_ms(lambda: fb.launch_mma(x, *ops)):.4f} ms"
        line = [f"n={n} C={c} M={m} {h}x{w}: E-mma plan {fb.mma_plan(c, m)}{ms} rel err "
                f"{err:.2e}{'' if ok else ' FAILED'};"]
        if not args.no_time:
            line.append(f"SIMT {graph_ms(lambda: fb.launch_simt(x, *ops)):.4f} ms; plain "
                        f"{graph_ms(lambda: fb.reference_fused_bottleneck(x, *ops)):.4f} ms; "
                        f"unfused cuDNN chain {graph_ms(chain):.4f} ms")
        print(" ".join(line), flush=True)
    if failed:
        print(f"FAILED: {failed}")
        return 1
    print("every shape agrees with the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
