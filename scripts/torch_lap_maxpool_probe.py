#!/usr/bin/env python3
"""Kernels B (``csrc/lap.cu``, the batched LAP of matching) and C
(``csrc/maxpool.cu``, the stem's 3x3/s2 max pool) on one NVIDIA GPU.

  python3 scripts/torch_lap_maxpool_probe.py [--root DIR] [--variants] [--generic]
                                             [--train-profile]

Builds B and C of this checkout and, with ``--root``, those of the package
under DIR (a ``git archive`` of another commit), and calls each through its
C entry point (``lap_solve``, ``max_pool_3x3_s2``: the same in both), so
one process times both in turns: DIR's, this one's, this one's, DIR's.

B: 48 problems of 100 x 100 (``chip_smoke.lap_problems``), each build held
against the plain version and scipy (prefix and scattered row masks,
assignments equal; tied costs, optimal cost equal), then its device time
from CUDA graphs beside the time of a loop of wrapper calls (host
included), the bound and the serial chain (Dijkstra steps of the longest
problem, counted by the plain version). C: the stems of the 896x1408 and
768x1280 serving buckets (1, 64, 448, 704), (1, 64, 384, 640) and of the
b8 376x672 training step (8, 64, 188, 336), fp32 and bf16, bit-equal to
``F.max_pool2d`` on post-ReLU and signed inputs, with device times from
CUDA graphs beside ``F.max_pool2d`` and the bound.

``--variants``: B and C as built beside variants of their sources
(``VARIANTS``: text edits that must occur in the source), each checked and
timed at the same shapes in turns: the designs measured and dropped.
``--generic``: B's generic instance (above 255 columns) at the widths of
``chip_smoke.LAP_GENERIC`` beside the same source with its column and row
state always in the device scratch (the plan's other side; more rows are
then staged), both held to scipy's assignment and timed in turns, with the
serial chain and the microseconds a Dijkstra step.
``--train-profile``: one full-width DETR-R50 training step (b8 376x672,
fp32) under ``torch.profiler``: B's and C's device time and share of the
step's kernel time, and the serial chain of the step's own LAP problems.
Needs a card; exits non-zero if a build disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch_probe_common import build_text, edited, registers

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
# chip_smoke.py of this checkout: its timing, bound and problems.
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

STEMS = [(1, 64, 448, 704), (1, 64, 384, 640), chip_smoke.TRAIN_STEM]

_ARGMIN = """  const unsigned least = __reduce_min_sync(kFull, k);
  j = static_cast<int>(__reduce_min_sync(kFull, k == least ? static_cast<unsigned>(j) : kFull));
  k = least;
"""
_SHUFFLES = """#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned ok = __shfl_xor_sync(kFull, k, off);
    const int oj = __shfl_xor_sync(kFull, j, off);
    if (ok < k || (ok == k && oj < j)) {
      k = ok;
      j = oj;
    }
  }
"""
_RUN = """  const int run = one_wave<U, V, 4>(batch, h, w, c)   ? 4
                  : one_wave<U, V, 8>(batch, h, w, c) ? 8
                                                      : 16;
"""
_STAGED = "  cpa::cp_async_wait<0>();\n  __syncthreads();\n"
# The generic instance's plan, its state forced into the device scratch.
_SMEM_STATE = ("  plan.state_in_smem = state <= room;\n", "  plan.state_in_smem = false;\n")
# (kernel source, variant name, [(text in the source, replacement)]). A name
# that starts with "ablate" drops work, so its output is timed, not checked.
VARIANTS = [
    ("maxpool.cu", "C runs of 4", [(_RUN, "  const int run = 4;\n")]),
    ("maxpool.cu", "C runs of 8", [(_RUN, "  const int run = 8;\n")]),
    ("maxpool.cu", "C runs of 16", [(_RUN, "  const int run = 16;\n")]),
    ("maxpool.cu", "C two rows a thread", [("constexpr int ROWS = 1;", "constexpr int ROWS = 2;")]),
    ("maxpool.cu", "C 128-thread blocks",
     [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")]),
    ("lap.cu", "B shuffle argmin", [(_ARGMIN, _SHUFFLES)]),
    ("lap.cu", "B 4-byte staging",
     [("if ((cols & 3) == 0 && (reinterpret_cast", "if (false && (reinterpret_cast")]),
    ("lap.cu", "B 4 warps", [("constexpr int kWarps = 16;", "constexpr int kWarps = 4;")]),
    ("lap.cu", "B 8 warps", [("constexpr int kWarps = 16;", "constexpr int kWarps = 8;")]),
    ("lap.cu", "B 32 warps", [("constexpr int kWarps = 16;", "constexpr int kWarps = 32;")]),
    ("lap.cu", "B no auction",
     [("constexpr int kAuctionRounds = 5;", "constexpr int kAuctionRounds = 0;")]),
    ("lap.cu", "ablate B: staging only", [(_STAGED, _STAGED + "  if (n >= 0) return;\n")]),
    ("lap.cu", "ablate B: no augmenting paths", [("  if (warp != 0) return;\n", "  return;\n")]),
]


def build(nvcc_build, path: Path, text: str | None = None) -> ctypes.CDLL:
    """Compile ``text`` (default: the file at ``path``) with the package's
    nvcc flags, headers from ``path``'s directory, into the build directory
    under a name that carries its hash; print ptxas's register lines."""
    text = path.read_text() if text is None else text
    handle, log = build_text(nvcc_build, text, f"probe_{path.stem}", include_dir=path.parent)
    if log:
        print(f"  built {path.name} {hashlib.sha256(text.encode()).hexdigest()[:12]}: "
              f"{registers(log)}", flush=True)
    return handle


def lap_entry(handle):
    handle.lap_solve.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def call(cost, mask):
        p, r, c = cost.shape
        out = torch.empty((p, r), dtype=torch.int32, device=cost.device)
        if handle.lap_solve(cost.data_ptr(), mask.data_ptr(), out.data_ptr(), p, r, c,
                            torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("lap_solve failed to launch")
        return out
    return call


def generic_entry(handle):
    """``lap_solve_generic`` of one build, its scratch sized by that build's
    ``lap_scratch_bytes``."""
    handle.lap_solve_generic.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    handle.lap_scratch_bytes.argtypes = [ctypes.c_int] * 3
    handle.lap_scratch_bytes.restype = ctypes.c_int64

    def call(cost, mask):
        p, r, c = cost.shape
        out = torch.empty((p, r), dtype=torch.int32, device=cost.device)
        nbytes = handle.lap_scratch_bytes(p, r, c)
        scratch = torch.empty(max(nbytes, 4) // 4, dtype=torch.int32, device=cost.device)
        if nbytes < 0 or handle.lap_solve_generic(
                cost.data_ptr(), mask.data_ptr(), out.data_ptr(), scratch.data_ptr(), p, r, c,
                torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("lap_solve_generic failed to launch")
        return out
    call.scratch_bytes = handle.lap_scratch_bytes
    return call


def generic(lap, calls) -> list:
    """Each generic build at every LAP_GENERIC width (``chip_smoke``'s
    seeds): equal to scipy's assignment, timed in turns; the failures."""
    from scipy.optimize import linear_sum_assignment

    failed = []
    for k, (label, p, c, real, many) in enumerate(chip_smoke.LAP_GENERIC):
        cost, mask, n_real = chip_smoke.generic_lap_problems(90 + k, p, c, real, many)
        ct, mt = torch.from_numpy(cost).cuda(), torch.from_numpy(mask).cuda()
        want = [linear_sum_assignment(cm[m])[1] for cm, m in zip(cost, mask)]
        for name, call in calls.items():
            got = call(ct, mt).cpu().numpy()
            for i, m in enumerate(mask):
                if (got[i, ~m] != -1).any() or (got[i, m] != want[i]).any():
                    failed.append(f"{name}: {p}x{c}x{c} problem {i}")
        times = in_turns(calls, lambda call: lambda: call(ct, mt))
        chain = max(lap.augmenting_steps(ct.cpu(), mt.cpu()))
        print(f"B generic {p}x{c}x{c} ({label}), n_real {n_real.min()}..{n_real.max()}, serial "
              f"chain {chain} Dijkstra steps (CUDA graphs, ms; us a step at most): "
              + ", ".join(f"{n} (scratch {call.scratch_bytes(p, c, c)} B) {times[n]:.4f}"
                          f"{f' ({1e3 * times[n] / chain:.2f})' if chain else ''}"
                          for n, call in calls.items()), flush=True)
    return failed


def pool_entry(handle):
    handle.max_pool_3x3_s2.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])

    def call(x):
        b, c, h, w = x.shape
        out = torch.empty((b, c, (h - 1) // 2 + 1, (w - 1) // 2 + 1), device=x.device,
                          dtype=x.dtype, memory_format=torch.channels_last)
        if handle.max_pool_3x3_s2(x.data_ptr(), out.data_ptr(), b, h, w, c,
                                  int(x.dtype == torch.bfloat16),
                                  torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("max_pool_3x3_s2 failed to launch")
        return out
    return call


def check_lap(lap, call, label) -> list:
    """B against the plain version and scipy; the problems it got wrong."""
    from scipy.optimize import linear_sum_assignment

    failed = []
    for ties, scattered in ((False, False), (False, True), (True, False)):
        cost, mask, _ = chip_smoke.lap_problems(3 + ties, ties, scattered)
        ct, mt = torch.from_numpy(cost).cuda(), torch.from_numpy(mask).cuda()
        got = call(ct, mt).cpu().numpy()
        plain = lap.reference_solve_lap_masked(torch.from_numpy(cost),
                                               torch.from_numpy(mask)).numpy()
        for i, (c, m) in enumerate(zip(cost, mask)):
            rows, cols = linear_sum_assignment(c[m])
            ours = c[m][np.arange(m.sum()), got[i, m]].sum() if m.any() else 0.0
            bad = ((got[i, ~m] != -1).any() or len(set(got[i, m].tolist())) != m.sum()
                   or abs(ours - c[m][rows, cols].sum()) > 1e-4 * max(1.0, abs(ours))
                   or (not ties and (got[i] != plain[i]).any()))
            if bad:
                failed.append(f"{label}: lap problem {i} (ties {ties}, scattered {scattered})")
    return failed


def check_pool(call, x, label) -> list:
    F = torch.nn.functional
    failed = []
    for inp in (torch.relu(x), x):
        if not torch.equal(call(inp), F.max_pool2d(inp, 3, stride=2, padding=1)):
            failed.append(f"{label}: max pool {tuple(x.shape)} {x.dtype}")
    return failed


def in_turns(calls: dict, fn_of) -> dict:
    """Device ms of each call from CUDA graphs, in the order a, b, b, a (each
    the mean of its two)."""
    names = list(calls)
    order = names + names[::-1]
    times = {n: [] for n in names}
    for n in order:
        times[n].append(chip_smoke.graph_ms(torch, fn_of(calls[n])))
    return {n: sum(t) / len(t) for n, t in times.items()}


def train_profile(lap):
    """One b8 376x672 fp32 training step of DETR-R50 under torch.profiler."""
    from detr_tensorflow_tpu_torch import train
    from detr_tensorflow_tpu_torch.models import api
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = train.TrainingConfig(background_class=chip_smoke.BACKGROUND, train_backbone=True,
                                  train_transformers=True, batch_size=chip_smoke.TRAIN_BATCH)
    trainer = train.Trainer(api.build_detr(seed=0, device="cuda").module, config, seed=0)
    batch = batch_to_device(chip_smoke.train_batch(6), "cuda")
    for _ in range(2):
        trainer.step(batch)
    problems = []
    solve = lap.solve_lap_masked

    def recording(cost, mask):
        problems.append((cost.detach().cpu(), mask.cpu()))
        return solve(cost, mask)

    recording.launches = 0  # the wrapper counts on the name it is bound to
    lap.solve_lap_masked = recording  # matching looks it up at each call
    try:
        trainer.step(batch)
    finally:
        lap.solve_lap_masked = solve
    for cost, mask in problems:
        steps = lap.augmenting_steps(cost, mask)
        ct, mt = cost.cuda(), mask.cuda()
        ms = chip_smoke.graph_ms(torch, lambda: lap.solve_lap_masked(ct, mt))
        print(f"training step's LAP: {tuple(cost.shape)}, real rows {int(mask.sum())}, serial "
              f"chain of the longest problem {max(steps)} Dijkstra steps ({sum(steps)} in all); "
              f"B {ms:.4f} ms on them (CUDA graphs)")
    for i in range(3):
        total, by_name = chip_smoke.kernel_ms(torch, lambda: trainer.step(batch),
                                              ("lap_kernel", "max_pool_3x3_s2"))
        print(f"training step {i} under torch.profiler: {total:.2f} ms of kernel time; B "
              f"{by_name['lap_kernel']:.4f} ms ({by_name['lap_kernel'] / total:.3%}), C "
              f"{by_name['max_pool_3x3_s2']:.4f} ms ({by_name['max_pool_3x3_s2'] / total:.3%})",
              flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=None,
                        help="another checkout whose B and C to time beside this one's")
    parser.add_argument("--variants", action="store_true",
                        help="then time B and C beside variants of their sources")
    parser.add_argument("--generic", action="store_true",
                        help="then time B's generic instance beside its state always in scratch")
    parser.add_argument("--train-profile", action="store_true",
                        help="then profile one full-width training step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    from detr_tensorflow_tpu_torch.ops import lap, nvcc_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    csrc = nvcc_build.CSRC_DIR
    roots = {"this": csrc}
    if args.root is not None:
        roots = {"parent": args.root.resolve() / "detr_tensorflow_tpu_torch" / "csrc", **roots}
    jobs = [(name, kernel, root / kernel, None) for name, root in roots.items()
            for kernel in ("lap.cu", "maxpool.cu")]
    if args.variants:
        for kernel, name, edits in VARIANTS:
            text = edited((csrc / kernel).read_text(), edits, f"{kernel} {name}")
            jobs.append((name, kernel, csrc / kernel, text))
    if args.generic:
        text = edited((csrc / "lap.cu").read_text(), [_SMEM_STATE], "lap.cu state in scratch",
                      once=True)
        jobs.append(("state in scratch", "lap.cu", csrc / "lap.cu", text))
    with ThreadPoolExecutor(len(jobs)) as pool:
        handles = list(pool.map(lambda j: build(nvcc_build, j[2], j[3]), jobs))
    laps = {name: lap_entry(h) for (name, kernel, *_), h in zip(jobs, handles)
            if kernel == "lap.cu"}
    pools = {name: pool_entry(h) for (name, kernel, *_), h in zip(jobs, handles)
             if kernel == "maxpool.cu"}

    failed = []
    for name, call in laps.items():
        if not name.startswith("ablate"):
            failed += check_lap(lap, call, name)
    cost, mask, n_real = chip_smoke.lap_problems(3)
    ct, mt = torch.from_numpy(cost).cuda(), torch.from_numpy(mask).cuda()
    times = in_turns(laps, lambda call: lambda: call(ct, mt))
    loop = chip_smoke.time_ms(torch, lambda: lap.solve_lap_masked(ct, mt), iters=20, warmup=3)
    bound = chip_smoke.bound_ms(4 * chip_smoke.LAP_SLOTS * int(n_real.sum()) + 5 * mask.size, {})
    chain = max(lap.augmenting_steps(ct.cpu(), mt.cpu()))
    print(f"B 48x100x100, n_real 0..30 (CUDA graphs, ms): "
          + ", ".join(f"{n} {t:.4f}" for n, t in times.items())
          + f"; this checkout's wrapper in a loop of calls (host included) {loop:.4f}; bound "
          f"{bound[0]:.5f} ({bound[1]}); serial chain {chain} Dijkstra steps", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in STEMS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype).contiguous(
                memory_format=torch.channels_last)
            for name, call in pools.items():
                failed += check_pool(call, x, name)
            xr = torch.relu(x)
            calls = {**pools, "F.max_pool2d": lambda t: torch.nn.functional.max_pool2d(
                t, 3, stride=2, padding=1)}
            times = in_turns(calls, lambda call: lambda: call(xr))
            b, c, h, w = shape
            size = x.element_size()
            bound = chip_smoke.bound_ms(
                b * c * (h * w + ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1)) * size, {})
            print(f"C {shape} {str(dtype)[6:]} (CUDA graphs, ms): "
                  + ", ".join(f"{n} {t:.4f}" for n, t in times.items())
                  + f"; bound {bound[0]:.4f} ({bound[1]}), this checkout at "
                  f"{bound[0] / times['this']:.1%} of it", flush=True)
    if args.generic:
        builds = {name: h for (name, kernel, *_), h in zip(jobs, handles) if kernel == "lap.cu"}
        failed += generic(lap, {"this (state in shared memory where it fits)":
                                generic_entry(builds["this"]),
                                "state in scratch": generic_entry(builds["state in scratch"])})
    if args.train_profile:
        train_profile(lap)
    if failed:
        print("FAILED:\n  " + "\n  ".join(failed))
        return 1
    print("every build agrees with its plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
