#!/usr/bin/env python3
"""Kernel F (``csrc/int8_matmul.cu``, the int8 1x1 GEMM with requantization)
on one NVIDIA GPU, shape by shape.

  python3 scripts/torch_int8_matmul_probe.py [--root DIR] [--mma-rate] [--no-time] [--variants]

Builds F from the package under ``--root`` (default: this checkout; give a
``git archive`` of another commit to time that commit's F on the same
card), prints nvcc's ptxas report (registers, spills) and the IMMA (int8
tensor-core) instructions of each compiled configuration. Then, at the 16
F shapes of one b1 896x1408 int8 DETR-R50 forward and at ragged shapes,
holds the kernel against the plain version (int8 integer-equal, bf16 equal,
both epilogues) and, unless ``--no-time``, prints the plan and the bytes
its tiles move between L2 and the SMs (where the package has one), the
device time of one call from CUDA graphs, its bound, and ``torch._int_mm``
(the contraction alone, not the same function), with their sums over a
forward. With ``--mma-rate``, first the card's rate of
back-to-back ``mma.sync.m16n8k32`` s8 instructions alone (no loads: every
warp of 4 CTAs an SM issues 8 independent MMAs a loop step into int32
accumulators in registers), from CUDA events: the ceiling of F's products.
With ``--variants``, F as built beside variants of it generated from its
source or its plan (``VARIANTS``: another ring depth and chunk width,
wider and taller tiles, other cluster splits), each checked against the
plain version, and ablations that drop the products, the epilogue's
arithmetic or the stores (timed only), all timed at the 16 path shapes
in turns, with their sums a forward: the measurements behind the
configuration F compiles and what its time goes to. Needs a card; exits
non-zero if a shape disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch
from torch_probe_common import build_text, edited

REPO = Path(__file__).resolve().parent.parent
# chip_smoke.py of this checkout: its timing, bound, operands and shapes.
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# Ragged shapes (M, C, K, Cd, variant): partial row and channel tiles, the
# 8-byte int8 copies (K % 16 != 0), residual2s whose Cd differs from C,
# contractions deep enough for clusters of 2, 4 and 8, and many row tiles
# ending in a partial channel tile.
RAGGED = [(1, 64, 8, 0, "plain"), (105, 128, 48, 0, "residual"), (105, 64, 48, 128, "residual2"),
          (105, 2048, 64, 0, "plain"), (105, 1024, 8, 0, "residual"),
          (33, 512, 72, 1024, "residual2"), (105, 4096, 48, 0, "plain"),
          (40, 512, 64, 2048, "residual2"), (40000, 128, 200, 0, "residual"),
          (40000, 64, 136, 128, "residual2")]

MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) imma_rate_kernel(int* out, int iters) {
  const unsigned v = 0x01020304u * (threadIdx.x + 1);
  const unsigned a[4] = {v, v ^ 0x11u, v ^ 0x2200u, v ^ 0x330000u}, b0 = v ^ 0x44u, b1 = v;
  int d[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(d[j][0]), "+r"(d[j][1]), "+r"(d[j][2]), "+r"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int imma_rate(int ctas, int iters, void* out, void* stream) {
  imma_rate_kernel<<<ctas, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<int*>(out),
                                                                        iters);
  return static_cast<int>(cudaGetLastError());
}
"""


# F's variants: (name, [(text in csrc/int8_matmul.cu, replacement)][, the
# plan's DEPTH]).
_CFG = "BM = 128, BN = 64, WM = 4, WN = 2, KC = 64, S = 2, kMinBlocks = 3"
_SRC_EPILOGUE = ("*at = make_char2(i8::to_int8<kRelu, kPrecise>(y0), "
                 "i8::to_int8<kRelu, kPrecise>(y1));")
_SRC_PRODUCTS = "products(acc, st, a_row, a_hi, b_row, b_hi, swz);"
_SRC_PRODUCTS_D = "products(accd, st, a_row, a_hi, b_row, b_hi, swz);"
_SRC_STORE = "*reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(staged + r * ldo + cb);"
VARIANTS = [
    ("built", []),
    ("KC 128", [(_CFG, _CFG.replace("KC = 64", "KC = 128"))]),
    ("S 3", [(_CFG, _CFG.replace("S = 2", "S = 3"))]),
    ("BN 128, 4x2 warps, 2 CTAs", [(_CFG, _CFG.replace("BN = 64", "BN = 128").replace(
        "kMinBlocks = 3", "kMinBlocks = 2"))]),
    ("BM 256, 8x2 warps, 1 CTA", [(_CFG, _CFG.replace("BM = 128", "BM = 256").replace(
        "WM = 4", "WM = 8").replace("kMinBlocks = 3", "kMinBlocks = 1"))]),
    ("no cluster split", [], 1 << 20),  # DEPTH past every contraction: one CTA a tile
    ("split to 4 chunks", [], 4),
    # Ablations, timed but not checked: what each part of the kernel costs.
    ("ablate: no epilogue arithmetic", [(_SRC_EPILOGUE, "*at = make_char2(acc[mt][nt][2 * h], "
                                         "accd[mt][nt][2 * h + 1]);")]),
    ("ablate: no products", [(_SRC_PRODUCTS, "(void)swz;"), (_SRC_PRODUCTS_D, "(void)swz;")]),
    ("ablate: no stores", [(_SRC_STORE, "(void)dst;")]),
]


def variant_entries(nvcc_build):
    """Each variant of F built from the source with its replacements (every
    replaced text must occur; one build a distinct source), as a list of
    ctypes entry points in the order of VARIANTS."""
    from concurrent.futures import ThreadPoolExecutor

    base = (nvcc_build.CSRC_DIR / "int8_matmul.cu").read_text()
    sources = [edited(base, edits, name) for name, edits, *_ in VARIANTS]

    def build(src):
        handle, log = build_text(nvcc_build, src, "int8_matmul_variant")
        if log:
            regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                           if "Used " in ln})
            spills = sorted({ln.strip() for ln in log.splitlines()
                             if "spill" in ln and not ln.strip().startswith("0 bytes stack")})
            names = [v[0] for v, other in zip(VARIANTS, sources) if other == src]
            print(f"variants {names}: {regs}; {spills or 'no spills'}", flush=True)
        fn = handle.int8_matmul
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        return fn

    unique = list(dict.fromkeys(sources))
    with ThreadPoolExecutor(len(unique)) as pool:
        built = dict(zip(unique, pool.map(build, unique)))
    return [built[src] for src in sources]


def time_variants(mm, nvcc_build, operands):
    """The variants at the 16 path shapes, in turns; returns the shapes where
    one disagrees with the plain version."""
    entries, sums, failed = variant_entries(nvcc_build), {}, []
    codes = {"plain": 0, "residual": 1, "residual2": 2}
    for (m, c, k, cd, variant), count, (x, w, s, b, extra), ref in operands:
        res = rs = xd = wd = sd = bd = None
        if variant == "residual":
            res, rs = extra
        elif variant == "residual2":
            xd, wd, sd, bd = extra
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        line = f"variants {variant} M={m} C={c} K={k}{f' Cd={cd}' if cd else ''}:"
        for (name, *rest), fn in zip(VARIANTS, entries):
            depth = mm.DEPTH
            mm.DEPTH = rest[1] if len(rest) > 1 else depth
            cluster = mm.plan(m, c, k, cd).cluster
            mm.DEPTH = depth

            def call(fn=fn):
                out = torch.empty((m, k), dtype=torch.int8, device="cuda")
                if fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(), ptr(res), ptr(rs),
                      ptr(xd), ptr(wd), ptr(sd), ptr(bd), out.data_ptr(), m, c, k, cd,
                      codes[variant], 1, 0, 1, cluster, torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError(f"variant {name!r} failed to launch")
                return out

            if not name.startswith("ablate") and not torch.equal(call(), ref):
                failed.append((name, variant, m, c, k, cd))
            ms = chip_smoke.graph_ms(torch, call)
            sums[name] = sums.get(name, 0) + count * ms
            line += f" {name} {ms:.4f};"
        print(line, flush=True)
    for name, ms in sums.items():
        print(f"variant {name!r} per forward: {ms:.4f} ms", flush=True)
    return failed


def tile_bytes(mm, m, c, k, cd, variant):
    """Bytes F's CTAs move between L2 and the SMs at one shape: each output
    tile loads its rows of x (and xd) and its channels of W (and Wd) over
    the whole contraction, reads its residual and writes its output."""
    bm, bn = mm.TILE
    return (-(-m // bm)) * (-(-k // bn)) * (bm + bn) * (c + cd) + m * k * (
        2 if variant == "residual" else 1)


def mma_rate(nvcc_build, iters=8192):
    """TOP/s of back-to-back m16n8k32 s8 `mma.sync` (2 * 16 * 8 * 32 ops each)."""
    fn = build_text(nvcc_build, MMA_RATE_SOURCE, "imma_rate")[0].imma_rate
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    ctas = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(ctas * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if fn(ctas, 16, out.data_ptr(), stream):
        raise RuntimeError("imma_rate launch failed")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    if fn(ctas, iters, out.data_ptr(), stream):
        raise RuntimeError("imma_rate launch failed")
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    mmas = ctas * 8 * iters * 8
    print(f"mma.sync m16n8k32 s8 alone: {mmas * 2 * 16 * 8 * 32 / ms / 1e9:.1f} TOP/s ({ctas} "
          f"CTAs of 8 warps, 8 independent accumulators a warp, {ms:.3f} ms)", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=REPO,
                        help="the checkout whose detr_tensorflow_tpu_torch to build and time")
    parser.add_argument("--mma-rate", action="store_true",
                        help="first time mma.sync m16n8k32 s8 alone")
    parser.add_argument("--no-time", action="store_true", help="check every shape, time none")
    parser.add_argument("--variants", action="store_true",
                        help="then time F beside variants of its source")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    sys.path.insert(0, str(args.root.resolve()))
    from detr_tensorflow_tpu_torch.ops import int8_matmul as mm
    from detr_tensorflow_tpu_torch.ops import nvcc_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; F from "
          f"{Path(mm.__file__).resolve()}", flush=True)
    if args.mma_rate:
        mma_rate(nvcc_build)
    build = nvcc_build.build("int8_matmul.cu")
    print(f"F: nvcc {build.seconds:.1f} s", flush=True)
    name = ""
    for line in build.log.splitlines():
        if "Compiling entry" in line:
            name = chip_smoke.template_args(line)
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {name}: {line.strip()}")
    imma = {chip_smoke.template_args(n): c for n, c in
            chip_smoke.sass_counts(nvcc_build, build.path, "IMMA").items()}
    print(f"IMMA instructions a configuration <variant,relu,bf16 out,precise>: {imma}", flush=True)

    act, wts, scale, bias = chip_smoke.int8_operands(torch, seed=17)
    f_shapes, _ = chip_smoke.int8_path_shapes(*chip_smoke.INT8_BUCKET)
    shapes = [(key, count) for key, count in sorted(f_shapes.items())]
    shapes += [(key, 0) for key in RAGGED]
    failed, total, path_operands = [], torch.zeros(4, dtype=torch.float64), []
    for (m, c, k, cd, variant), count in shapes:
        x, w, s, b = act(m, c), wts(k, c), scale(k, c), bias(k)
        if variant == "plain":
            fn, extra = "qmatmul", ()
        elif variant == "residual":
            fn, extra = "qmatmul_residual", (act(m, k), torch.tensor(0.3, device="cuda"))
        else:
            fn, extra = "qmatmul_residual2", (act(m, cd), wts(k, cd), scale(k, cd), bias(k))
        kernel = lambda **kw: getattr(mm, fn)(x, w, s, b, *extra, relu=True, **kw)  # noqa: E731
        plain = lambda **kw: getattr(mm, "reference_" + fn)(  # noqa: E731
            x, w, s, b, *extra, relu=True, **kw)
        tag = f"{variant} M={m} C={c} K={k}{f' Cd={cd}' if cd else ''}"
        try:
            chip_smoke.check_int8(torch, fn, kernel, plain)
        except AssertionError as err:
            failed.append(f"{tag}: {err}")
            continue
        line = f"{tag}{f' (x{count})' if count else ' (ragged)'}: equal to plain"
        if count and args.variants:
            path_operands.append(((m, c, k, cd, variant), count, (x, w, s, b, extra),
                                  plain(precise=True)))
        if hasattr(mm, "plan"):
            p = mm.plan(m, c, k, cd)
            line += f"; plan {p.rows}x{p.channels}, cluster {p.cluster}, {p.ctas} CTAs"
        if not args.no_time and count:
            wt = w.t()
            if variant == "residual2":
                wdt = extra[1].t()
                library = lambda: (torch._int_mm(x, wt), torch._int_mm(extra[0], wdt))  # noqa: E731
            else:
                library = lambda: torch._int_mm(x, wt)  # noqa: E731
            ms = chip_smoke.graph_ms(torch, kernel)
            lib_ms = chip_smoke.graph_ms(torch, library)
            bound, by = chip_smoke.f_bound_ms(m, c, k, cd, variant)
            moved = tile_bytes(mm, m, c, k, cd, variant) if hasattr(mm, "TILE") else 0
            total += count * torch.tensor([ms, bound, lib_ms, moved], dtype=torch.float64)
            line += (f"; F {ms:.4f} ms, bound {bound:.4f} ms ({by}, {bound / ms:.1%} of it), "
                     f"torch._int_mm {lib_ms:.4f} ms")
            if moved:
                line += f"; tiles move {moved / 1e6:.2f} MB, {moved / ms / 1e9:.2f} TB/s"
        print(line, flush=True)
    if not args.no_time:
        print(f"per b1 896x1408 int8 forward (32 launches): F {total[0]:.4f} ms, bound "
              f"{total[1]:.4f} ms, torch._int_mm {total[2]:.4f} ms"
              + (f"; tiles move {total[3] / 1e9:.3f} GB, {total[3] / total[0] / 1e9:.2f} TB/s"
                 if total[3] else ""), flush=True)
    if args.variants:
        failed += [f"variant {v}" for v in time_variants(mm, nvcc_build, path_operands)]
    if failed:
        print("FAILED:\n  " + "\n  ".join(failed))
        return 1
    print("every shape agrees with the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
