"""Profiling and timing (port of ``detr_tensorflow_tpu/utils/profiling.py``).

  * ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU and,
    on the card, CUDA activity) that writes a Chrome trace into ``logdir``
    and keeps the profile for ``device_stats_per_step``;
  * ``Timer`` / ``benchmark_fn``: host-clock timing that materializes the
    outputs by reading one element back to the host (a bare
    ``synchronize`` would also wait for other streams' unrelated work, and
    says nothing on the CPU), as the JAX package's ``_materialize``;
  * ``device_stats_per_step(trace, steps)``: the device time a step, the
    sum of the CUDA kernels' durations (copies and memsets apart) in a
    profile or in the newest Chrome trace under a directory. It returns
    None when there are no CUDA events, as the JAX package returns None
    without a TPU plane.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import tempfile
import time
from typing import Callable, Optional

import torch

# Chrome-trace event categories of the device's work (torch.profiler's names).
_KERNEL_CATS = ("kernel",)
_COPY_CATS = ("gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(logdir: str, record_shapes: bool = False):
    """Profile the block and write its Chrome trace to
    ``logdir/trace_<pid>_<ns>.json``; yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=record_shapes)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.chrome_trace_path = os.path.join(logdir,
                                              f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.chrome_trace_path)


def device_ms_per_step(trace_or_profile, steps: int = 1) -> Optional[float]:
    """Device ms a step (``device_stats_per_step``), None without CUDA events."""
    stats = device_stats_per_step(trace_or_profile, steps)
    return stats["device_ms"] if stats else None


def _events(trace_or_profile):
    """Chrome-trace events of a profile, or of the newest trace (.json or
    .json.gz) under a directory; None when there is none."""
    if not isinstance(trace_or_profile, (str, os.PathLike)):
        saved = getattr(trace_or_profile, "chrome_trace_path", None)
        if saved is not None:  # ``trace`` wrote it (a trace is written once)
            return _read(saved)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            trace_or_profile.export_chrome_trace(path)
            return _read(path)
    root = os.fspath(trace_or_profile)
    paths = [root] if os.path.isfile(root) else sorted(
        glob.glob(os.path.join(root, "**", "*.json"), recursive=True)
        + glob.glob(os.path.join(root, "**", "*.json.gz"), recursive=True),
        key=os.path.getmtime)
    return _read(paths[-1]) if paths else None


def _read(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def device_stats_per_step(trace_or_profile, steps: int = 1) -> Optional[dict]:
    """Per-step device stats of a ``torch.profiler`` profile, or of the
    newest Chrome trace under a directory (or a trace file): the summed
    durations of the CUDA kernels (``device_ms``) and of the copies and
    memsets (``copy_ms``), the kernel count (``kernels``), each divided by
    ``steps``, and the device busy span of the trace (``span_ms``, first
    kernel start to last kernel end, not divided). Excludes host time and
    launch latency by construction. None when no CUDA kernel was traced
    (a CPU run)."""
    events = _events(trace_or_profile)
    if not events:
        return None
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") in _KERNEL_CATS]
    if not kernels:
        return None
    copies = [e for e in events if e.get("ph") == "X" and e.get("cat") in _COPY_CATS]
    n = max(1, int(steps))
    start = min(float(e["ts"]) for e in kernels)
    end = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in kernels)
    return {
        "device_ms": sum(float(e.get("dur", 0.0)) for e in kernels) / 1e3 / n,
        "copy_ms": sum(float(e.get("dur", 0.0)) for e in copies) / 1e3 / n,
        "kernels": len(kernels) / n,
        "span_ms": (end - start) / 1e3,
    }


def _materialize(x):
    """Wait for ``x``'s computation: read one element of its first tensor
    back to the host."""
    leaf = _first_tensor(x)
    if leaf is not None and leaf.numel():
        leaf.detach().reshape(-1)[:1].cpu()
    return x


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


class Timer:
    """Accumulating section timer: ``with timer('fwd', sync_result=out): ...``."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync_result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_result is not None:
                _materialize(sync_result)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:>24}: {total:8.3f}s total, {total / n * 1e3:8.2f} ms/call x{n}")
        return "\n".join(lines)


def benchmark_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2,
                 name: Optional[str] = None) -> dict:
    """Time a callable: {'name', 'ms_per_iter', 'iters'}. Queues ``iters``
    calls and materializes only the last output: in-order device execution
    bounds the total, without a host sync a call."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _materialize(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _materialize(out)
    dt = time.perf_counter() - t0
    return {"name": name or getattr(fn, "__name__", "fn"), "ms_per_iter": dt / iters * 1e3,
            "iters": iters}
