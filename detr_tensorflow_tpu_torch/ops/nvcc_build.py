"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file exposes plain C entry points. It is compiled for
Hopper (``sm_90a``) into ``build/kernels/`` at the repository root, under
a name that carries a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source is rebuilt and an unchanged one
is reused. Nothing is built when a module is imported: the first launch of
a kernel builds it, and ``build_all`` compiles several sources at once,
one nvcc process each.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Build:
    """One compiled library: its path, the seconds nvcc took (0.0 when an
    existing build was reused) and nvcc's output (ptxas register and
    spill report)."""

    path: Path
    seconds: float
    log: str


_lock = threading.Lock()
_source_locks: dict[str, threading.Lock] = {}
_builds: dict[str, Build] = {}
_libraries: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA "
        "toolkit is installed (set CUDA_HOME or put nvcc on PATH)"
    )


def build(source: str) -> Build:
    """Compile ``csrc/<source>`` once per process (and once per content)."""
    with _lock:
        source_lock = _source_locks.setdefault(source, threading.Lock())
    with source_lock:
        if source in _builds:
            return _builds[source]
        src = CSRC_DIR / source
        content = src.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
        digest = hashlib.sha256(content + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        lib_path = BUILD_DIR / f"lib{src.stem}_{digest}.so"
        seconds, log = 0.0, ""
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            os.replace(tmp, lib_path)
        _builds[source] = Build(lib_path, seconds, log)
        return _builds[source]


def build_all(sources) -> list[Build]:
    """Compile several sources concurrently, one nvcc process each."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(build, sources))


def load_library(source: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<source>``, built on first use."""
    lib_path = build(source).path
    with _lock:
        if source not in _libraries:
            _libraries[source] = ctypes.CDLL(str(lib_path))
        return _libraries[source]
