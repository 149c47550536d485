"""What the card probes under ``scripts/`` share: a source made from a
kernel's by text edits, and a source given as text built with the package's
nvcc flags. Time a call from CUDA graphs with ``chip_smoke.graph_ms``.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path


def edited(base: str, edits, name: str, once: bool = False) -> str:
    """``base`` with each ``(old, new)`` of ``edits`` replaced, every
    occurrence; raises where ``old`` does not occur in the text so far, or,
    with ``once``, occurs more than once."""
    src = base
    for old, new in edits:
        count = src.count(old)
        if count == 0 or (once and count != 1):
            raise RuntimeError(f"variant {name!r}: {old!r} occurs {count} times in the source")
        src = src.replace(old, new)
    return src


def build_text(nvcc_build, text: str, stem: str, include_dir: Path | None = None,
               timeout: int = 900) -> tuple[ctypes.CDLL, str]:
    """Compile ``text`` with ``nvcc_build``'s flags and headers from
    ``include_dir`` (default: its ``csrc/``) into its build directory as
    ``<stem>_<hash of text>.so``, reused where that file exists; returns the
    ctypes handle and nvcc's output ("" where the build was reused)."""
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    path = nvcc_build.BUILD_DIR / f"{stem}_{digest}.cu"
    lib = path.with_suffix(".so")
    log = ""
    if not lib.exists():
        nvcc_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        include = str(include_dir or nvcc_build.CSRC_DIR)
        proc = subprocess.run([nvcc_build.nvcc_path(), *nvcc_build.NVCC_FLAGS, "-I", include,
                               "-o", str(lib), str(path)],
                              capture_output=True, text=True, timeout=timeout)
        log = proc.stdout + proc.stderr
        if proc.returncode:
            raise RuntimeError(f"{stem} {digest} failed to build:\n{log}")
    return ctypes.CDLL(str(lib)), log


def registers(log: str) -> list[str]:
    """ptxas's register and spill lines in nvcc's output."""
    return [ln.split("ptxas info    : ")[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
