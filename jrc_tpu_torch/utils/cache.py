"""Where the port keeps what it compiles (port of jrc_tpu/utils/cache.py).

The checkout persists, but the host it runs on may change. A shared library
compiled on one machine (another CPU, another compiler or CUDA toolkit)
must never be loaded on another, so each build keys its output directory by
``machine_fingerprint``:

    <default_cache_root()>/<kind>/<fingerprint>/<content hash>/

The reference's third function, ``enable_compile_cache``, points XLA at such
a directory; the port has no XLA cache. Unlike the reference there is no
environment override of the root: the port has no switches. Neither build
includes a PyTorch header or links against PyTorch, so PyTorch's version is
not part of the fingerprint (nvcc's version line names the CUDA toolkit).
"""
from __future__ import annotations

import hashlib
import platform
import subprocess
from functools import lru_cache
from pathlib import Path


@lru_cache(maxsize=1)
def _cpu_bits() -> tuple[str, ...]:
    """machine, processor and the first core's model / flags / microcode /
    bugs lines of /proc/cpuinfo (the flags alone do not tell two hosts
    apart whose compilers tune differently)."""
    bits = [platform.machine(), platform.processor()]
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "model name", "microcode", "bugs")):
                    bits.append(line.strip())
                if line.strip() == "" and len(bits) > 3:
                    break  # first core only
    except OSError:
        pass
    return tuple(bits)


@lru_cache(maxsize=None)
def compiler_version(compiler: str) -> str:
    """What ``compiler --version`` prints, or "" where it cannot be run (no
    compiler is needed to compute a fingerprint)."""
    try:
        out = subprocess.run([compiler, "--version"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def machine_fingerprint(compiler: str | None = None) -> str:
    """12 hex digits naming this host and, where given, the compiler that
    builds: the CPU's bits and ``compiler_version(compiler)``."""
    bits = list(_cpu_bits())
    if compiler is not None:
        bits.append(compiler_version(compiler))
    return hashlib.sha256("|".join(bits).encode()).hexdigest()[:12]


def default_cache_root() -> Path:
    """``build/`` at the root of the checkout."""
    return Path(__file__).resolve().parents[2] / "build"
