"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled once per content hash with ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``: one ``nvcc -c``
per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o     (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libjrc_kernels.so *.o

into ``build/jrc_tpu_torch_kernels/<fingerprint>/<hash>/`` at the root of
the checkout: the fingerprint (``utils.cache.machine_fingerprint``) names the
host and nvcc's version, so a library built elsewhere is never loaded.
No PyTorch headers are included, so the build takes seconds. ``-fmad=false``
(and no ``--use_fast_math``) keeps every float operation an IEEE-rounded
mul or add, as in the plain PyTorch versions, so kernel and plain outputs
can be compared exactly.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches; ``call``
raises on a non-zero code. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from jrc_tpu_torch.utils.cache import default_cache_root, machine_fingerprint

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = default_cache_root() / "jrc_tpu_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
# C signatures of the entry points (all return cudaError_t as int)
SIGNATURES = {
    # values (B, 2T) f32, scratch (B, T, 2) i32 or NULL → bits (B, T) u8; B, T, use_global,
    # n_steps (B,) i64 or NULL, steps ring (rows, 2) i64 and call counter (1,) i64 or NULL, rows
    "jrc_viterbi_decode": [P, P, P, I, I, I, P, P, P, I, P],
    # x (n, 2) f32, or i16 + is-sc16 flag + its scale dq → a (n, 2) f32, seg_first/seg_count
    # (n_seg,) i32; n, margin, threshold, min_n_peaks, max_peak_distance, lag, win, pwin; the row
    # layout (9,) i64 on the host or NULL → start, cfo, valid (rows, max_frames) i64/f32/bool,
    # n_candidates (rows,) i64; count ring (rows, 2) i64 and call counter (1,) i64 or NULL, rows
    "jrc_detect_front_end": [P, I, F, P, P, P, I, I, F, I, I, I, I, I, P, P, P, P, P, P, P, I, P],
    # x (N, 2) f32, or i16 + is-sc16 flag + its scale dq, starts (B,) i64/i32 + is-64 flag →
    # out (B, width, 2) f32; N, B, width, omega (B,) f32 or NULL, n0 (B,) i32/i64 or NULL +
    # its kind (0 none, 1 i32, 2 i64)
    "jrc_gather_rows": [P, I, F, P, I, P, L, I, I, P, P, I, P],
    # x (64, B) f32 → out (64, B) f32; B, steps, variant
    "jrc_shuffle_pieces": [P, P, I, I, I, P],
    # x (N, 2) f32, starts (B,) i32 → out (B, w_out, 2) f32; n, B, width, w_out, variant
    "jrc_gather_pieces": [P, P, P, I, I, I, I, I, P],
    # va, vb (T, B) f32 → w0, w1 (T, B) i32, pm (64, B) f32; B, T, chunk_t, variant
    "jrc_viterbi_pieces": [P, P, P, P, P, I, I, I, I, P],
}

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / machine_fingerprint(_nvcc()) / h.hexdigest()[:16] / "libjrc_kernels.so"


def _run(procs) -> None:
    """Wait for every (source, Popen) and raise on the first failure."""
    failed = []
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> Path:
    """Compile the library unless this content hash is already built: one
    nvcc per source, started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
        objs = [Path(tmp_dir) / f"{src.stem}.o" for src in _sources()]
        _run([(src, subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                     stderr=subprocess.PIPE, text=True))
              for src, obj in zip(_sources(), objs)])
        tmp = Path(tmp_dir) / out.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        _run([("link", subprocess.Popen(link, stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


def lib() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def call(name: str, *args) -> None:
    """Launch entry point ``name`` on the current stream; raise on error."""
    # the raw handle: building a torch.cuda.Stream per launch costs the host microseconds
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def ptr(t: torch.Tensor) -> int:
    """Device pointer of a contiguous CUDA tensor (a complex64 tensor is its
    interleaved (re, im) float32 pairs)."""
    if not t.is_cuda or not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous CUDA tensors")
    return t.data_ptr()
