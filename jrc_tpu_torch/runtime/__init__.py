"""Native host runtime: C++ SPSC IQ rings with overlapped block pop (port of
jrc_tpu/runtime/__init__.py:96-276).

``IQRing`` carries complex64 samples (8 B each), ``IQRing16`` int16 (re, im)
pairs (4 B each, the sc16 wire). ``pop_block`` returns
``[left_hist | block_len | halo]`` samples, the layout the flat-stream RX
consumes, and takes ``out=`` so that the streamer pops straight into a
pinned staging buffer.

The shared library is compiled from ``cc/jrc_runtime.cc`` at first use with

    g++ -O3 -shared -fPIC -std=c++17 -o libjrc_runtime.so jrc_runtime.cc

into ``build/jrc_tpu_torch_runtime/<fingerprint>/<content hash>/`` at the
root of the checkout (the fingerprint, ``utils.cache.machine_fingerprint``,
names the host and g++'s version, so a library built elsewhere is never
loaded). A build that fails raises: there is no silent
fallback. The numpy ring of the same semantics is reached only with
``native=False`` (the tests hold the two against each other).
``mean_power`` is the library's host-side mean |x|² (a double accumulator).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from jrc_tpu_torch.utils.cache import default_cache_root, machine_fingerprint

SRC = Path(__file__).resolve().parent / "cc" / "jrc_runtime.cc"
BUILD_ROOT = default_cache_root() / "jrc_tpu_torch_runtime"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

#: sc16 full-scale convention (UHD: float ±1.0 ↔ int16 ±32767)
SC16_SCALE = 32767.0

_lib = None
_build_lock = threading.Lock()

_SIZE, _U64, _P = ctypes.c_size_t, ctypes.c_uint64, ctypes.c_void_p
_F32P, _I16P = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / machine_fingerprint("g++") / h.hexdigest()[:16] / "libjrc_runtime.so"


def build() -> Path:
    """Compile the library unless this content hash is already built."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
        tmp = Path(tmp_dir) / out.name
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                           check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: the IQ ring cannot be built ({e})") from e
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"g++ failed on {SRC} ({e.returncode}):\n{e.stderr}") from e
        os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


def _declare(lib, prefix: str, sample_ptr) -> None:
    for name, restype, argtypes in (
            ("create", _P, [_SIZE]),
            ("destroy", None, [_P]),
            ("capacity", _SIZE, [_P]),
            ("available", _SIZE, [_P]),
            ("dropped", _U64, [_P]),
            ("push", _SIZE, [_P, sample_ptr, _SIZE]),
            ("pop_block", ctypes.c_int, [_P, sample_ptr, _SIZE, _SIZE, _SIZE])):
        fn = getattr(lib, f"{prefix}_{name}")
        fn.restype, fn.argtypes = restype, argtypes


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the native runtime; raises when the build
    fails."""
    global _lib
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib, "jrc_ring", _F32P)
            _declare(lib, "jrc_ring16", _I16P)
            lib.jrc_ring16_push_fc32.restype = _SIZE
            lib.jrc_ring16_push_fc32.argtypes = [_P, _F32P, _SIZE, ctypes.c_float]
            lib.jrc_mean_power.restype = ctypes.c_float
            lib.jrc_mean_power.argtypes = [_F32P, _SIZE]
            _lib = lib
    return _lib


def _as_floats(samples: np.ndarray) -> np.ndarray:
    """complex64 (n,) or float (n, 2) samples as a flat float32 (re, im, ...) array."""
    if np.iscomplexobj(samples):
        return np.ascontiguousarray(samples, np.complex64).view(np.float32)
    return np.ascontiguousarray(samples, np.float32).reshape(-1)


def mean_power(samples) -> float:
    """Mean |x|² of complex64 samples (numpy, or a tensor on the CPU), summed
    in double and returned as a float32 value; 0 for no sample."""
    x = np.ascontiguousarray(samples, np.complex64).reshape(-1)
    return float(load_library().jrc_mean_power(x.view(np.float32).ctypes.data_as(_F32P), len(x)))


def quantize_sc16(samples: np.ndarray, full_scale: float = 1.0) -> np.ndarray:
    """complex64 (n,) or float32 (n, 2) samples → int16 (n, 2) on the sc16
    wire: scaled so that ±``full_scale`` is ±32767, rounded to nearest even,
    saturating at ±32767. What ``IQRing16.push`` stores, in numpy."""
    q = np.rint(_as_floats(samples) * np.float32(SC16_SCALE / float(full_scale)))
    return np.clip(q, -32767, 32767).astype(np.int16).reshape(-1, 2)


class _RingBase:
    """The push / pop / history-reservation semantics of both rings, over the
    C++ ``Ring<T>`` or, with ``native=False``, over a numpy array (single
    thread only). Subclasses set the extern-C symbol family, the sample
    layout and the format-specific pushes."""

    _prefix = ""
    _dtype = None  # numpy dtype of one stored item
    _item_shape = ()  # trailing shape of one sample in a popped block

    def __init__(self, capacity: int, native: bool = True):
        self._h = None
        if native:
            self._lib = load_library()
            self._h = _P(self._fn("create")(capacity))
            if not self._h:
                raise MemoryError(f"{self._prefix}_create failed")
            self.capacity = int(self._fn("capacity")(self._h))
        else:
            self.capacity = 1
            while self.capacity < capacity:
                self.capacity *= 2
            self._buf = np.zeros((self.capacity, *self._item_shape), self._dtype)
            self._head = 0
            self._pos = 0
            self._dropped = 0
            self._hist_keep = 0  # left-history reservation (set by pop_block)

    def _fn(self, name: str):
        return getattr(self._lib, f"{self._prefix}_{name}")

    @property
    def native(self) -> bool:
        return self._h is not None

    def available(self) -> int:
        if self._h is not None:
            return int(self._fn("available")(self._h))
        return self._head - self._pos

    def dropped(self) -> int:
        if self._h is not None:
            return int(self._fn("dropped")(self._h))
        return self._dropped

    def _push_numpy(self, items: np.ndarray) -> int:
        """Append item rows, keeping the consumer's left-history region as
        the native ring does (tail = consumer position − left history)."""
        tail = max(self._pos - self._hist_keep, 0)
        free = self.capacity - (self._head - tail)
        n = min(len(items), free)
        self._dropped += len(items) - n
        idx = self._head % self.capacity
        first = min(self.capacity - idx, n)
        self._buf[idx : idx + first] = items[:first]
        if n > first:
            self._buf[: n - first] = items[first:n]
        self._head += n
        return n

    def _pop_numpy(self, out: np.ndarray, block_len: int, halo: int, left_hist: int):
        if self._head - self._pos < block_len + halo:
            return None
        self._hist_keep = max(self._hist_keep, left_hist)
        idx = self._pos - left_hist + np.arange(len(out))
        valid = (idx >= 0).reshape(-1, *([1] * len(self._item_shape)))
        out[...] = np.where(valid, self._buf[idx % self.capacity], 0)
        self._pos += block_len
        return out

    def pop_block(self, block_len: int, halo: int, left_hist: int,
                  out: np.ndarray | None = None) -> np.ndarray | None:
        """One ``[left_hist | block_len | halo]`` block (zeros before the
        stream start), consuming ``block_len`` samples, or None while fewer
        than ``block_len + halo`` are buffered. ``out`` is a C-contiguous
        array of the block's shape and dtype to pop into (returned)."""
        shape = (left_hist + block_len + halo, *self._item_shape)
        if out is None:
            out = np.empty(shape, self._dtype)
        elif (not isinstance(out, np.ndarray) or out.shape != shape or out.dtype != self._dtype
              or not out.flags.c_contiguous or not out.flags.writeable):
            raise ValueError(f"pop_block: out must be a writable C-contiguous {np.dtype(self._dtype)} "
                             f"array of shape {shape}")
        if self._h is None:
            return self._pop_numpy(out, block_len, halo, left_hist)
        ok = self._fn("pop_block")(self._h, self._sample_ptr(out), block_len, halo, left_hist)
        return out if ok else None

    def close(self):
        if self._h is not None:
            self._fn("destroy")(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _float_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_F32P)


class IQRing(_RingBase):
    """SPSC complex64 ring buffer with overlapped block pop."""

    _prefix = "jrc_ring"
    _dtype = np.complex64

    @staticmethod
    def _sample_ptr(arr: np.ndarray):
        return _float_ptr(arr.view(np.float32))

    def push(self, samples: np.ndarray) -> int:
        """Append complex samples; returns the number accepted (the rest is
        dropped and counted)."""
        x = np.ascontiguousarray(samples, np.complex64)
        if self._h is not None:
            return int(self._fn("push")(self._h, self._sample_ptr(x), len(x)))
        return self._push_numpy(x)


class IQRing16(_RingBase):
    """SPSC sc16 (int16 re, im) ring buffer with overlapped block pop: the
    quantized wire (4 B a sample against the fc32 ring's 8). ``pop_block``
    gives an (n_out, 2) int16 array; a sample's value is
    ``q.astype(float32) * float32(full_scale / SC16_SCALE)``."""

    _prefix = "jrc_ring16"
    _dtype = np.int16
    _item_shape = (2,)

    def __init__(self, capacity: int, full_scale: float = 1.0, native: bool = True):
        self.full_scale = float(full_scale)
        self._q_scale = SC16_SCALE / self.full_scale
        super().__init__(capacity, native=native)

    @staticmethod
    def _sample_ptr(arr: np.ndarray):
        return arr.ctypes.data_as(_I16P)

    def push(self, samples: np.ndarray) -> int:
        """Quantize complex64 (or float (n, 2)) samples onto the wire:
        round to nearest, saturating at ±32767."""
        if self._h is None:
            return self._push_numpy(quantize_sc16(samples, self.full_scale))
        x = _as_floats(samples)
        return int(self._fn("push_fc32")(self._h, _float_ptr(x), len(x) // 2,
                                         ctypes.c_float(self._q_scale)))

    def push_sc16(self, samples: np.ndarray) -> int:
        """Push already-quantized int16 samples ((n, 2) or interleaved)."""
        q = np.ascontiguousarray(samples, np.int16).reshape(-1, 2)
        if self._h is not None:
            return int(self._fn("push")(self._h, self._sample_ptr(q), q.shape[0]))
        return self._push_numpy(q)
