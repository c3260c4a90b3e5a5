"""The one table of the port's CUDA kernels and the helpers built on it.

Each entry names the wrapper (a function ``jrc_tpu_torch.ops.<module>.<name>``
that calls ``count(<name>)`` where it launches its kernel), the module that
holds its plain version ``<name>_plain``, its CUDA source, the TPU kernels
it replaces (file:line of each; the fused Viterbi decoder replaces two),
and the paths that launch it (``PATHS``: the static and SIG-driven block RX
``StreamingRx`` / ``StreamingRxDynamic``, the ingest ``BlockStreamer``, the
JRC dwell ``jrc_step``, the link simulation ``evaluation.link_curve``, the
per-block RX ``block`` (the windowed and sequential scans, static and
dynamic), the sharded executors ``mesh`` (``parallel.streaming``'s
``sharded_rx`` / ``sharded_rx_dynamic``, ``parallel.batch.batched_rx``) and
``configs``, the JRC dwell and ``scan_rx`` at the antenna configurations
beside the default (``capture.ANTENNA_CONFIGS``)).
A new kernel is entered here once; ``plain_kernels``, ``launch_counts``,
``reset_counts`` and ``rx_path_kernels`` follow from the table. The launch counts are kept here,
so swapping a wrapper never touches them. The ops modules are imported when
a helper is called, not when this module is imported.
"""
from __future__ import annotations

import collections
import contextlib
import importlib
from typing import NamedTuple


class Kernel(NamedTuple):
    name: str
    module: str
    plain_module: str
    source: str
    replaces: tuple[str, ...]
    paths: frozenset[str]


#: the paths whose launches chip_smoke.py counts, each with its launch counts reset before it
PATHS = ("static", "dynamic", "stream", "jrc", "sim", "block", "mesh", "configs")
_ALL, _NONE = frozenset(PATHS), frozenset()

KERNELS = (
    Kernel("viterbi_decode", "viterbi_cuda", "viterbi", "jrc_tpu_torch/kernels/csrc/viterbi.cu",
           ("jrc_tpu/ops/viterbi_pallas.py:95", "jrc_tpu/ops/viterbi_pallas.py:151"), _ALL),
    Kernel("detect_front_end", "detect_cuda", "detect_cuda", "jrc_tpu_torch/kernels/csrc/detect.cu",
           ("jrc_tpu/ops/detect_pallas.py:89",), _ALL),
    Kernel("gather_rows", "gather_cuda", "gather_cuda", "jrc_tpu_torch/kernels/csrc/gather.cu",
           ("jrc_tpu/ops/gather_pallas.py:32",), _ALL),
    Kernel("shuffle_pieces", "shuffle_pieces", "shuffle_pieces",
           "jrc_tpu_torch/kernels/csrc/shuffle_pieces.cu",
           ("scripts/profile_shuffle.py:70",), _NONE),
    Kernel("gather_pieces", "gather_pieces", "gather_pieces",
           "jrc_tpu_torch/kernels/csrc/gather_pieces.cu",
           ("scripts/profile_gather_variants.py:72",), _NONE),
    Kernel("viterbi_pieces", "viterbi_pieces", "viterbi_pieces",
           "jrc_tpu_torch/kernels/csrc/viterbi_pieces.cu",
           ("scripts/profile_viterbi_variants.py:103",), _NONE),
)


def _ops(module: str):
    return importlib.import_module(f"jrc_tpu_torch.ops.{module}")


def wrapper(k: Kernel):
    """The kernel's wrapper function (launches the kernel on a CUDA tensor)."""
    return getattr(_ops(k.module), k.name)


def plain(k: Kernel):
    """The kernel's plain PyTorch version."""
    return getattr(_ops(k.plain_module), f"{k.name}_plain")


def rx_path_kernels(path: str | None = None) -> tuple[str, ...]:
    """Names of the kernels ``path`` launches (with None: any path)."""
    if path is not None and path not in PATHS:
        raise ValueError(f"unknown path {path!r}; the paths are {PATHS}")
    return tuple(k.name for k in KERNELS if (path in k.paths if path else k.paths))


@contextlib.contextmanager
def _swapped(replacement):
    """Put ``replacement(k, wrapper)`` in every wrapper's place (callers reach
    the wrappers through their module, so the swap reaches them)."""
    originals = [(_ops(k.module), k.name, wrapper(k)) for k in KERNELS]
    try:
        for k, (mod, name, orig) in zip(KERNELS, originals):
            setattr(mod, name, replacement(k, orig))
        yield
    finally:
        for mod, name, orig in originals:
            setattr(mod, name, orig)


def plain_kernels():
    """Route every kernel wrapper to its plain version."""
    return _swapped(lambda k, _: plain(k))


def recorded_calls(calls: list):
    """Append (kernel name, args, kwargs) of every wrapper call to ``calls``;
    the wrapper still runs (and counts its launches)."""
    def recording(k, fn):
        def call(*args, **kwargs):
            calls.append((k.name, args, kwargs))
            return fn(*args, **kwargs)
        return call

    return _swapped(recording)


_COUNTS: collections.Counter = collections.Counter()


def count(name: str) -> None:
    """Add one to kernel ``name``'s launches; its wrapper calls this where it
    launches the kernel, and nowhere else."""
    _COUNTS[name] += 1


def launch_counts() -> dict[str, int]:
    return {k.name: _COUNTS[k.name] for k in KERNELS}


def reset_counts() -> None:
    _COUNTS.clear()
