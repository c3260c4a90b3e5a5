"""The one table of the port's CUDA kernels and the helpers built on it.

Each entry names the wrapper (a function ``jrc_tpu_torch.ops.<module>.<name>``
that carries a ``launches`` count), the module that holds its plain version
``<name>_plain``, its CUDA source, the TPU kernels it replaces (file:line of
each; the fused Viterbi decoder replaces two), and whether the
RX paths (``StreamingRx``, ``StreamingRxDynamic``) launch it. A new kernel is
entered here once; ``plain_kernels``, ``launch_counts``, ``reset_counts`` and
``rx_path_kernels`` follow from the table. The ops modules are imported when a
helper is called, not when this module is imported.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import NamedTuple


class Kernel(NamedTuple):
    name: str
    module: str
    plain_module: str
    source: str
    replaces: tuple[str, ...]
    on_rx_path: bool


KERNELS = (
    Kernel("viterbi_decode", "viterbi_cuda", "viterbi", "jrc_tpu_torch/kernels/csrc/viterbi.cu",
           ("jrc_tpu/ops/viterbi_pallas.py:95", "jrc_tpu/ops/viterbi_pallas.py:151"), True),
    Kernel("detect_front_end", "detect_cuda", "detect_cuda", "jrc_tpu_torch/kernels/csrc/detect.cu",
           ("jrc_tpu/ops/detect_pallas.py:89",), True),
    Kernel("gather_rows", "gather_cuda", "gather_cuda", "jrc_tpu_torch/kernels/csrc/gather.cu",
           ("jrc_tpu/ops/gather_pallas.py:32",), True),
    Kernel("shuffle_pieces", "shuffle_pieces", "shuffle_pieces",
           "jrc_tpu_torch/kernels/csrc/shuffle_pieces.cu",
           ("scripts/profile_shuffle.py:70",), False),
    Kernel("gather_pieces", "gather_pieces", "gather_pieces",
           "jrc_tpu_torch/kernels/csrc/gather_pieces.cu",
           ("scripts/profile_gather_variants.py:72",), False),
    Kernel("viterbi_pieces", "viterbi_pieces", "viterbi_pieces",
           "jrc_tpu_torch/kernels/csrc/viterbi_pieces.cu",
           ("scripts/profile_viterbi_variants.py:103",), False),
)


def _ops(module: str):
    return importlib.import_module(f"jrc_tpu_torch.ops.{module}")


def wrapper(k: Kernel):
    """The kernel's wrapper function (launches the kernel on a CUDA tensor)."""
    return getattr(_ops(k.module), k.name)


def plain(k: Kernel):
    """The kernel's plain PyTorch version."""
    return getattr(_ops(k.plain_module), f"{k.name}_plain")


def rx_path_kernels() -> tuple[str, ...]:
    """Names of the kernels every RX path launches."""
    return tuple(k.name for k in KERNELS if k.on_rx_path)


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version (callers reach the
    wrappers through their module, so the swap reaches them)."""
    originals = [(_ops(k.module), k.name, wrapper(k)) for k in KERNELS]
    try:
        for k in KERNELS:
            setattr(_ops(k.module), k.name, plain(k))
        yield
    finally:
        for mod, name, orig in originals:
            setattr(mod, name, orig)


def launch_counts() -> dict[str, int]:
    return {k.name: wrapper(k).launches for k in KERNELS}


def reset_counts() -> None:
    for k in KERNELS:
        wrapper(k).launches = 0
