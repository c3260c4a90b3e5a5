"""K3: batched frame-window row gather (port of jrc_tpu/ops/gather_pallas.py:61).

``gather_rows`` runs ``gather_rows_plain`` for a CPU tensor and the CUDA
kernel of kernels/csrc/gather.cu for a CUDA tensor; ``launches`` counts
kernel launches only.
"""
from __future__ import annotations

import torch

from jrc_tpu_torch import kernels


def _check(x: torch.Tensor, width: int) -> int:
    n = x.shape[-1]
    if n < width:
        raise ValueError(f"gather_rows: stream length {n} < requested width {width}")
    return n


def gather_rows_plain(x: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """out[b] = x[s_b : s_b + width] for complex (N,) ``x``, starts clamped
    to [0, N − width] → (B, width)."""
    n = _check(x, width)
    s = starts.to(torch.int64).clamp(0, n - width)
    idx = s[:, None] + torch.arange(width, device=x.device)
    return x[idx]


def gather_rows(x: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """Row gather of complex64 (N,) ``x`` at (B,) ``starts`` → (B, width)."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, starts, width)
    n = _check(x, width)
    if x.dtype != torch.complex64:
        raise TypeError(f"gather_rows: complex64 stream expected, got {x.dtype}")
    xr = torch.view_as_real(x.contiguous())
    starts = starts.to(torch.int32).contiguous()
    out = torch.empty((starts.shape[0], width), dtype=torch.complex64, device=x.device)
    kernels.call("jrc_gather_rows", kernels.ptr(xr), kernels.ptr(starts),
                 kernels.ptr(torch.view_as_real(out)), n, starts.shape[0], width)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
