"""P2: the pieces of the batched row gather (port of the Pallas profiling
kernel scripts/profile_gather_variants.py:28-78) on the port's complex
layout.

Rows of ``w_out = ceil(width/128)·128`` samples from starts clamped to
[0, N − width], zeros past N, for one of ``VARIANTS`` (see
kernels/csrc/gather_pieces.cu): ``full`` from the start, ``noroll`` from
the start rounded down to 128, ``noroll_nodma`` zeros without reading the
input (the TPU kernel left that output uninitialized). ``gather_pieces``
runs ``gather_pieces_plain`` for a CPU tensor and the CUDA kernel for a
CUDA tensor; each launch is counted in ``kernels.registry``.
"""
from __future__ import annotations

import torch

from jrc_tpu_torch import kernels
from jrc_tpu_torch.kernels import registry

LANE = 128
VARIANTS = ("full", "noroll", "noroll_nodma")


def _check(x: torch.Tensor, width: int, variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if x.shape[-1] < width:
        raise ValueError(f"gather_pieces: stream length {x.shape[-1]} < requested width {width}")
    return -(-width // LANE) * LANE


def gather_pieces_plain(x: torch.Tensor, starts: torch.Tensor, width: int,
                        variant: str) -> torch.Tensor:
    """Complex (N,) ``x``, (B,) ``starts`` → (B, w_out) complex64 rows."""
    w_out = _check(x, width, variant)
    n = x.shape[-1]
    if variant == "noroll_nodma":
        return torch.zeros((starts.shape[0], w_out), dtype=torch.complex64, device=x.device)
    s = starts.to(torch.int64).clamp(0, n - width)
    if variant == "noroll":
        s = s // LANE * LANE
    xp = torch.cat([x.to(torch.complex64), torch.zeros(w_out, dtype=torch.complex64, device=x.device)])
    return xp[s[:, None] + torch.arange(w_out, device=x.device)]


def gather_pieces(x: torch.Tensor, starts: torch.Tensor, width: int, variant: str) -> torch.Tensor:
    """Complex64 (N,) ``x``, (B,) ``starts`` → (B, w_out) complex64 rows."""
    if x.device.type == "cpu":
        return gather_pieces_plain(x, starts, width, variant)
    w_out = _check(x, width, variant)
    if x.dtype != torch.complex64:
        raise TypeError(f"gather_pieces: complex64 stream expected, got {x.dtype}")
    xr = torch.view_as_real(x.contiguous())
    starts = starts.to(torch.int32).contiguous()
    out = torch.empty((starts.shape[0], w_out), dtype=torch.complex64, device=x.device)
    kernels.call("jrc_gather_pieces", kernels.ptr(xr), kernels.ptr(starts),
                 kernels.ptr(torch.view_as_real(out)), x.shape[-1], starts.shape[0], width,
                 w_out, VARIANTS.index(variant))
    registry.count("gather_pieces")
    return out
