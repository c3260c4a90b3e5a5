"""Constellations, hard-decision and max-log-MAP demapping, re-modulation
(port of jrc_tpu/ops/modulation.py:27,62,75,89)."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_SQRT_HALF = np.sqrt(0.5)
_QAM16_LEVEL = np.sqrt(0.1)


@lru_cache(maxsize=None)
def constellation(n_bpsc: int, tx_scale: bool = False) -> np.ndarray:
    """Constellation points indexed by symbol value (gr-digital 3.8 Gray
    layout); ``tx_scale`` applies the encoder's extra 1/2 on QPSK."""
    if n_bpsc == 1:
        pts = np.array([-1.0, 1.0], np.complex64)
    elif n_bpsc == 2:
        pts = np.array(
            [
                -_SQRT_HALF - 1j * _SQRT_HALF,
                +_SQRT_HALF - 1j * _SQRT_HALF,
                -_SQRT_HALF + 1j * _SQRT_HALF,
                +_SQRT_HALF + 1j * _SQRT_HALF,
            ],
            np.complex64,
        )
        if tx_scale:
            pts = pts / 2.0
    elif n_bpsc == 4:
        L = _QAM16_LEVEL
        re = np.array([-3, 1, -1, 3], np.float32) * L  # indexed by bits (b1 b0)
        im = np.array([1, -1, 3, -3], np.float32) * L  # indexed by bits (b3 b2)
        vals = np.arange(16)
        pts = (re[vals & 3] + 1j * im[(vals >> 2) & 3]).astype(np.complex64)
    else:
        raise ValueError(f"unsupported n_bpsc={n_bpsc}")
    return pts.astype(np.complex64)


def hard_decision(symbols: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Nearest-point demap of complex (..., n) symbols against the unscaled
    ``points`` → int32 symbol values (first index on equal distances)."""
    dre = symbols.real[..., None] - points.real
    dim = symbols.imag[..., None] - points.imag
    return torch.argmin(dre * dre + dim * dim, dim=-1).to(torch.int32)


def modulate(values: torch.Tensor, points: torch.Tensor, n_bpsc: int) -> torch.Tensor:
    """Symbol values → constellation points with the TX scaling (QPSK
    halved), from the unscaled ``points`` of ``n_bpsc`` bits a symbol."""
    pts = points * 0.5 if n_bpsc == 2 else points
    return pts[values.to(torch.int64)]


def soft_llr(symbols: torch.Tensor, points: torch.Tensor, n_bpsc: int,
             noise_var=1.0) -> torch.Tensor:
    """Per-bit max-log-MAP LLRs: complex (..., n) symbols → float32
    (..., n·n_bpsc), bit k of a symbol value LSB-first; > 0 means the bit is
    more likely 1. The distances are divided by ``noise_var`` (a float, or a
    float32 tensor on the symbols' device that broadcasts against
    (..., n, n_points), e.g. (B, 1, 1) per frame) before the minima."""
    dre = symbols.real[..., None] - points.real
    dim = symbols.imag[..., None] - points.imag
    d2 = dre * dre + dim * dim
    if isinstance(noise_var, torch.Tensor):
        if noise_var.device != symbols.device:
            raise ValueError(f"noise_var lies on {noise_var.device} but the symbols on "
                             f"{symbols.device}")
        d2 = d2 / noise_var
    elif noise_var != 1.0:
        # over a 0-d tensor: by a host scalar the card multiplies by its reciprocal
        d2 = d2 / torch.full((), noise_var, dtype=d2.dtype, device=d2.device)
    vals = torch.arange(points.shape[0], device=points.device)
    inf = torch.full((), float("inf"), dtype=d2.dtype, device=d2.device)
    llrs = []
    for k in range(n_bpsc):
        bit1 = ((vals >> k) & 1).to(torch.bool)
        m1 = torch.where(bit1, d2, inf).amin(-1)
        m0 = torch.where(~bit1, d2, inf).amin(-1)
        llrs.append(m0 - m1)
    out = torch.stack(llrs, dim=-1)
    return out.reshape(*out.shape[:-2], out.shape[-2] * n_bpsc)
