"""RX half of the OFDM symbol ops (port of jrc_tpu/ops/ofdm.py:67-75,126).

Frequency grids are fft-shifted (DC at index fft_len/2) and transforms are
unitary, as in the reference, which fuses the shift into a DFT matrix; here
it is ``torch.fft.fft`` followed by an explicit ``fftshift``.
"""
from __future__ import annotations

import torch

from jrc_tpu_torch.config import OFDMConfig


def fft_symbols(cfg: OFDMConfig, sym_samples: torch.Tensor) -> torch.Tensor:
    """CP-less complex (..., fft_len) symbol samples → shifted spectrum."""
    assert sym_samples.shape[-1] == cfg.fft_len
    return torch.fft.fftshift(torch.fft.fft(sym_samples, norm="ortho"), dim=-1)


def extract_data_carriers(grid: torch.Tensor, data_idx: torch.Tensor) -> torch.Tensor:
    """(..., fft_len) → (..., n_data_carriers)."""
    return grid[..., data_idx]


def extract_pilot_carriers(grid: torch.Tensor, pilot_idx: torch.Tensor) -> torch.Tensor:
    """(..., fft_len) → (..., n_pilot_carriers)."""
    return grid[..., pilot_idx]
