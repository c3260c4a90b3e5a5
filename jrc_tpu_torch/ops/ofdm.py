"""OFDM symbol ops: carrier allocation, IFFT with cyclic prefix, CP strip
with FFT, zero padding (port of jrc_tpu/ops/ofdm.py:43-129).

Frequency grids are fft-shifted (DC at index fft_len/2) and transforms are
unitary (norm="ortho"), as in the reference, which folds the shift into a
constant DFT matrix; here every transform is ``torch.fft`` with an explicit
``fftshift`` / ``ifftshift``.
"""
from __future__ import annotations

import torch

from jrc_tpu_torch.config import OFDMConfig


def allocate_carriers(cfg: OFDMConfig, tab, data_syms: torch.Tensor,
                      pilot_row0: int = 0) -> torch.Tensor:
    """Scatter complex (..., n_sym, n_data_carriers) data symbols and the
    scheduled pilots (row ``(pilot_row0 + k) % 127`` for symbol k) into the
    shifted grid → (..., n_sym, fft_len). ``tab`` holds ``data_idx``,
    ``pilot_idx`` and ``pilot_symbols`` (``tables.Tables``)."""
    n_sym = data_syms.shape[-2]
    grid = torch.zeros((*data_syms.shape[:-1], cfg.fft_len), dtype=torch.complex64,
                       device=data_syms.device)
    grid[..., tab.data_idx] = data_syms.to(torch.complex64)
    rows = (pilot_row0 + torch.arange(n_sym, device=grid.device)) % tab.pilot_symbols.shape[0]
    grid[..., tab.pilot_idx] = tab.pilot_symbols[rows].expand(*grid.shape[:-1],
                                                              cfg.n_pilot_carriers)
    return grid


def fft_symbols(cfg: OFDMConfig, sym_samples: torch.Tensor) -> torch.Tensor:
    """CP-less complex (..., fft_len) symbol samples → shifted spectrum."""
    assert sym_samples.shape[-1] == cfg.fft_len
    return torch.fft.fftshift(torch.fft.fft(sym_samples, norm="ortho"), dim=-1)


def ofdm_modulate(cfg: OFDMConfig, grid: torch.Tensor) -> torch.Tensor:
    """Shifted (..., n_sym, fft_len) grid → (..., n_sym·sym_len) time
    samples, each symbol led by its cyclic prefix."""
    x = torch.fft.ifft(torch.fft.ifftshift(grid, dim=-1), norm="ortho")
    with_cp = torch.cat([x[..., -cfg.cp_len :], x], dim=-1)
    return with_cp.reshape(*grid.shape[:-2], grid.shape[-2] * cfg.sym_len)


def ofdm_demodulate(cfg: OFDMConfig, samples: torch.Tensor, n_sym: int) -> torch.Tensor:
    """(..., ≥ n_sym·sym_len) time samples → (..., n_sym, fft_len) shifted
    spectra, each symbol's CP dropped."""
    x = samples[..., : n_sym * cfg.sym_len].reshape(*samples.shape[:-1], n_sym, cfg.sym_len)
    return fft_symbols(cfg, x[..., cfg.cp_len :])


def zero_pad(samples: torch.Tensor, pad_front: int, pad_tail: int) -> torch.Tensor:
    """Pad the last axis with ``pad_front`` / ``pad_tail`` zeros."""
    return torch.nn.functional.pad(samples, (pad_front, pad_tail))


def extract_data_carriers(grid: torch.Tensor, data_idx: torch.Tensor) -> torch.Tensor:
    """(..., fft_len) → (..., n_data_carriers)."""
    return grid[..., data_idx]


def extract_pilot_carriers(grid: torch.Tensor, pilot_idx: torch.Tensor) -> torch.Tensor:
    """(..., fft_len) → (..., n_pilot_carriers)."""
    return grid[..., pilot_idx]
