"""OFDM symbol ops: carrier allocation, IFFT with cyclic prefix, CP strip
with FFT, zero padding (port of jrc_tpu/ops/ofdm.py:43-129).

Frequency grids are fft-shifted (DC at index fft_len/2) and transforms are
unitary (norm="ortho"), as in the reference, which folds the shift into a
constant DFT matrix; here every transform is ``torch.fft`` with an explicit
``fftshift`` / ``ifftshift``.
"""
from __future__ import annotations

import numpy as np
import torch

from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch.ops.channel import normal_pair


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


def zero_pad(samples: torch.Tensor, pad_front: int, pad_tail: int, *, noise_std: float = 0.1,
             generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None) -> torch.Tensor:
    """Pad the last axis with ``pad_front`` / ``pad_tail`` samples: zeros, or,
    as the reference pads where it is given a key (lib/zero_pad_impl.cc:61-94),
    complex Gaussian samples of ``noise_std``/√2 a quadrature: ``noise``
    (standard normal pairs shaped (..., pad_front + pad_tail), the front's
    then the tail's), else drawn from ``generator``."""
    if noise is None and generator is None:
        return torch.nn.functional.pad(samples, (pad_front, pad_tail))
    if noise is None:
        noise = normal_pair((*samples.shape[:-1], pad_front + pad_tail), generator=generator,
                            device=samples.device)
    std = float(np.float32(noise_std / np.sqrt(2.0)))  # the reference's float32 scale
    pad = torch.complex(std * noise.real, std * noise.imag)
    return torch.cat([pad[..., :pad_front], samples, pad[..., pad_front:]], dim=-1)


def extract_data_carriers(grid: torch.Tensor, data_idx: torch.Tensor) -> torch.Tensor:
    """(..., fft_len) → (..., n_data_carriers)."""
    return grid[..., data_idx]


def extract_pilot_carriers(grid: torch.Tensor, pilot_idx: torch.Tensor) -> torch.Tensor:
    """(..., fft_len) → (..., n_pilot_carriers)."""
    return grid[..., pilot_idx]
