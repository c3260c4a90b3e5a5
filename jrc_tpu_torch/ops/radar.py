"""MIMO OFDM radar imaging: channel-division estimate, background removal,
range-angle map and peak detection (port of jrc_tpu/ops/radar.py:34-258).

* ``radar_channel_estimate`` — Ĥ(pair, sc) = Σ_sym Y·conj(X) over the
  MIMO-LTF symbols, one einsum;
* ``background_removal`` — a functional ring buffer of past estimates:
  returns a new state and never writes into the caller's tensors;
* ``range_angle_map`` — zero-padded range IFFT (``torch.fft.ifft`` with
  n = fft_len·ir, numpy scaling), corner turn, zero-padded shifted angle FFT
  (``fftshift(torch.fft.fft(n = n_virt·ia))``); a taper multiplies the
  input of each transform (the reference folds it into its DFT matrices);
* ``range_angle_estimate`` — global argmax (the first maximum), noise from a
  wrapped patch at the orthogonal angle and the opposite range, SNR test.
No host reads: every result stays a tensor on the input's device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jrc_tpu_torch.config import C_LIGHT


def radar_channel_estimate(x_ref: torch.Tensor, y_rx: torch.Tensor,
                           tx_interleave: bool = False) -> torch.Tensor:
    """x_ref (n_tx, n_sym, fft_len) TX spectra, y_rx (n_rx, n_sym, fft_len)
    time-aligned RX spectra → (n_tx·n_rx, fft_len), rows rx-major
    (rx·n_tx + tx) unless ``tx_interleave``."""
    h = torch.einsum("rsf,tsf->trf", y_rx, x_ref.conj())  # (n_tx, n_rx, fft)
    if tx_interleave:
        return h.reshape(-1, h.shape[-1])
    return h.transpose(0, 1).reshape(-1, h.shape[-1])


class BackgroundState(NamedTuple):
    """Ring buffer of past channel estimates."""

    buffer: torch.Tensor  # (record_len, n_virt, fft_len) complex64
    count: torch.Tensor  # int32 number of estimates pushed


def init_background(record_len: int, n_virt: int, fft_len: int, device=None) -> BackgroundState:
    return BackgroundState(
        buffer=torch.zeros((record_len, n_virt, fft_len), dtype=torch.complex64, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def background_removal(state: BackgroundState, h: torch.Tensor, record=True):
    """Subtract the mean of the buffered estimates (past frames only), then
    push the raw estimate while ``record`` (a bool or a bool tensor) holds →
    (cleaned, new state)."""
    record_len = state.buffer.shape[0]
    n_valid = torch.clamp_max(state.count, record_len)
    mean = state.buffer.sum(0) / torch.clamp_min(n_valid, 1).to(torch.float32)
    cleaned = torch.where(n_valid > 0, h - mean, h)
    if not isinstance(record, torch.Tensor) and not record:
        return cleaned, state
    at_slot = torch.arange(record_len, device=h.device) == state.count % record_len
    count = state.count + 1
    if isinstance(record, torch.Tensor):
        at_slot = at_slot & record
        count = torch.where(record, count, state.count)
    return cleaned, BackgroundState(
        buffer=torch.where(at_slot[:, None, None], h[None], state.buffer), count=count)


#: aperture tapers (normalized to unit mean, so peak levels stay comparable)
_WINDOWS = {"hann": np.hanning, "hamming": np.hamming, "blackman": np.blackman}


def taper(n: int, window: str | None) -> np.ndarray:
    """(n,) float32 taper of ``window`` normalized to unit mean; ones for None."""
    if window is None:
        return np.ones(n, np.float32)
    w = _WINDOWS[window](n).astype(np.float32)
    return (w / max(w.mean(), 1e-12)).astype(np.float32)


def range_axis(fft_len: int, sample_rate: float, interp_factor_range: int = 8) -> np.ndarray:
    """Inclusive-endpoint linspace(0, c·fft_len/(2·fs), fft_len·ir), the
    reference flowgraph's range grid."""
    r_max = C_LIGHT * fft_len / (2.0 * sample_rate)
    return np.linspace(0, r_max, fft_len * interp_factor_range).astype(np.float32)


def range_angle_map(h: torch.Tensor, interp_factor_range: int = 8, interp_factor_angle: int = 16,
                    taper_range: torch.Tensor | None = None,
                    taper_angle: torch.Tensor | None = None) -> torch.Tensor:
    """Channel estimate (n_virt, fft_len), rx-major rows → complex
    (fft_len·ir, n_virt·ia) range-angle map; ``taper_range`` (fft_len,) and
    ``taper_angle`` (n_virt,) weight the apertures (``taper``)."""
    n_virt, fft_len = h.shape[-2], h.shape[-1]
    if taper_range is not None:
        h = h * taper_range
    ranges = torch.fft.ifft(h, n=fft_len * interp_factor_range, dim=-1)
    rt = ranges.transpose(-1, -2)  # (n_range, n_virt)
    if taper_angle is not None:
        rt = rt * taper_angle
    return torch.fft.fftshift(torch.fft.fft(rt, n=n_virt * interp_factor_angle, dim=-1), dim=-1)


def corner_turn(vectors: torch.Tensor, interp_factor: int = 1) -> torch.Tensor:
    """(n_vec, vec_len) → (vec_len, n_vec·interp_factor), zero-padded at the
    tail (the standalone matrix_transpose op)."""
    n_vec = vectors.shape[-2]
    t = vectors.transpose(-1, -2)
    return torch.nn.functional.pad(t, (0, n_vec * interp_factor - n_vec))


class RangeAngleEstimate(NamedTuple):
    range_m: torch.Tensor
    angle_deg: torch.Tensor
    power: torch.Tensor
    snr_db: torch.Tensor
    detected: torch.Tensor
    range_idx: torch.Tensor
    angle_idx: torch.Tensor


def range_angle_estimate(
    ra_map: torch.Tensor,  # (n_range, n_angle) complex
    range_bins: torch.Tensor,
    angle_bins: torch.Tensor,
    *,
    noise_discard_range_m: float = 2.4,
    noise_discard_angle_deg: float = 29.0,
    snr_threshold_db: float = 15.0,
    power_threshold: float = 0.0,
) -> RangeAngleEstimate:
    """Peak and SNR detection: noise is the mean power of the patch centred
    at (peak range + half the range axis, peak angle + 90° wrapped into
    [−90, 90)), ±``noise_discard_*`` wide, both axes wrapped."""
    n_range, n_angle = ra_map.shape[-2], ra_map.shape[-1]
    power = ra_map.real * ra_map.real + ra_map.imag * ra_map.imag
    flat_idx = torch.argmax(power.reshape(-1))
    ri = flat_idx // n_angle
    ai = flat_idx % n_angle
    peak_power = power.amax()

    range_val = range_bins[ri.reshape(1)][0]
    angle_val = angle_bins[ai.reshape(1)][0]
    angle_null = angle_val + 90.0
    angle_null = torch.where(angle_null >= 90.0, angle_null - 180.0, angle_null)
    null_idx = torch.clamp_max(torch.argmin(torch.abs(angle_bins - angle_null)), n_angle - 2)

    dr = range_bins[1] - range_bins[0]
    discard_r = torch.clamp_min((noise_discard_range_m / dr).to(torch.int32), 1)
    pair = angle_bins[torch.stack([null_idx, null_idx + 1])]
    discard_a = torch.clamp_min((noise_discard_angle_deg / (pair[1] - pair[0])).to(torch.int32), 1)

    dev = ra_map.device
    r_off = torch.arange(n_range, device=dev)
    a_off = torch.arange(n_angle, device=dev)
    r_center = ri + n_range // 2
    r_mask = torch.abs(((r_off - r_center + n_range // 2) % n_range) - n_range // 2) < discard_r
    a_mask = torch.abs(((a_off - null_idx + n_angle // 2) % n_angle) - n_angle // 2) < discard_a
    patch = r_mask[:, None] & a_mask[None, :]
    n_noise = torch.clamp_min(patch.sum(), 1)
    noise_power = torch.where(patch, power, 0.0).sum() / n_noise
    snr_db = 10.0 * torch.log10(peak_power / torch.clamp_min(noise_power, 1e-30))
    detected = (snr_db >= snr_threshold_db) & (peak_power >= power_threshold)
    return RangeAngleEstimate(range_m=range_val, angle_deg=angle_val, power=peak_power,
                              snr_db=snr_db, detected=detected, range_idx=ri, angle_idx=ai)
