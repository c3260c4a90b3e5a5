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
  wrapped patch at the orthogonal angle and the opposite range, SNR test;
  ``range_angle_estimate_multi`` repeats it, subtracting each peak's
  rank-1 response (port of jrc_tpu/ops/radar.py:261-320);
* ``cfar_detect`` — 2-D cell-averaging CFAR (:323-379);
* ``fft_peak_detect`` — the arg-max tone peak of array alignment (:382-424);
* ``velocity_axis``, ``range_doppler_map``, ``range_doppler_estimate`` —
  slow-time Doppler over a train of dwells (:436-533).
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
    """An empty buffer on ``device`` (None: the CUDA device; it raises where
    there is none)."""
    from jrc_tpu_torch.models.streaming import _entry_device  # models import ops

    device = _entry_device(device)
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


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``x`` at the 0-d index tensor ``idx`` along ``dim``, without a host read
    (a 0-d tensor used as an index would be read to the host)."""
    return x.index_select(dim, idx.reshape(1)).squeeze(dim)


def range_angle_estimate_multi(ra_map: torch.Tensor, range_bins: torch.Tensor,
                               angle_bins: torch.Tensor, *, max_targets: int = 3,
                               **estimate_kwargs) -> RangeAngleEstimate:
    """CLEAN multi-target detection: ``range_angle_estimate``, then subtract
    the peak's rank-1 response m ← m − outer(m[:, ai], m[ri, :]) / m[ri, ai]
    (skipped where |peak|² ≤ 1e-30), ``max_targets`` times. Fields gain a
    leading (max_targets,) axis, strongest first; once a slot fails the
    detection gates, it and every later slot read detected=False. The
    complex products and the division are written on the real and
    imaginary parts in the reference's order."""
    results = []
    m = ra_map
    for _ in range(max_targets):
        est = range_angle_estimate(m, range_bins, angle_bins, **estimate_kwargs)
        results.append(est)
        col = _take(m, est.angle_idx, 1)  # (n_range,) the range response at the angle
        row = _take(m, est.range_idx, 0)  # (n_angle,) the steering pattern at the range
        peak = _take(col, est.range_idx)
        cr, ci, rr, ri = col.real[:, None], col.imag[:, None], row.real[None, :], row.imag[None, :]
        o_re, o_im = cr * rr - ci * ri, cr * ri + ci * rr
        ok = peak.real * peak.real + peak.imag * peak.imag > 1e-30
        pr = torch.where(ok, peak.real, 1.0)
        pi = torch.where(ok, peak.imag, 0.0)
        d = pr * pr + pi * pi
        sub = torch.complex((o_re * pr + o_im * pi) / d, (o_im * pr - o_re * pi) / d)
        m = torch.where(ok, m - sub, m)
    stacked = RangeAngleEstimate(*(torch.stack([getattr(r, f) for r in results])
                                   for f in RangeAngleEstimate._fields))
    keep = torch.cumprod(stacked.detected.to(torch.int32), 0) > 0
    return stacked._replace(detected=keep)


class CfarResult(NamedTuple):
    detections: torch.Tensor  # (n_range, n_angle) bool
    threshold: torch.Tensor  # (n_range, n_angle) float32 per-cell threshold
    noise: torch.Tensor  # (n_range, n_angle) float32 per-cell noise estimate
    n_detections: torch.Tensor  # int64


def _box(x: torch.Tensor, win: tuple[int, int]) -> torch.Tensor:
    """Centred box sum of odd window ``win`` over a float64 (n, m) map with a
    zero-padded border (``lax.reduce_window`` with padding SAME), by one
    cumulative sum per axis."""
    for dim, w in enumerate(win):
        h = w // 2
        n = x.shape[dim]
        c = torch.nn.functional.pad(torch.cumsum(x, dim).movedim(dim, -1), (1, 0)).movedim(-1, dim)
        idx = torch.arange(n, device=x.device)
        hi, lo = torch.clamp_max(idx + h + 1, n), torch.clamp_min(idx - h, 0)
        x = c.index_select(dim, hi) - c.index_select(dim, lo)
    return x


def cfar_detect(power: torch.Tensor, *, guard: tuple[int, int] = (4, 2),
                train: tuple[int, int] = (12, 6), pfa: float = 1e-4) -> CfarResult:
    """2-D cell-averaging CFAR over a (n_range, n_angle) power map: the
    training ring is the (train + guard) box minus the guard box, each cell
    normalized by its own training count (the border is zero-padded, so edge
    cells count fewer), and the threshold is α·noise with the exact
    exponential-noise scale α = N·(pfa^(−1/N) − 1) of N training cells. The
    box sums are taken in float64 and rounded to float32, then subtracted in
    float32 as the reference does; α is float32."""
    gr, ga = guard
    tr, ta = train
    outer = (2 * (gr + tr) + 1, 2 * (ga + ta) + 1)
    inner = (2 * gr + 1, 2 * ga + 1)
    p64 = power.to(torch.float64)
    ones = torch.ones_like(p64)
    ring_sum = _box(p64, outer).to(torch.float32) - _box(p64, inner).to(torch.float32)
    ring_n = _box(ones, outer).to(torch.float32) - _box(ones, inner).to(torch.float32)
    ring_n = torch.clamp_min(ring_n, 1.0)
    noise = ring_sum / ring_n
    alpha = ring_n * (torch.pow(torch.full_like(ring_n, pfa), -1.0 / ring_n) - 1.0)
    threshold = alpha * noise
    det = power > threshold
    return CfarResult(detections=det, threshold=threshold, noise=noise,
                      n_detections=det.sum())


class PeakDetection(NamedTuple):
    freq: torch.Tensor
    phase: torch.Tensor
    magnitude: torch.Tensor
    detected: torch.Tensor


def fft_peak_detect(spectrum: torch.Tensor, sample_rate: float, *, samp_protect: int = 1,
                    threshold_db: float = -60.0) -> PeakDetection:
    """Arg-max tone peak over |spectrum| (..., n) with ``samp_protect`` edge
    bins protected on each side; the first maximum wins. Frequency is the
    signed bin times sample_rate / n."""
    n = spectrum.shape[-1]
    re, im = spectrum.real, spectrum.imag
    mag = torch.sqrt(re * re + im * im)
    idx = torch.arange(n, device=spectrum.device)
    protect = (idx < samp_protect) | (idx >= n - samp_protect)
    pk = torch.argmax(torch.where(protect, -torch.inf, mag), dim=-1, keepdim=True)
    mag_pk = mag.gather(-1, pk)[..., 0]
    phase = torch.atan2(im.gather(-1, pk), re.gather(-1, pk))[..., 0]
    pk = pk[..., 0]
    bin_hz = float(np.float32(sample_rate / n))  # the reference's float32 bin width
    freq = torch.where(pk < n // 2, pk, pk - n).to(torch.float32) * bin_hz
    detected = 20.0 * torch.log10(torch.clamp_min(mag_pk, 1e-30)) > threshold_db
    return PeakDetection(freq=freq, phase=phase, magnitude=mag_pk, detected=detected)


def velocity_axis(n_dwells: int, dwell_period_s: float, center_freq: float,
                  interp_factor: int = 4) -> np.ndarray:
    """Two-sided velocity bins (m/s) of the slow-time FFT: f_D = 2·v·f_c/c,
    unambiguous within ±λ/(4·T_dwell)."""
    n = n_dwells * interp_factor
    f_d = (np.arange(n) - n // 2) / (n * dwell_period_s)
    return (f_d * C_LIGHT / (2.0 * center_freq)).astype(np.float32)


def range_doppler_map(h_history: torch.Tensor, interp_factor_range: int = 8,
                      interp_factor_doppler: int = 4) -> torch.Tensor:
    """Dwell history (n_dwells, n_virt, fft_len) of channel estimates →
    range-Doppler power map (n_range, n_doppler): the zero-padded range IFFT
    of each dwell and channel (1/N scaled), a periodic-Hann window over slow
    time, the zero-padded shifted slow-time FFT (unscaled), |·|² summed over
    the virtual channels."""
    n_dwells, fft_len = h_history.shape[0], h_history.shape[-1]
    ranges = torch.fft.ifft(h_history, n=fft_len * interp_factor_range, dim=-1)
    st = ranges.permute(1, 2, 0)  # (n_virt, n_range, n_dwells)
    win = torch.from_numpy(np.hanning(n_dwells + 1)[:-1].astype(np.float32)).to(st.device)
    dopp = torch.fft.fftshift(torch.fft.fft(st * win, n=n_dwells * interp_factor_doppler, dim=-1),
                              dim=-1)
    return (dopp.real * dopp.real + dopp.imag * dopp.imag).sum(0)


class RangeDopplerEstimate(NamedTuple):
    range_m: torch.Tensor
    velocity_mps: torch.Tensor
    power: torch.Tensor
    snr_db: torch.Tensor
    detected: torch.Tensor
    blind_zone_mps: torch.Tensor  # MTI minimum detectable |v| (the guard's edge)


def median_midpoint(x: torch.Tensor) -> torch.Tensor:
    """Median of all elements; for an even count the mean of the two middle
    values, (low + high)·0.5, as ``jnp.median`` takes it (``torch.median``
    returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def range_doppler_estimate(rd_power: torch.Tensor, range_bins: torch.Tensor,
                           velocity_bins: torch.Tensor, *, snr_threshold_db: float = 15.0,
                           zero_doppler_guard: int = 8,
                           clutter_rel_db: float = -10.0) -> RangeDopplerEstimate:
    """2-D argmax over the map with ``zero_doppler_guard`` columns each side of
    zero Doppler masked out; detected when the peak clears
    ``snr_threshold_db`` over the median cell and ``clutter_rel_db`` against
    the strongest zero-Doppler cell."""
    n_dopp = rd_power.shape[-1]
    dc = n_dopp // 2
    col = torch.arange(n_dopp, device=rd_power.device)
    guard = (col - dc).abs() <= zero_doppler_guard
    masked = torch.where(guard[None, :], 0.0, rd_power).reshape(-1)
    flat = torch.argmax(masked)
    ri, di = flat // n_dopp, flat % n_dopp
    peak = _take(masked, flat)
    clutter = torch.where(guard[None, :], rd_power, 0.0).amax()
    noise = median_midpoint(rd_power)
    snr_db = 10.0 * torch.log10(torch.clamp_min(peak, 1e-30) / torch.clamp_min(noise, 1e-30))
    rel_db = 10.0 * torch.log10(torch.clamp_min(peak, 1e-30) / torch.clamp_min(clutter, 1e-30))
    return RangeDopplerEstimate(
        range_m=_take(range_bins, ri), velocity_mps=_take(velocity_bins, di), power=peak,
        snr_db=snr_db, detected=(snr_db >= snr_threshold_db) & (rel_db >= clutter_rel_db),
        blind_zone_mps=velocity_bins[min(dc + zero_doppler_guard + 1, n_dopp - 1)].abs())
