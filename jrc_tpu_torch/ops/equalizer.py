"""Equalizer (port of jrc_tpu/ops/equalizer.py:47-252).

Batched over frames: a grid is complex (B, n_sym_total, fft_len), with
the batch written out where the reference vmapped one frame.
``equalize_frame`` takes static DATA and NDP specs (an NDP frame returns its
MIMO channel estimate and equalizes its payload zero-forcing on the legacy
estimate), and the SIG-driven dynamic path (``ops/dynamic_rx``) equalizes
DATA and NDP frames with these pieces. ``estimator="ls"`` keeps the frame-initial
estimate (per-symbol work in parallel, one cumulative sum);
``estimator="sta"`` is the decision-directed tracking of the reference
(lib/mimo_ofdm_equalizer_impl.cc:500-592): a loop over the payload symbols
in order, each step on the whole frame batch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from jrc_tpu_torch.config import OFDMConfig, PacketType
from jrc_tpu_torch.ops import viterbi_cuda
from jrc_tpu_torch.ops.modulation import hard_decision, modulate
from jrc_tpu_torch.ops.encoder import FrameSpec
from jrc_tpu_torch.ops.precoder import parse_signal_field_bits
from jrc_tpu_torch.ops.sync import expj
from jrc_tpu_torch.ops.viterbi import hard_to_values
from jrc_tpu_torch.tables import Tables


class EqualizedFrame(NamedTuple):
    z: torch.Tensor  # (B, n_data_sym, n_data_carriers) equalized symbols
    snr_legacy: torch.Tensor  # (B,) dB, from the L-LTF pair
    snr_data: torch.Tensor  # (B,) dB, from pilot tracking over the payload
    chan_est_full: torch.Tensor  # (B, fft_len, n_tx) NDP MIMO estimate (zeros for DATA)
    chan_mean: torch.Tensor  # (B, n_tx) active-carrier mean (DATA: stream 0's, repeated)
    sig_rate_bitmap: torch.Tensor
    sig_length: torch.Tensor
    sig_ptype: torch.Tensor
    sig_ok: torch.Tensor


def abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|² of a complex tensor, as real·real + imag·imag."""
    return x.real * x.real + x.imag * x.imag


def cdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b as a·conj(b) / |b|², the reference's pair-form quotient (the
    STA feedback stays as close to it as float32 allows)."""
    den = abs2(b)
    return torch.complex((a.real * b.real + a.imag * b.imag) / den,
                         (a.imag * b.real - a.real * b.imag) / den)


def check_estimator(estimator: str) -> bool:
    """Whether ``estimator`` asks for STA tracking; raises on an unknown name."""
    if estimator not in ("ls", "sta"):
        raise ValueError(f"estimator must be 'ls' or 'sta', got {estimator!r}")
    return estimator == "sta"


def sampling_offset_compensate(cfg: OFDMConfig, grid: torch.Tensor, cfo_total: torch.Tensor):
    """Y[b,sym,i] ·= exp(j·2π·sym·(sym_len/fft_len)·ε0·(i−fft/2)), ε0 = cfo·fs/(2π·fc)."""
    n_sym = grid.shape[-2]
    dev = grid.device
    eps0 = cfo_total * cfg.sample_rate / (2 * math.pi * cfg.center_freq)
    sym = torch.arange(n_sym, dtype=torch.float32, device=dev)[:, None]
    i = torch.arange(cfg.fft_len, dtype=torch.float32, device=dev)[None, :] - cfg.fft_len / 2
    phase = 2 * math.pi * sym * (cfg.sym_len / cfg.fft_len) * eps0[:, None, None] * i
    return grid * expj(phase)


def legacy_channel_estimate(tab: Tables, y0: torch.Tensor, y1: torch.Tensor):
    """L-LTF pair (B, fft_len) → (H (B, fft_len), snr_dB (B,)): H is y0 with
    (y0+y1)/(2·ltf) on the active carriers; SNR from the sum/difference
    power of the two repetitions."""
    a = tab.active_idx
    noise = abs2(y0[:, a] - y1[:, a]).sum(-1)
    signal = abs2(y0[:, a] + y1[:, a]).sum(-1)
    h = y0.clone()
    h[:, a] = (y0[:, a] + y1[:, a]) / (2.0 * tab.lltf_freq[a])
    snr_db = 10.0 * torch.log10(signal / noise / 2.0)
    return h, snr_db


def common_phase_error(tab: Tables, y: torch.Tensor, chan: torch.Tensor, ref_pilots: torch.Tensor):
    """(β, est_rx_pilots): β = arg Σ_p y[p]·conj(chan[p]·ref[p])."""
    p = tab.pilot_idx
    est = chan[..., p] * ref_pilots
    s = (y[..., p] * est.conj()).sum(-1)
    return torch.atan2(s.imag, s.real), est


def decode_sig(tab: Tables, z_sig: torch.Tensor):
    """Equalized SIG data carriers (B, 48) → (rate_bitmap, ptype, length, ok);
    the 24-step Viterbi runs through K1 on the card."""
    bits = (z_sig.real > 0).to(torch.uint8)  # BPSK decision
    decoded = viterbi_cuda.viterbi_decode(hard_to_values(bits), tab.trellis, n_out=24)
    return parse_signal_field_bits(decoded)


def legacy_and_sig(cfg: OFDMConfig, tab: Tables, grid: torch.Tensor, cfo_total: torch.Tensor):
    """The stages every frame starts with: sampling-offset compensation, the
    L-LTF estimate and the SIG decode (symbol 2: CPE with pilot row 0, then
    zero-forcing) → (grid, h_legacy, snr_legacy_dB, (rate_bitmap, ptype,
    length, sig_ok))."""
    grid = sampling_offset_compensate(cfg, grid, cfo_total)
    h_legacy, snr_legacy = legacy_channel_estimate(tab, grid[:, 0], grid[:, 1])
    beta, _ = common_phase_error(tab, grid[:, 2], h_legacy, tab.pilot_symbols[0])
    y_sig = grid[:, 2] * expj(-beta)[:, None]
    d = tab.data_idx
    return grid, h_legacy, snr_legacy, decode_sig(tab, y_sig[:, d] / h_legacy[:, d])


def mimo_channel_estimate_ndp(tab, y_ltf: torch.Tensor):
    """(B, n_ltf, fft_len) received MIMO-LTFs → (h (B, fft_len, n_tx), the
    mean of h over the active carriers (B, n_tx)): the NDP sounding LS
    estimate Ĥ(sc,tx) = Σ_l conj(X_ltf[sc,tx,l])·y[l,sc]. ``tab`` holds
    ``ltf_conj``."""
    h = torch.einsum("stl,bls->bst", tab.ltf_conj, y_ltf)
    return h, h[:, tab.active_idx].mean(1)


def effective_channel_estimate(cfg: OFDMConfig, tab: Tables, y_ltf: torch.Tensor) -> torch.Tensor:
    """(B, n_ltf, fft_len) → (B, fft_len) effective channel of stream 0:
    Σ_l conj(X_ltf[s,0,l])·y[l,s] / n_ltf on active carriers, zero elsewhere."""
    h = (tab.ltf0_conj.T[None] * y_ltf).sum(1) / cfg.n_ltf
    out = torch.zeros_like(h)
    out[:, tab.active_idx] = h[:, tab.active_idx]
    return out


STA_ALPHA_DATA, STA_ALPHA_NDP = 0.4, 0.5  # lib/mimo_ofdm_equalizer_impl.cc:510,560


def _equalize_data_symbols_sta(cfg: OFDMConfig, spec: FrameSpec, tab: Tables,
                               y_data: torch.Tensor, h0: torch.Tensor):
    """The STA recursion of a batch of frames: per symbol, CPE and MMSE (NDP:
    zero-forcing) on the tracked channel, then the channel moved toward
    y / x̂ (x̂ the hard decision re-modulated with the TX scaling) on the
    data carriers and toward y / pilot on the pilot carriers."""
    n_sym = y_data.shape[1]
    d, p = tab.data_idx, tab.pilot_idx
    n_bpsc = spec.mcs_params.n_bpsc
    is_data = spec.packet_type is PacketType.DATA
    alpha = STA_ALPHA_DATA if is_data else STA_ALPHA_NDP
    h = h0
    sig_sum = torch.zeros(y_data.shape[0], dtype=torch.float32, device=y_data.device)
    noise_sum = torch.zeros_like(sig_sum)
    count = 0
    zs = []
    for k in range(n_sym):
        ref = tab.pilot_symbols[k % tab.pilot_symbols.shape[0]]
        beta, est = common_phase_error(tab, y_data[:, k], h, ref)
        y = y_data[:, k] * expj(-beta)[:, None]
        sig_sum = sig_sum + abs2(est).sum(-1)
        noise_sum = noise_sum + abs2(est - y[:, p]).sum(-1)
        count += cfg.n_pilot_carriers
        hd = h[:, d]
        if is_data:
            z = y[:, d] * hd.conj() / (abs2(hd) + (noise_sum / count)[:, None])
        else:
            z = cdiv(y[:, d], hd)
        x_hat = modulate(hard_decision(z, tab.points), tab.points, n_bpsc)
        h_new = h.clone()
        h_new[:, d] = hd * (1 - alpha) + cdiv(y[:, d], x_hat) * alpha
        h_new[:, p] = h[:, p] * (1 - alpha) + cdiv(y[:, p], ref) * alpha
        h = h_new
        zs.append(z)
    snr_data = 10.0 * torch.log10((sig_sum / count) / (noise_sum / count))
    return torch.stack(zs, dim=1), snr_data


def equalize_data_symbols(cfg: OFDMConfig, spec: FrameSpec, tab: Tables, y_data: torch.Tensor,
                          h0: torch.Tensor, estimator: str = "ls"):
    """Payload MMSE equalization of a DATA frame with per-symbol CPE and the
    running pilot-noise estimate: y_data (B, n_sym, fft_len), h0 (B,
    fft_len) → (z (B, n_sym, 48), snr_data_dB (B,)); an NDP ``spec`` is
    equalized zero-forcing on ``h0``. ``estimator="sta"`` tracks the channel
    symbol by symbol."""
    if check_estimator(estimator):
        return _equalize_data_symbols_sta(cfg, spec, tab, y_data, h0)
    n_sym = y_data.shape[1]
    dev = y_data.device
    d, p = tab.data_idx, tab.pilot_idx
    rows = torch.arange(n_sym, device=dev) % tab.pilot_symbols.shape[0]
    ref = tab.pilot_symbols[rows]  # (n_sym, n_pilot)
    beta, est = common_phase_error(tab, y_data, h0[:, None, :], ref[None])
    y_rot = y_data * expj(-beta)[..., None]
    sig_k = abs2(est).sum(-1)  # (B, n_sym)
    noise_k = abs2(est - y_rot[..., p]).sum(-1)
    noise_cum = torch.cumsum(noise_k, dim=-1)
    count_cum = torch.arange(1, n_sym + 1, device=dev) * cfg.n_pilot_carriers
    hd = h0[:, None, d]
    if spec.packet_type is PacketType.DATA:
        csi = abs2(hd) + (noise_cum / count_cum)[..., None]
        z = y_rot[..., d] * hd.conj() / csi
    else:
        z = cdiv(y_rot[..., d], hd)
    count = n_sym * cfg.n_pilot_carriers
    snr_data = 10.0 * torch.log10((sig_k.sum(-1) / count) / (noise_k.sum(-1) / count))
    return z, snr_data


def equalize_frame(
    cfg: OFDMConfig,
    spec: FrameSpec,
    tab: Tables,
    grid: torch.Tensor,  # (B, n_sym_total, fft_len) post-FFT, shifted
    cfo_total: torch.Tensor,  # (B,)
    estimator: str = "ls",
) -> EqualizedFrame:
    """L-LTF estimate → SIG decode → MIMO-LTF estimate → payload, per
    frame. DATA: the effective channel of stream 0 equalizes the payload
    (MMSE). NDP: the LTFs give the MIMO estimate, and the payload is
    equalized zero-forcing on the legacy estimate."""
    grid, h_legacy, snr_legacy, (rate_bitmap, ptype, length, sig_ok) = legacy_and_sig(
        cfg, tab, grid, cfo_total)
    y_ltf = grid[:, 3 : 3 + cfg.n_ltf]
    if spec.packet_type is PacketType.NDP:
        chan_full, chan_mean = mimo_channel_estimate_ndp(tab, y_ltf)
        h0 = h_legacy
    else:
        h0 = effective_channel_estimate(cfg, tab, y_ltf)
        chan_full = torch.zeros((grid.shape[0], cfg.fft_len, cfg.n_tx), dtype=grid.dtype,
                                device=grid.device)
        chan_mean = h0[:, tab.active_idx].mean(1, keepdim=True).expand(-1, cfg.n_tx)
    z, snr_data = equalize_data_symbols(cfg, spec, tab, grid[:, 3 + cfg.n_ltf :], h0, estimator)
    return EqualizedFrame(
        z=z, snr_legacy=snr_legacy, snr_data=snr_data, chan_est_full=chan_full,
        chan_mean=chan_mean, sig_rate_bitmap=rate_bitmap, sig_length=length, sig_ptype=ptype,
        sig_ok=sig_ok,
    )
