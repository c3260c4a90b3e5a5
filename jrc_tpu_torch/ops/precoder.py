"""MIMO precoder: SIG field, steering and TX frame assembly, and the SIG
parser of the receiver (port of jrc_tpu/ops/precoder.py).

Steering for a single-RX channel row h: the phased matrix puts conj(h),
scaled to √n_tx / ‖h‖, in column 0; the SVD matrix is a unitary V whose
column 0 is conj(h)/‖h‖, built as the reference builds it, as a complex
Householder reflector (its null-space basis is one particular choice, and
the waveform depends on it: a library SVD would give another).

Frame layout per antenna: ``[sync×4 | SIG | MIMO-LTF×n_ltf | DATA×n_sym]``;
the legacy preamble and SIG go out on the first two antennas only. NDP
frames are never precoded.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType, RATE_FIELD
from jrc_tpu_torch.ops import modulation
from jrc_tpu_torch.ops.encoder import FrameSpec
from jrc_tpu_torch.ops.ofdm import allocate_carriers


@lru_cache(maxsize=None)
def signal_field_symbols(spec: FrameSpec) -> np.ndarray:
    """48 BPSK symbols of the SIG field: 4 rate bits (MSB first), the
    packet-type bit, 12 length bits (LSB first), even parity over the first
    17, 6 zero tail bits; rate-1/2 coded, unscrambled."""
    rate = RATE_FIELD[spec.mcs]
    length = spec.data_size_byte
    bits = np.zeros(24, np.uint8)
    bits[0:4] = [(rate >> 3) & 1, (rate >> 2) & 1, (rate >> 1) & 1, rate & 1]
    bits[4] = spec.packet_type.sig_bit
    for i in range(12):
        bits[5 + i] = (length >> i) & 1
    bits[17] = bits[:17].sum() % 2
    coded = np.zeros(48, np.uint8)
    state = 0
    for i, b in enumerate(bits):
        state = ((state << 1) & 0x7E) | int(b)
        coded[2 * i] = bin(state & 0o155).count("1") % 2
        coded[2 * i + 1] = bin(state & 0o117).count("1") % 2
    return modulation.constellation(1)[coded].astype(np.complex64)


def parse_signal_field_bits(bits: torch.Tensor):
    """Decode (..., 24) SIG bits → (rate_bitmap, packet_type_bit, length, ok):
    parity over bits 0..16 must equal bit 17 and the tail must be zero."""
    bits = bits.to(torch.int32)
    rate_bitmap = bits[..., 0] | (bits[..., 1] << 1) | (bits[..., 2] << 2) | (bits[..., 3] << 3)
    ptype = bits[..., 4]
    weights = 1 << torch.arange(12, dtype=torch.int32, device=bits.device)
    length = (bits[..., 5:17] * weights).sum(-1)
    parity = bits[..., :17].sum(-1) % 2
    tail_ok = bits[..., 18:24].sum(-1) == 0
    ok = (parity == bits[..., 17]) & tail_ok
    return rate_bitmap, ptype, length, ok


#: received rate_bitmap value → MCS
SIG_RATE_TO_MCS = {11: MCS.BPSK_1_2, 15: MCS.BPSK_3_4, 10: MCS.QPSK_1_2,
                   14: MCS.QPSK_3_4, 9: MCS.QAM16_1_2, 13: MCS.QAM16_3_4}


def fourier_matrix(n: int) -> np.ndarray:
    """DFT precoding fallback matrix (n, n) complex64."""
    k = np.arange(n)
    return (np.exp(-2j * np.pi * np.outer(k, k) / n) / np.sqrt(n)).astype(np.complex64)


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real * x.real + x.imag * x.imag


def _q_from_h(h: torch.Tensor, n_tx: int, phased: bool) -> torch.Tensor:
    """Steering matrices Q (..., n_tx, n_tx) from complex channel rows h
    (..., n_tx); a zero row gives a zero Q. Householder: v = conj(h)/‖h‖,
    α = v0/|v0| (1 where |v0| ≤ 1e-12), w = v − α·e0, Q = I − 2ww^H/‖w‖²,
    the identity where ‖w‖² ≤ 1e-12."""
    norm = torch.sqrt(_abs2(h).sum(-1, keepdim=True))
    nonzero = norm[..., 0] > 0
    if phased:
        scale = torch.where(norm > 0, float(np.sqrt(n_tx)) / norm, 0.0)
        q = torch.zeros((*h.shape, n_tx), dtype=torch.complex64, device=h.device)
        q[..., 0] = h.conj() * scale
        return q

    v = h.conj() / torch.where(norm > 0, norm, 1.0)
    v0 = v[..., 0]
    v0_abs = torch.sqrt(_abs2(v0))
    alpha = torch.where(v0_abs > 1e-12, v0 / torch.clamp_min(v0_abs, 1e-12),
                        torch.ones_like(v0))
    eye = torch.eye(n_tx, dtype=torch.float32, device=h.device)
    e0 = eye[0]  # a row of the identity: no host value copied in (a graph cannot hold one)
    w = v - alpha[..., None] * e0
    wn2 = _abs2(w).sum(-1)  # ∈ [0, 4]
    outer = w[..., :, None] * w[..., None, :].conj()
    den = torch.clamp_min(wn2, 1e-12)[..., None, None]
    hh = torch.complex(eye - 2.0 * outer.real / den, -2.0 * outer.imag / den)
    # w → 0: v is already e0 up to a phase, and H degenerates to the identity
    hh = torch.where((wn2 > 1e-12)[..., None, None], hh, eye.to(torch.complex64))
    return torch.where(nonzero[..., None, None], hh, 0)


def steering_from_chan_est(cfg: OFDMConfig, tab, chan_est: torch.Tensor, phased: bool = False):
    """Per-subcarrier Q (fft_len, n_tx, n_tx) and the mean Q (n_tx, n_tx)
    from an NDP estimate (fft_len, n_tx) in shifted order; the mean averages
    the active carriers' rows. ``tab`` holds ``active_idx``."""
    q = _q_from_h(chan_est, cfg.n_tx, phased)
    h_mean = chan_est[tab.active_idx].mean(0)
    return q, _q_from_h(h_mean, cfg.n_tx, phased)


def steering_from_angle(cfg: OFDMConfig, angle_deg: torch.Tensor, phased: bool = True):
    """Radar-aided steering: the ULA vector exp(jπ·sin θ·i) for a float32
    angle estimate (0-d tensor) → mean Q (n_tx, n_tx)."""
    i_tx = torch.arange(cfg.n_tx, device=angle_deg.device)
    theta = torch.pi * torch.sin(torch.deg2rad(angle_deg)) * i_tx
    return _q_from_h(torch.complex(torch.cos(theta), torch.sin(theta)), cfg.n_tx, phased)


def mean_channel_angle(chan_mean: torch.Tensor) -> torch.Tensor:
    """Debug angle estimate asin(arg(h1/h0)/π) in degrees."""
    ratio = chan_mean[..., 1] / chan_mean[..., 0]
    return torch.rad2deg(torch.arcsin(torch.atan2(ratio.imag, ratio.real) / torch.pi))


def assemble_siso_frame(cfg: OFDMConfig, tab, data_syms: torch.Tensor,
                        pilot_row0: int = 0) -> torch.Tensor:
    """Legacy one-antenna allocator: sync words then data and pilots,
    (n_sym, 48) → (n_sync + n_sym, fft_len)."""
    payload = allocate_carriers(cfg, tab, data_syms, pilot_row0=pilot_row0)
    return torch.cat([tab.sync_freq, payload], dim=-2)


def radar_stream_values(cfg: OFDMConfig, n_sym: int, *, generator=None, device=None):
    """The random QPSK values (n_tx − 1, n_sym, n_active) of the radar
    streams, drawn from ``generator``."""
    n_active = cfg.n_data_carriers + cfg.n_pilot_carriers
    return torch.randint(0, 4, (cfg.n_tx - 1, n_sym, n_active), generator=generator,
                         device=device)


def _stream_grids(cfg: OFDMConfig, tab, data_syms: torch.Tensor, use_radar_streams: bool,
                  radar_values: torch.Tensor | None, generator) -> torch.Tensor:
    """(n_streams, n_sym, fft_len): stream 0 data and pilots, streams 1..
    random QPSK/2 on data and pilot carriers (``radar_values``, else drawn
    from ``generator``)."""
    grid0 = allocate_carriers(cfg, tab, data_syms, pilot_row0=0)
    if not use_radar_streams:
        return grid0[None]
    if radar_values is None:
        if generator is None:
            raise ValueError("use_radar_streams=True needs radar_values or a generator "
                             "(the radar streams are random QPSK)")
        radar_values = radar_stream_values(cfg, data_syms.shape[-2], generator=generator,
                                           device=data_syms.device)
    sym = tab.qpsk_tx[radar_values]
    extra = torch.zeros((cfg.n_tx - 1, data_syms.shape[-2], cfg.fft_len), dtype=torch.complex64,
                        device=data_syms.device)
    extra[..., tab.data_idx] = sym[..., : cfg.n_data_carriers]
    extra[..., tab.pilot_idx] = sym[..., cfg.n_data_carriers :]
    return torch.cat([grid0[None], extra], dim=0)


def assemble_frame(cfg: OFDMConfig, spec: FrameSpec, tab, data_syms: torch.Tensor, *,
                   steering: torch.Tensor | None = None,
                   mean_steering: torch.Tensor | None = None,
                   use_radar_streams: bool = False,
                   radar_values: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """The TX frequency grid (n_total_sym, n_tx, fft_len) of one frame.
    Precoder choice: per-subcarrier ``steering`` (fft_len, n_tx, n_tx), else
    ``mean_steering`` (n_tx, n_tx), else the Fourier matrix."""
    n_tx = cfg.n_tx
    n_sym = data_syms.shape[-2]
    assert n_sym == spec.n_ofdm_sym, (n_sym, spec.n_ofdm_sym)
    n_total = cfg.n_sync_words + 1 + cfg.n_ltf + n_sym
    legacy = min(2, n_tx)
    grid = torch.zeros((n_total, n_tx, cfg.fft_len), dtype=torch.complex64,
                       device=data_syms.device)
    grid[: cfg.n_sync_words, :legacy] = tab.sync_freq[:, None, :]
    grid[cfg.n_sync_words, :legacy] = allocate_carriers(cfg, tab, tab.sig_symbols[None])[0]

    ltf_rows = slice(cfg.n_sync_words + 1, cfg.n_sync_words + 1 + cfg.n_ltf)
    data_rows = slice(cfg.n_sync_words + 1 + cfg.n_ltf, n_total)
    x_ltf = tab.ltf_mapped  # (fft_len, n_tx, n_ltf)
    if spec.packet_type is PacketType.NDP:
        grid[ltf_rows] = x_ltf.permute(2, 1, 0)
        grid[data_rows, :legacy] = allocate_carriers(cfg, tab, data_syms)[:, None, :]
        return grid

    streams = _stream_grids(cfg, tab, data_syms, use_radar_streams, radar_values, generator)
    n_streams = streams.shape[0]
    if steering is not None:
        grid[ltf_rows] = torch.einsum("sij,sjl->lis", steering, x_ltf)
        grid[data_rows] = torch.einsum("sij,jks->kis", steering[:, :, :n_streams], streams)
    else:
        qm = tab.fourier if mean_steering is None else mean_steering
        grid[ltf_rows] = torch.einsum("ij,sjl->lis", qm, x_ltf)
        grid[data_rows] = torch.einsum("ij,jks->kis", qm[:, :n_streams], streams)
    return grid
