"""The RX chain's constant tables as tensors.

The system has no learned weights; its state is these tables: the carrier
index maps and sequences of ``jrc_tpu_torch.config.OFDMConfig``, the trellis, the
descrambler basis, the CRC-32 linear tables and the constellation, all
built in numpy (by ``jrc_tpu_torch.config`` and the port's own table functions) and
moved to ``device`` once. ``models.streaming.StreamingRx`` registers them as
buffers.

``from_numpy`` builds the tables of one static ``FrameSpec`` (both
directions: the TX chain's preamble, LTF mapping, SIG symbols, scrambler
cycle and fallback precoder are there too); ``from_numpy_dynamic`` those of
the SIG-driven dynamic path, which learns MCS, length and packet type per
frame and so carries every constellation, the SIG rate tables and tables
sized for the ``max_payload`` envelope; ``radar_from_numpy`` the radar
leg's virtual-array positions, range and angle axes and aperture tapers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jrc_tpu_torch.config import C_LIGHT, OFDMConfig, mcs_tables
from jrc_tpu_torch.ops import coding, modulation, viterbi
from jrc_tpu_torch.ops.encoder import FrameSpec
from jrc_tpu_torch.ops.precoder import SIG_RATE_TO_MCS


class Tables(NamedTuple):
    data_idx: torch.Tensor  # (n_data_carriers,) int64, shifted grid
    pilot_idx: torch.Tensor  # (n_pilot_carriers,) int64
    active_idx: torch.Tensor  # (n_active,) int64
    lltf_freq: torch.Tensor  # (fft_len,) complex64
    pilot_symbols: torch.Tensor  # (127, n_pilot_carriers) complex64
    ltf0_conj: torch.Tensor  # (fft_len, n_ltf) complex64: conj(P_ltf·ltf) of stream 0
    trellis_prev: torch.Tensor  # (64, 2) int64
    trellis_sign_a: torch.Tensor  # (64, 2) float32
    trellis_sign_b: torch.Tensor  # (64, 2) float32
    points: torch.Tensor  # unscaled constellation of spec.mcs, complex64
    descramble_basis: torch.Tensor  # (7, n_data_bits − 7) uint8
    scrambler_phase: torch.Tensor  # (128,) int64
    scrambler_state_at: torch.Tensor  # (127,) int64
    crc_T: torch.Tensor  # (data_size_byte, 256) int64 (uint32 values)
    crc_E: torch.Tensor  # (data_size_byte + 1,) int64
    ltf_conj: torch.Tensor  # (fft_len, n_tx, n_ltf) complex64: conj(P_ltf·ltf), all streams
    sync_freq: torch.Tensor  # (n_sync_words, fft_len) complex64 legacy preamble
    ltf_mapped: torch.Tensor  # (fft_len, n_tx, n_ltf) complex64 P_ltf·ltf
    sig_symbols: torch.Tensor  # (48,) complex64 BPSK SIG field of spec
    scramble_cycle: torch.Tensor  # (127,) uint8 periodic LFSR output
    fourier: torch.Tensor  # (n_tx, n_tx) complex64 fallback precoder
    qpsk_tx: torch.Tensor  # (4,) complex64 QPSK with the TX halving (radar streams)

    @property
    def trellis(self):
        return self.trellis_prev, self.trellis_sign_a, self.trellis_sign_b


def _shared_arrays(cfg: OFDMConfig, n_crc_bytes: int) -> dict:
    """The numpy tables both paths need: carrier maps and sequences, the
    trellis and the CRC-32 tables for messages of up to ``n_crc_bytes``."""
    prev, sign_a, sign_b = viterbi._trellis()
    crc_T, crc_E = coding._crc32_linear_tables(n_crc_bytes)
    return dict(
        data_idx=cfg.data_carrier_idx.astype(np.int64),
        pilot_idx=cfg.pilot_carrier_idx.astype(np.int64),
        active_idx=cfg.active_carrier_idx.astype(np.int64),
        lltf_freq=np.asarray(cfg.lltf_freq, np.complex64),
        pilot_symbols=np.asarray(cfg.pilot_symbols, np.complex64),
        ltf0_conj=np.conj(np.asarray(cfg.ltf_mapped_sc_ss_sym)[:, 0, :]).astype(np.complex64),
        trellis_prev=prev.astype(np.int64),
        trellis_sign_a=sign_a,
        trellis_sign_b=sign_b,
        crc_T=crc_T.astype(np.int64),
        crc_E=crc_E.astype(np.int64),
    )


def from_numpy(cfg: OFDMConfig, spec: FrameSpec, device) -> Tables:
    """Build every table for ``cfg``/``spec`` on ``device``."""
    from jrc_tpu_torch.ops import precoder

    cycle, phase, state_at = coding._scrambler_tables()
    arrays = dict(
        _shared_arrays(cfg, spec.data_size_byte),
        points=modulation.constellation(spec.mcs_params.n_bpsc),
        descramble_basis=coding._descramble_basis(spec.packet_params.n_data_bits - 7),
        scrambler_phase=phase.astype(np.int64),
        scrambler_state_at=state_at.astype(np.int64),
        ltf_conj=np.conj(np.asarray(cfg.ltf_mapped_sc_ss_sym)).astype(np.complex64),
        sync_freq=np.asarray(cfg.sync_words_freq, np.complex64),
        ltf_mapped=np.asarray(cfg.ltf_mapped_sc_ss_sym, np.complex64),
        sig_symbols=precoder.signal_field_symbols(spec),
        scramble_cycle=cycle,
        fourier=precoder.fourier_matrix(cfg.n_tx),
        qpsk_tx=modulation.constellation(2, tx_scale=True),
    )
    return Tables(**{k: torch.as_tensor(np.ascontiguousarray(arrays[k])).to(device)
                     for k in Tables._fields})


class RadarTables(NamedTuple):
    """Constants of the radar leg (one set per interpolation and taper)."""

    positions: torch.Tensor  # (n_tx, n_rx) float32 virtual-element positions, m
    range_axis: torch.Tensor  # (fft_len·ir,) float32 range bins, m
    angle_axis: torch.Tensor  # (n_virt·ia,) float32 angle bins, deg
    taper_range: torch.Tensor  # (fft_len,) float32 range-aperture taper (ones: none)


def radar_from_numpy(cfg: OFDMConfig, device, interp_factor_range: int = 8,
                     interp_factor_angle: int = 16,
                     window_range: str | None = None) -> RadarTables:
    """The radar leg's constants on ``device``."""
    from jrc_tpu_torch.ops import channel, radar

    arrays = dict(
        positions=channel.virtual_positions(cfg.n_tx, cfg.n_rx, C_LIGHT / cfg.center_freq),
        range_axis=radar.range_axis(cfg.fft_len, cfg.sample_rate, interp_factor_range),
        angle_axis=np.asarray(cfg.angle_axis(interp_factor_angle), np.float32),
        taper_range=radar.taper(cfg.fft_len, window_range),
    )
    return RadarTables(**{k: torch.as_tensor(arrays[k]).to(device) for k in RadarTables._fields})


class DynTables(NamedTuple):
    """Tables of the SIG-driven dynamic path (no FrameSpec); the fields it
    shares with ``Tables`` have the same names, so the equalizer functions
    take either."""

    data_idx: torch.Tensor
    pilot_idx: torch.Tensor
    active_idx: torch.Tensor
    lltf_freq: torch.Tensor
    pilot_symbols: torch.Tensor
    ltf0_conj: torch.Tensor
    ltf_conj: torch.Tensor  # (fft_len, n_tx, n_ltf) complex64: conj(P_ltf·ltf), all streams
    trellis_prev: torch.Tensor
    trellis_sign_a: torch.Tensor
    trellis_sign_b: torch.Tensor
    points_bpsk: torch.Tensor  # unscaled constellations, n_bpsc = 1, 2, 4
    points_qpsk: torch.Tensor
    points_qam16: torch.Tensor
    rate_lut: torch.Tensor  # (16,) int64: SIG rate bitmap → MCS index (0 if invalid)
    rate_valid: torch.Tensor  # (16,) bool
    n_dbps: torch.Tensor  # (6,) int64 data bits per OFDM symbol, by MCS index
    n_bpsc: torch.Tensor  # (6,) int64 bits per carrier symbol, by MCS index
    descramble_basis: torch.Tensor  # (7, 16 + 8·(max_payload+4) − 7) uint8
    crc_T: torch.Tensor  # (max_payload + 4, 256) int64
    crc_E: torch.Tensor  # (max_payload + 5,) int64

    @property
    def trellis(self):
        return self.trellis_prev, self.trellis_sign_a, self.trellis_sign_b

    def points(self, n_bpsc: int) -> torch.Tensor:
        return {1: self.points_bpsk, 2: self.points_qpsk, 4: self.points_qam16}[n_bpsc]


def _rate_tables() -> tuple[np.ndarray, np.ndarray]:
    """(rate_lut (16,), rate_valid (16,)) from the SIG rate bitmaps
    (jrc_tpu/ops/dynamic_rx.py:44-50)."""
    lut = np.zeros(16, np.int64)
    valid = np.zeros(16, bool)
    for bitmap, mcs in SIG_RATE_TO_MCS.items():
        lut[bitmap] = int(mcs)
        valid[bitmap] = True
    return lut, valid


def from_numpy_dynamic(cfg: OFDMConfig, max_payload: int, device) -> DynTables:
    """Build every table of the dynamic path for frames of up to
    ``max_payload`` bytes (without CRC) on ``device``."""
    max_bytes = max_payload + 4
    rate_lut, rate_valid = _rate_tables()
    arrays = dict(
        _shared_arrays(cfg, max_bytes),
        ltf_conj=np.conj(np.asarray(cfg.ltf_mapped_sc_ss_sym)).astype(np.complex64),
        points_bpsk=modulation.constellation(1),
        points_qpsk=modulation.constellation(2),
        points_qam16=modulation.constellation(4),
        rate_lut=rate_lut,
        rate_valid=rate_valid,
        n_dbps=mcs_tables(cfg.n_data_carriers)[2].astype(np.int64),
        n_bpsc=mcs_tables(cfg.n_data_carriers)[0].astype(np.int64),
        descramble_basis=coding._descramble_basis(16 + 8 * max_bytes - 7),
    )
    return DynTables(**{k: torch.as_tensor(np.ascontiguousarray(arrays[k])).to(device)
                        for k in DynTables._fields})
