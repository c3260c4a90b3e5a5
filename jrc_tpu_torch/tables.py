"""The RX chain's constant tables as tensors.

The system has no learned weights; its state is these tables: the carrier
index maps and sequences of ``jrc_tpu.config.OFDMConfig``, the trellis, the
descrambler basis, the CRC-32 linear tables and the constellation, all
built in numpy (by ``jrc_tpu.config`` and the port's own table functions) and
moved to ``device`` once. ``models.streaming.StreamingRx`` registers them as
buffers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jrc_tpu.config import OFDMConfig
from jrc_tpu_torch.ops import coding, modulation, viterbi
from jrc_tpu_torch.ops.encoder import FrameSpec


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

    @property
    def trellis(self):
        return self.trellis_prev, self.trellis_sign_a, self.trellis_sign_b


def from_numpy(cfg: OFDMConfig, spec: FrameSpec, device) -> Tables:
    """Build every table for ``cfg``/``spec`` on ``device``."""
    prev, sign_a, sign_b = viterbi._trellis()
    _, phase, state_at = coding._scrambler_tables()
    crc_T, crc_E = coding._crc32_linear_tables(spec.data_size_byte)
    arrays = dict(
        data_idx=cfg.data_carrier_idx.astype(np.int64),
        pilot_idx=cfg.pilot_carrier_idx.astype(np.int64),
        active_idx=cfg.active_carrier_idx.astype(np.int64),
        lltf_freq=np.asarray(cfg.lltf_freq, np.complex64),
        pilot_symbols=np.asarray(cfg.pilot_symbols, np.complex64),
        ltf0_conj=np.conj(np.asarray(cfg.ltf_mapped_sc_ss_sym)[:, 0, :]).astype(np.complex64),
        trellis_prev=prev.astype(np.int64),
        trellis_sign_a=sign_a,
        trellis_sign_b=sign_b,
        points=modulation.constellation(spec.mcs_params.n_bpsc),
        descramble_basis=coding._descramble_basis(spec.packet_params.n_data_bits - 7),
        scrambler_phase=phase.astype(np.int64),
        scrambler_state_at=state_at.astype(np.int64),
        crc_T=crc_T.astype(np.int64),
        crc_E=crc_E.astype(np.int64),
    )
    return Tables(**{k: torch.as_tensor(v).to(device) for k, v in arrays.items()})
