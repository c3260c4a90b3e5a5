"""Stream encoder: payload bytes → modulated OFDM data symbols, with the
frame geometry and payload packing (port of jrc_tpu/ops/encoder.py:25-90).

``encode_frame``: CRC-32 append → 16 SERVICE zeros + bits → scramble →
zero tail → conv encode → puncture → split → constellation map (no
interleaving, as in the reference). Batched over leading payload dims.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from jrc_tpu_torch.config import MCS, MCSParams, PacketParams, PacketType
from jrc_tpu_torch.ops import coding, modulation


@dataclass(frozen=True)
class FrameSpec:
    """Static frame geometry: everything the SIG field carries.

    ``payload_bytes`` is the PSDU length *without* CRC (4 CRC bytes are added
    before the packet parameters are computed).
    """

    mcs: MCS
    payload_bytes: int
    packet_type: PacketType
    n_data_carriers: int = 48

    @property
    def data_size_byte(self) -> int:
        return self.payload_bytes + 4

    @property
    def mcs_params(self) -> MCSParams:
        return MCSParams(self.mcs, self.n_data_carriers)

    @property
    def packet_params(self) -> PacketParams:
        return PacketParams(self.mcs_params, self.data_size_byte, self.packet_type)

    @property
    def n_ofdm_sym(self) -> int:
        return self.packet_params.n_ofdm_sym


def encode_frame(spec: FrameSpec, tab, payload: torch.Tensor, scrambler_seed) -> torch.Tensor:
    """(..., payload_bytes) uint8 + seed (1..127, an int or a 0-d tensor) →
    complex64 (..., n_ofdm_sym, n_data_carriers) symbols. ``tab`` is
    ``tables.from_numpy`` of ``spec`` on the payload's device."""
    pp = spec.packet_params
    mp = spec.mcs_params
    batch = payload.shape[:-1]
    fcs = coding.crc32_bytes(payload, tab.crc_T, tab.crc_E)
    # little-endian FCS bytes behind the payload
    fcs_bytes = torch.stack([(fcs >> (8 * k)) & 0xFF for k in range(4)], dim=-1)
    pdu = torch.cat([payload.to(torch.uint8), fcs_bytes.to(torch.uint8)], dim=-1)
    bits = torch.zeros((*batch, pp.n_data_bits), dtype=torch.uint8, device=payload.device)
    bits[..., 16 : 16 + 8 * pp.data_size_byte] = coding.bytes_to_bits(pdu)
    scrambled = coding.scramble(bits, scrambler_seed, tab.scramble_cycle, tab.scrambler_phase)
    tail0 = pp.n_data_bits - pp.n_pad_bits - 6
    scrambled[..., tail0 : tail0 + 6] = 0  # the reset tail bits
    coded = coding.puncture(coding.conv_encode(scrambled), spec.mcs)
    values = coding.split_symbols(coded, mp.n_bpsc)
    syms = modulation.modulate(values, tab.points, mp.n_bpsc)
    return syms.reshape(*batch, pp.n_ofdm_sym, mp.n_data_carriers)


def make_payload(spec: FrameSpec, data: bytes) -> np.ndarray:
    """Pack python bytes (first byte = packet type, the UDP PDU convention)
    to the spec length."""
    if len(data) > spec.payload_bytes:
        raise ValueError(f"{len(data)} bytes > payload_bytes={spec.payload_bytes}")
    buf = np.zeros(spec.payload_bytes, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    return buf
