"""Frame geometry and payload packing (port of jrc_tpu/ops/encoder.py:25-90).

Only the host-side pieces the RX chain needs; the TX encoder is not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from jrc_tpu_torch.config import MCS, MCSParams, PacketParams, PacketType


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


def make_payload(spec: FrameSpec, data: bytes) -> np.ndarray:
    """Pack python bytes (first byte = packet type, the UDP PDU convention)
    to the spec length."""
    if len(data) > spec.payload_bytes:
        raise ValueError(f"{len(data)} bytes > payload_bytes={spec.payload_bytes}")
    buf = np.zeros(spec.payload_bytes, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    return buf
