"""SIG-field parsing (port of jrc_tpu/ops/precoder.py:70-89); the TX
precoder is not ported yet."""
from __future__ import annotations

import torch

from jrc_tpu_torch.config import MCS


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
