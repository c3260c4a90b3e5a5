"""Stream decoder (port of jrc_tpu/ops/decoder.py:28-70 and
jrc_tpu/ops/viterbi.py:250): equalized symbols → depunctured channel values
(hard decisions or max-log-MAP LLRs) → Viterbi (K1) → payload + CRC
verdict, in one call (``decode_frame``) or in halves around a Viterbi pass
the caller batches; and the rolling PER of ``LinkStats`` (:73-92)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from jrc_tpu_torch.config import MCS
from jrc_tpu_torch.ops import coding, viterbi_cuda
from jrc_tpu_torch.ops.encoder import FrameSpec
from jrc_tpu_torch.ops.modulation import hard_decision, soft_llr
from jrc_tpu_torch.ops.viterbi import hard_to_values
from jrc_tpu_torch.tables import Tables


class DecodedFrame(NamedTuple):
    payload: torch.Tensor  # (..., payload_bytes) uint8 (without CRC)
    crc_ok: torch.Tensor  # (...,) bool
    scrambler_seed: torch.Tensor  # (...,) int64 recovered initial LFSR state


def frame_values(spec: FrameSpec, tab: Tables, z: torch.Tensor, soft: bool = False,
                 noise_var=1.0) -> torch.Tensor:
    """(..., n_data_sym, 48) equalized symbols → (..., 2·n_data_bits)
    depunctured channel values, 0 = erasure: ±1 hard decisions, or with
    ``soft`` the max-log-MAP LLRs at ``noise_var`` (see ``soft_llr``; the
    hard path ignores it)."""
    pp = spec.packet_params
    zs = z.reshape(*z.shape[:-2], -1)
    if soft:
        llrs = soft_llr(zs, tab.points, spec.mcs_params.n_bpsc, noise_var)
        return coding.depuncture(llrs, spec.mcs, 2 * pp.n_data_bits, erasure=0.0)
    vals = hard_decision(zs, tab.points)
    rx_bits = coding.merge_symbols(vals, spec.mcs_params.n_bpsc)
    return coding.depuncture(hard_to_values(rx_bits), spec.mcs, 2 * pp.n_data_bits, erasure=0.0)


def frame_from_bits(spec: FrameSpec, tab: Tables, decoded: torch.Tensor) -> DecodedFrame:
    """(..., n_data_bits) Viterbi output → payload + CRC verdict
    (descramble → CRC-32 residue)."""
    descrambled = coding.descramble(decoded, tab.descramble_basis)
    seed = coding.recover_scrambler_seed(decoded, tab.scrambler_phase, tab.scrambler_state_at)
    n_bytes = spec.data_size_byte  # payload + 4 CRC
    pdu = coding.bits_to_bytes(descrambled[..., 16 : 16 + 8 * n_bytes])
    crc_ok = coding.crc32_check_residue(pdu, tab.crc_T, tab.crc_E)
    return DecodedFrame(payload=pdu[..., :-4], crc_ok=crc_ok, scrambler_seed=seed)


def decode_frame(spec: FrameSpec, tab: Tables, z: torch.Tensor, soft: bool = False,
                 noise_var=1.0) -> DecodedFrame:
    """(..., n_data_sym, 48) equalized symbols → payload + CRC verdict; the
    Viterbi pass runs through K1 on the card."""
    values = frame_values(spec, tab, z, soft=soft, noise_var=noise_var)
    decoded = viterbi_cuda.viterbi_decode(values, tab.trellis, n_out=spec.packet_params.n_data_bits)
    return frame_from_bits(spec, tab, decoded)


def decode_bits(rx_bits: torch.Tensor, mcs: MCS, n_data_bits: int, trellis) -> torch.Tensor:
    """Hard-decision decode of (..., n_punctured) coded bits: depuncture
    (erasures as 0-valued channel values), then Viterbi → (..., n_data_bits)."""
    values = coding.depuncture(hard_to_values(rx_bits), mcs, 2 * n_data_bits, erasure=0.0)
    return viterbi_cuda.viterbi_decode(values, trellis, n_out=n_data_bits)


class LinkStats(NamedTuple):
    """Rolling PER statistics (the reference's boost rolling_mean, PER
    window 25): the last ``window`` frames' failures, newest first."""

    crc_history: torch.Tensor  # (window,) float32 of 0/1 failures
    count: torch.Tensor  # int32 frames seen


def init_stats(window: int = 25, device=None) -> LinkStats:
    """Empty statistics on ``device`` (None: the CUDA device; it raises where
    there is none)."""
    from jrc_tpu_torch.models.streaming import _entry_device  # models import ops

    device = _entry_device(device)
    return LinkStats(crc_history=torch.zeros(window, dtype=torch.float32, device=device),
                     count=torch.zeros((), dtype=torch.int32, device=device))


def update_stats(stats: LinkStats, crc_ok) -> LinkStats:
    """Push one frame's verdict (a bool, a float or a 0-d tensor on the
    stats' device)."""
    fail = 1.0 - torch.as_tensor(crc_ok, dtype=torch.float32, device=stats.crc_history.device)
    hist = torch.cat([fail.reshape(1), stats.crc_history[:-1]])
    return LinkStats(crc_history=hist, count=stats.count + 1)


def per_percent(stats: LinkStats) -> torch.Tensor:
    n = torch.clamp_max(stats.count, stats.crc_history.shape[0])
    return 100.0 * stats.crc_history.sum() / torch.clamp_min(n, 1)
