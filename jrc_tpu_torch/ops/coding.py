"""The bit-level codec (port of jrc_tpu/ops/coding.py).

TX: scrambler, K=7 convolutional encoder, puncturing, bit packing and
symbol splitting; RX: descrambler, depuncturing, CRC-32 residue check and
bit/byte packing. The constant tables are rebuilt here in numpy
(``_scrambler_tables``, ``_descramble_basis``, ``_crc32_linear_tables``)
and handed to the torch functions as tensors by ``jrc_tpu_torch.tables``.
CRC words are int64: torch's uint32 support is thin, and every value fits.
"""
from __future__ import annotations

import zlib
from functools import lru_cache

import numpy as np
import torch

from jrc_tpu_torch.config import CODE_RATE, CONV_POLY_A, CONV_POLY_B, CRC32_RESIDUE, MCS


def _lfsr_feedback(state: int) -> int:
    return ((state >> 6) ^ (state >> 3)) & 1


@lru_cache(maxsize=1)
def _scrambler_tables():
    """(cycle[127] uint8, phase[128] int32, state_at[127] int32) of the
    7-bit LFSR x^7 + x^4 + 1: ``cycle`` is its periodic output,
    ``phase[s]`` the cycle index at which a register seeded with ``s``
    starts, ``state_at`` the inverse map."""
    cycle = np.zeros(127, np.uint8)
    phase = np.zeros(128, np.int32)
    state_at = np.zeros(127, np.int32)
    state = 1
    for i in range(127):
        phase[state] = i
        state_at[i] = state
        fb = _lfsr_feedback(state)
        cycle[i] = fb
        state = ((state << 1) & 0x7E) | fb
    assert state == 1
    return cycle, phase, state_at


def scramble_sequence(seed, n: int, cycle: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """LFSR output bits (n,) uint8 for ``seed`` ∈ 1..127 (a Python int or a
    0-d integer tensor): ``cycle`` and ``phase`` are ``_scrambler_tables``'
    as tensors on the device the sequence is wanted on."""
    p = phase[seed]
    idx = (p + torch.arange(n, device=cycle.device)) % 127
    return cycle[idx]


def scramble(bits: torch.Tensor, seed, cycle: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """XOR (..., n) ``bits`` with the LFSR sequence of ``seed`` (involutive)."""
    return bits.to(torch.uint8) ^ scramble_sequence(seed, bits.shape[-1], cycle, phase)


@lru_cache(maxsize=32)
def _descramble_basis(n: int) -> np.ndarray:
    """(7, n) LFSR output basis: row j is the sequence from the register
    state with only bit j (MSB-first) set. The LFSR is linear over GF(2), so
    the sequence of any state is the XOR of the rows of its set bits."""
    cycle, phase, _ = _scrambler_tables()
    basis = np.zeros((7, n), np.uint8)
    for j in range(7):
        idx = (phase[1 << (6 - j)] + np.arange(n)) % 127
        basis[j] = cycle[idx]
    return basis


@lru_cache(maxsize=1)
def _crc32_table() -> np.ndarray:
    poly = 0xEDB88320
    tab = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if (c & 1) else (c >> 1)
        tab[i] = c
    return tab


@lru_cache(maxsize=8)
def _crc32_linear_tables(n_max: int):
    """CRC-32 is linear over GF(2):

        crc(msg[:L]) = E[L] ⊕ ⨁_j T[L−1−j, msg[j]] ⊕ 0xFFFFFFFF

    T[d, v] is the register from byte v pushed through d zero bytes, E[L]
    the 0xFFFFFFFF init register pushed through L zero bytes. Returns
    (T (n_max, 256), E (n_max+1,)) uint32."""
    tab = _crc32_table()

    def zstep(crc):
        return tab[crc & 0xFF] ^ (crc >> 8)

    T = np.zeros((n_max, 256), np.uint32)
    T[0] = tab
    for d in range(1, n_max):
        T[d] = zstep(T[d - 1])
    E = np.zeros(n_max + 1, np.uint32)
    E[0] = 0xFFFFFFFF
    for i in range(1, n_max + 1):
        E[i] = zstep(E[i - 1])
    return T, E


def descramble(bits: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Self-synchronizing descramble of (..., n) bits: the first 7 received
    bits are the raw LFSR output (all-zero SERVICE field), packed MSB-first
    into the register state. Returns uint8 bits with positions 0..6 zeroed.
    ``basis`` is ``_descramble_basis(m)`` for any m ≥ n − 7."""
    n = bits.shape[-1]
    bits = bits.to(torch.uint8)
    basis = basis[:, : n - 7]
    seq = torch.zeros_like(bits[..., 7:])
    for j in range(7):
        seq = seq ^ (bits[..., j : j + 1] & basis[j])
    head = torch.zeros_like(bits[..., :7])
    return torch.cat([head, bits[..., 7:] ^ seq], dim=-1)


def recover_scrambler_seed(
    bits: torch.Tensor, phase: torch.Tensor, state_at: torch.Tensor
) -> torch.Tensor:
    """Initial LFSR state the TX seeded, from the first 7 received bits
    (their MSB-first packing is the state 7 shifts later)."""
    weights = 1 << torch.arange(6, -1, -1, device=bits.device)
    s7 = (bits[..., :7].to(torch.int64) * weights).sum(-1)
    # take, not indexing: a 0-d index (one frame) would be read on the host
    p0 = (torch.take(phase, s7) - 7) % 127
    return torch.take(state_at, p0)


_TAPS_A = tuple(k for k in range(7) if (CONV_POLY_A >> k) & 1)  # (0, 2, 3, 5, 6)
_TAPS_B = tuple(k for k in range(7) if (CONV_POLY_B >> k) & 1)  # (0, 1, 2, 3, 6)


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """Rate-1/2 K=7 encode (polys 0o155 / 0o117): (..., n) bits → (..., 2n),
    out[2i] / out[2i+1] the parity of the register holding in[i−6..i], as an
    XOR of shifted copies of the input."""
    b = bits.to(torch.uint8)

    def branch(taps):
        acc = torch.zeros_like(b)
        for k in taps:
            acc = acc ^ (b if k == 0 else torch.nn.functional.pad(b[..., :-k], (k, 0)))
        return acc

    out = torch.stack([branch(_TAPS_A), branch(_TAPS_B)], dim=-1)
    return out.reshape(*b.shape[:-1], 2 * b.shape[-1])


@lru_cache(maxsize=None)
def _puncture_keep_idx(n_coded: int) -> np.ndarray:
    """Indices the rate-3/4 puncturer keeps (it drops i % 6 ∈ {3, 4})."""
    i = np.arange(n_coded)
    return i[(i % 6 != 3) & (i % 6 != 4)].astype(np.int32)


def puncture(coded: torch.Tensor, mcs: MCS) -> torch.Tensor:
    """Apply the MCS's puncturing pattern to (..., 2n) coded bits: rate 1/2
    keeps all, rate 3/4 keeps columns 0, 1, 2 and 5 of each group of six."""
    if CODE_RATE[mcs] == (1, 2):
        return coded
    n = coded.shape[-1]
    n_keep = len(_puncture_keep_idx(n))
    m6 = -(-n // 6)
    c = torch.nn.functional.pad(coded, (0, 6 * m6 - n)).reshape(*coded.shape[:-1], m6, 6)
    out = torch.cat([c[..., :3], c[..., 5:6]], dim=-1)
    return out.reshape(*coded.shape[:-1], 4 * m6)[..., :n_keep]


def depuncture(bits: torch.Tensor, mcs: MCS, n_coded: int, erasure=0) -> torch.Tensor:
    """Re-insert erasures at punctured positions → (..., n_coded). The
    rate-3/4 pattern has period 6 (i % 6 ∈ {3, 4} dropped)."""
    if CODE_RATE[mcs] == (1, 2):
        assert bits.shape[-1] == n_coded
        return bits
    lead = bits.shape[:-1]
    m6 = -(-n_coded // 6)
    pad = 4 * m6 - bits.shape[-1]
    b = bits
    if pad:
        b = torch.cat([b, b.new_full((*lead, pad), erasure)], dim=-1)
    b = b.reshape(*lead, m6, 4)
    e = bits.new_full((*lead, m6, 1), erasure)
    out = torch.cat([b[..., :3], e, e, b[..., 3:4]], dim=-1)
    return out.reshape(*lead, 6 * m6)[..., :n_coded]


@lru_cache(maxsize=None)
def _interleave_perm(n_cbps: int, n_bpsc: int) -> np.ndarray:
    """802.11-style two-step interleaver permutation (reference
    lib/utils.cc:251-275). out[k] = in[second[first[k]]]."""
    s = max(n_bpsc // 2, 1)
    j = np.arange(n_cbps)
    first = s * (j // s) + (j + (16 * j // n_cbps)) % s
    i = np.arange(n_cbps)
    second = 16 * i - (n_cbps - 1) * (16 * i // n_cbps)
    return second[first].astype(np.int32)


def interleave(bits: torch.Tensor, n_cbps: int, n_bpsc: int, reverse: bool = False) -> torch.Tensor:
    """Per-symbol block interleaver (port of jrc_tpu/ops/coding.py:231-254),
    on the device of ``bits``; ``reverse`` undoes it. Kept for parity: the
    reference ships it but never enables it (lib/stream_encoder_impl.cc:183-184
    commented out; no deinterleave at lib/stream_decoder_impl.cc:267)."""
    perm = _interleave_perm(n_cbps, n_bpsc)
    if reverse:
        perm = np.argsort(perm)
    n_sym = bits.shape[-1] // n_cbps
    b = bits.reshape(*bits.shape[:-1], n_sym, n_cbps)
    out = b[..., torch.from_numpy(perm.astype(np.int64)).to(bits.device)]
    return out.reshape(bits.shape)


def depuncture_mask(mcs: MCS, n_coded: int) -> np.ndarray:
    """Boolean mask (n_coded,) of positions carrying real channel bits."""
    i = np.arange(n_coded)
    if CODE_RATE[mcs] == (1, 2):
        return np.ones(n_coded, bool)
    return (i % 6 != 3) & (i % 6 != 4)


def crc32_bytes(data: torch.Tensor, crc_T: torch.Tensor, crc_E: torch.Tensor,
                n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """CRC-32 of (..., n) byte arrays as int64, from the linear tables
    (``crc_T``, ``crc_E`` built for any n_max ≥ n). ``n_valid`` (a tensor
    broadcasting against the leading dims) limits each row's CRC to its
    first bytes, so frames of different lengths share one pass."""
    n = data.shape[-1]
    j = torch.arange(n, device=data.device)
    if n_valid is None:  # Python-int indices: no host sync on the card
        d = n - 1 - j  # distance from the message end
        init = crc_E[n]
    else:
        n_valid = n_valid.to(torch.int64)
        d = n_valid[..., None] - 1 - j
        init = crc_E[n_valid.clamp(0, n)]
    contrib = crc_T[d.clamp(0, n - 1), data.to(torch.int64)]  # (..., n)
    contrib = torch.where(d >= 0, contrib, 0)
    while contrib.shape[-1] > 1:  # XOR tree: log2(n) folds
        h = contrib.shape[-1] // 2
        folded = contrib[..., :h] ^ contrib[..., h : 2 * h]
        contrib = torch.cat([folded, contrib[..., 2 * h :]], dim=-1)
    return contrib[..., 0] ^ init ^ 0xFFFFFFFF


def crc32_check_residue(data: torch.Tensor, crc_T: torch.Tensor, crc_E: torch.Tensor,
                        n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """True iff the CRC over payload+FCS (the first ``n_valid`` bytes of
    each row, or all of them) leaves the magic residue."""
    return crc32_bytes(data, crc_T, crc_E, n_valid) == CRC32_RESIDUE


def crc32_host(data: bytes) -> int:
    """Host-side CRC-32 (boost::crc_32_type, i.e. zlib.crc32)."""
    return zlib.crc32(data) & 0xFFFFFFFF


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """(..., n) uint8 bytes → (..., 8n) uint8 bits, LSB-first per byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data.to(torch.uint8)[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def split_symbols(bits: torch.Tensor, n_bpsc: int) -> torch.Tensor:
    """Group coded bits into constellation symbol values, LSB-first →
    int64 (..., n // n_bpsc)."""
    n_sym = bits.shape[-1] // n_bpsc
    b = bits[..., : n_sym * n_bpsc].reshape(*bits.shape[:-1], n_sym, n_bpsc)
    weights = 1 << torch.arange(n_bpsc, dtype=torch.int64, device=bits.device)
    return (b.to(torch.int64) * weights).sum(-1)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8n) bits → (..., n) uint8 bytes, LSB-first per byte."""
    n = bits.shape[-1] // 8
    b = bits.reshape(*bits.shape[:-1], n, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(-1).to(torch.uint8)


def merge_symbols(values: torch.Tensor, n_bpsc: int) -> torch.Tensor:
    """Symbol values → bits, LSB-first."""
    shifts = torch.arange(n_bpsc, dtype=values.dtype, device=values.device)
    bits = (values[..., :, None] >> shifts) & 1
    return bits.reshape(*values.shape[:-1], values.shape[-1] * n_bpsc).to(torch.uint8)
