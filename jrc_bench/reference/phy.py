"""The plain reference of the link's physical layer, in numpy float64.

Written from the semantics of the MIMO-OFDM frame of gr-mimo-ofdm-jrc (the
802.11a-style legacy preamble, SIG field and coding, the MIMO-LTF sounding
and the custom L-LTF of its flowgraphs), one frame at a time:

* TX: CRC-32, scrambler, K=7 code, puncturing, mapping, pilots, SIG field,
  preamble, MIMO-LTFs, a mean precoder and the IFFT with cyclic prefix;
* the bench channel (a ULA phase, path loss, CFO, AWGN from given draws);
* RX: the Schmidl-Cox trigger of a stream (direct sums), the L-LTF matched
  filter and peak-pair search, derotation, FFT, the L-LTF estimate and its
  SNR, the SIG decode, the MIMO-LTF estimates, pilot-phase tracking and the
  pilot-noise MMSE (DATA) or zero-forcing (NDP) equalizer, hard demapping,
  depuncturing, a textbook Viterbi decoder, descrambling and the CRC.

Nothing here imports the program. ``Prec`` rounds the signal to bfloat16
between stages for the control.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

FFT, CP = 64, 16
SYM = FFT + CP
N_TX, N_RX, N_LTF, N_SYNC = 4, 2, 4, 4
FS, FC = 125e6, 24e9
DATA_SC = np.array([*range(-26, -21), *range(-20, -7), *range(-6, 0), *range(1, 7),
                    *range(8, 21), *range(22, 27)]) + FFT // 2
PILOT_SC = np.array([-21, -7, 7, 21]) + FFT // 2
ACTIVE_SC = np.sort(np.concatenate([DATA_SC, PILOT_SC]))
#: the custom L-LTF of the flowgraphs (fft-shifted order, DC at 32)
_LTF_L = [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1]
_LTF_R = [1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1, 1, 1]
LTF = np.array([0, 0, 0, 0, 1, 1, *_LTF_L, 0, *_LTF_R, -1, -1, 0, 0, 0], np.complex128)
STF = np.zeros(FFT, np.complex128)
STF[[8, 16, 28, 44, 48, 52, 56]] = 1.4719601443879746 * (1 + 1j)
STF[[12, 20, 24, 36, 40]] = -1.4719601443879746 * (1 + 1j)
#: the third sync word: the L-LTF with the carrier rotation 1, -j, -1, j
SYNC_WORDS = np.stack([STF, STF, np.tile([1, -1j, -1, 1j], FFT // 4) * LTF, LTF])
P_LTF = np.array([[1, -1, 1, 1], [1, 1, -1, 1], [1, 1, 1, -1], [-1, 1, 1, 1]], np.float64)
_POLARITY = np.array([
    1, 1, 1, 1, -1, -1, -1, 1, -1, -1, -1, -1, 1, 1, -1, 1, -1, -1, 1, 1, -1, 1, 1, -1, 1, 1, 1,
    1, 1, 1, -1, 1, 1, 1, -1, 1, 1, -1, -1, 1, 1, 1, -1, 1, -1, -1, -1, 1, -1, 1, -1, -1, 1, -1,
    -1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1, -1, -1, -1, 1, 1, -1, -1, -1, -1,
    1, -1, -1, 1, -1, 1, 1, 1, 1, -1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, -1, 1, 1, -1, 1, -1,
    1, 1, 1, -1, -1, 1, -1, -1, -1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1])
#: pilot values of OFDM symbol k: row k % 127
PILOTS = _POLARITY[:, None] * np.array([1, 1, 1, -1], np.float64)
#: time-domain L-LTF of the matched filter
LTF_TIME = FFT * np.fft.ifft(np.fft.fftshift(LTF)) / np.sqrt(np.count_nonzero(LTF))

#: MCS name → (bits a carrier, code rate numerator, denominator, SIG rate nibble)
MCS = {"BPSK_1_2": (1, 1, 2, 0x0D), "BPSK_3_4": (1, 3, 4, 0x0F), "QPSK_1_2": (2, 1, 2, 0x05),
       "QPSK_3_4": (2, 3, 4, 0x07), "QAM16_1_2": (4, 1, 2, 0x09), "QAM16_3_4": (4, 3, 4, 0x0B)}
MCS_NAMES = tuple(MCS)
#: the SIG rate nibble as the receiver packs it (bit 0 first) → MCS index
RATE_TO_MCS = {sum(((r >> (3 - i)) & 1) << i for i in range(4)): k
               for k, (_, _, _, r) in enumerate(MCS.values())}
CRC_RESIDUE = 0x2144DF1C
THRESHOLD, MIN_PEAKS = 0.6, 10
IGNORE_GAP = (N_SYNC + N_TX) * SYM


def points(n_bpsc: int) -> np.ndarray:
    """The constellation by symbol value, LSB-first bits (gr-digital's Gray
    layout); the receiver decides against these."""
    if n_bpsc == 1:
        return np.array([-1, 1], np.complex128)
    if n_bpsc == 2:
        return np.array([-1 - 1j, 1 - 1j, -1 + 1j, 1 + 1j]) * np.sqrt(0.5)
    v = np.arange(16)
    return (np.array([-3, 1, -1, 3])[v & 3] + 1j * np.array([1, -1, 3, -3])[v >> 2]) * np.sqrt(0.1)


def tx_points(n_bpsc: int) -> np.ndarray:
    """The transmitter's constellation: the testbed's encoder halves QPSK."""
    return points(n_bpsc) * (0.5 if n_bpsc == 2 else 1.0)


@dataclass(frozen=True)
class Kind:
    """A frame's SIG content: MCS name, payload bytes (without CRC), DATA or NDP."""

    mcs: str
    payload_bytes: int
    ptype: str

    @property
    def n_bpsc(self) -> int:
        return MCS[self.mcs][0]

    @property
    def n_dbps(self) -> int:
        b, num, den, _ = MCS[self.mcs]
        return 48 * b * num // den

    @property
    def n_sym(self) -> int:
        return n_symbols(self.n_dbps, self.payload_bytes + 4)

    @property
    def n_data_bits(self) -> int:
        return self.n_sym * self.n_dbps


def n_symbols(n_dbps: int, data_size_byte: int) -> int:
    """OFDM data symbols of a frame: 16 service bits, the PDU, 6 tail bits."""
    return -(-(16 + 8 * data_size_byte + 6) // n_dbps)


# ---- bits -----------------------------------------------------------------

def lfsr(state: int, n: int) -> np.ndarray:
    """n output bits of the x^7 + x^4 + 1 scrambler from its 7-bit state."""
    out = np.empty(n, np.uint8)
    for i in range(n):
        fb = ((state >> 6) ^ (state >> 3)) & 1
        out[i] = fb
        state = ((state << 1) & 0x7E) | fb
    return out


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """Rate-1/2 K=7 code, generators 0o155 and 0o117, from the zero state."""
    out = np.empty(2 * len(bits), np.uint8)
    reg = 0
    for i, b in enumerate(bits):
        reg = ((reg << 1) | int(b)) & 0x7F
        out[2 * i] = bin(reg & 0o155).count("1") & 1
        out[2 * i + 1] = bin(reg & 0o117).count("1") & 1
    return out


def punctured(mcs: str, n_coded: int) -> np.ndarray:
    """Mask of the coded bits sent: rate 3/4 drops positions 3 and 4 of six."""
    i = np.arange(n_coded)
    return np.ones(n_coded, bool) if MCS[mcs][2] == 2 else (i % 6 != 3) & (i % 6 != 4)


def to_bits(data: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.asarray(data, np.uint8), bitorder="little")


def encode(kind: Kind, payload: np.ndarray, scrambler_seed: int) -> np.ndarray:
    """Payload bytes → the frame's data symbols (n_sym, 48) as sent."""
    pdu = np.concatenate([payload, np.frombuffer(
        (zlib.crc32(payload.tobytes()) & 0xFFFFFFFF).to_bytes(4, "little"), np.uint8)])
    bits = np.zeros(kind.n_data_bits, np.uint8)
    bits[16 : 16 + 8 * len(pdu)] = to_bits(pdu)
    bits ^= lfsr(scrambler_seed, len(bits))
    bits[16 + 8 * len(pdu) : 16 + 8 * len(pdu) + 6] = 0  # the tail resets the code
    coded = conv_encode(bits)
    coded = coded[punctured(kind.mcs, len(coded))]
    nb = kind.n_bpsc
    values = coded.reshape(-1, nb) @ (1 << np.arange(nb))
    return tx_points(nb)[values].reshape(kind.n_sym, 48)


def sig_symbols(kind: Kind) -> np.ndarray:
    """The SIG field's 48 BPSK symbols: the rate nibble MSB first, the type
    bit (DATA 1), the PDU length LSB first, even parity, 6 tail bits."""
    rate = MCS[kind.mcs][3]
    bits = np.zeros(24, np.uint8)
    bits[:4] = [(rate >> (3 - i)) & 1 for i in range(4)]
    bits[4] = kind.ptype == "DATA"
    bits[5:17] = [((kind.payload_bytes + 4) >> i) & 1 for i in range(12)]
    bits[17] = bits[:17].sum() & 1
    return points(1)[conv_encode(bits)]


def carriers(data: np.ndarray) -> np.ndarray:
    """(n, 48) data symbols → (n, 64) shifted grids with the scheduled pilots."""
    g = np.zeros((len(data), FFT), np.complex128)
    g[:, DATA_SC] = data
    g[:, PILOT_SC] = PILOTS[np.arange(len(data)) % 127]
    return g


def fourier(n: int = N_TX) -> np.ndarray:
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n) / np.sqrt(n)


def frame_grid(kind: Kind, data_syms: np.ndarray, q: np.ndarray | None) -> np.ndarray:
    """The frame's frequency grid (n_total, n_tx, 64): the preamble and SIG on
    antennas 0 and 1; the MIMO-LTFs (P_ltf coded) and the data precoded by
    ``q`` (n_tx, n_tx; its column 0 carries the one data stream), or, for an
    NDP, sent unprecoded, its data on antennas 0 and 1."""
    n_total = N_SYNC + 1 + N_LTF + len(data_syms)
    g = np.zeros((n_total, N_TX, FFT), np.complex128)
    g[:N_SYNC, :2] = SYNC_WORDS[:, None]
    g[N_SYNC, :2] = carriers(sig_symbols(kind)[None])[0]
    x_ltf = P_LTF[None] * LTF[:, None, None]  # (sc, tx, ltf)
    rows = carriers(data_syms)
    if kind.ptype == "NDP":
        g[N_SYNC + 1 : N_SYNC + 1 + N_LTF] = x_ltf.transpose(2, 1, 0)
        g[N_SYNC + 1 + N_LTF :, :2] = rows[:, None]
        return g
    g[N_SYNC + 1 : N_SYNC + 1 + N_LTF] = np.einsum("ij,sjl->lis", q, x_ltf)
    g[N_SYNC + 1 + N_LTF :] = q[None, :, 0, None] * rows[:, None, :]
    return g


class Prec:
    """Where the reference keeps its signal between stages: float64, or with
    ``bf16`` rounded to bfloat16 (real and imaginary parts apart) at each
    stage's output, the control's precision."""

    def __init__(self, bf16: bool = False):
        self.bf16 = bf16

    def r(self, x):
        if not self.bf16:
            return x
        x = np.asarray(x)
        if np.iscomplexobj(x):
            return _bf16(x.real) + 1j * _bf16(x.imag)
        return _bf16(x)


def _bf16(x: np.ndarray) -> np.ndarray:
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def ofdm(grid: np.ndarray, prec: Prec) -> np.ndarray:
    """(n_sym, n_tx, 64) → (n_tx, n_sym·80): unitary IFFT, cyclic prefix."""
    t = np.fft.ifft(np.fft.ifftshift(grid, axes=-1), axis=-1, norm="ortho")
    t = np.concatenate([t[..., -CP:], t], axis=-1)
    return prec.r(t.transpose(1, 0, 2).reshape(grid.shape[1], -1))


def tx_frame(kind: Kind, payload: np.ndarray, scrambler_seed: int, q: np.ndarray | None = None,
             prec: Prec = Prec()) -> tuple[np.ndarray, np.ndarray]:
    """(samples (n_tx, n), grid (n_sym, n_tx, 64)) of one frame; a DATA frame
    without ``q`` goes out on the Fourier precoder."""
    grid = frame_grid(kind, encode(kind, payload, scrambler_seed), fourier() if q is None else q)
    return ofdm(grid, prec), grid


def comm_channel(tx: np.ndarray, angle_deg: float, path_loss: float, cfo: float = 0.0):
    """A one-antenna receiver at ``angle_deg`` off the TX ULA's broadside:
    each antenna's phase, the path loss, the carrier offset (rad/sample)."""
    k = np.arange(tx.shape[0])
    y = (tx * np.exp(1j * np.pi * np.sin(np.deg2rad(angle_deg)) * k)[:, None]).sum(0) / path_loss
    return y * np.exp(1j * cfo * np.arange(y.shape[-1]))


# ---- receiver ---------------------------------------------------------------

def trailing_sum(x: np.ndarray, w: int) -> np.ndarray:
    """out[n] = Σ_{k<w} x[n−k], zeros before the start."""
    c = np.cumsum(np.concatenate([np.zeros(1, x.dtype), x]))
    n = np.arange(len(x)) + 1
    return c[n] - c[np.maximum(n - w, 0)]


def triggers(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Frame triggers of a stream (Schmidl-Cox on the L-STF's 16-sample
    period): a[n] = Σ_{k<32} x[n−k]·conj(x[n−16−k]), the power over 48
    samples, cor = |a| / (power/1.5); a trigger where 0.6 < cor < 2 holds at
    n and at more than 10 of the 160 samples up to n; later triggers within
    the preamble's 640 samples of a kept one dropped → (indices, coarse CFO
    rad/sample = arg a / 16)."""
    lag = FFT // 4
    xd = np.concatenate([np.zeros(lag, x.dtype), x[:-lag]])
    a = trailing_sum(x * np.conj(xd), FFT // 2)
    p = trailing_sum(np.abs(x) ** 2, 3 * FFT // 4) / 1.5
    cor = np.abs(a) / np.maximum(p, 1e-12)
    peak = (cor > THRESHOLD) & (cor < 2.0)
    fire = np.nonzero(peak & (trailing_sum(peak.astype(np.int64), 2 * SYM) > MIN_PEAKS))[0]
    kept, last = [], -(10**9)
    for n in fire:
        if n >= last + IGNORE_GAP:
            kept.append(n)
            last = n
    kept = np.asarray(kept, np.int64)
    return kept, np.angle(a[kept]) / lag


class Sync(NamedTuple):
    total_cfo: float  # rad/sample
    symbols: np.ndarray  # (n_sym, 64) time samples: two L-LTF copies, then CP-stripped symbols


def synchronize(x: np.ndarray, trig: int, coarse: float, n_sym: int, late: int = 0) -> Sync:
    """The L-LTF matched filter over the preamble after the trigger (derotated
    by the coarse CFO), the first pair among its four largest peaks 64
    samples apart (63 or 65 where none is), the fine CFO from their phases,
    and the frame's symbols derotated by the total (``late``: cut that many
    samples after the pair, a fault the control plants)."""
    win = N_SYNC * SYM
    k = np.arange(win + FFT - 1)
    w = x[trig + k] * np.exp(-1j * coarse * k)
    corr = np.array([np.vdot(LTF_TIME, w[n : n + FFT]) for n in range(win)])
    top = np.argsort(-np.abs(corr) ** 2, kind="stable")[:4]
    pairs = [tuple(sorted((top[i], top[j]))) for i in range(3) for j in range(i + 1, 4)]
    exact = [(lo, hi) for lo, hi in pairs if hi - lo == FFT]
    near = [(lo, hi) for lo, hi in pairs if hi - lo in (FFT - 1, FFT + 1)]
    # the first pair at the exact gap, else the last at one sample off
    best = exact[0] if exact else (near[-1] if near else None)
    if best:
        lo, hi = best
        best = (lo, np.angle(corr[lo] * np.conj(corr[hi])) / (hi - lo))
    start, fine = best if best else (win, 0.0)
    start += late
    total = coarse - fine
    n = 2 * FFT + (n_sym - 2) * SYM
    s = np.arange(n) + start
    y = x[trig + s] * np.exp(-1j * total * s)
    syms = np.concatenate([y[: 2 * FFT].reshape(2, FFT),
                           y[2 * FFT :].reshape(n_sym - 2, SYM)[:, CP:]])
    return Sync(float(total), syms)


def fft_symbols(syms: np.ndarray, total_cfo: float, prec: Prec) -> np.ndarray:
    """Unitary FFT of each symbol (shifted), then the sampling-clock offset
    that comes with the carrier offset: symbol s, carrier i rotated by
    2π·s·(80/64)·ε·(i − 32), ε = cfo·fs/(2π·fc)."""
    g = prec.r(np.fft.fftshift(np.fft.fft(syms, axis=-1, norm="ortho"), axes=-1))
    eps = total_cfo * FS / (2 * np.pi * FC)
    s = np.arange(len(g))[:, None]
    return g * np.exp(2j * np.pi * s * (SYM / FFT) * eps * (np.arange(FFT) - FFT // 2))


def viterbi(values: np.ndarray) -> np.ndarray:
    """Maximum-likelihood decode of (B, 2T) channel values (v > 0: bit 1,
    0: erasure) → (B, T) bits: the path from the zero state with the largest
    correlation, ending in the best state (the first on a tie); on a tie
    between two predecessors the one with the lower register wins."""
    v = np.asarray(values, np.float64).reshape(values.shape[0], -1, 2)
    b, t = v.shape[:2]
    s = np.arange(64)
    prev = np.stack([s >> 1, (s >> 1) + 32], 1)  # (64, 2): register drops its oldest bit
    reg = (prev << 1) | (s[:, None] & 1)
    sa = np.array([[1 - 2 * (bin(r & 0o155).count("1") & 1) for r in row] for row in reg])
    sb = np.array([[1 - 2 * (bin(r & 0o117).count("1") & 1) for r in row] for row in reg])
    metric = np.full((b, 64), -np.inf)
    metric[:, 0] = 0.0
    choice = np.empty((t, b, 64), np.uint8)
    for k in range(t):
        cand = metric[:, prev] - (sa * v[:, k, 0, None, None] + sb * v[:, k, 1, None, None])
        pick = cand[..., 1] > cand[..., 0]
        choice[k] = pick
        metric = np.where(pick, cand[..., 1], cand[..., 0])
    state = np.argmax(metric, axis=1)
    bits = np.empty((b, t), np.uint8)
    rows = np.arange(b)
    for k in range(t - 1, -1, -1):
        bits[:, k] = state & 1
        state = prev[state, choice[k, rows, state]]
    return bits


def descramble(bits: np.ndarray) -> np.ndarray:
    """The first 7 bits (scrambled service zeros) are the scrambler's state."""
    state = int(bits[:7] @ (1 << np.arange(6, -1, -1)))
    out = bits.copy()
    out[:7] = 0
    out[7:] ^= lfsr(state, len(bits) - 7)
    return out


class Frame(NamedTuple):
    sig_ok: bool
    mcs: int  # index into MCS_NAMES (0 where the rate is not one)
    ptype_bit: int  # 1 DATA, 0 NDP
    length: int  # PDU bytes from the SIG field, 4..max_payload+4
    snr_db: float  # from the L-LTF pair
    snr_data_db: float  # from the pilots over the payload
    chan_est: np.ndarray  # (64, n_tx) NDP MIMO estimate (every frame computes it)
    chan_est_ok: bool
    crc_ok: bool
    payload: np.ndarray  # length − 4 bytes


def receive(x: np.ndarray, trig: int, coarse: float, max_payload: int, kind: Kind | None = None,
            prec: Prec = Prec(), decode: bool = True, late: int = 0) -> Frame:
    """Decode the frame triggered at ``x[trig]``: its MCS, type and length from
    the SIG field (or, with ``kind``, from the frame kind the receiver was
    built for), everything else from the samples; without ``decode`` the
    payload is left undecoded (``crc_ok`` False, no payload bytes)."""
    n_env = kind.n_sym if kind else n_symbols(24, max_payload + 4)
    sy = synchronize(x, trig, coarse, 2 + 1 + N_LTF + n_env, late)
    g = fft_symbols(sy.symbols, sy.total_cfo, prec)
    a, d, p = ACTIVE_SC, DATA_SC, PILOT_SC
    y0, y1 = g[0], g[1]
    snr_db = 10 * math.log10(np.sum(np.abs(y0[a] + y1[a]) ** 2)
                             / np.sum(np.abs(y0[a] - y1[a]) ** 2) / 2)
    h_leg = y0.copy()
    h_leg[a] = (y0[a] + y1[a]) / (2 * LTF[a])

    def derotate(y, h, k):
        est = h[p] * PILOTS[k % 127]
        beta = np.angle(np.sum(y[p] * np.conj(est)))
        return y * np.exp(-1j * beta), est

    y_sig, _ = derotate(g[2], h_leg, 0)
    sig = viterbi(np.where((y_sig[d] / h_leg[d]).real > 0, 1.0, -1.0)[None])[0]
    rate = int(sig[:4] @ (1 << np.arange(4)))
    # the SIG-driven receiver also needs a rate it knows; one built for a kind does not
    sig_ok = bool(sig[:17].sum() % 2 == sig[17] and not sig[18:].any()
                  and (kind is not None or rate in RATE_TO_MCS))
    mcs = RATE_TO_MCS.get(rate, 0)
    ptype = int(sig[4])
    length = int(np.clip(sig[5:17] @ (1 << np.arange(12)), 4, max_payload + 4))
    if kind:
        mcs, ptype = MCS_NAMES.index(kind.mcs), int(kind.ptype == "DATA")
        length = kind.payload_bytes + 4
    mk = Kind(MCS_NAMES[mcs], length - 4, "DATA" if ptype else "NDP")
    x_ltf = P_LTF[None] * LTF[:, None, None]  # (sc, tx, ltf)
    y_ltf = g[3 : 3 + N_LTF]
    chan = np.einsum("stl,ls->st", np.conj(x_ltf), y_ltf)
    h_eff = np.zeros(FFT, np.complex128)
    h_eff[a] = chan[a, 0] / N_LTF
    h0 = h_eff if ptype else h_leg
    sig_sum = noise_sum = 0.0
    z = np.empty((mk.n_sym, 48), np.complex128)
    for k in range(mk.n_sym):
        y, est = derotate(g[3 + N_LTF + k], h0, k)
        sig_sum += np.sum(np.abs(est) ** 2)
        noise_sum += np.sum(np.abs(est - y[p]) ** 2)
        hd = h0[d]
        z[k] = (y[d] * np.conj(hd) / (np.abs(hd) ** 2 + noise_sum / (4 * (k + 1))) if ptype
                else y[d] / hd)
    snr_data = 10 * math.log10(max(sig_sum, 1e-30) / max(noise_sum, 1e-30))
    if not decode:
        return Frame(sig_ok=sig_ok, mcs=mcs, ptype_bit=ptype, length=length, snr_db=snr_db,
                     snr_data_db=snr_data, chan_est=chan, chan_est_ok=not ptype and sig_ok,
                     crc_ok=False, payload=np.zeros(0, np.uint8))
    nb = mk.n_bpsc
    vals = np.argmin(np.abs(z.reshape(-1, 1) - points(nb)[None]), axis=1)
    bits = ((vals[:, None] >> np.arange(nb)) & 1).reshape(-1)
    chanv = np.zeros(2 * mk.n_data_bits)
    chanv[punctured(mk.mcs, 2 * mk.n_data_bits)] = 2.0 * bits - 1
    dec = descramble(viterbi(chanv[None])[0])
    pdu = np.packbits(dec[16 : 16 + 8 * length], bitorder="little")
    crc_ok = zlib.crc32(pdu.tobytes()) & 0xFFFFFFFF == CRC_RESIDUE
    return Frame(sig_ok=sig_ok, mcs=mcs, ptype_bit=ptype, length=length, snr_db=snr_db,
                 snr_data_db=snr_data, chan_est=chan, chan_est_ok=not ptype and sig_ok,
                 crc_ok=bool(crc_ok and (sig_ok or kind is not None)), payload=pdu[: length - 4])
