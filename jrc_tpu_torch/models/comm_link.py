"""End-to-end OFDM communication link: TX frame → channel → synchronized
RX (port of jrc_tpu/models/comm_link.py).

encoder → precoder → IFFT/CP → zero_pad → [ULA phase + path loss + CFO +
AWGN] → detection (K2) → sync (K3) → FFT → equalizer (SIG through K1) →
decoder (K1). Random draws are passed in as tensors (``Draws``) or drawn
from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch.ops import channel, decoder, encoder, equalizer, ofdm, precoder, sync
from jrc_tpu_torch.tables import Tables


class Draws(NamedTuple):
    """The random draws of one frame or dwell; a None field is drawn from
    the generator the function is given."""

    radar_values: torch.Tensor | None = None  # (n_tx−1, n_sym, n_active) radar-stream QPSK values
    phase: torch.Tensor | None = None  # (K,) per-target radar phases
    radar_noise: torch.Tensor | None = None  # (n_rx, n_samples) standard normal pairs
    comm_noise: torch.Tensor | None = None  # (n_samples,) standard normal pairs


def draw(given, generator, what: str, make):
    """``given`` draws if there are any, else ``make()`` (which draws from
    ``generator``); no generator either is an error."""
    if given is not None:
        return given
    if generator is None:
        raise ValueError(f"no {what} draws were given and no generator to draw them from")
    return make()


class TxFrame(NamedTuple):
    samples: torch.Tensor  # (n_tx, n_samples) time domain
    grid: torch.Tensor  # (n_sym_total, n_tx, fft_len) frequency domain (pre-IFFT)


def tx_frame(
    cfg: OFDMConfig,
    spec: encoder.FrameSpec,
    tab: Tables,
    payload: torch.Tensor,
    scrambler_seed,
    *,
    steering: torch.Tensor | None = None,
    mean_steering: torch.Tensor | None = None,
    use_radar_streams: bool = False,
    radar_values: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    pad_front: int = 0,
    pad_tail: int = 0,
) -> TxFrame:
    """encode → precode and assemble → IFFT + CP → zero pad."""
    syms = encoder.encode_frame(spec, tab, payload, scrambler_seed)
    grid = precoder.assemble_frame(
        cfg, spec, tab, syms, steering=steering, mean_steering=mean_steering,
        use_radar_streams=use_radar_streams, radar_values=radar_values, generator=generator)
    t = ofdm.ofdm_modulate(cfg, grid.transpose(0, 1))  # (n_tx, n_samples)
    if pad_front or pad_tail:
        t = ofdm.zero_pad(t, pad_front, pad_tail)
    return TxFrame(samples=t, grid=grid)


class RxResult(NamedTuple):
    decoded: decoder.DecodedFrame
    eq: equalizer.EqualizedFrame
    detection: sync.Detections
    total_cfo: torch.Tensor
    sync_found: torch.Tensor


def rx_chain(
    cfg: OFDMConfig,
    spec: encoder.FrameSpec,
    tab: Tables,
    samples: torch.Tensor,  # complex (n,) stream holding at least one frame
    *,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
) -> RxResult:
    """The RX chain on one burst; the frame geometry is ``spec``'s (the SIG
    field is decoded and returned for verification). For the one burst
    that ``jrc_step`` receives each dwell, this route launches about 25
    fewer device kernels than ``rx_chain_batch`` with one row (no block
    bookkeeping around the detection); ``rx_chain_batch`` is the route for
    many bursts."""
    n_frame_sym = 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym  # from the first LTF copy
    det = sync.detect_frames(cfg, samples, threshold=threshold, min_n_peaks=min_n_peaks,
                             max_frames=1)
    trigger = torch.clamp_min(det.start[0], 0)
    symbols_t, total_cfo, found = sync.extract_frame(cfg, samples, trigger, det.coarse_cfo[0],
                                                     n_frame_sym)
    grid = ofdm.fft_symbols(cfg, symbols_t)
    eq = equalizer.equalize_frame(cfg, spec, tab, grid[None], total_cfo[None], estimator=estimator)
    eq = equalizer.EqualizedFrame(*(f[0] for f in eq))
    dec = decoder.decode_frame(spec, tab, eq.z, soft=soft)
    return RxResult(decoded=dec, eq=eq, detection=det, total_cfo=total_cfo, sync_found=found)


def rx_chain_batch(
    cfg: OFDMConfig,
    spec: encoder.FrameSpec,
    tab: Tables,
    bursts: torch.Tensor,  # complex (B, n) guarded bursts, one frame each
    *,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
) -> RxResult:
    """``rx_chain`` on each of B bursts in one pass: the bursts are laid end
    to end, each followed by zeros that every frame window read from it
    stays inside, and the stream goes once through the detection front end
    (K2, one launch, with the suppression of each burst's own triggers),
    once through the extraction (two K3 launches), the equalizer and the
    decoder (one K1 launch for the payloads) with B rows. Fields carry a
    leading B axis; ``detection.start`` is burst-relative, as ``rx_chain``
    reports it, and equals it in every field."""
    b, n = bursts.shape
    n_frame_sym = 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym
    sync_length = cfg.n_sync_words * cfg.sym_len
    need_sym = 2 * cfg.fft_len + (n_frame_sym - 2) * cfg.sym_len
    # a window starts at most at the last sample plus the LTF offset (< sync_length)
    block = -(-(n + sync_length + need_sym) // sync.SEG) * sync.SEG
    flat = torch.nn.functional.pad(bursts, (0, block - n)).reshape(-1)
    det = sync.detect_frames_stream(cfg, flat, block, b, 0, threshold=threshold,
                                    min_n_peaks=min_n_peaks, max_frames=1)
    offset = torch.arange(b, device=bursts.device)[:, None] * block
    start = torch.where(det.valid, det.start - offset, -1)
    det = det._replace(start=start)
    trigger = offset[:, 0] + torch.clamp_min(start[:, 0], 0)
    symbols_t, total_cfo, found = sync.extract_frames_batch(cfg, flat, trigger,
                                                            det.coarse_cfo[:, 0], n_frame_sym)
    grid = ofdm.fft_symbols(cfg, symbols_t)
    eq = equalizer.equalize_frame(cfg, spec, tab, grid, total_cfo, estimator=estimator)
    dec = decoder.decode_frame(spec, tab, eq.z, soft=soft)
    return RxResult(decoded=dec, eq=eq, detection=det, total_cfo=total_cfo, sync_found=found)


def guard(cfg: OFDMConfig, rx: torch.Tensor) -> torch.Tensor:
    """The burst with 2·n_sync·sym_len zeros behind it, so the frame
    windows of ``extract_frame`` never clamp at the tail."""
    return torch.nn.functional.pad(rx, (0, 2 * cfg.n_sync_words * cfg.sym_len))


#: loopback's padding: 5 symbols in front, 6 symbols and 10 samples behind the frame
LOOPBACK_PAD = (5, 6, 10)


def loopback_samples(cfg: OFDMConfig, spec: encoder.FrameSpec) -> int:
    """Length of loopback's padded frame, the length of its ``noise``."""
    n_sym = cfg.n_sync_words + 1 + cfg.n_ltf + spec.n_ofdm_sym + LOOPBACK_PAD[0] + LOOPBACK_PAD[1]
    return n_sym * cfg.sym_len + LOOPBACK_PAD[2]


def loopback(
    cfg: OFDMConfig,
    spec: encoder.FrameSpec,
    tab: Tables,
    payload: torch.Tensor,
    *,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    angle_deg: float = 0.0,
    path_loss: float = 10.0,
    snr_db: float | None = 30.0,
    cfo: float = 0.0,
    scrambler_seed: int = 1,
    mean_steering: torch.Tensor | None = None,
    estimator: str = "ls",
    soft: bool = False,
) -> RxResult:
    """TX → comm channel → RX in one call. ``snr_db`` sets the AWGN against
    the received mean signal power (None: noiseless), from ``noise``
    (standard normal pairs of the padded frame's length) or ``generator``."""
    tx = tx_frame(cfg, spec, tab, payload, scrambler_seed, mean_steering=mean_steering,
                  pad_front=LOOPBACK_PAD[0] * cfg.sym_len,
                  pad_tail=LOOPBACK_PAD[1] * cfg.sym_len + LOOPBACK_PAD[2])
    rx = channel.comm_channel(tx.samples, angle_deg=angle_deg, path_loss=path_loss, cfo=cfo)
    if snr_db is not None:
        sig_pow = equalizer.abs2(rx).mean()
        rx = channel.awgn(rx, sig_pow / (10.0 ** (snr_db / 10.0)), noise=noise,
                          generator=generator)
    return rx_chain(cfg, spec, tab, guard(cfg, rx), estimator=estimator, soft=soft)
