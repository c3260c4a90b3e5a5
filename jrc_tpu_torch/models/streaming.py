"""Batched block RX over a long capture: the static-spec main path (port of
jrc_tpu/models/streaming.py:34-60,174-282).

``scan_rx`` cuts the capture into ``n_blocks`` ownership windows and runs
``flat_rx`` once over the flat stream: detection (K2), frame extraction
with LTF sync (K3 twice), FFT, equalization with SIG decode (K1), hard
demapping, ONE Viterbi pass over every frame (K1), descrambling and CRC.
``StreamingRx`` wraps it as an ``nn.Module`` holding the constant tables
as buffers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from jrc_tpu.config import OFDMConfig
from jrc_tpu_torch import tables
from jrc_tpu_torch.ops import decoder, equalizer, ofdm, sync, viterbi_cuda
from jrc_tpu_torch.ops.encoder import FrameSpec


class BlockRxResult(NamedTuple):
    payload: torch.Tensor  # (n_frames_max, payload_bytes) uint8
    crc_ok: torch.Tensor  # (n_frames_max,) bool
    sig_ok: torch.Tensor  # (n_frames_max,) bool
    snr_db: torch.Tensor  # (n_frames_max,) float32
    start: torch.Tensor  # (n_frames_max,) trigger index in the capture (-1 invalid)
    valid: torch.Tensor  # (n_frames_max,) frame slot used


def frame_window_samples(cfg: OFDMConfig, spec: FrameSpec) -> int:
    """Samples needed from a trigger to process one frame."""
    n_sym = 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym
    sync_length = cfg.n_sync_words * cfg.sym_len
    return sync_length + 2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len + cfg.fft_len


def left_history_samples(cfg: OFDMConfig) -> int:
    """Left history a block needs so a plateau that begins in the previous
    block keeps its true trigger: the whole trigger-chain lookback, rounded
    up to the detector's segment size (384 samples at fft_len=64)."""
    mpd = 2 * cfg.sym_len
    lag = cfg.fft_len // 4
    win = cfg.fft_len // 2
    pwin = int(1.5 * win)
    need = 2 * (mpd - 1) + max(win + lag, pwin) - 1
    return -(-need // sync.SEG) * sync.SEG


def flat_rx(
    cfg: OFDMConfig,
    spec: FrameSpec,
    tab: tables.Tables,
    xp: torch.Tensor,  # flat complex [left-history | n_blocks·block_len | halo] stream
    block_len: int,
    n_blocks: int,
    own_lo: int,
    *,
    max_frames: int = 8,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
) -> BlockRxResult:
    """One flat pass over a pre-assembled stream; ``start`` is reported
    relative to ``own_lo`` and results are (n_blocks·max_frames,)-flat."""
    det = sync.detect_frames_stream(
        cfg, xp, block_len, n_blocks, own_lo,
        threshold=threshold, min_n_peaks=min_n_peaks, max_frames=max_frames,
    )
    owned = det.valid.reshape(-1)
    trig = torch.where(det.valid, det.start, 0).reshape(-1)
    n_sym = 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym
    syms, total_cfo, found = sync.extract_frames_batch(
        cfg, xp, trig, det.coarse_cfo.reshape(-1), n_sym)
    eq = equalizer.equalize_frame(cfg, spec, tab, ofdm.fft_symbols(cfg, syms), total_cfo)
    values = decoder.frame_values(spec, tab, eq.z)
    bits = viterbi_cuda.viterbi_decode(values, tab.trellis, n_out=spec.packet_params.n_data_bits)
    dec = decoder.frame_from_bits(spec, tab, bits)
    return BlockRxResult(
        payload=dec.payload,
        crc_ok=dec.crc_ok & found & owned,
        sig_ok=eq.sig_ok & owned,
        snr_db=eq.snr_legacy,
        start=torch.where(det.valid, det.start - own_lo, -1).reshape(-1),
        valid=owned,
    )


def scan_rx(
    cfg: OFDMConfig,
    spec: FrameSpec,
    tab: tables.Tables,
    x: torch.Tensor,  # complex (n_blocks·block_len + halo,) samples
    block_len: int,
    n_blocks: int,
    *,
    max_frames_per_block: int = 8,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
    batched: bool = True,
) -> BlockRxResult:
    """Decode every frame of ``n_blocks`` fixed-size blocks of ``x`` (the
    flat batched path of the reference's scan_rx). ``tab`` must lie on the
    device of ``x``."""
    if not batched or block_len % sync.SEG:
        raise NotImplementedError(
            "only the batched scan_rx with block_len a multiple of "
            f"{sync.SEG} is ported (batched={batched}, block_len={block_len})")
    if estimator != "ls" or soft:
        raise NotImplementedError("only estimator='ls' with hard decisions is ported")
    halo = frame_window_samples(cfg, spec) + cfg.fft_len
    left_hist = left_history_samples(cfg)
    if x.shape[-1] < n_blocks * block_len + halo:
        raise ValueError(f"capture of {x.shape[-1]} samples < {n_blocks}·{block_len} + halo {halo}")
    x = x.to(torch.complex64)
    xp = torch.cat([torch.zeros(left_hist, dtype=x.dtype, device=x.device), x])
    return flat_rx(
        cfg, spec, tab, xp, block_len, n_blocks, left_hist,
        max_frames=max_frames_per_block, threshold=threshold, min_n_peaks=min_n_peaks,
    )


class StreamingRx(nn.Module):
    """The static-spec RX chain as a module: ``forward(x)`` runs ``scan_rx``
    on a complex capture lying on the module's device."""

    def __init__(self, cfg: OFDMConfig, spec: FrameSpec, block_len: int, n_blocks: int, *,
                 max_frames_per_block: int = 8, threshold: float = 0.6, min_n_peaks: int = 10):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        self.block_len, self.n_blocks = block_len, n_blocks
        self.max_frames_per_block = max_frames_per_block
        self.threshold, self.min_n_peaks = threshold, min_n_peaks
        for name, t in tables.from_numpy(cfg, spec, "cpu")._asdict().items():
            self.register_buffer(name, t)

    def constants(self) -> tables.Tables:
        return tables.Tables(**{f: getattr(self, f) for f in tables.Tables._fields})

    def forward(self, x: torch.Tensor) -> BlockRxResult:
        return scan_rx(
            self.cfg, self.spec, self.constants(), x, self.block_len, self.n_blocks,
            max_frames_per_block=self.max_frames_per_block, threshold=self.threshold,
            min_n_peaks=self.min_n_peaks,
        )
