"""Batched block RX over a long capture (port of
jrc_tpu/models/streaming.py:34-60,174-282,332-504).

``scan_rx`` (the static-spec path) cuts the capture into ``n_blocks``
ownership windows and runs ``flat_rx`` once over the flat stream:
detection (K2), frame extraction with LTF sync (K3 twice), FFT,
equalization with SIG decode (K1), demapping (hard decisions, or LLRs with
``soft=True``), ONE Viterbi pass over every frame (K1), descrambling and
CRC; ``estimator="sta"`` adds decision-directed channel tracking. The flat
functions take the stream as complex64 or, with ``dq``, as the int16 pairs
of the sc16 wire, which K2 and K3 dequantize in their loads. ``scan_rx_dynamic`` /
``flat_rx_dynamic`` are the SIG-driven analog for mixed traffic: every
frame is extracted over the ``max_payload`` envelope and decoded with the
MCS, length and packet type its SIG field gives, NDP frames return their
MIMO channel estimate. ``StreamingRx`` and ``StreamingRxDynamic`` wrap
them as ``nn.Module``s holding the constant tables as buffers. The modules
live on the CUDA device unless the caller names another; the plain
functions on tensors follow the device of their input.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch import tables
from jrc_tpu_torch.ops import decoder, dynamic_rx, equalizer, ofdm, sync, viterbi_cuda
from jrc_tpu_torch.ops.encoder import FrameSpec


def _entry_device(device) -> torch.device:
    """The device an entry point's tables are built on: the CUDA device when
    ``device`` is None (no fallback to the CPU: without a CUDA device that
    raises), else the device the caller named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the RX entry points run on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _check_input_device(module: nn.Module, x: torch.Tensor) -> None:
    want = module.data_idx.device
    if x.device != want:
        raise RuntimeError(f"{type(module).__name__} lies on {want} but its input on {x.device}; "
                           "move the capture to the module's device")


class BlockRxResult(NamedTuple):
    payload: torch.Tensor  # (n_frames_max, payload_bytes) uint8
    crc_ok: torch.Tensor  # (n_frames_max,) bool
    sig_ok: torch.Tensor  # (n_frames_max,) bool
    snr_db: torch.Tensor  # (n_frames_max,) float32
    start: torch.Tensor  # (n_frames_max,) trigger index in the capture (-1 invalid)
    valid: torch.Tensor  # (n_frames_max,) frame slot used


def _frame_window(cfg: OFDMConfig, n_data_sym: int) -> int:
    n_sym = 2 + 1 + cfg.n_ltf + n_data_sym
    sync_length = cfg.n_sync_words * cfg.sym_len
    return sync_length + 2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len + cfg.fft_len


def frame_window_samples(cfg: OFDMConfig, spec: FrameSpec) -> int:
    """Samples needed from a trigger to process one frame."""
    return _frame_window(cfg, spec.n_ofdm_sym)


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


def _padded_stream(cfg: OFDMConfig, x: torch.Tensor, block_len: int, n_blocks: int, halo: int,
                   *, batched: bool):
    """Reject what is not ported, then prepend the zero left history →
    (flat complex64 stream, own_lo)."""
    if not batched or block_len % sync.SEG:
        raise NotImplementedError(
            f"only the batched path with block_len a multiple of {sync.SEG} is ported; the "
            f"per-block rx_block / rx_block_dynamic is not (batched={batched}, "
            f"block_len={block_len})")
    if x.shape[-1] < n_blocks * block_len + halo:
        raise ValueError(f"capture of {x.shape[-1]} samples < {n_blocks}·{block_len} + halo {halo}")
    left_hist = left_history_samples(cfg)
    x = x.to(torch.complex64)
    return torch.cat([torch.zeros(left_hist, dtype=x.dtype, device=x.device), x]), left_hist


def flat_rx(
    cfg: OFDMConfig,
    spec: FrameSpec,
    tab: tables.Tables,
    xp: torch.Tensor,  # flat [left-history | n_blocks·block_len | halo] stream
    block_len: int,
    n_blocks: int,
    own_lo: int,
    *,
    max_frames: int = 8,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
    dq: float | None = None,
) -> BlockRxResult:
    """One flat pass over a pre-assembled stream, complex64 (n,) or int16
    (n, 2) with its scale ``dq``; ``start`` is reported relative to
    ``own_lo`` and results are (n_blocks·max_frames,)-flat."""
    det = sync.detect_frames_stream(
        cfg, xp, block_len, n_blocks, own_lo,
        threshold=threshold, min_n_peaks=min_n_peaks, max_frames=max_frames, dq=dq,
    )
    owned = det.valid.reshape(-1)
    trig = torch.where(det.valid, det.start, 0).reshape(-1)
    n_sym = 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym
    syms, total_cfo, found = sync.extract_frames_batch(
        cfg, xp, trig, det.coarse_cfo.reshape(-1), n_sym, dq=dq)
    eq = equalizer.equalize_frame(cfg, spec, tab, ofdm.fft_symbols(cfg, syms), total_cfo,
                                  estimator=estimator)
    values = decoder.frame_values(spec, tab, eq.z, soft=soft)
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
    halo = frame_window_samples(cfg, spec) + cfg.fft_len
    xp, left_hist = _padded_stream(cfg, x, block_len, n_blocks, halo, batched=batched)
    return flat_rx(
        cfg, spec, tab, xp, block_len, n_blocks, left_hist,
        max_frames=max_frames_per_block, threshold=threshold, min_n_peaks=min_n_peaks,
        estimator=estimator, soft=soft,
    )


class StreamingRx(nn.Module):
    """The static-spec RX chain as a module: ``forward(x)`` runs ``scan_rx``
    on a complex capture lying on the module's device: the CUDA device
    unless ``device`` names another (``device="cpu"`` runs the kernels'
    plain versions)."""

    def __init__(self, cfg: OFDMConfig, spec: FrameSpec, block_len: int, n_blocks: int, *,
                 max_frames_per_block: int = 8, threshold: float = 0.6, min_n_peaks: int = 10,
                 estimator: str = "ls", soft: bool = False, device=None):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        self.block_len, self.n_blocks = block_len, n_blocks
        self.max_frames_per_block = max_frames_per_block
        self.threshold, self.min_n_peaks = threshold, min_n_peaks
        self.estimator, self.soft = estimator, soft
        for name, t in tables.from_numpy(cfg, spec, _entry_device(device))._asdict().items():
            self.register_buffer(name, t)

    def constants(self) -> tables.Tables:
        return tables.Tables(**{f: getattr(self, f) for f in tables.Tables._fields})

    def forward(self, x: torch.Tensor) -> BlockRxResult:
        _check_input_device(self, x)
        return scan_rx(
            self.cfg, self.spec, self.constants(), x, self.block_len, self.n_blocks,
            max_frames_per_block=self.max_frames_per_block, threshold=self.threshold,
            min_n_peaks=self.min_n_peaks, estimator=self.estimator, soft=self.soft,
        )


# ---------------------------------------------------------------------------
# SIG-driven dynamic path: MCS / length / packet type learned per frame from
# the SIG field; one pass covers the whole MCS × length envelope.
# ---------------------------------------------------------------------------


class DynBlockRxResult(NamedTuple):
    payload: torch.Tensor  # (n_frames_max, max_payload) uint8
    payload_len: torch.Tensor  # (n_frames_max,) bytes without CRC (0 if invalid)
    crc_ok: torch.Tensor  # (n_frames_max,) bool
    sig_ok: torch.Tensor  # (n_frames_max,) bool
    mcs: torch.Tensor  # (n_frames_max,) int64 MCS index from SIG
    packet_type_bit: torch.Tensor  # (n_frames_max,) 0 = NDP, 1 = DATA
    snr_db: torch.Tensor  # (n_frames_max,) legacy-LTF estimate
    snr_data_db: torch.Tensor  # (n_frames_max,) pilot-tracked payload SNR
    start: torch.Tensor  # (n_frames_max,) trigger index in the capture (-1 invalid)
    valid: torch.Tensor  # (n_frames_max,) frame slot used
    chan_est: torch.Tensor  # (n_frames_max, fft_len, n_tx) complex64 NDP estimate
    chan_est_ok: torch.Tensor  # (n_frames_max,) NDP + valid SIG → chan_est is live


def frame_window_samples_dynamic(cfg: OFDMConfig, max_payload: int) -> int:
    """Samples needed from a trigger for the worst-case dynamic frame
    (BPSK-1/2 at max_payload)."""
    return _frame_window(cfg, dynamic_rx.max_symbols(max_payload, cfg.n_data_carriers))


def flat_rx_dynamic(
    cfg: OFDMConfig,
    tab: tables.DynTables,
    xp: torch.Tensor,  # flat [left-history | n_blocks·block_len | halo] stream
    block_len: int,
    n_blocks: int,
    own_lo: int,
    *,
    max_frames: int = 8,
    max_payload: int = 256,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
    dq: float | None = None,
) -> DynBlockRxResult:
    """SIG-driven analog of :func:`flat_rx`: one detection pass (K2), one
    gathered extraction batch (K3) over the max envelope, and ONE
    shared-envelope Viterbi call (K1) over every frame."""
    det = sync.detect_frames_stream(
        cfg, xp, block_len, n_blocks, own_lo,
        threshold=threshold, min_n_peaks=min_n_peaks, max_frames=max_frames, dq=dq,
    )
    owned = det.valid.reshape(-1)
    trig = torch.where(det.valid, det.start, 0).reshape(-1)
    n_sym = 2 + 1 + cfg.n_ltf + dynamic_rx.max_symbols(max_payload, cfg.n_data_carriers)
    syms, total_cfo, _found = sync.extract_frames_batch(
        cfg, xp, trig, det.coarse_cfo.reshape(-1), n_sym, dq=dq)
    pre = dynamic_rx.rx_frame_dynamic_values_from_syms(
        cfg, tab, syms, total_cfo, max_payload=max_payload, estimator=estimator, soft=soft)
    bits = viterbi_cuda.viterbi_decode(pre.values, tab.trellis, n_out=16 + 8 * (max_payload + 4))
    fr = dynamic_rx.rx_frame_dynamic_finish(tab, pre, bits, max_payload)
    return DynBlockRxResult(
        payload=fr.payload,
        payload_len=torch.where(owned, fr.payload_len, 0),
        crc_ok=fr.crc_ok & owned,
        sig_ok=fr.sig_ok & owned,
        mcs=fr.mcs,
        packet_type_bit=fr.packet_type_bit,
        snr_db=fr.snr_db,
        snr_data_db=fr.snr_data_db,
        start=torch.where(det.valid, det.start - own_lo, -1).reshape(-1),
        valid=owned,
        chan_est=fr.chan_est,
        chan_est_ok=fr.chan_est_ok & owned,
    )


def scan_rx_dynamic(
    cfg: OFDMConfig,
    tab: tables.DynTables,
    x: torch.Tensor,  # complex (n_blocks·block_len + halo,) samples
    block_len: int,
    n_blocks: int,
    *,
    max_frames_per_block: int = 8,
    max_payload: int = 256,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
    batched: bool = True,
) -> DynBlockRxResult:
    """Decode every frame of ``n_blocks`` fixed-size blocks of ``x`` with
    SIG-discovered MCS/length/type (the flat batched path of the
    reference's scan_rx_dynamic). ``tab`` is ``tables.from_numpy_dynamic``
    for the same ``max_payload``, on the device of ``x``."""
    halo = frame_window_samples_dynamic(cfg, max_payload) + cfg.fft_len
    xp, left_hist = _padded_stream(cfg, x, block_len, n_blocks, halo, batched=batched)
    return flat_rx_dynamic(
        cfg, tab, xp, block_len, n_blocks, left_hist,
        max_frames=max_frames_per_block, max_payload=max_payload,
        threshold=threshold, min_n_peaks=min_n_peaks, estimator=estimator, soft=soft,
    )


class StreamingRxDynamic(nn.Module):
    """The SIG-driven RX chain as a module: ``forward(x)`` runs
    ``scan_rx_dynamic`` on a complex capture lying on the module's device:
    the CUDA device unless ``device`` names another."""

    def __init__(self, cfg: OFDMConfig, block_len: int, n_blocks: int, *,
                 max_frames_per_block: int = 8, max_payload: int = 256,
                 threshold: float = 0.6, min_n_peaks: int = 10, estimator: str = "ls",
                 soft: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        self.block_len, self.n_blocks = block_len, n_blocks
        self.max_frames_per_block, self.max_payload = max_frames_per_block, max_payload
        self.threshold, self.min_n_peaks = threshold, min_n_peaks
        self.estimator, self.soft = estimator, soft
        tab = tables.from_numpy_dynamic(cfg, max_payload, _entry_device(device))
        for name, t in tab._asdict().items():
            self.register_buffer(name, t)

    def constants(self) -> tables.DynTables:
        return tables.DynTables(**{f: getattr(self, f) for f in tables.DynTables._fields})

    def forward(self, x: torch.Tensor) -> DynBlockRxResult:
        _check_input_device(self, x)
        return scan_rx_dynamic(
            self.cfg, self.constants(), x, self.block_len, self.n_blocks,
            max_frames_per_block=self.max_frames_per_block, max_payload=self.max_payload,
            threshold=self.threshold, min_n_peaks=self.min_n_peaks,
            estimator=self.estimator, soft=self.soft,
        )
