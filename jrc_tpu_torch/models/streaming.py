"""Block RX over a long capture (port of jrc_tpu/models/streaming.py).

``scan_rx`` (the static-spec path) cuts the capture into ``n_blocks``
ownership windows. With ``block_len`` a multiple of ``sync.SEG`` it runs
``flat_rx`` once over the flat stream: detection (K2), frame extraction
with LTF sync (K3 twice), FFT, equalization with SIG decode (K1),
demapping (hard decisions, or LLRs with ``soft=True``), ONE Viterbi pass
over every frame (K1), descrambling and CRC; ``estimator="sta"`` adds
decision-directed channel tracking. Any other ``block_len`` takes the
windowed route (each window detected on its own, every slot decoded in
one batch), and ``batched=False`` the sequential one (``rx_block``, the
per-block body, once a block). The flat
functions take the stream as complex64 or, with ``dq``, as the int16 pairs
of the sc16 wire, which K2 and K3 dequantize in their loads. ``scan_rx_dynamic`` /
``flat_rx_dynamic`` are the SIG-driven analog for mixed traffic: every
frame is extracted over the ``max_payload`` envelope and decoded with the
MCS, length and packet type its SIG field gives, NDP frames return their
MIMO channel estimate. ``StreamingRx`` and ``StreamingRxDynamic`` wrap
them as ``nn.Module``s holding the constant tables as buffers. The modules
live on the CUDA device unless the caller names another; the plain
functions on tensors follow the device of their input.

Every route stamps the stage clock of ``utils.profiling`` (entry ``"rx"``)
at its layer boundaries, once a pass: ``start``, ``detect`` (K2, the
suppression and the sorts), ``extract`` (K3 twice, the LTF sync),
``equalize`` (FFT, equalizer, SIG with its K1 call), ``demap`` (the MCS
branches, depuncture), ``viterbi`` (the payload's K1) and ``finish``
(descramble, CRC, the result). A stamp is one single-thread kernel on a
card, so a captured call holds its stamps and each replay times its stages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch import tables
from jrc_tpu_torch.ops import decoder, dynamic_rx, equalizer, ofdm, sync, viterbi_cuda
from jrc_tpu_torch.ops.encoder import FrameSpec
from jrc_tpu_torch.utils.profiling import stamp


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


def _padded_stream(cfg: OFDMConfig, x: torch.Tensor, block_len: int, n_blocks: int, halo: int):
    """Check the capture's length, then prepend the zero left history →
    (flat complex64 stream, own_lo)."""
    if x.shape[-1] < n_blocks * block_len + halo:
        raise ValueError(f"capture of {x.shape[-1]} samples < {n_blocks}·{block_len} + halo {halo}")
    left_hist = left_history_samples(cfg)
    x = x.to(torch.complex64)
    return torch.cat([torch.zeros(left_hist, dtype=x.dtype, device=x.device), x]), left_hist


class _Slots(NamedTuple):
    """The frame slots of a batch of blocks, ready to decode from one flat
    stream (reference: what ``_rx_block_prelude`` and ``flat_rx`` pass on)."""

    trig: torch.Tensor  # (n_slots,) trigger in the flat stream (a free slot: its window's start)
    cfo: torch.Tensor  # (n_slots,) coarse CFO
    owned: torch.Tensor  # (n_slots,) frame slot used
    start: torch.Tensor  # (n_slots,) trigger less own_lo in its window (-1 for a free slot)


def _window_slots(cfg: OFDMConfig, xp: torch.Tensor, block_len: int, n_windows: int, window: int,
                  step: int, own_lo: int, *, max_frames: int, threshold: float,
                  min_n_peaks: int) -> _Slots:
    """Detect each window ``xp[b·step : b·step + window]`` on its own (one K2
    a window, no history before it: the reference's per-window
    ``detect_frames`` with ``own_window=(own_lo, block_len)``), keep the
    owned triggers and place every slot in ``xp``: an owned frame fits inside
    its window (the halo is a frame window + fft_len), so reading it from
    ``xp`` reads what the window holds; a free slot starts at its window's
    start, as the reference's does."""
    xw = xp.unfold(0, window, step)[:n_windows]
    det = sync.detect_frames(cfg, xw, threshold=threshold, min_n_peaks=min_n_peaks,
                             max_frames=max_frames, own_window=(own_lo, block_len))
    owned = det.valid & (det.start >= own_lo) & (det.start < own_lo + block_len)
    base = step * torch.arange(n_windows, device=xp.device)[:, None]
    trig = base + torch.where(owned, det.start, 0)
    return _Slots(trig=trig.reshape(-1), cfo=det.coarse_cfo.reshape(-1), owned=owned.reshape(-1),
                  start=torch.where(owned, det.start - own_lo, -1).reshape(-1))


def _stream_slots(det: sync.Detections, own_lo: int) -> _Slots:
    """The slots of ``detect_frames_stream`` (triggers already in the flat
    stream; a free slot starts at 0, as in the reference's flat_rx)."""
    return _Slots(trig=torch.where(det.valid, det.start, 0).reshape(-1),
                  cfo=det.coarse_cfo.reshape(-1), owned=det.valid.reshape(-1),
                  start=torch.where(det.valid, det.start - own_lo, -1).reshape(-1))


def _decode_slots(cfg: OFDMConfig, spec: FrameSpec, tab: tables.Tables, xp: torch.Tensor,
                  slots: _Slots, *, estimator: str, soft: bool,
                  dq: float | None = None) -> BlockRxResult:
    """Extraction of every slot (K3 twice), FFT, equalization with SIG
    decode, demapping and ONE Viterbi pass (K1) over all of them."""
    n_sym = 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym
    syms, total_cfo, found = sync.extract_frames_batch(cfg, xp, slots.trig, slots.cfo, n_sym,
                                                       dq=dq)
    stamp("rx", "extract", xp)
    eq = equalizer.equalize_frame(cfg, spec, tab, ofdm.fft_symbols(cfg, syms), total_cfo,
                                  estimator=estimator)
    stamp("rx", "equalize", xp)
    values = decoder.frame_values(spec, tab, eq.z, soft=soft)
    stamp("rx", "demap", xp)
    bits = viterbi_cuda.viterbi_decode(values, tab.trellis, n_out=spec.packet_params.n_data_bits)
    stamp("rx", "viterbi", xp)
    dec = decoder.frame_from_bits(spec, tab, bits)
    res = BlockRxResult(
        payload=dec.payload,
        crc_ok=dec.crc_ok & found & slots.owned,
        sig_ok=eq.sig_ok & slots.owned,
        snr_db=eq.snr_legacy,
        start=slots.start,
        valid=slots.owned,
    )
    stamp("rx", "finish", xp)
    return res


def _shifted(res, shift):
    """``res`` with every valid start moved by ``shift`` samples (an int, or
    one a slot)."""
    return res._replace(start=torch.where(res.valid, res.start + shift, -1))


def _block_shifts(block_len: int, n_blocks: int, max_frames: int, device) -> torch.Tensor:
    """b·block_len for each slot of block b: a window's starts → the capture's."""
    return (block_len * torch.arange(n_blocks, device=device)).repeat_interleave(max_frames)


def _cat(results):
    """Per-block results → one result, the slot axis flattened."""
    return type(results[0])(*(torch.cat(f) for f in zip(*results)))


def _per_window(res, n_windows: int):
    """Flat slot fields → (n_windows, max_frames, ...)."""
    return type(res)(*(f.reshape(n_windows, -1, *f.shape[1:]) for f in res))


def _as_windows(x: torch.Tensor):
    """One window (n,) or independent windows (n_windows, n) → (flat complex64
    stream, n_windows, n)."""
    x = x.to(torch.complex64)
    n_windows = 1 if x.dim() == 1 else x.shape[0]
    return x.reshape(-1), n_windows, x.shape[-1]


def rx_block(
    cfg: OFDMConfig,
    spec: FrameSpec,
    tab: tables.Tables,
    x: torch.Tensor,  # complex (left_hist + block_len + halo,), or (n_windows, that)
    block_len: int,
    *,
    own_lo: int = 0,  # ownership window [own_lo, own_lo + block_len)
    max_frames: int = 8,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
) -> BlockRxResult:
    """Detect and decode every frame whose trigger lies in the ownership
    window of one block: K2 once, then the block's slots through K3 twice
    and one K1; ``start`` is reported relative to ``own_lo``. A batch of
    independent windows (n_windows, n) is the reference's vmap over
    rx_block: K2 once a window, the slots of all windows decoded as one
    batch, every field (n_windows, max_frames, ...)."""
    flat, n_windows, n = _as_windows(x)
    stamp("rx", "start", flat)
    slots = _window_slots(cfg, flat, block_len, n_windows, n, n, own_lo, max_frames=max_frames,
                          threshold=threshold, min_n_peaks=min_n_peaks)
    stamp("rx", "detect", flat)
    res = _decode_slots(cfg, spec, tab, flat, slots, estimator=estimator, soft=soft)
    return res if x.dim() == 1 else _per_window(res, n_windows)


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
    stamp("rx", "start", xp)
    det = sync.detect_frames_stream(
        cfg, xp, block_len, n_blocks, own_lo,
        threshold=threshold, min_n_peaks=min_n_peaks, max_frames=max_frames, dq=dq, entry="rx",
    )
    slots = _stream_slots(det, own_lo)
    stamp("rx", "detect", xp)
    return _decode_slots(cfg, spec, tab, xp, slots, estimator=estimator, soft=soft, dq=dq)


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
    """Decode every frame of ``n_blocks`` fixed-size blocks of ``x``; ``tab``
    must lie on the device of ``x``. Batched with ``block_len`` a multiple
    of ``sync.SEG``: ``flat_rx`` over the flat stream. Batched otherwise
    (windowed): each block window ``[left history | block | halo]`` detected
    on its own (one K2 a block), then every slot of every block decoded as
    one batch (K3 twice, one K1). ``batched=False``: ``rx_block`` on one
    window after the other, so device memory does not grow with
    ``n_blocks``. ``start`` is in capture coordinates (-1 for a free slot)
    and the slot axis is flat, (n_blocks·max_frames_per_block,)."""
    halo = frame_window_samples(cfg, spec) + cfg.fft_len
    xp, left_hist = _padded_stream(cfg, x, block_len, n_blocks, halo)
    kw = dict(threshold=threshold, min_n_peaks=min_n_peaks)
    if batched and block_len % sync.SEG == 0:
        return flat_rx(cfg, spec, tab, xp, block_len, n_blocks, left_hist,
                       max_frames=max_frames_per_block, estimator=estimator, soft=soft, **kw)
    window = left_hist + block_len + halo
    if batched:
        stamp("rx", "start", xp)
        slots = _window_slots(cfg, xp, block_len, n_blocks, window, block_len, left_hist,
                              max_frames=max_frames_per_block, **kw)
        stamp("rx", "detect", xp)
        res = _decode_slots(cfg, spec, tab, xp, slots, estimator=estimator, soft=soft)
        return _shifted(res, _block_shifts(block_len, n_blocks, max_frames_per_block, xp.device))
    return _cat([_shifted(rx_block(cfg, spec, tab, xp[b * block_len : b * block_len + window],
                                   block_len, own_lo=left_hist, max_frames=max_frames_per_block,
                                   estimator=estimator, soft=soft, **kw), b * block_len)
                 for b in range(n_blocks)])


class StreamingRx(nn.Module):
    """The static-spec RX chain as a module: ``forward(x)`` runs ``scan_rx``
    on a complex capture lying on the module's device: the CUDA device
    unless ``device`` names another (``device="cpu"`` runs the kernels'
    plain versions)."""

    def __init__(self, cfg: OFDMConfig, spec: FrameSpec, block_len: int, n_blocks: int, *,
                 max_frames_per_block: int = 8, threshold: float = 0.6, min_n_peaks: int = 10,
                 estimator: str = "ls", soft: bool = False, batched: bool = True, device=None):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        self.block_len, self.n_blocks = block_len, n_blocks
        self.max_frames_per_block = max_frames_per_block
        self.threshold, self.min_n_peaks = threshold, min_n_peaks
        self.estimator, self.soft, self.batched = estimator, soft, batched
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
            batched=self.batched,
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


def _decode_slots_dynamic(cfg: OFDMConfig, tab: tables.DynTables, xp: torch.Tensor,
                          slots: _Slots, *, max_payload: int, estimator: str, soft: bool,
                          dq: float | None = None) -> DynBlockRxResult:
    """Every slot through ``dynamic_rx.rx_frame_dynamic`` (K3 twice over the
    max envelope, ONE K1 whose rows each run to their own SIG extent), masked
    by ownership."""
    fr = dynamic_rx.rx_frame_dynamic(cfg, tab, xp, slots.trig, slots.cfo,
                                     max_payload=max_payload, estimator=estimator, soft=soft,
                                     dq=dq, entry="rx")
    owned = slots.owned
    res = DynBlockRxResult(
        payload=fr.payload,
        payload_len=torch.where(owned, fr.payload_len, 0),
        crc_ok=fr.crc_ok & owned,
        sig_ok=fr.sig_ok & owned,
        mcs=fr.mcs,
        packet_type_bit=fr.packet_type_bit,
        snr_db=fr.snr_db,
        snr_data_db=fr.snr_data_db,
        start=slots.start,
        valid=owned,
        chan_est=fr.chan_est,
        chan_est_ok=fr.chan_est_ok & owned,
    )
    stamp("rx", "finish", xp)
    return res


def rx_block_dynamic(
    cfg: OFDMConfig,
    tab: tables.DynTables,
    x: torch.Tensor,  # complex (left_hist + block_len + halo,), or (n_windows, that)
    block_len: int,
    *,
    own_lo: int = 0,
    max_frames: int = 8,
    max_payload: int = 256,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    estimator: str = "ls",
    soft: bool = False,
) -> DynBlockRxResult:
    """Detect every owned frame of one block and decode it with
    SIG-discovered MCS/length/type (K2 once, K3 twice, one K1, one host
    sync); ``start`` is reported relative to ``own_lo``. A batch of
    independent windows (n_windows, n) as in :func:`rx_block`."""
    flat, n_windows, n = _as_windows(x)
    stamp("rx", "start", flat)
    slots = _window_slots(cfg, flat, block_len, n_windows, n, n, own_lo, max_frames=max_frames,
                          threshold=threshold, min_n_peaks=min_n_peaks)
    stamp("rx", "detect", flat)
    res = _decode_slots_dynamic(cfg, tab, flat, slots, max_payload=max_payload,
                                estimator=estimator, soft=soft)
    return res if x.dim() == 1 else _per_window(res, n_windows)


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
    gathered extraction batch (K3) over the max envelope, and ONE Viterbi
    call (K1) over every frame, each row run to its own SIG extent."""
    stamp("rx", "start", xp)
    det = sync.detect_frames_stream(
        cfg, xp, block_len, n_blocks, own_lo,
        threshold=threshold, min_n_peaks=min_n_peaks, max_frames=max_frames, dq=dq, entry="rx",
    )
    slots = _stream_slots(det, own_lo)
    stamp("rx", "detect", xp)
    return _decode_slots_dynamic(cfg, tab, xp, slots, max_payload=max_payload,
                                 estimator=estimator, soft=soft, dq=dq)


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
    SIG-discovered MCS/length/type, by the three routes of :func:`scan_rx`
    (flat, windowed, sequential through ``rx_block_dynamic``). ``tab`` is
    ``tables.from_numpy_dynamic`` for the same ``max_payload``, on the
    device of ``x``."""
    halo = frame_window_samples_dynamic(cfg, max_payload) + cfg.fft_len
    xp, left_hist = _padded_stream(cfg, x, block_len, n_blocks, halo)
    kw = dict(max_payload=max_payload, threshold=threshold, min_n_peaks=min_n_peaks,
              estimator=estimator, soft=soft)
    if batched and block_len % sync.SEG == 0:
        return flat_rx_dynamic(cfg, tab, xp, block_len, n_blocks, left_hist,
                               max_frames=max_frames_per_block, **kw)
    window = left_hist + block_len + halo
    if batched:
        stamp("rx", "start", xp)
        slots = _window_slots(cfg, xp, block_len, n_blocks, window, block_len, left_hist,
                              max_frames=max_frames_per_block, threshold=threshold,
                              min_n_peaks=min_n_peaks)
        stamp("rx", "detect", xp)
        res = _decode_slots_dynamic(cfg, tab, xp, slots, max_payload=max_payload,
                                    estimator=estimator, soft=soft)
        return _shifted(res, _block_shifts(block_len, n_blocks, max_frames_per_block, xp.device))
    return _cat([_shifted(rx_block_dynamic(cfg, tab, xp[b * block_len : b * block_len + window],
                                           block_len, own_lo=left_hist,
                                           max_frames=max_frames_per_block, **kw), b * block_len)
                 for b in range(n_blocks)])


class StreamingRxDynamic(nn.Module):
    """The SIG-driven RX chain as a module: ``forward(x)`` runs
    ``scan_rx_dynamic`` on a complex capture lying on the module's device:
    the CUDA device unless ``device`` names another."""

    def __init__(self, cfg: OFDMConfig, block_len: int, n_blocks: int, *,
                 max_frames_per_block: int = 8, max_payload: int = 256,
                 threshold: float = 0.6, min_n_peaks: int = 10, estimator: str = "ls",
                 soft: bool = False, batched: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        self.block_len, self.n_blocks = block_len, n_blocks
        self.max_frames_per_block, self.max_payload = max_frames_per_block, max_payload
        self.threshold, self.min_n_peaks = threshold, min_n_peaks
        self.estimator, self.soft, self.batched = estimator, soft, batched
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
            estimator=self.estimator, soft=self.soft, batched=self.batched,
        )
