"""K2: fused frame-detection front end (port of
jrc_tpu/ops/detect_pallas.py:151).

``detect_front_end`` runs ``detect_front_end_plain`` for a CPU tensor and
the CUDA kernel of kernels/csrc/detect.cu for a CUDA tensor, each launch
counted in ``kernels.registry``. The kernel reads the stream as it is given:
no padded copy is made. The stream is complex64 (n,) or, with its scale
``dq``, int16 (n, 2) (the sc16 wire, ``ops/wire.py``): the kernel then
dequantizes each sample as it loads it, and no dequantized copy is made.

Given a row layout (``Rows``), the same call also selects the frame
triggers (``sync.Detections``): on the card a second kernel of the same
entry point, one block a row, in place of the sorts and the unrolled
suppression loop of ``select_plain``, which the CPU runs. With ``entry``
the selection writes that entry's ``detect_cands`` count
(``utils.profiling``): the most candidates a row fed to the suppression,
out of the envelope 4·max_frames.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from jrc_tpu_torch import kernels
from jrc_tpu_torch.kernels import registry
from jrc_tpu_torch.ops import sync, wire
from jrc_tpu_torch.utils import profiling

SEG = sync.SEG
ROW = 32  # samples per warp row of the kernel
CHUNK_SEGS = 32  # 128-sample segments per CUDA block (must match detect.cu)
WARPS = 8  # warps per CUDA block (must match detect.cu)
MAX_WINDOW = 127  # the kernel's doubling levels sum at most 64 samples


def margin_samples(max_peak_distance: int) -> int:
    """Samples before a block's chunk whose mask the block recomputes: the
    sparsify stage reads the trigger back max_peak_distance−1 samples and the
    peak count another max_peak_distance−1; rounded up to whole warp rows
    (320 samples at fft_len=64). The moving sums' own lookback is each
    warp's warm-up (``warm_up_rows``), not part of the margin."""
    return -(-2 * (max_peak_distance - 1) // ROW) * ROW


def warm_up_rows(win: int, pwin: int) -> int:
    """Rows a warp runs before its first own row so that its moving sums are
    those of the whole stream."""
    return -(-(max(win, pwin) - 1) // ROW)


def window_fits(win: int) -> bool:
    """Whether the kernel takes a moving-sum window: its shift-and-add chain
    must reach back at most one warp row at every step (true of 32, 48, 64
    and 96, the windows of fft_len 64 and 128)."""
    if not 1 <= win <= MAX_WINDOW:
        return False
    high = 1 << (win.bit_length() - 1)
    return win - high <= ROW


class Rows(NamedTuple):
    """The row layout of the trigger selection. Row b reads the segments
    ``first_seg + b·step`` … ``+ span − 1`` (a segment below 0 is empty:
    ``lead`` of them pad row 0), the first ``pre`` only to drive the
    suppression; its ``n_candidates`` counts the triggers of the other
    ``own``, and it keeps the triggers of ``owned(b)``, in samples."""

    n: int  # rows
    first_seg: int
    step: int  # segments from one row's first segment to the next's
    pre: int
    own: int
    own_lo: int  # row 0's owned window [own_lo, own_lo + own_len)
    own_len: int
    max_frames: int
    ignore_gap: int

    @classmethod
    def blocks(cls, own_lo: int, block_len: int, n_blocks: int, *, ignore_gap: int,
               max_frames: int) -> "Rows":
        """``sync.detect_frames_stream``'s rows: a block each, its own
        segments plus the ``ignore_gap`` span before it."""
        s_ext = -(-ignore_gap // SEG)
        return cls(n_blocks, own_lo // SEG - s_ext, block_len // SEG, s_ext, block_len // SEG,
                   own_lo, block_len, max_frames, ignore_gap)

    @classmethod
    def whole(cls, n: int, *, ignore_gap: int, max_frames: int,
              own_window: tuple[int, int] | None = None) -> "Rows":
        """``sync.detect_frames``' one row: every segment of an n-sample
        block, keeping the triggers in ``own_window`` (lo, length), or all."""
        n_seg = -(-n // SEG)
        lo, length = (0, n) if own_window is None else own_window
        return cls(1, 0, n_seg, 0, n_seg, lo, length, max_frames, ignore_gap)

    @property
    def span(self) -> int:
        return self.pre + self.own

    @property
    def lead(self) -> int:
        return max(0, -self.first_seg)

    def owned(self, b: int) -> tuple[int, int]:
        lo = self.own_lo + b * self.step * SEG
        return lo, lo + self.own_len

    def check(self, n_seg: int) -> None:
        """Raise unless every row's segments lie below ``n_seg`` and its own
        ones at or above 0."""
        last = self.first_seg + (self.n - 1) * self.step + self.span
        if self.first_seg + self.pre < 0 or (self.n and last > n_seg):
            raise ValueError(f"{self} does not fit a stream of {n_seg} segments")


def _window_index(rows: Rows, device) -> torch.Tensor:
    """(rows, span) indices of each row's segments into the segments led by
    ``rows.lead`` empty ones."""
    return (rows.lead + rows.first_seg + torch.arange(rows.n, device=device)[:, None] * rows.step
            + torch.arange(rows.span, device=device)[None, :])


def _suppress(cand: torch.Tensor, n: int, ignore_gap: int) -> torch.Tensor:
    """Near-trigger suppression over ascending candidates (..., k), in order:
    keep a candidate at least ``ignore_gap`` after the last kept one; the
    others become ``n``."""
    last_kept = torch.full(cand.shape[:-1], -(10**9), dtype=cand.dtype, device=cand.device)
    keeps = []
    for i in range(cand.shape[-1]):
        c = cand[..., i]
        keep = (c < n) & (c >= last_kept + ignore_gap)
        last_kept = torch.where(keep, c, last_kept)
        keeps.append(keep)
    return torch.where(torch.stack(keeps, dim=-1), cand, n)


def _starts_and_cfo(a: torch.Tensor, kept_idx: torch.Tensor, n: int, max_frames: int, lag: int):
    """The first ``max_frames`` kept triggers (..., k) of a stream's
    autocorrelation ``a`` (n,) → (start (-1 = none), coarse CFO from its
    angle there over the lag, valid)."""
    starts = torch.sort(kept_idx, dim=-1).values[..., :max_frames]
    valid = starts < n
    starts = torch.where(valid, starts, -1)
    a_at = a[starts.clamp(0, n - 1)]
    cfo = torch.atan2(a_at.imag, a_at.real) / lag
    return starts, torch.where(valid, cfo, 0.0).to(torch.float32), valid


def select_plain(a, seg_first, seg_count, rows: Rows, lag: int):
    """The trigger selection of ``rows`` from K2's outputs → ``sync.Detections``
    with a leading row axis: each row's candidates sorted, the first
    4·max_frames through ``_suppress``, the owned ones kept, the first
    max_frames of those with their coarse CFO (``_starts_and_cfo``)."""
    n = a.shape[-1]
    dev = a.device
    rows.check(seg_first.shape[-1])
    cand_all = torch.where(seg_first < SEG, torch.arange(seg_first.shape[-1], device=dev) * SEG
                           + seg_first, n)
    cand_pad = torch.cat([torch.full((rows.lead,), n, dtype=cand_all.dtype, device=dev), cand_all])
    row_ids = torch.arange(rows.n, device=dev)[:, None]
    cand = torch.sort(cand_pad[_window_index(rows, dev)], dim=-1).values[:, : rows.max_frames * 4]
    kept_idx = _suppress(cand, n, rows.ignore_gap)
    # drop non-owned candidates BEFORE truncating to max_frames (the pre-span
    # ones exist only to drive the suppression above)
    lo = rows.own_lo + row_ids * rows.step * SEG
    kept_idx = torch.where((kept_idx >= lo) & (kept_idx < lo + rows.own_len), kept_idx, n)
    starts, cfo, valid = _starts_and_cfo(a, kept_idx, n, rows.max_frames, lag)
    own_idx = rows.first_seg + rows.pre + row_ids * rows.step + torch.arange(rows.own, device=dev)
    n_candidates = seg_count[own_idx].to(torch.int64).sum(-1)
    return sync.Detections(start=starts, coarse_cfo=cfo, valid=valid, n_candidates=n_candidates)


def count_fed(entry: str | None, seg_first: torch.Tensor, rows: Rows) -> None:
    """The host's write of the ``detect_cands`` count of ``entry``'s call (a
    CPU tensor's ring, as the selection kernel writes it on the card): the
    most candidates a row feeds to the suppression, of 4·max_frames."""
    if entry is None or not rows.n:
        return
    has = F.pad(seg_first < SEG, (rows.lead, 0))[_window_index(rows, seg_first.device)]
    fed = int(has.sum(-1).clamp(max=4 * rows.max_frames).max())
    profiling.count(entry, "detect_cands", fed, 4 * rows.max_frames, seg_first)


def detect_front_end_plain(x, *, threshold, min_n_peaks, max_peak_distance, lag, win, pwin,
                           dq=None, rows: Rows | None = None, entry: str | None = None):
    """Complex (n,) stream, or int16 (n, 2) with ``dq`` → (a complex64 (n,),
    seg_first int32 (n_seg,) with 128 = no trigger, seg_count int32
    (n_seg,)), built from the ported sync functions: autocorrelation,
    0.6 < cor < 2 mask, gap-tolerant trigger, sparsify, per-segment first
    trigger and count. With ``rows``: ``select_plain`` of those. ``entry``
    is the wrapper's, taken so that this version can stand in for it
    (``kernels.registry.plain_kernels``); it writes no count."""
    x = wire.as_complex(x, dq, "detect_front_end_plain")
    n = x.shape[-1]
    a_re, a_im, cor = sync.autocorrelation_pair(x, lag, win, pwin)
    mask = (cor > threshold) & (cor < 2.0)
    trigger = sync._gap_tolerant_triggers(mask, min_n_peaks, max_peak_distance)
    tf = trigger.to(torch.float32)
    trigger = trigger & (sync.moving_sum(tf, max_peak_distance) - tf == 0)
    n_seg = -(-n // SEG)
    tseg = F.pad(trigger.to(torch.int32), (0, n_seg * SEG - n)).reshape(n_seg, SEG)
    has = tseg.any(dim=-1)
    first = torch.where(has, torch.argmax(tseg, dim=-1), SEG).to(torch.int32)
    count = tseg.sum(dim=-1).to(torch.int32)
    a = torch.complex(a_re, a_im)
    if rows is not None:
        return select_plain(a, first, count, rows, lag)
    return a, first, count


def detect_front_end(x, *, threshold, min_n_peaks, max_peak_distance, lag, win, pwin, dq=None,
                     rows: Rows | None = None, entry: str | None = None):
    """Fused detection front end over a complex64 (n,) stream or, with
    ``dq``, an int16 (n, 2) one, and with ``rows`` the trigger selection;
    same outputs as ``detect_front_end_plain``."""
    if x.device.type == "cpu":
        out = detect_front_end_plain(
            x, threshold=threshold, min_n_peaks=min_n_peaks,
            max_peak_distance=max_peak_distance, lag=lag, win=win, pwin=pwin, dq=dq)
        if rows is None:
            return out
        count_fed(entry, out[1], rows)
        return select_plain(*out, rows, lag)
    sc16 = wire.is_sc16(x, dq, "detect_front_end")
    if not (window_fits(win) and window_fits(pwin)):
        raise ValueError(f"detect_front_end: the kernel takes no window sums of {win} and {pwin} "
                         "samples (each step of the chain must reach back at most 32)")
    n = x.shape[0]
    n_seg = -(-n // SEG)
    a = torch.empty(n, dtype=torch.complex64, device=x.device)
    first = torch.empty(n_seg, dtype=torch.int32, device=x.device)
    count = torch.empty(n_seg, dtype=torch.int32, device=x.device)
    det, selection = _selection(rows, entry, n_seg, x.device)
    kernels.call(
        "jrc_detect_front_end", kernels.ptr(x.contiguous()), int(sc16),
        float(dq) if sc16 else 0.0, kernels.ptr(a),
        kernels.ptr(first), kernels.ptr(count), n,
        margin_samples(max_peak_distance), float(threshold), int(min_n_peaks),
        int(max_peak_distance), int(lag), int(win), int(pwin), *selection, profiling.ROWS)
    registry.count("detect_front_end")
    return (a, first, count) if det is None else det


def _selection(rows: Rows | None, entry: str | None, n_seg: int, device):
    """(the selection's outputs as ``sync.Detections``, or None without
    ``rows``; the C entry's arguments for it: the layout, then the pointers
    of start, cfo, valid, n_candidates, the count ring and its counter)."""
    if rows is None:
        return None, (None,) * 7
    rows.check(n_seg)
    shape = (rows.n, rows.max_frames)
    det = sync.Detections(torch.empty(shape, dtype=torch.int64, device=device),
                          torch.empty(shape, dtype=torch.float32, device=device),
                          torch.empty(shape, dtype=torch.bool, device=device),
                          torch.empty(rows.n, dtype=torch.int64, device=device))
    ring = (None, None) if entry is None else profiling.count_ring(entry, "detect_cands", det[0])
    return det, ((ctypes.c_longlong * len(rows))(*rows),
                 *(None if t is None else kernels.ptr(t) for t in (*det, *ring)))


def select(a, seg_first, seg_count, rows: Rows, lag: int, entry: str | None = None):
    """The trigger selection alone over front-end outputs as given: on the
    card the selection kernel (the entry point's second launch with no
    first), ``select_plain`` and ``count_fed`` for CPU tensors. Only
    ``sync.detect_frames(strict_runs=True)``, whose front end is plain
    PyTorch, and the kernel's tests call it; the detection paths call
    ``detect_front_end`` with ``rows``."""
    if a.device.type == "cpu":
        count_fed(entry, seg_first, rows)
        return select_plain(a, seg_first, seg_count, rows, lag)
    n_seg = -(-a.shape[0] // SEG)
    if seg_first.shape != (n_seg,) or seg_count.shape != (n_seg,):
        raise ValueError(f"seg_first and seg_count must hold {n_seg} segments")
    det, selection = _selection(rows, entry, n_seg, a.device)
    ins = (a.to(torch.complex64).contiguous(), seg_first.to(torch.int32).contiguous(),
           seg_count.to(torch.int32).contiguous())
    kernels.call("jrc_detect_front_end", None, 0, 0.0, *map(kernels.ptr, ins), a.shape[0], 0,
                 0.0, 0, 0, int(lag), 0, 0, *selection, profiling.ROWS)
    return det
