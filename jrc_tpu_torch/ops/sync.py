"""Frame detection and synchronization (port of jrc_tpu/ops/sync.py).

The stream path (``detect_frames_stream``, ``extract_frames_batch``) and the
per-frame functions of one burst (``detect_frames``, ``extract_frame``).

Samples are complex64; the detector arithmetic is written on the real and
imaginary parts in the same order as the reference's pair form, so the
plain versions match it to the last bit where the operations allow.
``detect_frames_stream`` and ``detect_frames`` run the fused front end K2
(``detect_cuda.detect_front_end``), ``extract_frames_batch`` and
``extract_frame`` the row gather K3 (``gather_cuda.gather_rows``); both
kernels choose the plain version or
the CUDA kernel by the device of the samples. Both stream functions take
the flat stream as complex64 (n,) or, with ``dq``, as int16 (n, 2) (the
sc16 wire, ``ops/wire.py``) and hand it to the kernels as it is; what
comes out of K2 and K3 is complex64 either way.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch.ops import gather_cuda

SEG = 128  # candidate-extraction segment (must stay < max_peak_distance)


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """x delayed by k samples along the last axis, zeros shifted in."""
    if k == 0:
        return x
    if k >= x.shape[-1]:
        return torch.zeros_like(x)
    pad = torch.zeros((*x.shape[:-1], k), dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-k]], dim=-1)


def moving_sum(x: torch.Tensor, win: int) -> torch.Tensor:
    """Trailing-window sum out[n] = Σ_{k<win} x[n−k] (zeros history), by
    binary shift-and-add doubling in the reference's order (not a cumsum)."""
    acc = None
    shift = 0
    s = x
    w = 1
    while True:
        if win & w:
            part = _shift_right(s, shift)
            acc = part if acc is None else acc + part
            shift += w
        w *= 2
        if w > win:
            break
        s = s + _shift_right(s, w // 2)
    return acc


def autocorrelation_pair(x: torch.Tensor, lag: int, win: int, pwin: int):
    """(a_re, a_im, cor) of complex (..., n) samples:
    a[n] = Σ_{k<win} x[n−k]·conj(x[n−lag−k]);
    cor[n] = |a[n]| / ((1/1.5)·Σ_{k<pwin} |x[n−k]|²)."""
    xr, xi = x.real, x.imag
    xdr, xdi = _shift_right(xr, lag), _shift_right(xi, lag)
    a_re = moving_sum(xr * xdr + xi * xdi, win)
    a_im = moving_sum(xi * xdr - xr * xdi, win)
    p = moving_sum(xr * xr + xi * xi, pwin) / 1.5
    cor = torch.sqrt(a_re * a_re + a_im * a_im) / torch.clamp_min(p, 1e-12)
    return a_re, a_im, cor


def autocorrelation(cfg: OFDMConfig, x: torch.Tensor):
    """(autocorr a[n] complex, normalized correlation cor[n])."""
    win = cfg.fft_len // 2
    a_re, a_im, cor = autocorrelation_pair(x, cfg.fft_len // 4, win, int(1.5 * win))
    return torch.complex(a_re, a_im), cor


def _gap_tolerant_triggers(mask: torch.Tensor, min_n_peaks: int, max_peak_distance: int):
    """A trigger fires where the trailing ``max_peak_distance`` window holds
    more than ``min_n_peaks`` peaks (the reference's SEARCH counter)."""
    peaks_in_window = moving_sum(mask.to(torch.float32), max_peak_distance)
    return mask & (peaks_in_window > min_n_peaks)


def _run_lengths(mask: torch.Tensor) -> torch.Tensor:
    """Length of the current True-run ending at each position."""
    idx = torch.arange(mask.shape[-1], device=mask.device)
    last_false = torch.where(mask, -1, idx)
    return idx - torch.cummax(last_false, dim=-1).values


class Detections(NamedTuple):
    """Frame triggers: (n_blocks, max_frames) from ``detect_frames_stream``,
    (max_frames,) from ``detect_frames``."""

    start: torch.Tensor  # int64 trigger index (-1 = none)
    coarse_cfo: torch.Tensor  # float32 rad/sample
    valid: torch.Tensor  # bool
    n_candidates: torch.Tensor  # trigger count (in the owned span: per block)


def detect_frames(
    cfg: OFDMConfig,
    x: torch.Tensor,  # complex (n,) sample block, or (n_windows, n) windows
    *,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    max_frames: int = 8,
    ignore_gap: int | None = None,
    strict_runs: bool = False,
    own_window: tuple[int, int] | None = None,
) -> Detections:
    """STF plateaus of one sample block. Default: the gap-tolerant trigger
    chain, which the front end K2 computes (autocorrelation, the
    ``threshold < cor < 2`` mask, the trigger at the (min_n_peaks+1)-th peak
    within 2·sym_len, one candidate per cluster, the first per 128-sample
    segment); ``strict_runs=True`` fires at the min_n_peaks-th sample of a
    consecutive run instead (plain PyTorch). Triggers within ``ignore_gap``
    of a kept one are suppressed; ``own_window=(lo, length)`` reports only
    triggers inside it, before truncating to ``max_frames`` (K2's selection
    of one row, ``detect_cuda.Rows.whole``). A batch of windows (n_windows,
    n) is detected as the reference's vmap over them: K2 once a window, each
    with no history before it; every field gains the leading window axis."""
    from jrc_tpu_torch.ops import detect_cuda

    if ignore_gap is None:
        ignore_gap = (cfg.n_sync_words + cfg.n_tx) * cfg.sym_len
    n = x.shape[-1]
    max_peak_distance = 2 * cfg.sym_len
    assert max_peak_distance > SEG
    n_seg = -(-n // SEG)
    rows = detect_cuda.Rows.whole(n, ignore_gap=ignore_gap, max_frames=max_frames,
                                  own_window=own_window)
    lag = cfg.fft_len // 4

    def one(xr: torch.Tensor) -> Detections:
        if not strict_runs:
            return detect_cuda.detect_front_end(
                xr, threshold=threshold, min_n_peaks=min_n_peaks,
                max_peak_distance=max_peak_distance, lag=lag, win=cfg.fft_len // 2,
                pwin=int(1.5 * (cfg.fft_len // 2)), rows=rows)
        a, cor = autocorrelation(cfg, xr)
        trigger = _run_lengths((cor > threshold) & (cor < 2.0)) == min_n_peaks
        tf = trigger.to(torch.float32)
        trigger = trigger & (moving_sum(tf, max_peak_distance) - tf == 0)
        tseg = torch.nn.functional.pad(trigger.to(torch.int32), (0, n_seg * SEG - n))
        tseg = tseg.reshape(n_seg, SEG)
        seg_first = torch.where(tseg.any(-1), torch.argmax(tseg, dim=-1), SEG)
        return detect_cuda.select(a, seg_first, tseg.sum(-1), rows, lag)

    fields = [torch.cat(f) for f in zip(*(one(xr) for xr in (x[None] if x.dim() == 1 else x)))]
    return Detections(*(f[0] if x.dim() == 1 else f for f in fields))


def detect_frames_stream(
    cfg: OFDMConfig,
    x: torch.Tensor,  # flat [left-pad | n_blocks·block_len | halo] complex stream
    block_len: int,
    n_blocks: int,
    own_lo: int,  # ownership of block b = [own_lo + b·block_len, +block_len)
    *,
    threshold: float = 0.6,
    min_n_peaks: int = 10,
    max_frames: int = 8,
    ignore_gap: int | None = None,
    dq: float | None = None,  # the scale of an int16 (n, 2) stream
    entry: str | None = None,
) -> Detections:
    """Block-batched detection over one flat pass of the stream: the front
    end (K2) gives one first-trigger candidate per 128-sample segment; each
    block then runs the ``ignore_gap`` suppression over its own segments
    plus the span before it, and keeps only owned triggers BEFORE truncating
    to ``max_frames`` (K2's selection, one row a block:
    ``detect_cuda.Rows.blocks``). ``start`` is in flat-stream coordinates;
    ``entry`` names the entry point whose ``detect_cands`` count the
    selection writes."""
    from jrc_tpu_torch.ops import detect_cuda

    if ignore_gap is None:
        ignore_gap = (cfg.n_sync_words + cfg.n_tx) * cfg.sym_len
    if own_lo % SEG or block_len % SEG:
        raise ValueError(f"own_lo={own_lo} and block_len={block_len} must be multiples of {SEG}")
    max_peak_distance = 2 * cfg.sym_len
    assert max_peak_distance > SEG
    rows = detect_cuda.Rows.blocks(own_lo, block_len, n_blocks, ignore_gap=ignore_gap,
                                   max_frames=max_frames)
    return detect_cuda.detect_front_end(
        x, threshold=threshold, min_n_peaks=min_n_peaks,
        max_peak_distance=max_peak_distance, lag=cfg.fft_len // 4,
        win=cfg.fft_len // 2, pwin=int(1.5 * (cfg.fft_len // 2)), dq=dq, rows=rows, entry=entry,
    )


class SyncResult(NamedTuple):
    frame_start: torch.Tensor  # (B,) int64 offset of the LTF from the trigger
    fine_cfo: torch.Tensor  # (B,) float32 rad/sample
    found: torch.Tensor  # (B,) bool: a peak pair at lag fft_len(±1) existed


def ltf_correlate(cfg: OFDMConfig, x: torch.Tensor) -> torch.Tensor:
    """Matched filter corr[n] = Σ_k conj(ltf_t[k])·x[n+k] over complex
    (..., L) → (..., L − fft_len + 1), as fft_len shifted scalar FMAs in the
    reference's order (real taps first, then imaginary)."""
    taps = np.conj(np.asarray(cfg.lltf_time))
    n = x.shape[-1] - cfg.fft_len + 1
    xr, xi = x.real, x.imag
    acc_re = torch.zeros((*x.shape[:-1], n), dtype=xr.dtype, device=x.device)
    acc_im = torch.zeros_like(acc_re)
    for k in range(cfg.fft_len):
        xr_k = xr[..., k : k + n]
        xi_k = xi[..., k : k + n]
        tr, ti = float(taps[k].real), float(taps[k].imag)
        if tr != 0.0:
            acc_re = acc_re + tr * xr_k
            acc_im = acc_im + tr * xi_k
        if ti != 0.0:
            acc_re = acc_re - ti * xi_k
            acc_im = acc_im + ti * xr_k
    return torch.complex(acc_re, acc_im)


def search_frame_start(cfg: OFDMConfig, corr: torch.Tensor) -> SyncResult:
    """Top-4 |corr|² peak-pair search at index gap fft_len (±1) over
    complex (B, n), preferring an exact-gap pair. The top 4 come from a
    stable descending sort, so equal magnitudes keep the lower index first
    as ``jax.lax.top_k`` does."""
    B, n = corr.shape
    dev = corr.device
    mag2 = corr.real * corr.real + corr.imag * corr.imag
    top_idx = torch.sort(mag2, dim=-1, descending=True, stable=True).indices[:, :4]
    top_val = corr.gather(-1, top_idx)

    best_start = torch.full((B,), n, dtype=torch.int64, device=dev)
    best_cfo = torch.zeros(B, dtype=torch.float32, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    exact_found = torch.zeros(B, dtype=torch.bool, device=dev)
    for i in range(3):
        for k in range(i + 1, 4):
            ii, kk = top_idx[:, i], top_idx[:, k]
            vi, vk = top_val[:, i], top_val[:, k]
            swap = ii > kk
            first = torch.where(swap, vk, vi)
            second = torch.where(swap, vi, vk)
            diff = (ii - kk).abs()
            start = torch.minimum(ii, kk)
            # first · conj(second)
            pr = first.real * second.real + first.imag * second.imag
            pi = first.imag * second.real - first.real * second.imag
            ang = torch.atan2(pi, pr)
            for gap in (cfg.fft_len, cfg.fft_len - 1, cfg.fft_len + 1):
                hit = (diff == gap) & ~exact_found
                best_start = torch.where(hit, start, best_start)
                best_cfo = torch.where(hit, ang / gap, best_cfo)
                found = found | hit
                if gap == cfg.fft_len:
                    exact_found = exact_found | hit
    return SyncResult(frame_start=best_start, fine_cfo=best_cfo, found=found)


def expj(theta: torch.Tensor) -> torch.Tensor:
    """exp(j·theta) for real float32 theta."""
    return torch.complex(torch.cos(theta), torch.sin(theta))


def symbol_sample_offsets(cfg: OFDMConfig, n_sym: int) -> np.ndarray:
    """(n_sym, fft_len) sample indices relative to the frame start: symbols
    0 and 1 are the back-to-back LTF copies, later symbols skip their CP."""
    offs = np.zeros((n_sym, cfg.fft_len), np.int32)
    for s in range(n_sym):
        base = s * cfg.fft_len if s < 2 else 2 * cfg.fft_len + (s - 2) * cfg.sym_len + cfg.cp_len
        offs[s] = base + np.arange(cfg.fft_len)
    return offs


def extract_frame(cfg: OFDMConfig, x: torch.Tensor, trigger: torch.Tensor,
                  coarse_cfo: torch.Tensor, n_sym: int, sync_length: int | None = None):
    """Full sync of one detected frame of a complex (n,) block: the two
    clamped windows of ``extract_frames_batch`` with one row each (K3) →
    (symbols (n_sym, fft_len), total_cfo, found)."""
    syms, total_cfo, found = extract_frames_batch(
        cfg, x, trigger.reshape(1), coarse_cfo.reshape(1).to(torch.float32), n_sym, sync_length)
    return syms[0], total_cfo[0], found[0]


def extract_frames_batch(
    cfg: OFDMConfig,
    x: torch.Tensor,  # flat complex sample stream
    triggers: torch.Tensor,  # (B,) int
    coarse_cfos: torch.Tensor,  # (B,) float32
    n_sym: int,
    sync_length: int | None = None,
    dq: float | None = None,  # the scale of an int16 (n, 2) stream
):
    """Derotate from each trigger, find the LTF peak pair, apply the fine
    derotation and cut the CP-stripped symbols. The two window reads go
    through the row gather K3, which applies the derotation as it stores
    (two launches for both). Returns (symbols (B, n_sym, fft_len)
    complex64, total_cfo (B,), found (B,))."""
    if sync_length is None:
        sync_length = cfg.n_sync_words * cfg.sym_len
    need_corr = sync_length + cfg.fft_len - 1
    # window from the trigger, derotated by the coarse CFO: phase −coarse·k
    w_corr = gather_cuda.gather_rows(x, triggers, need_corr, rot=(-coarse_cfos, None), dq=dq)
    corr = ltf_correlate(cfg, w_corr)[..., :sync_length]
    sr = search_frame_start(cfg, corr)

    assert cfg.sym_len == cfg.fft_len + cfg.cp_len
    need_sym = 2 * cfg.fft_len + (n_sym - 2) * cfg.sym_len
    # window from the LTF, phase (fine − coarse)·(frame_start + k)
    w_sym = gather_cuda.gather_rows(x, triggers + sr.frame_start, need_sym,
                                    rot=(sr.fine_cfo - coarse_cfos, sr.frame_start), dq=dq)
    b = w_sym.shape[0]
    ltf = w_sym[:, : 2 * cfg.fft_len].reshape(b, 2, cfg.fft_len)
    rest = w_sym[:, 2 * cfg.fft_len :].reshape(b, n_sym - 2, cfg.sym_len)
    symbols = torch.cat([ltf, rest[..., cfg.cp_len :]], dim=1)
    total_cfo = coarse_cfos - sr.fine_cfo
    return symbols, total_cfo, sr.found
