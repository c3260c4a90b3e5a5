"""K2: fused frame-detection front end (port of
jrc_tpu/ops/detect_pallas.py:151).

``detect_front_end`` runs ``detect_front_end_plain`` for a CPU tensor and
the CUDA kernel of kernels/csrc/detect.cu for a CUDA tensor, each launch
counted in ``kernels.registry``. The kernel reads the stream as it is given:
no padded copy is made. The stream is complex64 (n,) or, with its scale
``dq``, int16 (n, 2) (the sc16 wire, ``ops/wire.py``): the kernel then
dequantizes each sample as it loads it, and no dequantized copy is made.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from jrc_tpu_torch import kernels
from jrc_tpu_torch.kernels import registry
from jrc_tpu_torch.ops import sync, wire

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


def detect_front_end_plain(x, *, threshold, min_n_peaks, max_peak_distance, lag, win, pwin,
                           dq=None):
    """Complex (n,) stream, or int16 (n, 2) with ``dq`` → (a complex64 (n,),
    seg_first int32 (n_seg,) with 128 = no trigger, seg_count int32
    (n_seg,)), built from the ported sync functions: autocorrelation,
    0.6 < cor < 2 mask, gap-tolerant trigger, sparsify, per-segment first
    trigger and count."""
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
    return torch.complex(a_re, a_im), first, count


def detect_front_end(x, *, threshold, min_n_peaks, max_peak_distance, lag, win, pwin, dq=None):
    """Fused detection front end over a complex64 (n,) stream or, with
    ``dq``, an int16 (n, 2) one; same outputs as ``detect_front_end_plain``."""
    if x.device.type == "cpu":
        return detect_front_end_plain(
            x, threshold=threshold, min_n_peaks=min_n_peaks,
            max_peak_distance=max_peak_distance, lag=lag, win=win, pwin=pwin, dq=dq)
    sc16 = wire.is_sc16(x, dq, "detect_front_end")
    if not (window_fits(win) and window_fits(pwin)):
        raise ValueError(f"detect_front_end: the kernel takes no window sums of {win} and {pwin} "
                         "samples (each step of the chain must reach back at most 32)")
    n = x.shape[0]
    n_seg = -(-n // SEG)
    a = torch.empty(n, dtype=torch.complex64, device=x.device)
    first = torch.empty(n_seg, dtype=torch.int32, device=x.device)
    count = torch.empty(n_seg, dtype=torch.int32, device=x.device)
    kernels.call(
        "jrc_detect_front_end", kernels.ptr(x.contiguous()), int(sc16),
        float(dq) if sc16 else 0.0, kernels.ptr(a),
        kernels.ptr(first), kernels.ptr(count), n,
        margin_samples(max_peak_distance), float(threshold), int(min_n_peaks),
        int(max_peak_distance), int(lag), int(win), int(pwin))
    registry.count("detect_front_end")
    return a, first, count
