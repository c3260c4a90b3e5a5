"""K2: fused frame-detection front end (port of
jrc_tpu/ops/detect_pallas.py:151).

``detect_front_end`` runs ``detect_front_end_plain`` for a CPU tensor and
the CUDA kernel of kernels/csrc/detect.cu for a CUDA tensor; ``launches``
counts kernel launches only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from jrc_tpu_torch import kernels
from jrc_tpu_torch.ops import sync

SEG = sync.SEG
CHUNK_SEGS = 32  # 128-sample segments per CUDA block (must match detect.cu)


def margin_samples(lag: int, win: int, pwin: int, max_peak_distance: int) -> int:
    """Left margin covering the trigger chain's lookback: the sparsify stage
    reads the trigger mask back max_peak_distance−1 samples, the peak count
    another max_peak_distance−1, the moving sums max(win+lag, pwin)−1 more;
    rounded up to whole segments (384 samples at fft_len=64)."""
    lookback = 2 * (max_peak_distance - 1) + max(win + lag, pwin) - 1
    return -(-lookback // SEG) * SEG


def detect_front_end_plain(x, *, threshold, min_n_peaks, max_peak_distance, lag, win, pwin):
    """Complex (n,) stream → (a complex64 (n,), seg_first int32 (n_seg,)
    with 128 = no trigger, seg_count int32 (n_seg,)), built from the ported
    sync functions: autocorrelation, 0.6 < cor < 2 mask, gap-tolerant
    trigger, sparsify, per-segment first trigger and count."""
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


def detect_front_end(x, *, threshold, min_n_peaks, max_peak_distance, lag, win, pwin):
    """Fused detection front end over a complex64 (n,) stream; same outputs
    as ``detect_front_end_plain``."""
    if x.device.type == "cpu":
        return detect_front_end_plain(
            x, threshold=threshold, min_n_peaks=min_n_peaks,
            max_peak_distance=max_peak_distance, lag=lag, win=win, pwin=pwin)
    if x.dtype != torch.complex64 or x.dim() != 1:
        raise TypeError(f"detect_front_end: complex64 (n,) stream expected, got {x.dtype} {tuple(x.shape)}")
    n = x.shape[0]
    n_seg = -(-n // SEG)
    chunk = CHUNK_SEGS * SEG
    n_chunks = -(-n // chunk)
    margin = margin_samples(lag, win, pwin, max_peak_distance)
    # top-pad with the margin of zeros (the zero history of the plain
    # version) and tail-pad to whole chunks: the kernel reads no bounds
    xp = F.pad(torch.view_as_real(x), (0, 0, margin, n_chunks * chunk - n)).contiguous()
    a = torch.empty(n, dtype=torch.complex64, device=x.device)
    first = torch.empty(n_seg, dtype=torch.int32, device=x.device)
    count = torch.empty(n_seg, dtype=torch.int32, device=x.device)
    kernels.call(
        "jrc_detect_front_end", kernels.ptr(xp), kernels.ptr(torch.view_as_real(a)),
        kernels.ptr(first), kernels.ptr(count), n, n_chunks, margin,
        float(threshold), int(min_n_peaks), int(max_peak_distance), int(lag),
        int(win), int(pwin))
    detect_front_end.launches += 1
    return a, first, count


detect_front_end.launches = 0
