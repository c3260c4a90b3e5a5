"""The trigger selection that ends K2 (``detect_cuda.Rows``,
``select_plain``), on the CPU: the row layout against the indices that
``detect_frames_stream`` built around its sorts and suppression loop, the
plain selection against that composition (on synthetic K2 outputs and on the
dense receive traffic through the plain front end), a numpy emulation of the
selection kernel's steps (ordered compaction of the first 4·max_frames
candidates, successors by binary search, the chain walked from the first,
the owned ones compacted) against the plain selection, and the
``detect_cands`` count. The kernel itself against the plain selection:
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from jrc_tpu_torch import capture
from jrc_tpu_torch.config import OFDMConfig
from jrc_tpu_torch.models import streaming
from jrc_tpu_torch.ops import detect_cuda, sync
from jrc_tpu_torch.utils import profiling
from select_cases import CASE_IDS, CASES, GAP, LAG, SEG, candidates_fed, select_case
from tests.torch_parity import THREADS  # noqa: F401 (the one-thread pool)

CFG = OFDMConfig()
DETECT_KW = dict(threshold=0.6, min_n_peaks=10, max_peak_distance=2 * CFG.sym_len,
                 lag=CFG.fft_len // 4, win=CFG.fft_len // 2,
                 pwin=int(1.5 * (CFG.fft_len // 2)))


def _old_indices(own_lo, block_len, n_blocks, ignore_gap):
    """(lead, win_idx into the lead-padded candidates, lo) as
    ``detect_frames_stream`` built them around its sort."""
    s_blk = block_len // SEG
    s_ext = -(-ignore_gap // SEG)
    base0 = own_lo // SEG - s_ext
    lead = max(0, -base0)
    win_idx = (lead + base0 + torch.arange(n_blocks)[:, None] * s_blk
               + torch.arange(s_blk + s_ext)[None, :])
    lo = own_lo + torch.arange(n_blocks)[:, None] * block_len
    return lead, win_idx, lo


def _old_composition(a, seg_first, seg_count, own_lo, block_len, n_blocks, max_frames,
                     ignore_gap, lag):
    """``detect_frames_stream``'s selection as it was composed after K2:
    candidates, per-block sort, ``detect_cuda._suppress``, ownership, sort, CFO."""
    n = a.shape[0]
    n_seg = seg_first.shape[0]
    cand_all = torch.where(seg_first < SEG, torch.arange(n_seg) * SEG + seg_first, n)
    own_rows = seg_count[own_lo // SEG : own_lo // SEG + n_blocks * block_len // SEG]
    n_candidates = own_rows.reshape(n_blocks, block_len // SEG).to(torch.int64).sum(-1)
    lead, win_idx, lo = _old_indices(own_lo, block_len, n_blocks, ignore_gap)
    cand_pad = torch.cat([torch.full((lead,), n, dtype=cand_all.dtype), cand_all])
    cand = torch.sort(cand_pad[win_idx], dim=-1).values[:, : max_frames * 4]
    kept_idx = detect_cuda._suppress(cand, n, ignore_gap)
    kept_idx = torch.where((kept_idx >= lo) & (kept_idx < lo + block_len), kept_idx, n)
    starts = torch.sort(kept_idx, dim=-1).values[..., :max_frames]
    valid = starts < n
    starts = torch.where(valid, starts, -1)
    a_at = a[starts.clamp(0, n - 1)]
    cfo = torch.atan2(a_at.imag, a_at.real) / lag
    return starts, torch.where(valid, cfo, 0.0).to(torch.float32), valid, n_candidates


def _assert_same(got, want):
    for name, g, w in zip(sync.Detections._fields, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("ignore_gap", [1, 640, 700])
@pytest.mark.parametrize("n_blocks", [1, 2, 7])
@pytest.mark.parametrize("block_len", [128, 2**16])
@pytest.mark.parametrize("own_lo", [0, 384, 1280])
def test_rows_are_the_streams_block_indices(own_lo, block_len, n_blocks, ignore_gap):
    """Each row's first segment, span, lead, own segments and owned window
    are those of the indices ``detect_frames_stream`` built (``win_idx``,
    ``lo``, the ``n_candidates`` slice)."""
    rows = detect_cuda.Rows.blocks(own_lo, block_len, n_blocks, ignore_gap=ignore_gap,
                                   max_frames=8)
    lead, win_idx, lo = _old_indices(own_lo, block_len, n_blocks, ignore_gap)
    assert rows.lead == lead and rows.span == win_idx.shape[1] and rows.n == n_blocks
    for b in range(n_blocks):
        assert int(win_idx[b, 0]) - lead == rows.first_seg + b * rows.step
        assert rows.owned(b) == (int(lo[b]), int(lo[b]) + block_len)
        own0 = own_lo // SEG + b * block_len // SEG
        assert rows.first_seg + b * rows.step + rows.pre == own0 and rows.own == block_len // SEG
    n_seg = own_lo // SEG + n_blocks * block_len // SEG
    rows.check(n_seg)
    with pytest.raises(ValueError, match="segments"):
        rows.check(n_seg - 1)


@pytest.mark.parametrize("n_rows,max_frames,opts", CASES, ids=CASE_IDS)
def test_select_plain_is_the_old_composition(n_rows, max_frames, opts):
    a, first, count, rows = select_case(n_rows, max_frames, **opts)
    got = detect_cuda.select_plain(a, first, count, rows, LAG)
    _assert_same(got, _old_composition(a, first, count, rows.own_lo, rows.own * SEG, n_rows,
                                       max_frames, GAP, LAG))
    assert int(got.valid.sum()) > 0 or opts.get("empty_row") is not None


def _dense_stream(max_payload=3100):
    """The dense receive traffic as the live receiver's call sees it: a
    2^16-sample block of the seven pinned mixed frames 2111 samples apart
    over 1e-4 noise, with its left history and the 3100-B halo."""
    halo = streaming.frame_window_samples_dynamic(CFG, max_payload) + CFG.fft_len
    left = streaming.left_history_samples(CFG)
    frames = [f.samples for f in capture.load_mixed_frames()]
    rng = np.random.default_rng(5)
    x = (rng.normal(0, 1e-4, (left + 2**16 + halo, 2)) @ [1, 1j]).astype(np.complex64)
    pos, k, placed = left + 700, 0, []
    while pos + len(frames[k % 7]) < len(x):
        f = frames[k % 7]
        x[pos : pos + len(f)] += f
        placed.append(pos)
        pos, k = pos + len(f) + 2111, k + 1
    return torch.from_numpy(x), left, placed


@pytest.mark.parametrize("max_frames", [32, 1])
def test_plain_front_end_with_rows_is_the_old_composition_on_dense_traffic(max_frames):
    """``detect_front_end_plain`` with the stream's row layout equals the old
    composition over its own outputs at the dense cell's shape, and so does
    ``detect_frames_stream``."""
    x, left, placed = _dense_stream()
    rows = detect_cuda.Rows.blocks(left, 2**16, 1, ignore_gap=GAP, max_frames=max_frames)
    a, first, count = detect_cuda.detect_front_end_plain(x, **DETECT_KW)
    want = _old_composition(a, first, count, left, 2**16, 1, max_frames, GAP, LAG)
    in_block = sum(left <= p < left + 2**16 for p in placed)
    assert int(want[2].sum()) == min(in_block, max_frames) and in_block > 10
    _assert_same(detect_cuda.detect_front_end_plain(x, **DETECT_KW, rows=rows), want)
    _assert_same(sync.detect_frames_stream(CFG, x, 2**16, 1, left, max_frames=max_frames), want)


def emulate_selection(a, seg_first, seg_count, rows, lag, threads=1024):
    """The selection kernel's steps in numpy, one block of ``threads`` a row
    → (start, cfo, valid, n_candidates, the most candidates a row fed)."""
    first = seg_first.numpy()
    k, mf = 4 * rows.max_frames, rows.max_frames
    start = np.full((rows.n, mf), -1, np.int64)
    n_cand = np.zeros(rows.n, np.int64)
    fed = 0
    for b in range(rows.n):
        base = rows.first_seg + b * rows.step
        n_cand[b] = int(seg_count[base + rows.pre : base + rows.pre + rows.own].sum())
        cand, m = [], 0
        for j0 in range(0, rows.span, threads):  # ordered compaction, stopping at K
            if m >= k:
                break
            s = base + np.arange(j0, min(j0 + threads, rows.span))
            f = np.where(s >= 0, first[np.maximum(s, 0)], SEG)
            for c in (s * SEG + f)[f < SEG]:
                if m < k:
                    cand.append(int(c))
                m += 1
        m = min(m, k)
        fed = max(fed, m)
        cand = np.asarray(cand, np.int64)
        # successors by binary search, then the chain from the first candidate
        nxt = [max(i + 1, int(np.searchsorted(cand, cand[i] + rows.ignore_gap))) for i in range(m)]
        kept = np.zeros(m, bool)
        i = 0
        while i < m:
            kept[i], i = True, nxt[i]
        lo, hi = rows.owned(b)
        sel = cand[kept & (cand >= lo) & (cand < hi)][:mf]
        start[b, : len(sel)] = sel
    start = torch.from_numpy(start)
    valid = start >= 0
    a_at = a[start.clamp(0)]
    cfo = torch.where(valid, torch.atan2(a_at.imag, a_at.real) / lag, 0.0).to(torch.float32)
    return (start, cfo, valid, torch.from_numpy(n_cand)), fed


@pytest.mark.parametrize("n_rows,max_frames,opts", CASES, ids=CASE_IDS)
def test_the_kernels_steps_give_the_plain_selection(n_rows, max_frames, opts):
    a, first, count, rows = select_case(n_rows, max_frames, **opts)
    want = detect_cuda.select_plain(a, first, count, rows, LAG)
    for threads in (1024, 32):  # one pass of the compaction, and many
        got, fed = emulate_selection(a, first, count, rows, LAG, threads)
        _assert_same(got, want)
        assert fed == candidates_fed(first, rows)


def test_the_plain_selection_writes_detect_cands():
    """With ``entry`` each call of the selection on the CPU (the host's write,
    as the kernel makes it on the card) raises its row of the ``detect_cands`` count
    to the most candidates a row fed to the suppression, out of
    4·max_frames; the count reaches its envelope where the truncation bites."""
    profiling.reset()
    want = []
    for n_rows, max_frames, opts in (CASES[2], CASES[6], CASES[8]):
        a, first, count, rows = select_case(n_rows, max_frames, **opts)
        profiling.stamp("rx", "start", a)
        detect_cuda.select(a, first, count, rows, LAG, entry="rx")
        want.append((candidates_fed(first, rows), 4 * max_frames))
    assert profiling.counts("rx", "detect_cands") == want
    assert want[1][0] == want[1][1] and want[0][0] < want[0][1]
    profiling.reset()
