"""Synthetic K2 outputs for the tests of the trigger selection that ends K2
(``detect_cuda.select_plain`` and its kernel): per-segment first triggers
and counts over the rows of ``detect_cuda.Rows.blocks``, with the shapes
that decide the selection planted in each row."""
import numpy as np
import torch

from jrc_tpu_torch.ops import detect_cuda

SEG = detect_cuda.SEG
GAP = 640  # the default ignore_gap: (n_sync_words + n_tx) · sym_len
LAG = 16

#: (rows, max_frames, options) of each case
CASES = [
    (1, 1, {}), (2, 8, {}), (7, 32, {}), (2, 1024, {}),
    (1, 8, dict(over=True)), (7, 1, dict(over=True)), (2, 32, dict(over=True)),
    (1, 1024, dict(over=True)),
    (2, 8, dict(empty_row=1)), (7, 32, dict(empty_row=0)), (1, 1, dict(empty_row=0)),
    (7, 8, dict(own_lo=1280)), (2, 32, dict(own_lo=0)),
]
CASE_IDS = [f"rows{r}-mf{m}" + "".join(f"-{k}{v}" for k, v in o.items()) for r, m, o in CASES]


def select_case(n_rows: int, max_frames: int, *, over: bool = False, empty_row: int | None = None,
                own_lo: int = 384, seed: int = 0):
    """(a complex64 (n,), seg_first int32 (n_seg,) with 128 = none, seg_count
    int32 (n_seg,), rows). Segments hold a trigger at random (with ``over``
    so densely that every row has more than 4·max_frames candidates); then
    around each block's start a quiet stretch holds a candidate 100 samples
    before the start (in the span before the block, for the suppression
    only), one ``GAP − 1`` after it (suppressed), and further in a chain at
    exactly ``GAP`` (kept) followed by one ``GAP − 1`` after that (suppressed).
    ``empty_row`` clears a row's whole span. ``own_lo`` below
    ceil(GAP/128)·128 leads row 0 with empty segments."""
    rng = np.random.default_rng(seed + 1000 * n_rows + max_frames)
    k = 4 * max_frames
    s_blk = max(40, -(-13 * k // 10) + 48 if over else 4 * max_frames + 16)
    block_len = s_blk * SEG
    rows = detect_cuda.Rows.blocks(own_lo, block_len, n_rows, ignore_gap=GAP,
                                   max_frames=max_frames)
    n_seg = own_lo // SEG + n_rows * s_blk + 4
    n = n_seg * SEG - 37
    has = rng.random(n_seg) < (0.9 if over else 0.35)
    first = rng.integers(0, SEG, n_seg)
    first[-1] = min(first[-1], SEG - 38)  # every trigger lies below n

    def place(c):
        if 0 <= c < n:
            has[c // SEG], first[c // SEG] = True, c % SEG

    for b in range(n_rows):
        lo = own_lo + b * block_len
        has[max(0, (lo - 741) // SEG) : (lo + 3500) // SEG + 1] = False
        for c in (lo - 100, lo + GAP - 101, lo + 1580, lo + 1580 + GAP, lo + 1580 + 2 * GAP - 1):
            place(c)
    if empty_row is not None:
        s0 = rows.first_seg + empty_row * rows.step
        has[max(0, s0) : s0 + rows.span] = False
    seg_first = np.where(has, first, SEG).astype(np.int32)
    seg_count = np.where(has, rng.integers(1, 4, n_seg), 0).astype(np.int32)
    a = (rng.normal(0, 1, n) + 1j * rng.normal(0, 1, n)).astype(np.complex64)
    return torch.from_numpy(a), torch.from_numpy(seg_first), torch.from_numpy(seg_count), rows


def candidates_fed(seg_first: torch.Tensor, rows) -> int:
    """The ``detect_cands`` count of a call: the most candidates a row feeds
    to the suppression, at most 4·max_frames."""
    fed = 0
    for b in range(rows.n):
        s0 = rows.first_seg + b * rows.step
        segs = seg_first[max(0, s0) : s0 + rows.span]
        fed = max(fed, min(int((segs < SEG).sum()), 4 * rows.max_frames))
    return fed
