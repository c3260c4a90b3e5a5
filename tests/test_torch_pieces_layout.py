"""The data layouts of the CUDA kernels P1 and P3, emulated in torch on the
CPU and held exactly against their plain versions.

The kernels run only on a card; these emulations repeat what each thread of
them does, lane by lane, so an index mistake shows here first. P3
(kernels/csrc/viterbi_pieces.cu): which lane holds which state, the
shuffle sources, the costs read from the staged (s, d, d, s) values, the
decisions' sign, the ballot words and their interleave into w0 and w1, the
renormalization schedule (the chunk_t templates and the step counter), and
the stage and tile indexing at a B off every multiple of the frames per
block and at a T whose last stage is short. P1
(kernels/csrc/shuffle_pieces.cu): each variant on its layout (the
half-plane one and the quads, interleave's on its orbits), the rows a lane
holds, the shuffle sources and register moves of every step, and the
halving folded into an fma, at an odd step count.
"""
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu_torch.ops import shuffle_pieces, viterbi_pieces  # noqa: E402
from tests.torch_parity import THREADS  # noqa: E402,F401 (the one-thread pool)

# ---- P3 -------------------------------------------------------------------

POLY_A, POLY_B = 0o155, 0o117
S, F = 32, 8  # steps a stage, frames a block (viterbi_pieces.cu)
LANES = torch.arange(32)


def tap_sign(reg: int, poly: int) -> float:
    return 1.0 if bin(reg & poly).count("1") & 1 else -1.0


def cost_of(reg: int) -> tuple[float, bool]:
    """(g, is_s): the cost of register reg is g·s or g·d (cost_of)."""
    sa = tap_sign(reg, POLY_A)
    return -sa, sa == tap_sign(reg, POLY_B)


def lane_setup(repeat: bool) -> dict:
    """Per-lane constants of lane_setup, as (32,) tensors: lane u runs
    butterfly u."""
    ln = {k: [] for k in ("src1", "src2", "off", "g", "godd")}
    for u in range(32):
        odd = u & 1
        g2u, is_s = cost_of(2 * u)
        gx = -g2u if u >> 4 else g2u
        godd = -1.0 if odd else 1.0
        vals = ((u >> 1) + (16 if odd else 0), (u >> 1) + (0 if odd else 16), 0 if is_s else 1,
                gx * godd if repeat else gx, godd)
        for k, v in zip(ln, vals):
            ln[k].append(v)
    return {k: torch.tensor(v, dtype=torch.float32 if k in ("g", "godd") else torch.int64)
            for k, v in ln.items()}


def ballot(pred: torch.Tensor) -> torch.Tensor:
    """(frames, 32) bool → (frames,) int64 word, bit lane."""
    return (pred.to(torch.int64) << LANES).sum(-1)


def acs_step(variant: str, ln: dict, sd: torch.Tensor, x, y):
    """One warp step for every frame. sd: (frames, 4) the step's (s, d, d, s)."""
    c = sd[:, ln["off"]]  # (frames, 32): s or d by lane
    g = ln["g"]
    if variant == "norepeat":
        p, q, r, s = x + g * c, x - g * c, y - g * c, y + g * c
        dx, dy = q < p, s < r
    else:
        s1, s2 = x[:, ln["src1"]], y[:, ln["src2"]]
        p, q, r, s = s1 + g * c, s2 - g * c, s1 - g * c, s2 + g * c
        dx, dy = (q - p) * ln["godd"] < 0, (s - r) * ln["godd"] < 0
    x, y = torch.minimum(p, q), torch.minimum(r, s)
    if variant == "nopack":
        first = dx[:, 0].to(torch.int64)
        kept = torch.stack([first, torch.zeros_like(first)])
    else:
        kept = torch.stack([ballot(dx), ballot(dy)])
    return x, y, kept


def outer_shuffle(v: torch.Tensor) -> torch.Tensor:
    """outer_shuffle on int64 holding 32-bit words."""
    for m, k, keep in ((0x0000FF00, 8, 0xFF0000FF), (0x00F000F0, 4, 0xF00FF00F),
                       (0x0C0C0C0C, 2, 0xC3C3C3C3), (0x22222222, 1, 0x99999999)):
        v = ((v & m) << k) | ((v >> k) & m) | (v & keep)
    return v


def state_words(variant: str, kept: torch.Tensor):
    a, b = kept[..., 0], kept[..., 1]
    if variant == "nopack":
        return a, a
    lo = (a & 0xFFFF) | ((b & 0xFFFF) << 16)  # __byte_perm(a, b, 0x5410)
    hi = ((b >> 16) & 0xFFFF) | (((a >> 16) & 0xFFFF) << 16)  # __byte_perm(b, a, 0x7632)
    return outer_shuffle(lo), outer_shuffle(hi)


def emulate_acs_kernel(va, vb, variant: str, chunk_t: int):
    """acs_pieces_kernel on every block, stage by stage, as the card runs it."""
    t_steps, b = va.shape
    n_blocks = -(-b // F)
    frames = n_blocks * F
    n_stages = -(-t_steps // S)
    # the staged values: cp.async zero-fills past T and B, then (s, d, d, s)
    a = torch.zeros(n_stages * S, frames)
    c = torch.zeros(n_stages * S, frames)
    a[:t_steps, :b], c[:t_steps, :b] = va, vb
    s, d = a + c, a - c
    stage = torch.stack([s, d, d, s], -1)  # (steps, frames, 4)
    ln = lane_setup(variant != "norepeat")
    x = torch.full((frames, 32), 1e9)
    x[:, 0] = 0.0
    y = torch.full((frames, 32), 1e9)
    kept = torch.zeros(n_stages * S, frames, 2, dtype=torch.int64)
    k_chunk = chunk_t if chunk_t in (16, 32, 64) else 0

    def renormalize(x, y):  # by pm[0], lane 0's x
        return x - x[:, :1], y - x[:, :1]

    left = chunk_t
    for st in range(n_stages):
        t0 = st * S
        n = min(S, t_steps - t0)
        if n == S:
            for i in range(S):
                x, y, w = acs_step(variant, ln, stage[t0 + i], x, y)
                kept[t0 + i] = w.T
                if 0 < k_chunk <= S:
                    if (i + 1) % k_chunk == 0:
                        x, y = renormalize(x, y)
                elif k_chunk == 0:
                    left -= 1
                    if left == 0:
                        x, y = renormalize(x, y)
                        left = chunk_t
            if k_chunk > S and (st + 1) % (k_chunk // S) == 0:
                x, y = renormalize(x, y)
        else:
            to_go = chunk_t - t0 % chunk_t
            for i in range(n):
                x, y, w = acs_step(variant, ln, stage[t0 + i], x, y)
                kept[t0 + i] = w.T
                to_go -= 1
                if to_go == 0:
                    x, y = renormalize(x, y)
                    to_go = chunk_t
    # the tile write: thread (ei, ef) of block blk writes step t0 + ei of frame blk·F + ef
    w0 = torch.zeros(t_steps, b, dtype=torch.int64)
    w1 = torch.zeros_like(w0)
    ei, ef = torch.arange(S * F) // F, torch.arange(S * F) % F
    for st in range(n_stages):
        for blk in range(n_blocks):
            t, f = st * S + ei, blk * F + ef
            ok = (t < t_steps) & (f < b)
            a_w, b_w = state_words(variant, kept[t[ok], f[ok]])
            w0[t[ok], f[ok]], w1[t[ok], f[ok]] = a_w, b_w
    # the metrics: lane u holds rows 2u + (u >> 4), 2u + 1 − (u >> 4)
    rx, ry = 2 * LANES + (LANES >> 4), 2 * LANES + 1 - (LANES >> 4)
    pm = torch.empty(64, frames)
    pm[rx], pm[ry] = x.T, y.T
    to32 = viterbi_pieces.viterbi._to_int32_word
    return to32(w0), to32(w1), pm[:, :b]


def _values(t_steps: int, b: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    va, vb = torch.randn(t_steps, b, generator=g), torch.randn(t_steps, b, generator=g)
    va[torch.rand(t_steps, b, generator=g) < 0.2] = 0.0  # erasures: equal candidates
    return va, vb


def test_outer_shuffle_interleaves_the_halves():
    v = torch.tensor([1 << i for i in range(32)])
    want = torch.tensor([1 << (2 * i) for i in range(16)] + [1 << (2 * i + 1) for i in range(16)])
    assert torch.equal(outer_shuffle(v), want)


# chunk_t 16 with T = 80 ends on a 16-step stage; 24 takes the step counter and a
# short last stage, 3 a run shorter than one stage; B = 19 leaves 5 frames of the
# last block empty, B = 1 seven
@pytest.mark.parametrize("b", [19, 1])
@pytest.mark.parametrize("variant,chunk_t,t_steps", [
    ("full", 16, 80), ("full", 32, 96), ("full", 64, 128), ("full", 24, 72),
    ("full", 3, 9), ("nopack", 32, 96), ("nopack", 16, 80), ("norepeat", 32, 96),
    ("norepeat", 24, 72),
])
def test_acs_kernel_layout_matches_plain(variant, chunk_t, t_steps, b):
    va, vb = _values(t_steps, b, chunk_t + t_steps)
    got = emulate_acs_kernel(va, vb, variant, chunk_t)
    want = viterbi_pieces.viterbi_pieces_plain(va, vb, variant, chunk_t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- P1 -------------------------------------------------------------------

CYCLES = (1, 3, 5, 7, 11, 15, 33, 35, 37, 39, 43, 47)  # kCycles
FIXED = (0, 31, 32, 63)  # kFixed


def rotl5(r: int) -> int:
    return (r & 32) | ((r << 1) & 31) | ((r >> 4) & 1)


def lanes_per_column(variant: str) -> int:
    return 4 if variant in ("interleave", "roll8") else 32


def row_of(variant: str, j: int, m: int) -> int:
    if lanes_per_column(variant) == 32:
        return j + 32 * m
    if variant == "roll8":
        return 4 * m + j
    if m == 15:
        return FIXED[j]
    r = CYCLES[3 * j + m // 5]
    for _ in range(m % 5):
        r = rotl5(r)
    return r


def fma_half(a: torch.Tensor, c: float) -> torch.Tensor:
    """fmaf(a, 0.5, c) for c in {±0.5, ±1}: a/2 + c in float64, rounded to
    float32 once (exact in float64 where it can matter; where it is not, c or
    a/2 is far below half an ulp of the other, so the float32 result is the
    same)."""
    return (a.double() * 0.5 + c).float()


def p1_step(variant: str, r: torch.Tensor) -> torch.Tensor:
    """One step of every lane: r is (columns, lanes, slots)."""
    if variant == "baseline":
        return fma_half(r, 0.5)
    if variant == "repeat2":
        q = (r[..., 0] + r[..., 1]) * 0.5  # (columns, 32)
        j = torch.arange(32)
        return torch.stack([q[:, j >> 1], q[:, 16 + (j >> 1)]], -1)
    if variant == "concat":
        return torch.stack([r[..., 1] * 0.5, r[..., 0] * 0.5], -1)
    if variant == "halves":
        a, b = r[..., 0], r[..., 1]
        return torch.stack([torch.minimum(fma_half(a, 0.5), fma_half(b, 1.0)),
                            torch.minimum(fma_half(a, -0.5), fma_half(b, -1.0))], -1)
    if variant == "roll8":
        return r[..., [(m + 14) % 16 for m in range(16)]] * 0.5
    src = [5 * c + (p + 4) % 5 for c in range(3) for p in range(5)] + [15]  # interleave
    return r[..., src] * 0.5


def emulate_shuffle_kernel(x: torch.Tensor, variant: str, steps: int) -> torch.Tensor:
    g = lanes_per_column(variant)
    rows = torch.tensor([[row_of(variant, j, m) for m in range(64 // g)] for j in range(g)])
    assert sorted(rows.flatten().tolist()) == list(range(64))  # every row in one slot
    r = x.T[:, rows]  # (columns, lanes, slots)
    for _ in range(steps):
        r = p1_step(variant, r)
    out = torch.empty_like(x)
    out[rows] = r.permute(1, 2, 0)
    return out


@pytest.mark.parametrize("variant", shuffle_pieces.VARIANTS)
def test_shuffle_kernel_layout_matches_plain(variant):
    # 37 steps: odd, off every permutation's order, and not a multiple of the
    # unrolled 8 or 10; values spread so the fma folding meets every exponent
    x = torch.randn(64, 29, generator=torch.Generator().manual_seed(3))
    x *= torch.logspace(-30, 30, x.numel()).reshape(x.shape)
    want, _ = shuffle_pieces.shuffle_pieces_plain(x, variant, 37)
    assert torch.equal(emulate_shuffle_kernel(x, variant, 37), want)


def test_interleave_cycles_are_its_orbits():
    """The 12 cycles and 4 fixed rows cover the 64 rows, each cycle closed
    under the interleave's move of a row."""
    seen = set(FIXED)
    for c in CYCLES:
        orbit = [c]
        for _ in range(4):
            orbit.append(rotl5(orbit[-1]))
        assert rotl5(orbit[-1]) == c and not seen & set(orbit)
        seen |= set(orbit)
    assert seen == set(range(64)) and all(rotl5(r) == r for r in FIXED)
