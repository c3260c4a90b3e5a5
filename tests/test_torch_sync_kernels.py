"""The row gather K3 with its fused derotation and the detection front end
K2 of the port, on the CPU: the plain versions against the JAX package
(its Pallas kernels in interpret mode), and a numpy emulation of the CUDA
detection kernel's arithmetic (the per-warp rows with register carries, the
warm-up rows, the unpadded edges, the bit-count windows over ballot words)
against the plain version. The CUDA kernels themselves against their plain
versions: tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.config import OFDMConfig as JOFDMConfig  # noqa: E402
from jrc_tpu.ops import cplx as cx, detect_pallas as dp, sync as jsync  # noqa: E402
from jrc_tpu.ops.gather_pallas import gather_rows as j_gather_rows  # noqa: E402
from jrc_tpu_torch.config import OFDMConfig  # noqa: E402
from jrc_tpu_torch.ops import detect_cuda, gather_cuda, sync  # noqa: E402
from tests.torch_parity import THREADS  # noqa: E402,F401 (the one-thread pool)


def detect_kw(fft_len, cp_len, **over):
    sym_len = fft_len + cp_len
    kw = dict(threshold=0.6, min_n_peaks=10, max_peak_distance=2 * sym_len, lag=fft_len // 4,
              win=fft_len // 2, pwin=int(1.5 * (fft_len // 2)))
    kw.update(over)
    return kw


# ------------------------------------------------------------------ K3


def _stream(rng, n):
    xs = rng.normal(0, 1, (2, n)).astype(np.float32)
    return xs, torch.complex(torch.from_numpy(xs[0]), torch.from_numpy(xs[1]))


@pytest.mark.parametrize("with_n0", [False, True], ids=["coarse", "fine"])
@pytest.mark.parametrize("n,width,starts", [
    (8192, 383, None),  # unaligned random starts, an odd width
    (4096, 1168, [-5, 2920, 4090, 0, 17]),  # clamped like dynamic_slice
])
def test_gather_rot_plain_matches_reference(n, width, starts, with_n0):
    """gather_rows_plain with ``rot`` against the reference's gather (Pallas,
    interpret mode) rotated by its two phase expressions (jrc_tpu/ops/sync.py:
    −coarse·k from the trigger, (fine − coarse)·(frame_start + k) from the
    LTF), the float32 phase taken to exp(j·phase) in float64 by numpy:
    rtol = atol = 1e-5, a float32 cos/sin at phases up to about 30 rad.

    The rotation is not held against ``cx.expj``: in one process of a
    six-worker run, the rows rotated by it and the port's differed by up to
    4.3e-4 in 19% of the elements, while the same test passes alone; that
    process had loaded XLA:CPU executables from the persistent compile
    cache with the warning that they were compiled for another machine
    type."""
    rng = np.random.default_rng(11)
    xs, x = _stream(rng, n)
    if starts is None:
        starts = rng.integers(0, n - width, 13)
    starts = np.asarray(starts, np.int32)
    b = len(starts)
    omega = rng.uniform(-0.02, 0.02, b).astype(np.float32)
    n0 = rng.integers(0, 320, b).astype(np.int32)
    rows = j_gather_rows(cx.CArray(jnp.asarray(xs[0]), jnp.asarray(xs[1])), jnp.asarray(starts),
                         width, interpret=True)
    rows = np.asarray(rows.re) + 1j * np.asarray(rows.im)
    k = jnp.arange(width, dtype=jnp.float32)
    if with_n0:
        phase = jnp.asarray(omega)[:, None] * (jnp.asarray(n0).astype(jnp.float32)[:, None]
                                               + k[None, :])
    else:
        phase = jnp.asarray(omega)[:, None] * k[None, :]
    ref = rows * np.exp(1j * np.asarray(phase).astype(np.float64))
    rot = (torch.from_numpy(omega), torch.from_numpy(n0) if with_n0 else None)
    out = gather_cuda.gather_rows(x, torch.from_numpy(starts), width, rot=rot)
    assert out.shape == (b, width) and out.dtype == torch.complex64
    # the gathered rows are the reference's to the bit
    plain_rows = gather_cuda.gather_rows_plain(x, torch.from_numpy(starts), width)
    np.testing.assert_array_equal(plain_rows.numpy(), rows.astype(np.complex64))
    np.testing.assert_allclose(out.real.numpy(), ref.real, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.imag.numpy(), ref.imag, rtol=1e-5, atol=1e-5)
    # the rotation is the plain expression on them, held as the kernel is
    # (ROT_ATOL · max|x|): two float32 cos/sin evaluations need not take the
    # same vectorized or scalar route in every process
    kk = torch.arange(width, dtype=torch.float32)[None, :]
    if with_n0:
        kk = torch.from_numpy(n0).to(torch.float32)[:, None] + kk
    want = plain_rows * sync.expj(torch.from_numpy(omega)[:, None] * kk)
    assert (out - want).abs().max() <= gather_cuda.ROT_ATOL * x.abs().max()


@pytest.mark.parametrize("rot", [False, True], ids=["gather", "rotated"])
def test_gather_int64_and_int32_starts_give_the_same_rows(rot):
    rng = np.random.default_rng(12)
    _, x = _stream(rng, 5000)
    starts = rng.integers(-300, 5300, 40)
    n0 = rng.integers(0, 100, 40)
    omega = torch.from_numpy(rng.uniform(-0.02, 0.02, 40).astype(np.float32))
    outs = [gather_cuda.gather_rows(x, torch.from_numpy(starts.astype(t)), 383,
                                    rot=(omega, torch.from_numpy(n0.astype(t))) if rot else None)
            for t in (np.int64, np.int32)]
    assert torch.equal(outs[0], outs[1])
    if not rot:  # the pure gather is exact: the clamped slices themselves
        want = np.stack([x.numpy()[s : s + 383] for s in np.clip(starts, 0, 5000 - 383)])
        np.testing.assert_array_equal(outs[0].numpy(), want)


def test_gather_rot_zero_omega_is_the_pure_gather():
    rng = np.random.default_rng(13)
    _, x = _stream(rng, 3000)
    starts = torch.from_numpy(rng.integers(0, 2000, 9))
    out = gather_cuda.gather_rows(x, starts, 300, rot=(torch.zeros(9), starts))
    assert torch.equal(out, gather_cuda.gather_rows(x, starts, 300))


def test_gather_kernel_path_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(4096, dtype=torch.complex64, device="meta")
    s = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(TypeError, match="starts"):
        gather_cuda.gather_rows(x, s.to(torch.float32), 100)
    with pytest.raises(TypeError, match="omega"):
        gather_cuda.gather_rows(x, s, 100, rot=(torch.zeros(3, dtype=torch.float64, device="meta"), None))
    with pytest.raises(TypeError, match="n0"):
        gather_cuda.gather_rows(x, s, 100, rot=(torch.zeros(3, device="meta"),
                                                torch.zeros(4, dtype=torch.int64, device="meta")))
    with pytest.raises(TypeError, match="complex64"):
        gather_cuda.gather_rows(x.to(torch.complex128), s, 100)


def test_extract_frames_batch_takes_int32_triggers():
    """The call site hands K3 the triggers as they come: int32 and int64
    triggers give the same symbols, CFO and found flags, equal to the
    reference's on a two-frame stream."""
    cfg, jcfg = OFDMConfig(), JOFDMConfig()
    rng = np.random.default_rng(14)
    n_sym = 8
    x = (rng.normal(0, 0.05, 6000) + 1j * rng.normal(0, 0.05, 6000)).astype(np.complex64)
    ltf = np.asarray(cfg.lltf_time).astype(np.complex64)
    for pos in (400, 3100):  # two LTF copies at gap fft_len after a sync-length lead
        x[pos : pos + cfg.fft_len] += ltf
        x[pos + cfg.fft_len : pos + 2 * cfg.fft_len] += ltf
    trig = np.array([330, 3020, 5990, 0])
    cfo = rng.uniform(-3e-4, 3e-4, 4).astype(np.float32)
    got = [sync.extract_frames_batch(cfg, torch.from_numpy(x), torch.from_numpy(trig.astype(t)),
                                     torch.from_numpy(cfo), n_sym) for t in (np.int64, np.int32)]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    syms, total_cfo, found = got[0]
    r_syms, r_total, r_found = jsync.extract_frames_batch(
        jcfg, cx.from_complex(x), jnp.asarray(trig.astype(np.int32)), jnp.asarray(cfo), n_sym)
    assert found.tolist()[:2] == [True, True]
    np.testing.assert_array_equal(found.numpy(), np.asarray(r_found))
    np.testing.assert_allclose(total_cfo.numpy(), np.asarray(r_total), atol=1e-6)
    np.testing.assert_allclose(syms.numpy(), np.asarray(r_syms.re) + 1j * np.asarray(r_syms.im),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ K2

ROW, CHUNK = detect_cuda.ROW, detect_cuda.CHUNK_SEGS * detect_cuda.SEG
LANE = np.arange(ROW)
F32 = np.float32


def _shifted(cur, prev, sh):
    """detect.cu's shifted(): one shuffle of (this row | previous row)."""
    if sh == 0:
        return cur
    if sh == ROW:
        return prev
    assert 0 < sh < ROW
    return np.where(LANE < ROW - sh, cur, prev)[(LANE - sh) & (ROW - 1)]


class _WindowSum:
    """detect.cu's WindowSum: per level the previous row's value."""

    def __init__(self):
        self.prev = [np.zeros(ROW, F32) for _ in range(7)]

    def step(self, c, win):
        s, acc, shift = c, None, 0
        for level in range(7):
            w = 1 << level
            if w > win:
                break
            if win & w:
                part = _shifted(s, self.prev[level], shift)
                acc = part if acc is None else acc + part
                shift += w
            keep = s
            if 2 * w <= win:
                s = s + _shifted(s, self.prev[level], w)
            self.prev[level] = keep
        return acc


def _count_bits(words, lo, hi):
    """detect.cu's count_bits(): whole words plus two masked partial ones."""
    if hi < lo:
        return 0
    wlo, whi = lo >> 5, hi >> 5
    top = ((2 << (hi & 31)) - 1) & 0xFFFFFFFF
    if wlo == whi:
        return bin((int(words[wlo]) >> (lo & 31)) & (top >> (lo & 31))).count("1")
    c = bin(int(words[wlo]) >> (lo & 31)).count("1") + bin(int(words[whi]) & top).count("1")
    return c + sum(bin(int(words[w])).count("1") for w in range(wlo + 1, whi))


def _ballot(bits):
    return int(sum(1 << int(k) for k in np.nonzero(bits)[0]))


def emulate_detect_kernel(x, *, threshold, min_n_peaks, max_peak_distance, lag, win, pwin):
    """The CUDA kernel's arithmetic, block by block, warp by warp, row by
    row, in numpy float32 (each operation rounded once, as -fmad=false
    compiles it)."""
    n = len(x)
    xr, xi = x.real.astype(F32), x.imag.astype(F32)
    mpd = max_peak_distance
    margin = detect_cuda.margin_samples(mpd)
    warm = detect_cuda.warm_up_rows(win, pwin)
    rows = (CHUNK + margin) // ROW
    n_seg = -(-n // detect_cuda.SEG)
    a = np.full(n, np.nan + 1j * np.nan, np.complex64)
    first = np.full(n_seg, -1, np.int32)
    count = np.full(n_seg, -1, np.int32)

    skip = F32(0.3) * F32(threshold) * F32(threshold) if threshold > 0 else F32(-1.0)

    def load(g):
        ok = (g >= 0) & (g < n)
        gi = np.clip(g, 0, n - 1)
        return np.where(ok, xr[gi], F32(0)), np.where(ok, xi[gi], F32(0))

    for blk in range(-(-n // CHUNK)):
        g0 = blk * CHUNK - margin
        mask_w, trig_w = [0] * rows, [0] * rows
        for warp in range(detect_cuda.WARPS):
            r_lo, r_hi = rows * warp // detect_cuda.WARPS, rows * (warp + 1) // detect_cuda.WARPS
            s_re, s_im, s_pw = _WindowSum(), _WindowSum(), _WindowSum()
            first_row = r_lo - warm
            first_row -= (r_hi - first_row) & 1  # rows go two a turn
            for row in range(first_row, r_hi):
                g = g0 + row * ROW + LANE
                (cr, ci), (dr, di) = load(g), load(g - lag)
                are = s_re.step(cr * dr + ci * di, win)
                aim = s_im.step(ci * dr - cr * di, win)
                pws = s_pw.step(cr * cr + ci * ci, pwin)
                if row < r_lo:
                    continue
                # the shortcut: no square root or division where |a|² is out of
                # the threshold's reach
                q = are * are + aim * aim
                near = (g < n) & ~(q < skip * (pws * pws))
                p = pws / F32(1.5)
                with np.errstate(divide="ignore", invalid="ignore"):
                    cor = np.sqrt(q) / np.maximum(p, F32(1e-12))
                m = near & (cor > F32(threshold)) & (cor < F32(2.0))
                mask_w[row] = _ballot(m)
                if row >= margin // ROW:
                    own = g < n
                    a[g[own]] = (are + 1j * aim)[own]
        for row in range(rows):
            if mask_w[row]:
                tg = [(mask_w[row] >> ln) & 1 and
                      _count_bits(mask_w, max(row * ROW + ln - mpd + 1, 0), row * ROW + ln) > min_n_peaks
                      for ln in range(ROW)]
                trig_w[row] = _ballot(np.array(tg, bool))
        for seg in range(detect_cuda.CHUNK_SEGS):
            gseg = blk * detect_cuda.CHUNK_SEGS + seg
            if gseg >= n_seg:
                continue
            seg_first, seg_count = detect_cuda.SEG, 0
            for q in range(detect_cuda.SEG // ROW):
                row = margin // ROW + seg * (detect_cuda.SEG // ROW) + q
                if not trig_w[row]:
                    continue
                keep = [(trig_w[row] >> ln) & 1 and
                        _count_bits(trig_w, max(row * ROW + ln - mpd + 1, 0), row * ROW + ln - 1) == 0
                        for ln in range(ROW)]
                bal = _ballot(np.array(keep, bool))
                if seg_first == detect_cuda.SEG and bal:
                    seg_first = q * ROW + (bal & -bal).bit_length() - 1
                seg_count += bin(bal).count("1")
            first[gseg], count[gseg] = seg_first, seg_count
    return a, first, count


def _plateaus(rng, n, period, positions, noise=0.1):
    """STF-like plateaus (a ``period``-sample block repeated) in noise."""
    x = rng.normal(0, noise, n) + 1j * rng.normal(0, noise, n)
    block = rng.normal(0, 1, period) + 1j * rng.normal(0, 1, period)
    for pos in positions:
        if 0 <= pos < n:
            end = min(n, pos + 50 * period)
            x[pos:end] = np.tile(block, 50)[: end - pos]
    return x.astype(np.complex64)


@pytest.mark.parametrize("fft_len,cp_len", [(64, 16), (128, 32)], ids=["mpd160", "mpd320"])
@pytest.mark.parametrize("n,kind", [
    (2 * 4096 + 77, "plateaus"),  # off every multiple of 32, 128 and 4096
    (4096, "plateaus"),  # exactly one chunk
    (4096 + 1, "plateaus"),  # a second chunk of one sample
    (200, "plateaus"),  # below the margin
    (31, "noise"),  # below one warp row
    (6000, "noise"),  # a random mask at a threshold where noise triggers now and then
])
def test_detect_kernel_emulation_matches_plain(fft_len, cp_len, n, kind):
    """Triggers, first and count exactly equal and ``a`` bit for bit."""
    rng = np.random.default_rng(n + fft_len)
    if kind == "plateaus":
        x = _plateaus(rng, n, fft_len // 4, (60, 3900, n // 2 - 200, n - 700))
        kw = detect_kw(fft_len, cp_len)
    else:
        x = _plateaus(rng, n, fft_len // 4, (), noise=1.0)
        thr, peaks = {64: (0.3, 20), 128: (0.2, 10)}[fft_len]
        kw = detect_kw(fft_len, cp_len, threshold=thr, min_n_peaks=peaks)
    a_p, first_p, count_p = detect_cuda.detect_front_end_plain(torch.from_numpy(x), **kw)
    a_e, first_e, count_e = emulate_detect_kernel(x, **kw)
    if n >= 4096:  # the stream did trigger
        assert int(count_p.sum()) >= (1 if kind == "plateaus" else 5)
    np.testing.assert_array_equal(first_e, first_p.numpy())
    np.testing.assert_array_equal(count_e, count_p.numpy())
    a_p = a_p.numpy()
    np.testing.assert_array_equal(a_e.real.view(np.uint32), a_p.real.copy().view(np.uint32))
    np.testing.assert_array_equal(a_e.imag.view(np.uint32), a_p.imag.copy().view(np.uint32))


@pytest.mark.parametrize("threshold", [0.6, 0.15, 1.9])
def test_detect_shortcut_never_drops_a_passing_sample(threshold):
    """The kernel takes the square root and the divisions only where
    |a|² ≥ 0.3·threshold²·(window power)²: no sample that passes the full
    test lies below that, over 30 decades of power, and most of those well
    below the threshold do."""
    rng = np.random.default_rng(int(threshold * 100))
    m = 200_000
    pws = (10.0 ** rng.uniform(-20, 10, m)).astype(F32)
    cor_aimed = rng.uniform(0.0, 1.5 * threshold, m)
    mag = cor_aimed * (pws.astype(np.float64) / 1.5)
    angle = rng.uniform(0, 2 * np.pi, m)
    are, aim = (mag * np.cos(angle)).astype(F32), (mag * np.sin(angle)).astype(F32)
    q = are * are + aim * aim
    skipped = q < (F32(0.3) * F32(threshold) * F32(threshold)) * (pws * pws)
    with np.errstate(over="ignore", invalid="ignore"):
        cor = np.sqrt(q) / np.maximum(pws / F32(1.5), F32(1e-12))
    passing = (cor > F32(threshold)) & (cor < F32(2.0))
    assert passing.sum() > 1000
    assert not (skipped & passing).any()
    assert skipped[cor_aimed < 0.7 * threshold].mean() > 0.9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bit_count_window_equals_float_moving_sum(seed):
    """A count of set bits over the trailing window of packed 32-bit words
    equals sync.moving_sum of the 0/1 floats exactly, for any window."""
    rng = np.random.default_rng(seed)
    n = 32 * 40
    bits = rng.random(n) < (0.05, 0.5, 0.95)[seed]
    words = [_ballot(bits[r * ROW : (r + 1) * ROW]) for r in range(n // ROW)]
    for mpd in (1, 31, 32, 33, 160, 320, 500):
        want = sync.moving_sum(torch.from_numpy(bits.astype(np.float32)), mpd).numpy()
        got = [_count_bits(words, max(i - mpd + 1, 0), i) for i in range(n)]
        np.testing.assert_array_equal(np.asarray(got, np.float32), want)


@pytest.mark.parametrize("win,fits", [(32, True), (48, True), (64, True), (96, True), (1, True),
                                      (63, True), (97, False), (127, False), (128, False),
                                      (0, False)])
def test_detect_window_fits(win, fits):
    """The kernel's chain reaches back at most one warp row a step."""
    assert detect_cuda.window_fits(win) is fits
    if fits:  # the emulated chain then equals the plain moving sum, bit for bit
        x = np.random.default_rng(win).normal(0, 1, 32 * 9).astype(np.float32)
        ws = _WindowSum()
        got = np.concatenate([ws.step(x[r * ROW : (r + 1) * ROW], win) for r in range(9)])
        want = sync.moving_sum(torch.from_numpy(x), win).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_detect_kernel_path_rejects_a_window_it_does_not_take():
    x = torch.zeros(4096, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="window"):
        detect_cuda.detect_front_end(x, **detect_kw(256, 64))
    assert detect_cuda.margin_samples(160) == 320 and detect_cuda.margin_samples(320) == 640
    assert detect_cuda.warm_up_rows(32, 48) == 2 and detect_cuda.warm_up_rows(64, 96) == 3


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_detect_plain_matches_pallas_at_fft_len_128(n_chunks):
    """The fft_len-128 numerology (lag 32, windows 64 and 96,
    max_peak_distance 320) through the Pallas kernel in interpret mode."""
    n = n_chunks * dp.CHUNK_ROWS * dp.LANE
    x = _plateaus(np.random.default_rng(n_chunks), n, 32, (1000, 9000, n // 2 - 400, n - 6000))
    kw = detect_kw(128, 32)
    assert kw == detect_kw(JOFDMConfig(fft_len=128, cp_len=32).fft_len, 32)
    xp = cx.from_complex(jnp.asarray(x))
    a_re, a_im, first, count = dp.detect_front_end(xp.re, xp.im, interpret=True, **kw)
    a, first_t, count_t = detect_cuda.detect_front_end_plain(torch.from_numpy(x), **kw)
    n_seg = -(-n // 128)
    assert int(count_t.sum()) >= 4  # the plateaus did trigger
    np.testing.assert_array_equal(first_t.numpy(), np.asarray(first[:n_seg]))
    np.testing.assert_array_equal(count_t.numpy(), np.asarray(count[:n_seg]))
    np.testing.assert_allclose(a.real.numpy(), np.asarray(a_re[:n]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.imag.numpy(), np.asarray(a_im[:n]), rtol=1e-5, atol=1e-5)
