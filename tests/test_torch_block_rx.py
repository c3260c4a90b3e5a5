"""Parity of the port's per-block RX with jrc_tpu on the CPU: ``rx_block``
(one block and a batch of independent windows), and the windowed
(``batched=True`` with ``block_len`` off every multiple of 128) and
sequential (``batched=False``) branches of ``scan_rx`` and
``scan_rx_dynamic``, on three blocks of 8192 or 8200 samples.

The static capture holds the eviction case of tests/test_streaming.py:89
(a trigger just before block 1 within ``ignore_gap``, block 1 at its slot
capacity) and frames across both block boundaries; it runs through the
flat path at 8192 and the windowed and sequential paths at 8200. The
dynamic capture holds a mixed-MCS block with an NDP frame, a block whose
every slot is an NDP frame and a block with no frame at all.

Tolerances: valid, start, CRC, SIG, MCS, packet type, length, chan_est_ok
and the payload bytes of every slot exactly equal; SNRs within 1e-3 dB on
valid slots, chan_est within 1e-5 · max|h| where live (torch.fft and
complex division round differently from the reference's DFT matmul).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.models import streaming as jst  # noqa: E402
from jrc_tpu_torch import capture, tables  # noqa: E402
from jrc_tpu_torch.models import streaming as tst  # noqa: E402
from tests.torch_parity import CFG, JCFG, np_of, specs, t  # noqa: E402

MIXED = capture.load_mixed_frames()
#: the eviction case's frame (a QPSK-1/2 DATA frame of 64 bytes, 1680 samples)
FRAME = MIXED[2]
SPEC, JSPEC = specs(FRAME.mcs, len(FRAME.payload))
MAXP = 96
N_BLOCKS = 3


def _capture(placed, n_samples: int, seed: int) -> np.ndarray:
    """``(position, frame)`` pairs over AWGN 25 dB below the frames' power."""
    rng = np.random.default_rng(seed)
    power = np.mean(np.abs(np.concatenate([f for _, f in placed])) ** 2)
    sigma = np.sqrt(power / 10 ** 2.5 / 2)
    cap = (rng.normal(0, sigma, (n_samples, 2)) @ [1, 1j]).astype(np.complex64)
    for pos, f in placed:
        cap[pos : pos + len(f)] += f
    return cap


@pytest.fixture(scope="module")
def static_capture():
    """Block 0: a frame, and one whose trigger sits 400 samples before block
    1 (within ignore_gap = 640, across the boundary); block 1: two frames,
    its slot capacity; block 2: a frame and one across the end of the
    blocks into the halo."""
    f = FRAME.samples
    positions = np.array([500, 8192 - 400, 8192 + 1400, 8192 + 3300, 2 * 8192 + 2000,
                          3 * 8192 - 500])
    halo = tst.frame_window_samples(CFG, SPEC) + CFG.fft_len
    return _capture([(p, f) for p in positions], N_BLOCKS * 8200 + halo, seed=7), positions


@pytest.fixture(scope="module")
def dynamic_capture():
    """Block 0: BPSK-1/2, BPSK-3/4 and QPSK-1/2 DATA frames (its three
    slots); block 1: three NDP frames (every slot NDP); block 2: none."""
    d, ndp = [MIXED[k].samples for k in (0, 1, 2)], MIXED[6].samples
    placed = [(300, d[0]), (2400, d[1]), (5400, d[2])]
    placed += [(8192 + p, ndp) for p in (300, 2100, 3900)]
    halo = tst.frame_window_samples_dynamic(CFG, MAXP) + CFG.fft_len
    return _capture(placed, N_BLOCKS * 8200 + halo, seed=8)


def _same(ours, ref, fields, *, floats=("snr_db",), chan_est=False):
    for f in fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    valid = ours.valid.numpy()
    for f in floats:
        np.testing.assert_allclose(getattr(ours, f).numpy()[valid],
                                   np.asarray(getattr(ref, f))[valid], rtol=0, atol=1e-3,
                                   err_msg=f)
    if chan_est:
        live = ours.chan_est_ok.numpy()
        h_ref = np_of(ref.chan_est)[live]
        np.testing.assert_allclose(ours.chan_est.numpy()[live], h_ref, rtol=0,
                                   atol=1e-5 * np.abs(h_ref).max())


STATIC_BRANCHES = [(8192, True), (8200, True), (8200, False)]
DYNAMIC_BRANCHES = [(8200, True), (8192, False)]
RX_BLOCK_LEN = 32768


def _rx_block_capture():
    frame, _, halo = capture.load_bench_frame()
    return capture.build_capture(frame, RX_BLOCK_LEN, halo=halo)


@pytest.fixture(scope="module")
def references(static_capture, dynamic_capture):
    """jrc_tpu's results of every case, jitted and compiled four at a time in
    threads (XLA compiles outside the interpreter lock) → {case: future}."""
    def static(block_len, batched):
        return jax.jit(lambda x: jst.scan_rx(JCFG, JSPEC, x, block_len, N_BLOCKS,
                                             max_frames_per_block=2, batched=batched))(
            jnp.asarray(static_capture[0]))

    def dynamic(block_len, batched):
        return jax.jit(lambda x: jst.scan_rx_dynamic(
            JCFG, x, block_len, N_BLOCKS, max_frames_per_block=3, max_payload=MAXP,
            batched=batched))(jnp.asarray(dynamic_capture))

    def rx_block():
        return jax.jit(lambda x: jst.rx_block(JCFG, specs(3, 64)[1], x, RX_BLOCK_LEN,
                                              max_frames=16))(jnp.asarray(_rx_block_capture()[0]))

    with ThreadPoolExecutor(4) as pool:
        futures = {("static", *b): pool.submit(static, *b) for b in STATIC_BRANCHES}
        futures.update({("dynamic", *b): pool.submit(dynamic, *b) for b in DYNAMIC_BRANCHES})
        futures["rx_block"] = pool.submit(rx_block)
        yield futures


STATIC_FIELDS = ("valid", "start", "crc_ok", "sig_ok", "payload")
DYNAMIC_FIELDS = STATIC_FIELDS + ("mcs", "packet_type_bit", "payload_len", "chan_est_ok")


def test_rx_block_matches_reference(references):
    """The tests/test_streaming.py:79 case (one 32768-sample block of bench
    frames, a zero halo, 16 slots) on both packages; a batch of two windows
    equals each window on its own (SNR within 1e-4 dB)."""
    cap, n_frames = _rx_block_capture()
    block_len = RX_BLOCK_LEN
    ours = tst.rx_block(CFG, specs(3, 64)[0], tables.from_numpy(CFG, specs(3, 64)[0], "cpu"),
                        t(cap), block_len, max_frames=16)
    _same(ours, references["rx_block"].result(), STATIC_FIELDS)
    assert int(ours.valid.sum()) == int(ours.crc_ok.sum()) == n_frames

    spec = specs(3, 64)[0]
    tab = tables.from_numpy(CFG, spec, "cpu")
    other = np.roll(cap, -5000)
    both = tst.rx_block(CFG, spec, tab, t(np.stack([cap, other])), block_len, max_frames=16,
                        own_lo=100)
    for row, x in enumerate((cap, other)):
        one = tst.rx_block(CFG, spec, tab, t(x), block_len, max_frames=16, own_lo=100)
        for f in ("payload", "crc_ok", "sig_ok", "start", "valid"):
            assert torch.equal(getattr(both, f)[row], getattr(one, f)), f
        # the CPU's reductions round by batch size: the SNR of a batch of 32 slots
        # and of 16 may differ in the last bits
        np.testing.assert_allclose(both.snr_db[row].numpy(), one.snr_db.numpy(), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("block_len,batched", STATIC_BRANCHES,
                         ids=["flat-8192", "windowed-8200", "sequential-8200"])
def test_scan_rx_branches_match_reference(static_capture, references, block_len, batched):
    cap, positions = static_capture
    tab = tables.from_numpy(CFG, SPEC, "cpu")
    ours = tst.scan_rx(CFG, SPEC, tab, t(cap), block_len, N_BLOCKS, max_frames_per_block=2,
                       batched=batched)
    _same(ours, references["static", block_len, batched].result(), STATIC_FIELDS)
    # every frame decodes once, none evicted by the pre-block trigger, the
    # last one from the halo past the blocks
    valid = ours.valid.numpy()
    got = np.sort(ours.start.numpy()[valid])
    assert ours.crc_ok.numpy()[valid].all()
    assert len(got) == len(positions)
    assert ((got - positions >= 0) & (got - positions <= CFG.fft_len)).all(), got

    model = tst.StreamingRx(CFG, SPEC, block_len, N_BLOCKS, max_frames_per_block=2,
                            batched=batched, device="cpu")
    res = model(t(cap))
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(ours, f)), f


@pytest.mark.parametrize("block_len,batched", DYNAMIC_BRANCHES,
                         ids=["windowed-8200", "sequential-8192"])
def test_scan_rx_dynamic_branches_match_reference(dynamic_capture, references, block_len,
                                                  batched):
    cap = dynamic_capture
    tab = tables.from_numpy_dynamic(CFG, MAXP, "cpu")
    ours = tst.scan_rx_dynamic(CFG, tab, t(cap), block_len, N_BLOCKS, max_frames_per_block=3,
                               max_payload=MAXP, batched=batched)
    ref = references["dynamic", block_len, batched].result()
    _same(ours, ref, DYNAMIC_FIELDS, floats=("snr_db", "snr_data_db"), chan_est=True)
    valid = ours.valid.numpy().reshape(N_BLOCKS, 3)
    assert valid[:2].all() and not valid[2].any()  # block 2 holds no frame
    assert int(ours.crc_ok.sum()) == 6
    assert ours.chan_est_ok.numpy().reshape(N_BLOCKS, 3)[1].all()  # every slot of block 1 NDP
    np.testing.assert_array_equal(ours.mcs.numpy().reshape(N_BLOCKS, 3)[0],
                                  [MIXED[k].mcs for k in (0, 1, 2)])
    for slot, k in enumerate((0, 1, 2)):
        n = len(MIXED[k].payload)
        np.testing.assert_array_equal(ours.payload[slot, :n].numpy(), MIXED[k].payload)

    model = tst.StreamingRxDynamic(CFG, block_len, N_BLOCKS, max_frames_per_block=3,
                                   max_payload=MAXP, batched=batched, device="cpu")
    res = model(t(cap))
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(ours, f)), f


def test_rx_block_dynamic_with_no_frame_and_all_ndp(dynamic_capture):
    """The per-MCS grouping on a block with no owned frame (every slot a
    free one over noise) and on one whose every slot is NDP: each block alone
    equals its slots of the sequential scan."""
    cap = dynamic_capture
    tab = tables.from_numpy_dynamic(CFG, MAXP, "cpu")
    scan = tst.scan_rx_dynamic(CFG, tab, t(cap), 8192, N_BLOCKS, max_frames_per_block=3,
                               max_payload=MAXP, batched=False)
    left = tst.left_history_samples(CFG)
    window = left + 8192 + tst.frame_window_samples_dynamic(CFG, MAXP) + CFG.fft_len
    xp = np.concatenate([np.zeros(left, np.complex64), cap])
    for b in (1, 2):
        one = tst.rx_block_dynamic(CFG, tab, t(xp[b * 8192 : b * 8192 + window]), 8192,
                                   own_lo=left, max_frames=3, max_payload=MAXP)
        sl = slice(3 * b, 3 * b + 3)
        for f in one._fields:
            want = getattr(scan, f)[sl]
            if f == "start":
                want = torch.where(want >= 0, want - b * 8192, -1)
            assert torch.equal(getattr(one, f), want), (b, f)


def test_decode_payload_dynamic_matches_reference():
    """Equalized symbols of frames of every MCS (noisy constellation points,
    zero past each frame) through demap, ONE Viterbi pass and the CRC:
    bytes and CRC flags equal to the reference's per-frame decode."""
    from jrc_tpu.ops import dynamic_rx as jdyn
    from jrc_tpu.ops import cplx as cx
    from jrc_tpu_torch.ops import dynamic_rx

    rng = np.random.default_rng(21)
    mcs = np.arange(6).repeat(2)
    n_bytes = rng.integers(4, MAXP + 5, len(mcs))
    max_n_sym = dynamic_rx.max_symbols(MAXP)
    n_sym, _ = jdyn.frame_geometry(jnp.asarray(mcs), jnp.asarray(n_bytes))
    z = (rng.choice([-1.0, 1.0], (len(mcs), max_n_sym, 48, 2)) * 0.7
         + rng.normal(0, 0.2, (len(mcs), max_n_sym, 48, 2))) @ [1, 1j]
    z = z.astype(np.complex64)
    z[np.arange(max_n_sym)[None, :] >= np.asarray(n_sym)[:, None]] = 0
    pdu, ok = dynamic_rx.decode_payload_dynamic(CFG, tables.from_numpy_dynamic(CFG, MAXP, "cpu"),
                                                t(z), t(mcs), t(n_bytes), MAXP)
    r_pdu, r_ok = jax.jit(jax.vmap(lambda zz, m, nb: jdyn.decode_payload_dynamic(
        JCFG, zz, m, nb, MAXP)))(cx.from_complex(z), jnp.asarray(mcs, jnp.int32),
                                 jnp.asarray(n_bytes, jnp.int32))
    np.testing.assert_array_equal(pdu.numpy(), np.asarray(r_pdu))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(r_ok))


@pytest.mark.parametrize("strict_runs", [False, True], ids=["gap-tolerant", "strict"])
def test_detect_frames_on_a_batch_of_windows_equals_each_window(dynamic_capture, strict_runs):
    """``detect_frames`` on (n_windows, n) equals it on each window alone,
    every field and the candidate counts (the windowed route's detection)."""
    from jrc_tpu_torch.ops import sync

    windows = t(np.stack([dynamic_capture[:9000], dynamic_capture[7000:16000]]))
    kw = dict(max_frames=3, strict_runs=strict_runs, own_window=(384, 8000))
    both = sync.detect_frames(CFG, windows, **kw)
    for row in range(2):
        one = sync.detect_frames(CFG, windows[row], **kw)
        for f in one._fields:
            assert torch.equal(getattr(both, f)[row], getattr(one, f)), f
    assert int(both.valid.sum()) > 0
