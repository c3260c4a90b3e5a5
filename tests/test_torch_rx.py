"""Parity of the PyTorch port's RX chain with jrc_tpu on the CPU: module by
module, then the whole static-spec slice (scan_rx) on the bench capture,
and the owned-frame eviction case (all six MCS: test_torch_rx_mcs.py).

Tolerances: bits, triggers, starts, CRC flags and payloads exactly equal;
float outputs within the stated tolerance, because torch.fft, complex
division and libm's sin/cos round differently from the reference's DFT
matmul at HIGHEST precision and XLA's own kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import zlib

torch = pytest.importorskip("torch")

import bench  # noqa: E402
from jrc_tpu.config import MCS  # noqa: E402
from jrc_tpu.ops import (  # noqa: E402
    coding as jcoding, cplx as cx, decoder as jdec, equalizer as jeq,
    modulation as jmod, ofdm as jofdm, sync as jsync,
)
from jrc_tpu_torch.models import streaming as tst  # noqa: E402
from jrc_tpu_torch.ops import (  # noqa: E402
    coding, decoder, equalizer, modulation, ofdm, sync,
)
from tests.torch_parity import (  # noqa: E402
    CFG, JCFG, assert_same_rx, cplx as _cplx, jax_scan_rx, np_of as _np, specs as _specs,
    t as _t, tab as _tab, tx_frame,
)

BENCH_MCS, BENCH_BYTES = MCS.QPSK_3_4, 64


# ---------------------------------------------------------------- coding


def test_descramble_and_seed_recovery_match():
    rng = np.random.default_rng(0)
    spec, _ = _specs(BENCH_MCS, BENCH_BYTES)
    tab = _tab(spec)
    n = spec.packet_params.n_data_bits
    bits = rng.integers(0, 2, (5, n)).astype(np.uint8)
    np.testing.assert_array_equal(
        coding.descramble(_t(bits), tab.descramble_basis).numpy(),
        np.asarray(jcoding.descramble(jnp.asarray(bits))))
    # every TX seed is recovered from its scrambled all-zero SERVICE field
    seeds = np.arange(1, 128)
    scrambled = np.stack([np.asarray(jcoding.scramble(jnp.zeros(n, jnp.uint8), s)) for s in seeds])
    got = coding.recover_scrambler_seed(_t(scrambled), tab.scrambler_phase, tab.scrambler_state_at)
    np.testing.assert_array_equal(got.numpy(), seeds)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcoding.recover_scrambler_seed(jnp.asarray(scrambled))))


@pytest.mark.parametrize("mcs", [MCS.QPSK_1_2, MCS.QPSK_3_4])
def test_depuncture_matches(mcs):
    n_coded = 2 * 216
    mask = coding.depuncture_mask(mcs, n_coded)
    np.testing.assert_array_equal(mask, jcoding.depuncture_mask(mcs, n_coded))
    vals = np.random.default_rng(1).normal(size=(3, int(mask.sum()))).astype(np.float32)
    np.testing.assert_array_equal(
        coding.depuncture(_t(vals), mcs, n_coded, erasure=0.0).numpy(),
        np.asarray(jcoding.depuncture(jnp.asarray(vals), mcs, n_coded, erasure=0.0)))


def test_crc_and_byte_packing_match():
    rng = np.random.default_rng(2)
    spec, _ = _specs(BENCH_MCS, BENCH_BYTES)
    tab = _tab(spec)
    payloads = rng.integers(0, 256, (6, BENCH_BYTES)).astype(np.uint8)
    pdus = np.stack([
        np.concatenate([p, np.frombuffer(zlib.crc32(p.tobytes()).to_bytes(4, "little"), np.uint8)])
        for p in payloads])
    pdus[3, 10] ^= 0x40  # corrupted frames fail
    pdus[5, -1] ^= 0x01
    ok = coding.crc32_check_residue(_t(pdus), tab.crc_T, tab.crc_E).numpy()
    np.testing.assert_array_equal(ok, [True, True, True, False, True, False])
    np.testing.assert_array_equal(ok, np.asarray(jcoding.crc32_check_residue(jnp.asarray(pdus))))
    bits = rng.integers(0, 2, (4, 8 * 9)).astype(np.uint8)
    np.testing.assert_array_equal(coding.bits_to_bytes(_t(bits)).numpy(),
                                  np.asarray(jcoding.bits_to_bytes(jnp.asarray(bits))))
    for n_bpsc in (1, 2, 4):
        vals = rng.integers(0, 2**n_bpsc, (3, 48)).astype(np.int32)
        np.testing.assert_array_equal(
            coding.merge_symbols(_t(vals), n_bpsc).numpy(),
            np.asarray(jcoding.merge_symbols(jnp.asarray(vals), n_bpsc)))


# ------------------------------------------------------------ modulation


@pytest.mark.parametrize("mcs", [MCS.BPSK_1_2, MCS.QPSK_3_4, MCS.QAM16_3_4])
def test_constellation_and_hard_decision_match(mcs):
    n_bpsc = _specs(mcs, 1)[0].mcs_params.n_bpsc
    for tx_scale in (False, True):
        np.testing.assert_array_equal(modulation.constellation(n_bpsc, tx_scale),
                                      jmod.constellation(n_bpsc, tx_scale))
    z = 0.8 * _cplx(np.random.default_rng(3), 4, 96)
    got = modulation.hard_decision(_t(z), _t(modulation.constellation(n_bpsc))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmod.hard_decision(cx.from_complex(z), mcs)))


# ------------------------------------------------------------------ ofdm


def test_fft_symbols_match():
    x = _cplx(np.random.default_rng(4), 3, 17, CFG.fft_len)
    got = ofdm.fft_symbols(CFG, _t(x)).numpy()
    want = _np(jofdm.fft_symbols(JCFG, cx.from_complex(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    tab = _tab(_specs(BENCH_MCS, BENCH_BYTES)[0])
    np.testing.assert_array_equal(ofdm.extract_data_carriers(_t(x), tab.data_idx).numpy(),
                                  _np(jofdm.extract_data_carriers(JCFG, cx.from_complex(x))))
    np.testing.assert_array_equal(ofdm.extract_pilot_carriers(_t(x), tab.pilot_idx).numpy(),
                                  _np(jofdm.extract_pilot_carriers(JCFG, cx.from_complex(x))))


# ------------------------------------------------------------- equalizer


def test_equalize_frame_matches():
    spec, jspec = _specs(BENCH_MCS, BENCH_BYTES)
    rng = np.random.default_rng(5)
    n_total = 3 + CFG.n_ltf + spec.n_ofdm_sym
    grid = _cplx(rng, 4, n_total, CFG.fft_len)
    cfo = rng.normal(0, 0.002, 4).astype(np.float32)
    eq = equalizer.equalize_frame(CFG, spec, _tab(spec), _t(grid), _t(cfo))
    ref = jax.vmap(lambda g, c: jeq.equalize_frame(JCFG, jspec, g, c))(
        cx.from_complex(grid), jnp.asarray(cfo))
    np.testing.assert_allclose(eq.z.numpy(), _np(ref.z), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(eq.snr_legacy.numpy(), np.asarray(ref.snr_legacy), atol=1e-3)
    np.testing.assert_allclose(eq.snr_data.numpy(), np.asarray(ref.snr_data), atol=1e-3)
    for f in ("sig_rate_bitmap", "sig_length", "sig_ptype", "sig_ok"):
        np.testing.assert_array_equal(getattr(eq, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)


# --------------------------------------------------------------- decoder


@pytest.mark.parametrize("mcs", [MCS.QPSK_3_4, MCS.QAM16_1_2])
def test_frame_values_match(mcs):
    spec, jspec = _specs(mcs, 40)
    z = _cplx(np.random.default_rng(6), 3, spec.n_ofdm_sym, 48)
    np.testing.assert_array_equal(
        decoder.frame_values(spec, _tab(spec), _t(z)).numpy(),
        np.asarray(jdec.frame_values(jspec, cx.from_complex(z))))


def test_frame_from_bits_matches():
    spec, jspec = _specs(BENCH_MCS, BENCH_BYTES)
    pp = spec.packet_params
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, BENCH_BYTES).astype(np.uint8)
    pdu = np.concatenate([payload, np.frombuffer(
        zlib.crc32(payload.tobytes()).to_bytes(4, "little"), np.uint8)])
    bits = np.zeros(pp.n_data_bits, np.uint8)
    bits[16 : 16 + 8 * len(pdu)] = np.asarray(jcoding.bytes_to_bits(jnp.asarray(pdu)))
    frames = np.stack([np.asarray(jcoding.scramble(jnp.asarray(bits), 5)),
                       rng.integers(0, 2, pp.n_data_bits).astype(np.uint8)])
    got = decoder.frame_from_bits(spec, _tab(spec), _t(frames))
    ref = jdec.frame_from_bits(jspec, jnp.asarray(frames))
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(ref.payload))
    np.testing.assert_array_equal(got.crc_ok.numpy(), np.asarray(ref.crc_ok))
    np.testing.assert_array_equal(got.scrambler_seed.numpy(), np.asarray(ref.scrambler_seed))
    np.testing.assert_array_equal(got.payload[0].numpy(), payload)
    assert got.crc_ok.tolist() == [True, False] and int(got.scrambler_seed[0]) == 5


# ------------------------------------------------------------------ sync


@pytest.fixture(scope="module")
def bench_capture():
    """bench.build_capture at 4 blocks of 2^13 samples (9 frames)."""
    _, jspec = _specs(BENCH_MCS, BENCH_BYTES)
    cap, n_frames = bench.build_capture(JCFG, jspec, 4 * 2**13)
    return cap, n_frames


def test_moving_sum_and_autocorrelation_match():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 3000)).astype(np.float32)
    for win in (5, 32, 48, 160):
        np.testing.assert_array_equal(sync.moving_sum(_t(x), win).numpy(),
                                      np.asarray(jsync.moving_sum(jnp.asarray(x), win)))
    z = _cplx(rng, 3000)
    a, cor = sync.autocorrelation(CFG, _t(z))
    a_ref, cor_ref = jsync.autocorrelation(JCFG, cx.from_complex(z))
    np.testing.assert_allclose(a.numpy(), _np(a_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cor.numpy(), np.asarray(cor_ref), rtol=1e-5, atol=1e-5)


def test_detect_and_extract_match(bench_capture):
    cap, n_frames = bench_capture
    block_len, n_blocks, mf = 2**13, 4, 4
    own_lo = tst.left_history_samples(CFG)
    xp = np.concatenate([np.zeros(own_lo, np.complex64), cap])
    det = sync.detect_frames_stream(CFG, _t(xp), block_len, n_blocks, own_lo, max_frames=mf)
    ref = jsync.detect_frames_stream(JCFG, cx.from_complex(xp), block_len, n_blocks, own_lo,
                                     max_frames=mf)
    np.testing.assert_array_equal(det.start.numpy(), np.asarray(ref.start))
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(det.n_candidates.numpy(), np.asarray(ref.n_candidates))
    np.testing.assert_allclose(det.coarse_cfo.numpy(), np.asarray(ref.coarse_cfo), atol=1e-6)
    assert int(det.valid.sum()) == n_frames

    spec, _ = _specs(BENCH_MCS, BENCH_BYTES)
    n_sym = 3 + CFG.n_ltf + spec.n_ofdm_sym
    trig = np.where(np.asarray(ref.valid), np.asarray(ref.start), 0).reshape(-1)
    cfo = np.asarray(ref.coarse_cfo).reshape(-1)
    syms, total_cfo, found = sync.extract_frames_batch(CFG, _t(xp), _t(trig), _t(cfo), n_sym)
    r_syms, r_total, r_found = jsync.extract_frames_batch(
        JCFG, cx.from_complex(xp), jnp.asarray(trig), jnp.asarray(cfo), n_sym)
    np.testing.assert_array_equal(found.numpy(), np.asarray(r_found))
    np.testing.assert_allclose(total_cfo.numpy(), np.asarray(r_total), atol=1e-6)
    np.testing.assert_allclose(syms.numpy(), _np(r_syms), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------- the slice


def test_scan_rx_matches_on_bench_capture(bench_capture):
    cap, n_frames = bench_capture
    spec, jspec = _specs(BENCH_MCS, BENCH_BYTES)
    ours = tst.scan_rx(CFG, spec, _tab(spec), _t(cap), 2**13, 4, max_frames_per_block=4)
    ref = jax_scan_rx(jspec, cap, 2**13, 4, 4)
    assert_same_rx(ours, ref)
    assert int(ours.valid.sum()) == int(ours.crc_ok.sum()) == n_frames
    # the nn.Module runs the same chain from its buffers
    model = tst.StreamingRx(CFG, spec, 2**13, 4, max_frames_per_block=4, device="cpu")
    res = model(_t(cap))
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(ours, f)), f


def test_owned_frames_not_evicted_by_preblock_trigger():
    """tests/test_streaming.py:89 on the port: a trigger in the ignore_gap
    span before block 1 must not take one of its max_frames slots."""
    spec, jspec = _specs(MCS.QPSK_1_2, 16)
    frame, _ = tx_frame(jspec, b"evict")
    block_len, n_blocks, mf = 8192, 2, 2
    cap = np.zeros(n_blocks * block_len + tst.frame_window_samples(CFG, spec) + CFG.fft_len,
                   np.complex64)
    positions = [block_len - 400, block_len + 700, block_len + 2500]
    for pos in positions:
        cap[pos : pos + len(frame)] += frame
    ours = tst.scan_rx(CFG, spec, _tab(spec), _t(cap), block_len, n_blocks,
                       max_frames_per_block=mf)
    # noise-free: the SNR is set by rounding alone and is not compared
    assert_same_rx(ours, jax_scan_rx(jspec, cap, block_len, n_blocks, mf), snr=False)
    valid = ours.valid.numpy()
    assert int(valid.sum()) == 3 and ours.crc_ok.numpy()[valid].all()
    got = sorted(ours.start.numpy()[valid].tolist())
    for g, want in zip(got, positions):
        assert 0 <= g - want <= CFG.fft_len, got
