"""``soft=True`` (max-log-MAP LLRs) and ``estimator="sta"`` (decision-directed
channel tracking) of the port against jrc_tpu on the CPU, module by module
and through the flat paths, on the captures of
tests/test_soft_sta_executors.py (16-QAM 3/4 at a noise level that breaks
hard decisions; QPSK-3/4 at 40 dB), static and SIG-driven dynamic.

LLRs and channel values also at noise_var 0.05 and at one variance a
frame ((B, 1, 1), seeded), and ``decode_frame(soft=True, noise_var=0.05)``
on the QPSK-3/4 capture's frames.

Tolerances: LLRs within 1e-4 · max|LLR|; equalized symbols of the STA
recursion within rtol 1e-4 / atol 1e-5 on the grids of real frames (the
recursion feeds its decisions back, so the comparison needs symbols that sit
off the decision boundaries); decoded flags, starts and payloads exact, SNRs
within 1e-3 dB."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.config import MCS, PacketType  # noqa: E402
from jrc_tpu.models import streaming as jst  # noqa: E402
from jrc_tpu.ops import (  # noqa: E402
    cplx as cx, decoder as jdec, dynamic_rx as jdyn, equalizer as jeq, modulation as jmod,
)
from jrc_tpu_torch import tables  # noqa: E402
from jrc_tpu_torch.io.stream import BlockStreamer  # noqa: E402
from jrc_tpu_torch.models import streaming as tst  # noqa: E402
from jrc_tpu_torch.ops import decoder, dynamic_rx, equalizer, modulation, ofdm, sync  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    CFG, JCFG, assert_same_rx, cplx as _cplx, np_of as _np, specs as _specs, t as _t, tab as _tab,
    tx_frame,
)

BLOCK_LEN, N_BLOCKS, MAX_FRAMES, MAXP = 1 << 13, 4, 4, 64


def _capture(jspec, noise_var, gap=997, seed=3):
    """Frames + AWGN at a pinned noise level → (capture with halo, n_frames)."""
    rng = np.random.default_rng(seed)
    text = bytes(rng.integers(0, 256, jspec.payload_bytes - 1).tolist())
    frame, _ = tx_frame(jspec, text, cfo=0.0)
    n = BLOCK_LEN * N_BLOCKS
    halo = max(jst.frame_window_samples(JCFG, jspec),
               jst.frame_window_samples_dynamic(JCFG, MAXP)) + JCFG.fft_len
    cap = (rng.normal(0, np.sqrt(noise_var / 2), (n + halo, 2))
           .astype(np.float32).view(np.complex64)[:, 0]).astype(np.complex64)
    pos, nf = 600, 0
    while pos + len(frame) < n - 100:
        cap[pos : pos + len(frame)] += frame
        pos += len(frame) + gap
        nf += 1
    return cap, nf


@pytest.fixture(scope="module")
def qam_capture():
    return _capture(_specs(MCS.QAM16_3_4, 64)[1], noise_var=6e-3)


@pytest.fixture(scope="module")
def qpsk_capture():
    return _capture(_specs(MCS.QPSK_3_4, 48)[1], noise_var=1e-4)


def _frame_grids(spec, cap, n_sym_total):
    """(grid (B, n_sym_total, fft_len), total_cfo (B,)) of the capture's
    frames, from the port's own detection, extraction and FFT."""
    xp = torch.cat([torch.zeros(384, dtype=torch.complex64), _t(cap)])
    det = sync.detect_frames_stream(CFG, xp, BLOCK_LEN, N_BLOCKS, 384, max_frames=MAX_FRAMES)
    keep = det.valid.reshape(-1)
    syms, cfo, _ = sync.extract_frames_batch(
        CFG, xp, det.start.reshape(-1)[keep], det.coarse_cfo.reshape(-1)[keep], n_sym_total)
    return ofdm.fft_symbols(CFG, syms).numpy(), cfo.numpy()


# ------------------------------------------------------------------- modules


def _noise_var_cases(mcs_list):
    """(mcs, noise_var) cases: unit (under the id the unit case always had),
    0.05, and one float32 variance a frame, (B, 1, 1) from a seeded generator."""
    return [pytest.param(m, nv, id=f"{int(m)}" + ("" if nv == "unit" else f"-{nv}"))
            for m in mcs_list for nv in ("unit", "0.05", "per_frame")]


def _noise_vars(case, n_frames):
    """(reference's noise_var, port's noise_var) of a case: the default, or
    the same numpy values as a jax array and as a tensor (0-d for 0.05)."""
    if case == "unit":
        return 1.0, 1.0
    if case == "0.05":
        nv = np.float32(0.05)
    else:
        nv = np.random.default_rng(11).uniform(0.02, 2.0, (n_frames, 1, 1)).astype(np.float32)
    return jnp.asarray(nv), _t(nv)


@pytest.mark.parametrize("mcs,noise_var", _noise_var_cases(
    [MCS.BPSK_1_2, MCS.QPSK_3_4, MCS.QAM16_3_4]))
def test_soft_llr_and_modulate_match(mcs, noise_var):
    spec, jspec = _specs(mcs, 40)
    n_bpsc = spec.mcs_params.n_bpsc
    z = _cplx(np.random.default_rng(int(mcs)), 7, 96) * 0.8
    jnv, nv = _noise_vars(noise_var, 7)
    ours = modulation.soft_llr(_t(z), _tab(spec).points, n_bpsc, nv).numpy()
    ref = np.asarray(jmod.soft_llr(cx.from_complex(z), jspec.mcs, jnv))
    assert ours.shape == ref.shape == (7, 96 * n_bpsc) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    # a hard decision is the sign of the LLRs
    vals = modulation.hard_decision(_t(z), _tab(spec).points).numpy()
    bits = (vals[..., None] >> np.arange(n_bpsc)) & 1
    np.testing.assert_array_equal(ours.reshape(7, 96, n_bpsc) > 0, bits.astype(bool))
    remod = modulation.modulate(_t(vals), _tab(spec).points, n_bpsc).numpy()
    np.testing.assert_array_equal(remod, _np(jmod.modulate(jnp.asarray(vals), jspec.mcs)))


@pytest.mark.parametrize("mcs,noise_var", _noise_var_cases([MCS.QPSK_3_4, MCS.QAM16_1_2]))
def test_soft_frame_values_match(mcs, noise_var):
    spec, jspec = _specs(mcs, 40)
    z = _cplx(np.random.default_rng(6), 3, spec.n_ofdm_sym, 48)
    jnv, nv = _noise_vars(noise_var, 3)
    ours = decoder.frame_values(spec, _tab(spec), _t(z), soft=True, noise_var=nv).numpy()
    ref = np.asarray(jdec.frame_values(jspec, cx.from_complex(z), soft=True, noise_var=jnv))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(ours == 0, ref == 0)  # the erasures sit where they sat


def test_soft_decode_frame_at_noise_var_matches(qpsk_capture):
    """decode_frame(soft=True, noise_var=0.05) on the QPSK-3/4 capture's
    equalized frames: payload, CRC verdict and scrambler seed exactly the
    reference's, every frame CRC-clean."""
    spec, jspec = _specs(MCS.QPSK_3_4, 48)
    grid, cfo = _frame_grids(spec, qpsk_capture[0], 3 + CFG.n_ltf + spec.n_ofdm_sym)
    z = equalizer.equalize_frame(CFG, spec, _tab(spec), _t(grid), _t(cfo)).z.numpy()
    ours = decoder.decode_frame(spec, _tab(spec), _t(z), soft=True, noise_var=0.05)
    ref = jax.jit(lambda x: jdec.decode_frame(jspec, x, soft=True, noise_var=0.05))(
        cx.from_complex(z))
    for f in ("payload", "crc_ok", "scrambler_seed"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert len(z) == qpsk_capture[1] and bool(ours.crc_ok.all())


def test_noise_var_on_another_device_is_refused():
    spec, _ = _specs(MCS.QPSK_3_4, 40)
    z = _t(_cplx(np.random.default_rng(6), 3, spec.n_ofdm_sym, 48))
    elsewhere = torch.full((3, 1, 1), 0.05, device="meta")
    with pytest.raises(ValueError, match="noise_var lies on meta"):
        modulation.soft_llr(z.reshape(3, -1), _tab(spec).points, 2, elsewhere)
    with pytest.raises(ValueError, match="noise_var lies on meta"):
        decoder.decode_frame(spec, _tab(spec), z, soft=True, noise_var=elsewhere)


def test_sta_equalize_frame_matches(qpsk_capture):
    spec, jspec = _specs(MCS.QPSK_3_4, 48)
    grid, cfo = _frame_grids(spec, qpsk_capture[0], 3 + CFG.n_ltf + spec.n_ofdm_sym)
    assert len(grid) == qpsk_capture[1]
    eq = equalizer.equalize_frame(CFG, spec, _tab(spec), _t(grid), _t(cfo), estimator="sta")
    ref = jax.vmap(lambda g, c: jeq.equalize_frame(JCFG, jspec, g, c, estimator="sta"))(
        cx.from_complex(grid), jnp.asarray(cfo))
    np.testing.assert_allclose(eq.z.numpy(), _np(ref.z), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(eq.snr_data.numpy(), np.asarray(ref.snr_data), atol=1e-3)
    ls = equalizer.equalize_frame(CFG, spec, _tab(spec), _t(grid), _t(cfo))
    assert not torch.equal(ls.z, eq.z)  # the tracking did move the estimate
    with pytest.raises(ValueError, match="estimator"):
        equalizer.equalize_frame(CFG, spec, _tab(spec), _t(grid), _t(cfo), estimator="dd")


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_dynamic_sta_values_match(qpsk_capture, soft):
    """The masked STA scan and the per-MCS LLRs of the dynamic path on real
    frames: the channel values that reach the shared Viterbi pass."""
    spec, _ = _specs(MCS.QPSK_3_4, 48)
    n_total = 3 + CFG.n_ltf + dynamic_rx.max_symbols(MAXP, CFG.n_data_carriers)
    xp = torch.cat([torch.zeros(384, dtype=torch.complex64), _t(qpsk_capture[0])])
    det = sync.detect_frames_stream(CFG, xp, BLOCK_LEN, N_BLOCKS, 384, max_frames=MAX_FRAMES)
    keep = det.valid.reshape(-1)
    syms, cfo, _ = sync.extract_frames_batch(
        CFG, xp, det.start.reshape(-1)[keep][:6], det.coarse_cfo.reshape(-1)[keep][:6], n_total)
    tab = tables.from_numpy_dynamic(CFG, MAXP, "cpu")
    pre = dynamic_rx.rx_frame_dynamic_values_from_syms(
        CFG, tab, syms, cfo, max_payload=MAXP, estimator="sta", soft=soft)
    ref = jax.vmap(lambda s, c: jdyn.rx_frame_dynamic_values_from_syms(
        JCFG, s, c, max_payload=MAXP, estimator="sta", soft=soft))(
        cx.from_complex(syms.numpy()), jnp.asarray(cfo.numpy()))
    for f in ("mcs", "length", "packet_type_bit", "n_ofdm_sym", "sig_ok"):
        np.testing.assert_array_equal(getattr(pre, f).numpy(), np.asarray(getattr(ref, f)), f)
    want = np.asarray(ref.values)
    if soft:
        np.testing.assert_allclose(pre.values.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(pre.values.numpy(), want)
    np.testing.assert_allclose(pre.snr_data_db.numpy(), np.asarray(ref.snr_data_db), atol=1e-3)


# --------------------------------------------------------------- whole paths


def _jax_scan(jspec, cap, **kw):
    return jax.jit(lambda x: jst.scan_rx(JCFG, jspec, x, BLOCK_LEN, N_BLOCKS,
                                         max_frames_per_block=MAX_FRAMES, **kw))(jnp.asarray(cap))


def test_soft_scan_rx_matches_and_beats_hard(qam_capture):
    cap, nf = qam_capture
    spec, jspec = _specs(MCS.QAM16_3_4, 64)
    tab = _tab(spec)
    hard = tst.scan_rx(CFG, spec, tab, _t(cap), BLOCK_LEN, N_BLOCKS, max_frames_per_block=MAX_FRAMES)
    soft = tst.scan_rx(CFG, spec, tab, _t(cap), BLOCK_LEN, N_BLOCKS,
                       max_frames_per_block=MAX_FRAMES, soft=True)
    assert_same_rx(soft, _jax_scan(jspec, cap, soft=True))
    assert int(soft.valid.sum()) == nf
    # the pinned noise level does stress the hard decoder, and LLRs repair it
    assert int(hard.crc_ok.sum()) < nf and int(soft.crc_ok.sum()) >= int(hard.crc_ok.sum()) + 2


def test_sta_scan_rx_matches(qpsk_capture):
    cap, nf = qpsk_capture
    spec, jspec = _specs(MCS.QPSK_3_4, 48)
    ours = tst.scan_rx(CFG, spec, _tab(spec), _t(cap), BLOCK_LEN, N_BLOCKS,
                       max_frames_per_block=MAX_FRAMES, estimator="sta")
    assert_same_rx(ours, _jax_scan(jspec, cap, estimator="sta"))
    assert int(ours.crc_ok.sum()) == nf


def test_dynamic_scan_rx_soft_and_sta_match(qpsk_capture):
    cap, nf = qpsk_capture
    tab = tables.from_numpy_dynamic(CFG, MAXP, "cpu")
    ours = tst.scan_rx_dynamic(CFG, tab, _t(cap), BLOCK_LEN, N_BLOCKS,
                               max_frames_per_block=MAX_FRAMES, max_payload=MAXP,
                               estimator="sta", soft=True)
    ref = jax.jit(lambda x: jst.scan_rx_dynamic(
        JCFG, x, BLOCK_LEN, N_BLOCKS, max_frames_per_block=MAX_FRAMES, max_payload=MAXP,
        estimator="sta", soft=True))(jnp.asarray(cap))
    assert_same_rx(ours, ref, payload_slots="valid")
    valid = np.asarray(ref.valid)
    for f in ("mcs", "payload_len", "packet_type_bit", "chan_est_ok"):
        np.testing.assert_array_equal(getattr(ours, f).numpy()[valid],
                                      np.asarray(getattr(ref, f))[valid], err_msg=f)
    np.testing.assert_allclose(ours.snr_data_db.numpy()[valid],
                               np.asarray(ref.snr_data_db)[valid], atol=1e-3)
    assert int(ours.crc_ok.sum()) == nf
    assert (ours.mcs.numpy()[valid] == int(MCS.QPSK_3_4)).all()


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_modules_and_streamer_take_both_flags(qpsk_capture, dynamic):
    """StreamingRx / StreamingRxDynamic / BlockStreamer hand ``estimator`` and
    ``soft`` to the flat paths: each equals scan_rx with the same flags."""
    cap, nf = qpsk_capture
    spec, _ = _specs(MCS.QPSK_3_4, 48)
    kw = dict(estimator="sta", soft=True)
    if dynamic:
        model = tst.StreamingRxDynamic(CFG, BLOCK_LEN, N_BLOCKS, max_frames_per_block=MAX_FRAMES,
                                       max_payload=MAXP, device="cpu", **kw)
        want = tst.scan_rx_dynamic(CFG, model.constants(), _t(cap), BLOCK_LEN, N_BLOCKS,
                                   max_frames_per_block=MAX_FRAMES, max_payload=MAXP, **kw)
    else:
        model = tst.StreamingRx(CFG, spec, BLOCK_LEN, N_BLOCKS, max_frames_per_block=MAX_FRAMES,
                                device="cpu", **kw)
        want = tst.scan_rx(CFG, spec, model.constants(), _t(cap), BLOCK_LEN, N_BLOCKS,
                           max_frames_per_block=MAX_FRAMES, **kw)
    got = model(_t(cap))
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    s = BlockStreamer(CFG, None if dynamic else spec, block_len=BLOCK_LEN, n_blocks=N_BLOCKS,
                      max_frames=MAX_FRAMES, max_payload=MAXP, device="cpu", **kw)
    s.push(cap)
    (res,) = list(s.process_available())
    for f in res._fields:
        assert torch.equal(getattr(res, f), getattr(want, f)), f
    assert s.stats.crc_ok == nf
