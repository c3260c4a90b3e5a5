"""The port's radar extras against jrc_tpu on the CPU, each package given the
same input: ``fft_peak_detect`` on test_radar.py's tone and on a batch of
rows, ``range_angle_estimate_multi`` on the map of test_radar.py's
two-target scene (and on an all-zero map), ``cfar_detect`` on exponential
noise and on the map of test_radar.py's CFAR scene with the reference's
noise draws (both maps made by the port's ``radar_frame`` and handed to
both packages), ``range_doppler_map`` / ``range_doppler_estimate`` on
16-dwell histories of test_doppler.py's train through the port's
``SimTrx`` (approaching, receding, static; ±150 m/s, outside the blind
zone of 72 m/s that the zero-Doppler guard leaves at 16 dwells), and the
median of an even count of cells.

The reference's ``fft_peak_detect`` and ``range_angle_estimate_multi`` run
under ``jax.jit`` (eagerly, a compile per primitive costs seconds).
Tolerances: indices, flags, bins read at an index (range, angle, velocity,
frequency, blind zone) are equal. Maps and powers within 1e-5 · max|reference|
(torch.fft against the reference's DFT matmuls), SNRs within 1e-3 dB, tone
phase within 1e-5 rad. CFAR: noise and threshold per cell within 1e-5 of the
cell's training-box scale (the float64 sum of |power| over its outer window
over its training count, times α for the threshold): the reference's
box(outer) − box(inner) cancels in float32 wherever a strong cell sits in the
guard window, so a per-cell relative tolerance would test rounding, not the
port. Detections are equal except in cells whose power lies within that
tolerance of the reference's threshold; those are counted and printed (0 in
these cases). Range-Doppler estimates are compared on one map through both
packages (the reference's map, then the port's); across the two maps only
where a target is detected, since a static scene's two mirror bins ±v tie
to the maps' last bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrc_tpu.ops import channel as jchannel, cplx as cx, radar as jradar
from jrc_tpu_torch.config import MCS, PacketType
from jrc_tpu_torch.ops import radar
from tests.torch_parity import CFG, JCFG, np_of, specs, t

RTOL = 1e-5
DB_TOL = 1e-3
CFAR_TOL = 1e-5


#: the reference's functions that are slow eagerly (a compile per primitive), under jax.jit
ref_peak = jax.jit(jradar.fft_peak_detect, static_argnums=(1,), static_argnames=("samp_protect",))
ref_multi = jax.jit(jradar.range_angle_estimate_multi, static_argnames=("max_targets",))


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def r_bins():
    return radar.range_axis(CFG.fft_len, CFG.sample_rate)


def a_bins():
    return np.asarray(CFG.angle_axis(16), np.float32)


@pytest.mark.parametrize("freqs", [(125.0,), (-200.0,), (125.0, -200.0, 312.5)],
                         ids=["positive", "negative", "rows"])
def test_fft_peak_detect_matches(freqs):
    """test_radar.py:92's tones (n 256, fs 1 kHz, two bins protected a side)."""
    n, fs = 256, 1000.0
    tt = np.arange(n) / fs
    x = np.stack([np.exp(2j * np.pi * f * tt) * (0.5 + i) for i, f in enumerate(freqs)])
    spec = np.fft.fft(x).astype(np.complex64)
    want = ref_peak(jnp.asarray(spec), fs, samp_protect=2)
    got = radar.fft_peak_detect(t(spec), fs, samp_protect=2)
    np.testing.assert_array_equal(got.freq.numpy(), np.asarray(want.freq))
    np.testing.assert_array_equal(got.detected.numpy(), np.asarray(want.detected))
    np.testing.assert_allclose(got.phase.numpy(), np.asarray(want.phase), atol=1e-5, rtol=0)
    close(got.magnitude.numpy(), np.asarray(want.magnitude))
    assert np.all(np.abs(got.freq.numpy() - np.asarray(freqs)) < fs / n)


def test_fft_peak_detect_protects_edges_and_takes_the_first_maximum():
    spec = np.zeros((2, 16), np.complex64)
    spec[0, [0, 15, 5, 9]] = [100, 100, 3, 3]  # edges protected; a tie: the first wins
    spec[1] = 1e-4  # below −60 dB
    want = ref_peak(jnp.asarray(spec), 16.0)
    got = radar.fft_peak_detect(t(spec), 16.0)
    np.testing.assert_array_equal(got.freq.numpy(), np.asarray(want.freq))
    np.testing.assert_array_equal(got.detected.numpy(), [True, False])
    np.testing.assert_array_equal(got.detected.numpy(), np.asarray(want.detected))
    assert float(got.freq[0]) == 5.0


def _port_map(targets, payload_bytes: int, payload: bytes, **kw) -> np.ndarray:
    """The port's radar_frame map of an NDP QPSK-1/2 dwell on ``targets``."""
    from jrc_tpu_torch import tables
    from jrc_tpu_torch.models import radar_chain
    from jrc_tpu_torch.ops import channel
    from jrc_tpu_torch.ops.encoder import make_payload

    spec = specs(MCS.QPSK_1_2, payload_bytes, PacketType.NDP)[0]
    pl = torch.from_numpy(make_payload(spec, payload))
    res = radar_chain.radar_frame(CFG, spec, tables.from_numpy(CFG, spec, "cpu"),
                                  tables.radar_from_numpy(CFG, "cpu"), pl,
                                  channel.Targets(*targets), **kw)
    return res


@pytest.fixture(scope="module")
def two_target_map():
    """test_radar.py:155's scene: 12 m / 25° and 5 m / −20°, NDP QPSK-1/2 of 30 B."""
    res = _port_map(((12.0, 5.0), (0.0, 0.0), (25.0, -20.0), (10.0, 10.0)), 30,
                    bytes([1]) + bytes(26))
    return res.ra_map.numpy()


def _multi_equal(got, want):
    for f in ("detected", "range_idx", "angle_idx", "range_m", "angle_deg"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    close(got.power.numpy(), np.asarray(want.power))
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), atol=DB_TOL, rtol=0)


@pytest.mark.parametrize("max_targets", [2, 3])
def test_range_angle_estimate_multi_matches(two_target_map, max_targets):
    m = two_target_map
    want = ref_multi(jnp.asarray(m), jnp.asarray(r_bins()), jnp.asarray(a_bins()),
                     max_targets=max_targets)
    got = radar.range_angle_estimate_multi(t(m), t(r_bins()), t(a_bins()),
                                           max_targets=max_targets)
    _multi_equal(got, want)
    det = got.detected.numpy()
    assert det[0] and det[1]
    found = [(float(r), float(a)) for r, a, d in zip(got.range_m, got.angle_deg, det) if d]
    assert any(abs(r - 12) <= 1 and abs(a - 25) <= 3 for r, a in found)
    assert any(abs(r - 5) <= 1 and abs(a + 20) <= 3 for r, a in found)


def test_range_angle_estimate_multi_on_an_empty_map():
    """All zeros: every subtraction is skipped (|peak|² ≤ 1e-30), no NaN."""
    m = np.zeros((64, 32), np.complex64)
    rb, ab = np.linspace(0, 10, 64).astype(np.float32), np.linspace(-60, 60, 32).astype(np.float32)
    want = ref_multi(jnp.asarray(m), jnp.asarray(rb), jnp.asarray(ab))
    got = radar.range_angle_estimate_multi(t(m), t(rb), t(ab))
    for f in ("detected", "range_idx", "angle_idx", "power"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert not got.detected.any()


def _box64(x, win):
    """Zero-padded centred box sum in float64 (numpy), the tolerance's scale."""
    out = x.astype(np.float64)
    for ax, w in enumerate(win):
        h = w // 2
        c = np.concatenate([np.zeros_like(np.take(out, [0], ax)), np.cumsum(out, ax)], ax)
        n = out.shape[ax]
        i = np.arange(n)
        out = np.take(c, np.minimum(i + h + 1, n), ax) - np.take(c, np.maximum(i - h, 0), ax)
    return out


def _cfar_equal(power, **kw):
    want = jradar.cfar_detect(jnp.asarray(power), **kw)
    got = radar.cfar_detect(t(power), **kw)
    gr, ga = kw.get("guard", (4, 2))
    tr, ta = kw.get("train", (12, 6))
    outer, inner = (2 * (gr + tr) + 1, 2 * (ga + ta) + 1), (2 * gr + 1, 2 * ga + 1)
    ring_n = np.maximum(_box64(np.ones_like(power), outer) - _box64(np.ones_like(power), inner), 1)
    scale = CFAR_TOL * _box64(np.abs(power), outer) / ring_n
    alpha = np.asarray(want.threshold) / np.where(np.asarray(want.noise) != 0,
                                                  np.asarray(want.noise), 1)
    assert np.all(np.abs(got.noise.numpy() - np.asarray(want.noise)) <= scale)
    thr_tol = np.abs(alpha) * scale
    assert np.all(np.abs(got.threshold.numpy() - np.asarray(want.threshold)) <= thr_tol)
    near = np.abs(power - np.asarray(want.threshold)) <= thr_tol
    differ = got.detections.numpy() != np.asarray(want.detections)
    assert not (differ & ~near).any()
    print(f"cfar: {int(near.sum())} cells within the tolerance of the threshold, "
          f"{int(differ.sum())} of them flipped")
    if not differ.any():
        assert int(got.n_detections) == int(want.n_detections)
    return got, want


@pytest.mark.parametrize("scale", [1.0, 1e6])
def test_cfar_on_noise_matches(scale):
    """test_radar.py's exponential noise at two levels, pfa 1e-3, the
    default 2-D window (the border zero-padded)."""
    pwr = np.random.default_rng(0).exponential(scale, (512, 128)).astype(np.float32)
    got, _ = _cfar_equal(pwr, pfa=1e-3)
    assert 15 <= int(got.n_detections) <= 260


def test_cfar_on_a_radar_map_matches():
    """test_radar.py:244: range-only CFAR (guard 8, train 24) on the map of a
    target at 12 m / 25° with noise 1e-8 (NDP QPSK-1/2 of 50 B)."""
    from jrc_tpu_torch.models import comm_link

    spec = specs(MCS.QPSK_1_2, 50, PacketType.NDP)[0]
    n = (CFG.n_sync_words + 1 + CFG.n_ltf + spec.n_ofdm_sym + 3) * CFG.sym_len
    k_n = jax.random.split(jax.random.key(0), 3)[2]  # the reference's draw of its noise
    noise = t(np_of(jchannel.awgn(k_n, cx.zeros((CFG.n_rx, n)), 2.0)).astype(np.complex64))
    res = _port_map(((12.0,), (0.0,), (25.0,), (10.0,)), 50, bytes([1]), noise_var=1e-8,
                    draws=comm_link.Draws(radar_noise=noise))
    pwr = (res.ra_map.real ** 2 + res.ra_map.imag ** 2).numpy()
    got, _ = _cfar_equal(pwr, guard=(8, 0), train=(24, 0), pfa=1e-4)
    ri, ai = int(res.estimate.range_idx), int(res.estimate.angle_idx)
    assert bool(got.detections[ri, ai]) and int(got.n_detections) < 0.03 * pwr.size


def test_velocity_axis_is_the_reference_axis():
    for n, period in ((16, 1.3e-4), (64, 9.1e-5)):
        np.testing.assert_array_equal(radar.velocity_axis(n, period, CFG.center_freq),
                                      jradar.velocity_axis(n, period, JCFG.center_freq))


N_DWELLS = 16


def _history(velocity: float) -> tuple[np.ndarray, float]:
    """test_doppler.py's dwell train through the port's SimTrx on the CPU:
    the same NDP frame burst back to back, a target at 12 m / 20° → (history
    (N_DWELLS, n_virt, fft_len) complex64, dwell period)."""
    from jrc_tpu_torch import tables
    from jrc_tpu_torch.io.backend import SimTrx, TrxSession
    from jrc_tpu_torch.models import comm_link
    from jrc_tpu_torch.ops import channel, ofdm
    from jrc_tpu_torch.ops.encoder import make_payload

    spec = specs(MCS.QPSK_1_2, 30, PacketType.NDP)[0]
    payload = torch.from_numpy(make_payload(spec, bytes([1]) + bytes(26)))
    session = TrxSession(SimTrx(CFG, channel.Targets((12.0,), (velocity,), (20.0,), (10.0,)),
                                device="cpu"), update_period=0.0)
    tx = comm_link.tx_frame(CFG, spec, tables.from_numpy(CFG, spec, "cpu"), payload, 1,
                            pad_tail=3 * CFG.sym_len)
    sl = slice(CFG.n_sync_words + 1, CFG.n_sync_words + 1 + CFG.n_ltf)
    x_ref, n_sym = tx.grid.transpose(0, 1)[:, sl], tx.grid.shape[0]
    hist = [radar.radar_channel_estimate(
        x_ref, ofdm.ofdm_demodulate(CFG, session.frame(tx.samples, 0.0).rx, n_sym)[:, sl])
        for _ in range(N_DWELLS)]
    return torch.stack(hist).numpy(), tx.samples.shape[-1] / CFG.sample_rate


@pytest.fixture(scope="module")
def histories():
    return {v: _history(v) for v in (150.0, -150.0, 0.0)}


@pytest.mark.parametrize("velocity", [150.0, -150.0, 0.0],
                         ids=["approaching", "receding", "static"])
def test_range_doppler_matches(histories, velocity):
    hist, period = histories[velocity]
    v_bins = radar.velocity_axis(N_DWELLS, period, CFG.center_freq)
    want_map = jax.jit(jradar.range_doppler_map)(cx.from_complex(jnp.asarray(hist)))
    got_map = radar.range_doppler_map(t(hist))
    close(got_map.numpy(), np.asarray(want_map))
    # the estimate on the same map, so that only the estimate is compared
    m = np.asarray(want_map)
    want = jradar.range_doppler_estimate(jnp.asarray(m), jnp.asarray(r_bins()),
                                         jnp.asarray(v_bins))
    got = radar.range_doppler_estimate(t(m), t(r_bins()), t(v_bins))
    for f in ("range_m", "velocity_mps", "detected", "blind_zone_mps"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    close(got.power.numpy(), np.asarray(want.power))
    assert abs(float(got.snr_db) - float(want.snr_db)) <= DB_TOL
    # and on its own map: the reference's estimate on that same map. A static
    # scene's strongest unguarded cells are the two mirror bins ±v of the
    # Hann leakage, a tie that the last bits of each map decide, so the
    # estimates on the two maps are held equal only where a target is detected
    own_map = got_map.numpy()
    own = radar.range_doppler_estimate(got_map, t(r_bins()), t(v_bins))
    ref_own = jradar.range_doppler_estimate(jnp.asarray(own_map), jnp.asarray(r_bins()),
                                            jnp.asarray(v_bins))
    for f in ("range_m", "velocity_mps", "detected"):
        np.testing.assert_array_equal(getattr(own, f).numpy(), np.asarray(getattr(ref_own, f)),
                                      err_msg=f)
        if velocity != 0.0:
            assert torch.equal(getattr(own, f), getattr(got, f)), f
    if velocity == 0.0:
        assert not bool(got.detected)
    else:  # the sign follows the target: approaching and receding land on opposite sides
        v_res = v_bins[1] - v_bins[0]
        assert bool(got.detected) and abs(float(got.velocity_mps) - velocity) <= v_res
        assert np.sign(float(got.velocity_mps)) == np.sign(velocity)


def test_range_doppler_noise_is_the_averaged_median():
    """The noise floor is the median of an even count of cells, the mean of
    the two middle ones as jnp.median takes it; torch.median's lower middle
    value would move this SNR by 1.76 dB."""
    rd = np.ones((8, 32), np.float32)
    rd[:4] = 3.0  # the two middle cells are 1 and 3: median 2, lower median 1
    rd[2, 3] = 400.0  # off zero Doppler
    rb, vb = np.arange(8, dtype=np.float32), np.linspace(-5, 5, 32).astype(np.float32)
    want = jradar.range_doppler_estimate(jnp.asarray(rd), jnp.asarray(rb), jnp.asarray(vb))
    got = radar.range_doppler_estimate(t(rd), t(rb), t(vb))
    assert float(radar.median_midpoint(t(rd))) == float(jnp.median(jnp.asarray(rd))) == 2.0
    assert abs(float(got.snr_db) - float(want.snr_db)) <= DB_TOL
    assert abs(float(got.snr_db) - 10 * np.log10(400.0 / 2.0)) <= DB_TOL
    assert float(radar.median_midpoint(t(np.array([1.0, 2.0, 3.0, 4.0], np.float32)))) == 2.5
    assert float(radar.median_midpoint(t(np.array([1.0, 9.0, 3.0], np.float32)))) == 3.0
