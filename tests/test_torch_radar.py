"""The port's synthetic channel and radar imaging against jrc_tpu on the CPU:
``apply_targets`` (one and two targets, the random phase injected,
self-coupling, t0 ≠ 0), ``awgn`` with injected draws, the radar channel
estimate in both row orders, background removal recording and frozen past
``record_len``, the range-angle map with and without tapers, the estimate,
and one ``radar_frame`` dwell on the bench scene.

Tolerances: detection fields (indices, ``detected``, range and angle) and
AWGN on the same draws are equal. ``apply_targets`` is held within 2e-5 ·
max|reference|: its delay phase reaches about 1.2e4 rad at 24 GHz (a
float32 ulp there is 1e-3 rad), computed in float32 in the reference's order
on both sides, and its two frame-length transforms are torch.fft against the
reference's Cooley-Tukey matmul DFT (measured: 1e-7 to 3e-7). The reference
is run op by op, the order the port follows: under ``jax.jit`` XLA fuses the
phase expression and the reference itself moves by 7e-4 · max at the 30 m
target, where one ulp of the phase is 2e-3 rad. The channel estimate, the map and
radar_frame's outputs are held within 1e-5 · max|reference|, SNR within
1e-3 dB."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrc_tpu.models import radar_chain as jradar_chain
from jrc_tpu.ops import channel as jchannel, cplx as cx, radar as jradar
from jrc_tpu.ops.encoder import make_payload as jmake_payload
from jrc_tpu_torch import tables
from jrc_tpu_torch.config import MCS
from jrc_tpu_torch.models import radar_chain
from jrc_tpu_torch.ops import channel, radar
from tests.torch_parity import CFG, JCFG, cplx, np_of, specs, t

RTOL = 1e-5
SCENES = {
    "one": ((12.0,), (5.0,), (25.0,), (10.0,)),
    "two": ((12.0, 30.0), (5.0, -3.0), (25.0, -40.0), (10.0, 3.0)),
}


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err / np.abs(want).max())


def pos():
    wl = channel.C_LIGHT / CFG.center_freq
    p = channel.virtual_positions(CFG.n_tx, CFG.n_rx, wl)
    np.testing.assert_array_equal(p, jchannel.virtual_positions(CFG.n_tx, CFG.n_rx, wl))
    return p


@pytest.mark.parametrize("scene,phase,coupling,t0", [
    ("one", False, None, 0.0), ("two", True, None, 0.0), ("one", False, -30.0, 3.7e-3),
], ids=["one-target", "two-targets-random-phase", "self-coupling-t0"])
def test_apply_targets_matches(scene, phase, coupling, t0, rng):
    tx = cplx(rng, CFG.n_tx, 2160) * 0.1
    p = pos()
    key = jax.random.PRNGKey(5)
    want = jchannel.apply_targets(
        cx.from_complex(jnp.asarray(tx)), jchannel.Targets(*SCENES[scene]),
        sample_rate=JCFG.sample_rate, center_freq=JCFG.center_freq, pos_virtual=p,
        rng_key=key if phase else None, self_coupling_db=coupling, t0=t0)
    draws = None
    if phase:  # the reference's draw, injected
        draws = t(jax.random.uniform(key, (2,), minval=0.0, maxval=2 * np.pi))
    got = channel.apply_targets(
        t(tx), channel.Targets(*SCENES[scene]), sample_rate=CFG.sample_rate,
        center_freq=CFG.center_freq, pos_virtual=t(p), phase=draws,
        self_coupling_db=coupling, t0=t0)
    close(got.numpy(), np_of(want), rtol=2e-5)


def test_awgn_with_injected_draws_is_the_reference_noise(rng):
    x = cplx(rng, 2, 300)
    key = jax.random.PRNGKey(9)
    want = jchannel.awgn(key, cx.from_complex(jnp.asarray(x)), 3e-3)
    draws = np_of(jchannel.awgn(key, cx.zeros(x.shape), 2.0)).astype(np.complex64)
    got = channel.awgn(t(x), 3e-3, noise=t(draws))
    np.testing.assert_array_equal(got.numpy(), np_of(want).astype(np.complex64))
    # a tensor noise variance, and draws from a generator of the right power
    got_t = channel.awgn(t(x), torch.tensor(3e-3), noise=t(draws))
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())
    n = channel.awgn(torch.zeros(20000, dtype=torch.complex64), 0.5,
                     generator=torch.Generator().manual_seed(0))
    assert abs(float(n.abs().pow(2).mean()) - 0.5) < 0.03
    assert channel.thermal_noise_var(20e6) == jchannel.thermal_noise_var(20e6)


@pytest.mark.parametrize("tx_interleave", [False, True], ids=["rx-major", "tx-major"])
def test_radar_channel_estimate_matches(tx_interleave, rng):
    x = cplx(rng, CFG.n_tx, 4, CFG.fft_len)
    y = cplx(rng, CFG.n_rx, 4, CFG.fft_len)
    got = radar.radar_channel_estimate(t(x), t(y), tx_interleave)
    want = jradar.radar_channel_estimate(cx.from_complex(jnp.asarray(x)),
                                         cx.from_complex(jnp.asarray(y)), tx_interleave)
    close(got.numpy(), np_of(want))


def test_background_removal_matches_past_record_len(rng):
    """Ten estimates into a buffer of four, recording for seven, frozen for
    three (a Python bool and a bool tensor in turn): every cleaned estimate
    and the state after each push; the caller's tensors are left alone."""
    hs = cplx(rng, 10, CFG.n_virtual, CFG.fft_len)
    st = radar.init_background(4, CFG.n_virtual, CFG.fft_len, device="cpu")
    jst = jradar.init_background(4, CFG.n_virtual, CFG.fft_len)
    for i, h in enumerate(hs):
        record = i < 7
        rec = record if i % 2 else torch.tensor(record)
        before = st.buffer.clone()
        cleaned, new = radar.background_removal(st, t(h), record=rec)
        jcleaned, jst = jradar.background_removal(jst, cx.from_complex(jnp.asarray(h)),
                                                  record=record)
        assert torch.equal(st.buffer, before)
        st = new
        close(cleaned.numpy(), np_of(jcleaned))
        np.testing.assert_array_equal(st.buffer.numpy(), np_of(jst.buffer).astype(np.complex64))
        assert int(st.count) == int(jst.count) == min(i + 1, 7)


@pytest.mark.parametrize("window_range,window_angle", [(None, None), ("hann", "hamming")])
def test_range_angle_map_and_estimate_match(window_range, window_angle, rng):
    h = cplx(rng, CFG.n_virtual, CFG.fft_len) * 0.05
    # a point-like target: a range ramp across subcarriers, an angle ramp
    # across the virtual elements
    h += np.exp(2j * np.pi * (0.11 * np.arange(CFG.fft_len)[None, :]
                              + 0.23 * np.arange(CFG.n_virtual)[:, None]))
    rtab = tables.radar_from_numpy(CFG, "cpu", window_range=window_range)
    taper_angle = None if window_angle is None else t(radar.taper(CFG.n_virtual, window_angle))
    got = radar.range_angle_map(t(h), 8, 16, taper_range=rtab.taper_range,
                                taper_angle=taper_angle)
    want = jradar.range_angle_map(cx.from_complex(jnp.asarray(h)), 8, 16,
                                  window_range=window_range, window_angle=window_angle)
    close(got.numpy(), np_of(want))
    np.testing.assert_array_equal(rtab.range_axis.numpy(),
                                  jradar.range_axis(CFG.fft_len, CFG.sample_rate))
    est = radar.range_angle_estimate(got, rtab.range_axis, rtab.angle_axis)
    jest = jradar.range_angle_estimate(want, jnp.asarray(rtab.range_axis.numpy()),
                                       jnp.asarray(rtab.angle_axis.numpy()))
    for f in ("range_idx", "angle_idx", "detected", "range_m", "angle_deg"):
        assert getattr(est, f).item() == np.asarray(getattr(jest, f)).item(), f
    assert abs(est.snr_db.item() - float(jest.snr_db)) < 1e-3
    close(est.power.numpy(), np.asarray(jest.power))
    ct = radar.corner_turn(t(h), 4)
    np.testing.assert_array_equal(ct.numpy(), np_of(jradar.corner_turn(
        cx.from_complex(jnp.asarray(h)), 4)).astype(np.complex64))


def test_radar_frame_on_the_bench_scene():
    """One dwell of bench.py's radar scene (12 m, 5 m/s, 25°, 10 m²,
    QPSK-3/4 80 B) through an empty background: estimate fields equal, map
    and channel estimate within 1e-5 · max, the estimate recorded."""
    spec, jspec = specs(MCS.QPSK_3_4, 80)
    payload = jmake_payload(jspec, bytes([2]) + b"bench jrc")
    targets = SCENES["one"]
    f = jax.jit(lambda p, k, bg: jradar_chain.radar_frame(
        JCFG, jspec, p, jchannel.Targets(*targets), key=k, background=bg))
    jbg = jradar.init_background(8, CFG.n_virtual, CFG.fft_len)
    want = f(jnp.asarray(payload), jax.random.key(0), jbg)
    tab = tables.from_numpy(CFG, spec, "cpu")
    rtab = tables.radar_from_numpy(CFG, "cpu")
    bg = radar.init_background(8, CFG.n_virtual, CFG.fft_len, device="cpu")
    got = radar_chain.radar_frame(CFG, spec, tab, rtab, t(payload), channel.Targets(*targets),
                                  background=bg)
    for fld in ("range_idx", "angle_idx", "detected", "range_m", "angle_deg"):
        assert getattr(got.estimate, fld).item() == np.asarray(getattr(want.estimate, fld)).item()
    assert abs(got.estimate.snr_db.item() - float(want.estimate.snr_db)) < 1e-3
    close(got.ra_map.numpy(), np_of(want.ra_map))
    close(got.chan.numpy(), np_of(want.chan))
    assert got.estimate.detected.item() and abs(got.estimate.range_m.item() - 12.0) < 0.6
    assert int(got.background.count) == int(want.background.count) == 1
