"""The port's TX chain against jrc_tpu on the CPU: the coding TX functions
(and ``decode_bits``, their hard-decision inverse), ``encode_frame`` for all
six MCS, the SIG field, steering (phased and
Householder, the zero row, a row along e0), frame assembly, OFDM
modulation, and whole frames (the five cases of tests/golden_tx_frames.npz,
the radar streams with the reference's draws injected; the pinned bench
frame rebuilt through the port's TX and channel).

Bits, symbol values and SIG symbols must be equal; float waveforms are held
within 1e-5 · max|reference| (torch.fft against the reference's DFT
matmuls; measured about 5e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrc_tpu import config as jconfig
from jrc_tpu.models import comm_link as jcomm_link
from jrc_tpu.ops import channel as jchannel, coding as jcoding, cplx as cx, encoder as jencoder
from jrc_tpu.ops import ofdm as jofdm, precoder as jprecoder
from jrc_tpu_torch import capture, tables
from jrc_tpu_torch.config import MCS, PacketType
from jrc_tpu_torch.models import comm_link
from jrc_tpu_torch.ops import channel, coding, encoder, ofdm, precoder
from tests.torch_parity import CFG, JCFG, cplx, np_of, specs, t

RTOL = 1e-5
ROOT_GOLDEN = "tests/golden_tx_frames.npz"


def close(got, want, rtol=RTOL):
    """|got − want| ≤ rtol · max|want| (complex or real)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def tab(spec):
    return tables.from_numpy(CFG, spec, "cpu")


def test_scramble_conv_encode_and_packing(rng):
    cycle_t, phase_t = (t(a) for a in coding._scrambler_tables()[:2])
    bits = rng.integers(0, 2, (3, 301)).astype(np.uint8)
    for seed in (1, 5, 93, 127):
        np.testing.assert_array_equal(
            coding.scramble_sequence(seed, 301, cycle_t, phase_t).numpy(),
            np.asarray(jcoding.scramble_sequence(seed, 301)))
        np.testing.assert_array_equal(coding.scramble(t(bits), seed, cycle_t, phase_t).numpy(),
                                      np.asarray(jcoding.scramble(jnp.asarray(bits), seed)))
    np.testing.assert_array_equal(coding.conv_encode(t(bits)).numpy(),
                                  np.asarray(jcoding.conv_encode(jnp.asarray(bits))))
    data = rng.integers(0, 256, (2, 37)).astype(np.uint8)
    np.testing.assert_array_equal(coding.bytes_to_bits(t(data)).numpy(),
                                  np.asarray(jcoding.bytes_to_bits(jnp.asarray(data))))
    assert coding.crc32_host(data[0].tobytes()) == jcoding.crc32_host(data[0].tobytes())
    for n_bpsc in (1, 2, 4):
        np.testing.assert_array_equal(coding.split_symbols(t(bits), n_bpsc).numpy(),
                                      np.asarray(jcoding.split_symbols(jnp.asarray(bits), n_bpsc)))


@pytest.mark.parametrize("mcs", list(MCS), ids=lambda m: m.name)
def test_puncture_and_encode_frame_match(mcs, rng):
    """Punctured bits and the encoded symbols of a batch of payloads, with
    two scrambler seeds: equal."""
    spec, jspec = specs(mcs, 53)
    coded = rng.integers(0, 2, (2, 2 * spec.packet_params.n_data_bits)).astype(np.uint8)
    np.testing.assert_array_equal(coding.puncture(t(coded), spec.mcs).numpy(),
                                  np.asarray(jcoding.puncture(jnp.asarray(coded), jspec.mcs)))
    payload = rng.integers(0, 256, (2, 53)).astype(np.uint8)
    for seed in (1, 77):
        got = encoder.encode_frame(spec, tab(spec), t(payload), seed).numpy()
        want = np_of(jax.jit(lambda p, sd: jencoder.encode_frame(jspec, p, sd))(
            jnp.asarray(payload), seed))
        assert got.shape == want.shape == (2, spec.n_ofdm_sym, 48)
        np.testing.assert_array_equal(got, want.astype(np.complex64))


@pytest.mark.parametrize("mcs", [MCS.QPSK_1_2, MCS.QAM16_3_4], ids=lambda m: m.name)
def test_decode_bits_matches(mcs, rng):
    """Hard-decision decode of punctured coded bits with a few flipped:
    the same bits as the reference's decode_bits, and the sent bits back."""
    from jrc_tpu.ops import viterbi as jviterbi
    from jrc_tpu_torch.ops import decoder

    spec, _ = specs(mcs, 20)
    n = 200
    bits = rng.integers(0, 2, (2, n)).astype(np.uint8)
    bits[:, -6:] = 0  # the zero tail
    coded = coding.puncture(coding.conv_encode(t(bits)), spec.mcs).numpy()
    coded[:, rng.integers(0, coded.shape[1], 3)] ^= 1
    got = decoder.decode_bits(t(coded), spec.mcs, n, tab(spec).trellis).numpy()
    want = np.asarray(jviterbi.decode_bits(jnp.asarray(coded), jconfig.MCS(int(mcs)), n))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, bits)


@pytest.mark.parametrize("mcs,ptype,n_bytes", [
    (MCS.BPSK_1_2, PacketType.DATA, 1), (MCS.QAM16_3_4, PacketType.DATA, 1500),
    (MCS.QPSK_1_2, PacketType.NDP, 24)])
def test_signal_field_symbols_match(mcs, ptype, n_bytes):
    spec, jspec = specs(mcs, n_bytes, jconfig.PacketType(int(ptype)))
    np.testing.assert_array_equal(precoder.signal_field_symbols(spec),
                                  jprecoder.signal_field_symbols(jspec))


@pytest.mark.parametrize("phased", [True, False], ids=["phased", "householder"])
def test_steering_matrices_match(phased, rng):
    """Rows: random, zero, along e0, along e0 with a phase, e1: Q within
    1e-6 (the reference's own construction, the zero row giving zero Q)."""
    h = cplx(rng, 7, CFG.n_tx)
    h[1] = 0
    h[2] = [1.5, 0, 0, 0]
    h[3] = [0.3 - 0.4j, 0, 0, 0]
    h[4] = [0, 1, 0, 0]
    got = precoder._q_from_h(t(h), CFG.n_tx, phased).numpy()
    want = np_of(jprecoder._q_from_h(cx.from_complex(jnp.asarray(h)), CFG.n_tx, phased))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert not got[1].any()
    chan = np.zeros((CFG.fft_len, CFG.n_tx), np.complex64)
    chan[CFG.active_carrier_idx] = cplx(rng, len(CFG.active_carrier_idx), CFG.n_tx)
    spec, _ = specs(MCS.QPSK_3_4, 40)
    q, qm = precoder.steering_from_chan_est(CFG, tab(spec), t(chan), phased=phased)
    jq, jqm = jprecoder.steering_from_chan_est(JCFG, cx.from_complex(jnp.asarray(chan)), phased)
    np.testing.assert_allclose(q.numpy(), np_of(jq), atol=1e-6)
    np.testing.assert_allclose(qm.numpy(), np_of(jqm), atol=1e-6)
    for angle in (-40.0, 0.0, 25.0):
        got = precoder.steering_from_angle(CFG, torch.tensor(angle), phased=phased)
        np.testing.assert_allclose(
            got.numpy(), np_of(jprecoder.steering_from_angle(JCFG, jnp.float32(angle), phased)),
            atol=1e-6)
    mean = cplx(rng, CFG.n_tx)
    np.testing.assert_allclose(
        precoder.mean_channel_angle(t(mean)).numpy(),
        np.asarray(jprecoder.mean_channel_angle(cx.from_complex(jnp.asarray(mean)))), atol=1e-4)


def test_ofdm_ops_match(rng):
    spec, _ = specs(MCS.QPSK_3_4, 40)
    data = cplx(rng, 2, 5, 48)
    for row0 in (0, 125):
        got = ofdm.allocate_carriers(CFG, tab(spec), t(data), pilot_row0=row0).numpy()
        np.testing.assert_array_equal(got, np_of(jofdm.allocate_carriers(
            JCFG, cx.from_complex(jnp.asarray(data)), pilot_row0=row0)))
    grid = cplx(rng, 3, 6, CFG.fft_len)
    x = ofdm.ofdm_modulate(CFG, t(grid))
    close(x.numpy(), np_of(jofdm.ofdm_modulate(JCFG, cx.from_complex(jnp.asarray(grid)))))
    samples = cplx(rng, 2, 6 * CFG.sym_len + 7)
    close(ofdm.ofdm_demodulate(CFG, t(samples), 6).numpy(),
          np_of(jofdm.ofdm_demodulate(JCFG, cx.from_complex(jnp.asarray(samples)), 6)))
    close(ofdm.ofdm_demodulate(CFG, x, 6).numpy(), grid)  # the round trip
    padded = ofdm.zero_pad(t(samples), 400, 17).numpy()
    np.testing.assert_array_equal(padded, np_of(jofdm.zero_pad(
        cx.from_complex(jnp.asarray(samples)), 400, 17)))
    close(precoder.assemble_siso_frame(CFG, tab(spec), t(data[0])).numpy(),
          np_of(jprecoder.assemble_siso_frame(JCFG, cx.from_complex(jnp.asarray(data[0])))))


def _golden_steering(spec):
    """(per-subcarrier phased Q, mean Householder Q) of the golden file's
    sounded channel: a ULA at 18° on the active carriers."""
    h = np.zeros((CFG.fft_len, CFG.n_tx), np.complex64)
    h[CFG.active_carrier_idx] = np.exp(1j * np.pi * np.sin(np.deg2rad(18.0)) * np.arange(CFG.n_tx))
    q_phased, _ = precoder.steering_from_chan_est(CFG, tab(spec), t(h), phased=True)
    _, qm_svd = precoder.steering_from_chan_est(CFG, tab(spec), t(h), phased=False)
    return q_phased, qm_svd


@pytest.mark.parametrize("case", ["data_fourier", "data_steered_phased", "data_mean_svd",
                                  "data_radar_streams", "ndp"])
def test_tx_frame_reproduces_the_golden_frames(case):
    """The five pinned 4-antenna waveforms; the radar streams take the
    reference's randint draws of PRNGKey(7)."""
    g = np.load(ROOT_GOLDEN)
    spec, _ = specs(MCS(int(g[f"{case}_mcs"])), int(g[f"{case}_payload_bytes"]),
                    jconfig.PacketType(int(g[f"{case}_ptype"])))
    q_phased, qm_svd = _golden_steering(spec)
    kw = {"data_steered_phased": dict(steering=q_phased), "data_mean_svd": dict(
        mean_steering=qm_svd)}.get(case, {})
    if case == "data_radar_streams":
        n_active = CFG.n_data_carriers + CFG.n_pilot_carriers
        vals = jax.random.randint(jax.random.PRNGKey(7), (CFG.n_tx - 1, spec.n_ofdm_sym, n_active),
                                  0, 4)
        kw = dict(use_radar_streams=True, radar_values=t(vals).long())
    tx = comm_link.tx_frame(CFG, spec, tab(spec), t(g[f"{case}_payload"]), 1, **kw)
    close(tx.samples.numpy(), g[f"{case}_wave"])
    assert tx.grid.shape == (4 + 1 + CFG.n_ltf + spec.n_ofdm_sym, CFG.n_tx, CFG.fft_len)


def test_tx_frame_with_padding_and_radar_streams_matches(rng):
    """Padded frame and grid against the reference's tx_frame with the same
    key, the radar-stream values rebuilt from it; without values or a
    generator the radar streams raise."""
    spec, jspec = specs(MCS.QAM16_1_2, 33)
    payload = rng.integers(0, 256, 33).astype(np.uint8)
    key = jax.random.PRNGKey(4)
    ref = jax.jit(lambda p: jcomm_link.tx_frame(JCFG, jspec, p, 9, use_radar_streams=True,
                                                rng_key=key, pad_front=400, pad_tail=240))(
        jnp.asarray(payload))
    n_active = CFG.n_data_carriers + CFG.n_pilot_carriers
    vals = jax.random.randint(key, (CFG.n_tx - 1, spec.n_ofdm_sym, n_active), 0, 4)
    got = comm_link.tx_frame(CFG, spec, tab(spec), t(payload), 9, use_radar_streams=True,
                             radar_values=t(vals).long(), pad_front=400, pad_tail=240)
    close(got.samples.numpy(), np_of(ref.samples))
    close(got.grid.numpy(), np_of(ref.grid))
    with pytest.raises(ValueError, match="radar"):
        comm_link.tx_frame(CFG, spec, tab(spec), t(payload), 9, use_radar_streams=True)


def test_bench_frame_rebuilt_by_the_port(rng):
    """The pinned bench frame (reference TX + comm channel at angle 0, path
    loss 5, CFO 0.02·2π/64) from the port's tx_frame and comm_channel."""
    frame, payload, _ = capture.load_bench_frame()
    spec, _ = specs(MCS.QPSK_3_4, 64)
    tx = comm_link.tx_frame(CFG, spec, tab(spec), t(payload), 1)
    got = channel.comm_channel(tx.samples, angle_deg=0.0, path_loss=5.0,
                               cfo=0.02 * 2 * np.pi / CFG.fft_len)
    close(got.numpy(), frame)
    # and the channel itself against the reference's on the same samples
    x = cplx(rng, CFG.n_tx, 500)
    for angle, cfo in ((0.0, 0.0), (25.0, 0.003)):
        close(channel.comm_channel(t(x), angle_deg=angle, path_loss=20.0, cfo=cfo).numpy(),
              np_of(jchannel.comm_channel(cx.from_complex(jnp.asarray(x)), angle_deg=angle,
                                          path_loss=20.0, noise_var=0.0, cfo=cfo)))
