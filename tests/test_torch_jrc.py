"""The port's comm leg and JRC dwell against jrc_tpu on the CPU: per-frame
detection (the K2 chain, and ``strict_runs``) and extraction (K3),
``rx_chain`` on DATA and NDP bursts with both estimators and soft
decisions, ``loopback``, the steering fallback chain, and ``jrc_step`` over
the pinned dwell sequence (``capture.JRC_DWELLS``: the Fourier fallback, an
NDP sounding frame, Householder steering with radar streams, radar-aided
steering) with the reference's draws injected, from the initial state and
from a state the reference produced (``state_from_numpy``).

Exactly equal: triggers, validity, candidate counts, payloads, CRC flags,
SIG fields, detection indices, ``detected``, range and angle, the state's
booleans and counters. Within 1e-5 · max|reference|: symbols, channel
estimates (``chan_est_full``, ``chan_mean``, the state's), the map's peak
row and column, peak power; SNRs within 1e-3 dB; coarse CFO within 1e-6
rad/sample. The reference is computed once per module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrc_tpu import config as jconfig
from jrc_tpu.models import comm_link as jcomm_link, jrc_trx as jjrc
from jrc_tpu.ops import channel as jchannel, cplx as cx, sync as jsync
from jrc_tpu_torch import capture, tables
from jrc_tpu_torch.config import MCS
from jrc_tpu_torch.models import comm_link, jrc_trx
from jrc_tpu_torch.ops import channel, precoder, sync
from scripts import pin_torch_jrc
from tests.torch_parity import CFG, JCFG, np_of, specs, t

RTOL = 1e-5
NDP = jconfig.PacketType.NDP


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), err / np.abs(want).max()


def tab(spec):
    return tables.from_numpy(CFG, spec, "cpu")


@pytest.fixture(scope="module")
def reference():
    """The pinned dwell sequence recomputed by jrc_tpu."""
    return pin_torch_jrc.reference_dwells()


def test_pinned_dwells_are_current(reference):
    """jrc_tpu_torch/data/jrc_dwells.npz is what the reference gives today
    (scripts/pin_torch_jrc.py rewrites it): every integer and boolean array
    equal; each dwell's record within ``capture.jrc_mismatches``' tolerances,
    its comm-noise draws and map peak within 1e-5 relative (XLA:CPU's float
    results may differ in the last bits between machines)."""
    with np.load(capture.JRC_FIXTURE) as f:
        pinned = {k: f[k] for k in f}
    assert sorted(pinned) == sorted(reference)
    for k, v in reference.items():
        if not np.issubdtype(v.dtype, np.inexact):
            np.testing.assert_array_equal(pinned[k], v, err_msg=k)
    for i in range(len(capture.JRC_DWELLS)):
        got, want = ({k[len(f"d{i}_"):]: v for k, v in arrays.items() if k.startswith(f"d{i}_")}
                     for arrays in (pinned, reference))
        assert capture.jrc_mismatches(capture.jrc_record(got), capture.jrc_record(want)) == [], i
        for k in ("comm_noise", "map_max"):
            close(got[k], want[k])
    assert capture.JRC_FIXTURE.stat().st_size < 300_000


def _run(trx, dwells, state):
    records = []
    for dw in dwells:
        spec, payload, targets, draws, opts = capture.pinned_step_args(dw, "cpu")
        r = trx(state, spec, payload, targets, draws=draws, **opts)
        state = r.state
        records.append(capture.step_record(r))
    return records


def test_jrc_step_reproduces_the_pinned_dwells(reference):
    trx = jrc_trx.JRCTrx(CFG, device="cpu")
    dwells = capture.pinned_jrc_dwells()
    for i, (got, dw) in enumerate(zip(_run(trx, dwells, trx.init_state()), dwells)):
        assert capture.jrc_mismatches(got, capture.jrc_record(dw.want)) == [], i
    # the loop closes: detected every dwell, the sounding frame sets the
    # estimate, and the steered frames decode
    assert [bool(dw.want["detected"]) for dw in dwells] == [True] * 4
    assert [bool(dw.want["crc_ok"]) for dw in dwells] == [False, True, True, True]


def test_jrc_step_from_a_reference_state():
    """Dwells 2 and 3 from the state the reference left after dwell 1."""
    dwells = capture.pinned_jrc_dwells()
    leaves = [dwells[1].want[f"state_{n}"] for n in capture.JRC_STATE_LEAVES]
    state = jrc_trx.state_from_numpy(leaves, "cpu")
    for got, want in zip(jrc_trx.state_to_numpy(state), leaves):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    trx = jrc_trx.JRCTrx(CFG, device="cpu")
    for got, dw in zip(_run(trx, dwells[2:], state), dwells[2:]):
        assert capture.jrc_mismatches(got, capture.jrc_record(dw.want)) == []


def test_jrc_step_reads_nothing_back():
    """One dwell dispatches no operation that reads a value back to the host
    (on the card each would be a host sync): no scalar read, no nonzero."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(name in str(func) for name in ("_local_scalar_dense", "nonzero")):
                self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    trx = jrc_trx.JRCTrx(CFG, device="cpu")
    dw = capture.pinned_jrc_dwells()[3]
    spec, payload, targets, draws, opts = capture.pinned_step_args(dw, "cpu")
    state = trx.init_state()._replace(radar_valid=torch.tensor(True))
    with Reads() as reads:
        trx(state, spec, payload, targets, draws=draws, **opts)
    assert reads.seen == []


def test_jrc_trx_runs_on_the_card_unless_told():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            jrc_trx.JRCTrx(CFG)
    trx = jrc_trx.JRCTrx(CFG, device="cpu")
    assert {b.device.type for b in trx.buffers()} == {"cpu"}
    spec, _ = specs(MCS.QPSK_3_4, 80)
    with pytest.raises(RuntimeError, match="device"):
        trx(trx.init_state(), spec, torch.zeros(80, dtype=torch.uint8, device="meta"),
            channel.Targets(*((v,) for v in capture.JRC_TARGET)))


def test_select_steering_fallback_chain():
    """Nothing valid → Fourier; radar valid → the ULA vector in column 0;
    channel valid → the estimate's steering, per subcarrier unless smoothing
    or radar-aided; each against the reference's choice."""
    spec, _ = specs(MCS.QPSK_3_4, 80)
    st = jrc_trx.init_state(CFG, device="cpu")
    js = jjrc.init_state(JCFG)
    h = np.zeros((CFG.fft_len, CFG.n_tx), np.complex64)
    h[CFG.active_carrier_idx] = np.exp(1j * np.pi * np.sin(np.deg2rad(-12.0)) * np.arange(4))
    for radar_valid, chan_valid in ((False, False), (True, False), (False, True), (True, True)):
        s = st._replace(radar_valid=torch.tensor(radar_valid), radar_angle=torch.tensor(20.0),
                        chan_valid=torch.tensor(chan_valid), chan_est=t(h))
        j = js._replace(radar_valid=jnp.bool_(radar_valid), radar_angle=jnp.float32(20.0),
                        chan_valid=jnp.bool_(chan_valid), chan_est=cx.from_complex(jnp.asarray(h)))
        for ra, ph, sm in ((True, True, False), (False, False, False), (False, True, True)):
            per_sc, mean_q = jrc_trx.select_steering(CFG, tab(spec), s, radar_aided=ra,
                                                     phased_steering=ph, smoothing=sm)
            jper_sc, jmean_q = jjrc.select_steering(JCFG, j, radar_aided=ra,
                                                    phased_steering=ph, smoothing=sm)
            np.testing.assert_allclose(mean_q.numpy(), np_of(jmean_q), atol=1e-6)
            assert (per_sc is None) == (jper_sc is None)
            if per_sc is not None:
                np.testing.assert_allclose(per_sc.numpy(), np_of(jper_sc), atol=1e-6)
    _, mq = jrc_trx.select_steering(CFG, tab(spec), st, radar_aided=True, phased_steering=True,
                                    smoothing=False)
    np.testing.assert_allclose(mq.numpy(), precoder.fourier_matrix(4), atol=1e-6)


def _burst(jspec, text, key, snr_db=30.0, cfo=0.02 * 2 * np.pi / 64):
    """A reference burst: TX frame with the loopback padding, the comm
    channel with CFO at angle 10°, AWGN at ``snr_db``, the guard tail."""
    payload = np.zeros(jspec.payload_bytes, np.uint8)
    payload[: len(text)] = np.frombuffer(text, np.uint8)

    def burst(p):
        tx = jcomm_link.tx_frame(JCFG, jspec, p, 1, pad_front=5 * CFG.sym_len,
                                 pad_tail=6 * CFG.sym_len + 10)
        clean = jchannel.comm_channel(tx.samples, angle_deg=10.0, path_loss=10.0, noise_var=0.0,
                                      cfo=cfo)
        rx = jchannel.awgn(key, clean, jnp.mean(cx.abs2(clean)) / 10.0 ** (snr_db / 10.0))
        return cx.concatenate([rx, cx.zeros(2 * CFG.n_sync_words * CFG.sym_len)], axis=-1)

    return np_of(jax.jit(burst)(jnp.asarray(payload))).astype(np.complex64), payload


@pytest.fixture(scope="module")
def bursts():
    """(port spec, reference spec, samples, payload) of a DATA and an NDP burst."""
    out = {}
    for name, mcs, n_bytes, ptype, text in (
            ("data", MCS.QPSK_3_4, 80, jconfig.PacketType.DATA, b"\x02rx chain"),
            ("ndp", MCS.QPSK_1_2, 24, NDP, b"\x01")):
        spec, jspec = specs(mcs, n_bytes, ptype)
        x, payload = _burst(jspec, text, jax.random.PRNGKey(len(name)))
        out[name] = (spec, jspec, x, payload)
    return out


@pytest.mark.parametrize("strict_runs", [False, True], ids=["gap-tolerant", "strict-runs"])
def test_detect_and_extract_frame_match(bursts, strict_runs):
    _, _, x, _ = bursts["data"]
    # a second copy of the burst behind the first, and an owned window
    x2 = np.concatenate([x, x[:1900]])
    for xs, kw in ((x, {}), (x2, {"own_window": (0, 1000)})):
        got = sync.detect_frames(CFG, t(xs), strict_runs=strict_runs, **kw)
        want = jax.jit(lambda v: jsync.detect_frames(JCFG, v, strict_runs=strict_runs, **kw))(
            cx.from_complex(jnp.asarray(xs)))
        for f in ("start", "valid", "n_candidates"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        np.testing.assert_allclose(got.coarse_cfo.numpy(), np.asarray(want.coarse_cfo), atol=1e-6)
    assert bool(got.valid[0])
    n_sym = 2 + 1 + CFG.n_ltf + 10
    extract = jax.jit(lambda v, trig, cfo: jsync.extract_frame(JCFG, v, trig, cfo, n_sym))
    for trig in (int(got.start[0]), 5, len(x) - 100):  # in range; clamped at both ends
        syms, cfo, found = sync.extract_frame(CFG, t(x), torch.tensor(trig), got.coarse_cfo[0],
                                              n_sym)
        jsyms, jcfo, jfound = extract(cx.from_complex(jnp.asarray(x)), jnp.int32(trig),
                                      jnp.float32(got.coarse_cfo[0]))
        close(syms.numpy(), np_of(jsyms))
        assert abs(float(cfo) - float(jcfo)) < 1e-6 and bool(found) == bool(jfound)
    np.testing.assert_array_equal(sync.symbol_sample_offsets(CFG, 7),
                                  jsync.symbol_sample_offsets(JCFG, 7))


@pytest.mark.parametrize("name,estimator,soft", [
    ("data", "ls", False), ("data", "sta", False), ("data", "ls", True), ("ndp", "ls", False),
    ("ndp", "sta", False)])
def test_rx_chain_matches(bursts, name, estimator, soft):
    spec, jspec, x, payload = bursts[name]
    got = comm_link.rx_chain(CFG, spec, tab(spec), t(x), estimator=estimator, soft=soft)
    want = jax.jit(lambda s: jcomm_link.rx_chain(JCFG, jspec, s, estimator=estimator,
                                                 soft=soft))(cx.from_complex(jnp.asarray(x)))
    for f in ("payload", "crc_ok", "scrambler_seed"):
        np.testing.assert_array_equal(getattr(got.decoded, f).numpy(),
                                      np.asarray(getattr(want.decoded, f)), err_msg=f)
    for f in ("sig_rate_bitmap", "sig_length", "sig_ptype", "sig_ok"):
        assert getattr(got.eq, f).item() == np.asarray(getattr(want.eq, f)).item(), f
    np.testing.assert_array_equal(got.detection.start.numpy(), np.asarray(want.detection.start))
    assert bool(got.sync_found) == bool(want.sync_found)
    for f in ("snr_legacy", "snr_data"):
        assert abs(getattr(got.eq, f).item() - float(getattr(want.eq, f))) < 1e-3, f
    close(got.eq.chan_mean.numpy(), np_of(want.eq.chan_mean))
    if name == "ndp":
        close(got.eq.chan_est_full.numpy(), np_of(want.eq.chan_est_full))
    else:
        assert not got.eq.chan_est_full.any() and bool(got.decoded.crc_ok)
        np.testing.assert_array_equal(got.decoded.payload.numpy(), payload)
    assert bool(got.eq.sig_ok)


def test_loopback_matches_with_the_reference_noise():
    spec, jspec = specs(MCS.QAM16_1_2, 40)
    payload = np.arange(40, dtype=np.uint8)
    key = jax.random.PRNGKey(21)
    want = jax.jit(lambda p: jcomm_link.loopback(JCFG, jspec, p, key=key, angle_deg=15.0,
                                                 cfo=0.003))(jnp.asarray(payload))
    n = (4 + 1 + CFG.n_ltf + spec.n_ofdm_sym + 5 + 6) * CFG.sym_len + 10
    noise = np_of(jchannel.awgn(jax.random.split(key)[1], cx.zeros((n,)), 2.0))
    got = comm_link.loopback(CFG, spec, tab(spec), t(payload), noise=t(noise.astype(np.complex64)),
                             angle_deg=15.0, cfo=0.003)
    np.testing.assert_array_equal(got.decoded.payload.numpy(), np.asarray(want.decoded.payload))
    assert bool(got.decoded.crc_ok) and bool(want.decoded.crc_ok)
    np.testing.assert_array_equal(got.detection.start.numpy(), np.asarray(want.detection.start))
    assert abs(got.eq.snr_legacy.item() - float(want.eq.snr_legacy)) < 1e-3
    close(got.eq.z.numpy(), np_of(want.eq.z))
