"""The port at the antenna configurations that jrc_tpu's OFDMConfig accepts
beside its default 4 TX × 2 RX (``capture.ANTENNA_CONFIGS``: (n_tx, n_rx,
n_ltf) = (1, 1, 1), (2, 1, 2), (1, 2, 1), (4, 4, 4), (3, 2, 4)), against
jrc_tpu on the CPU. They move the MIMO-LTF count (frame header, frame
window, K3's widths), the virtual array (n_tx·n_rx·16 angle bins) and the
precoder's matrices (``legacy = min(2, n_tx)`` antennas carry the preamble).

- ``jrc_step``: two dwell sequences from the initial state
  (``capture.config_dwells``), the reference's draws injected: the
  ``__graft_entry__.py`` dwell three times in a row with the background
  recorded, and an NDP sounding frame followed by a DATA frame steered per
  subcarrier from its estimate (Householder) with radar streams. Exact: detection, range and
  angle, payload, CRC, trigger, SIG fields, the state's flags and counters;
  SNRs within 1e-3 dB (or both -inf: nothing detected); maps, powers and
  channel estimates within 1e-5 · max|reference| (``capture.jrc_mismatches``).
- ``radar_frame``: three dwells (PRNG keys 0-2) with radar streams on the
  antennas past the first and radar noise, the reference's draws injected:
  the estimate exactly, SNR within 1e-3 dB, map and channel estimate within
  1e-5 · max|reference|.
- ``scan_rx`` / ``scan_rx_dynamic`` at n_ltf 1 and 2 on small captures of
  frames the port encodes there (``capture.config_frame``): every integer
  field equal, SNRs within 1e-3 dB, the NDP estimate within 1e-5 · max|h|.

The reference's programs are jitted and compiled four at a time in threads
(XLA compiles outside the interpreter lock; module fixture ``references``).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrc_tpu import config as jconfig
from jrc_tpu.models import jrc_trx as jjrc, radar_chain as jradar_chain, streaming as jst
from jrc_tpu.ops import channel as jchannel, cplx as cx
from jrc_tpu_torch import capture, tables
from jrc_tpu_torch.config import MCS, PacketType
from jrc_tpu_torch.models import comm_link, jrc_trx, radar_chain, streaming as tst
from jrc_tpu_torch.ops import channel
from jrc_tpu_torch.ops.encoder import FrameSpec
from scripts.pin_torch_jrc import EST_FIELDS
from tests.torch_parity import np_of, specs

CONFIGS = capture.ANTENNA_CONFIGS
IDS = ["x".join(map(str, c)) for c in CONFIGS]
SEQUENCES = {"entry": capture.ENTRY_DWELLS, "sounding": capture.SOUNDING_DWELLS}
SCAN_CONFIGS = [c for c in CONFIGS if c[2] in (1, 2) and c[1] == 1]  # n_ltf 1 and 2
N_RADAR_DWELLS = 3
RADAR_NOISE_VAR = 1e-12  # 12-17 dB under the echo's mean power at each RX antenna
BLOCK_LEN, N_BLOCKS, MAX_FRAMES = 2**13, 4, 4
MAXP = 64
#: the dynamic capture's frames: two MCS and an NDP frame, payloads up to MAXP
DYN_TRAFFIC = ((MCS.BPSK_1_2, 16, PacketType.DATA), (MCS.QAM16_3_4, 48, PacketType.DATA),
               (MCS.QPSK_1_2, 12, PacketType.NDP))


def configs(c):
    """(port OFDMConfig, reference OFDMConfig) at (n_tx, n_rx, n_ltf) ``c``."""
    kw = dict(zip(("n_tx", "n_rx", "n_ltf"), c))
    return capture.antenna_config(**kw), jconfig.OFDMConfig(**kw)


def entry_spec():
    """(port spec, reference spec) of ``capture.ENTRY_FRAME``."""
    mcs, n_bytes, ptype, _ = capture.ENTRY_FRAME
    return specs(MCS[mcs], n_bytes, jconfig.PacketType[ptype])


def reference_jrc(c, dwells) -> tuple[list, list, list[dict]]:
    """jrc_tpu's dwell sequence ``dwells`` at ``c`` from its initial state,
    dwell i on PRNG key i → (comm-noise draws, radar-stream values or None,
    each dwell's record in ``capture.step_record``'s form)."""
    _, jcfg = configs(c)
    state = jjrc.init_state(jcfg)
    steps, noise, values, records = {}, [], [], []
    for i, dwell in enumerate(dwells):
        frame, kw = dwell
        spec, _, _, options = capture.dwell_args(dwell, "cpu")
        _, jspec = specs(spec.mcs, spec.payload_bytes, jconfig.PacketType(int(spec.packet_type)))
        tag = (jspec, tuple(sorted(kw.items())))
        if tag not in steps:
            targets = jchannel.Targets(*((v,) for v in capture.ENTRY_TARGET))
            steps[tag] = jax.jit(lambda s, p, k, jspec=jspec, options=options: jjrc.jrc_step(
                jcfg, s, jspec, p, targets, key=k, **options))
        key = jax.random.PRNGKey(i)
        r = steps[tag](state, jnp.asarray(capture.jrc_payload(frame)), key)
        state = r.state
        k_tx, _, k_comm = jax.random.split(key, 3)
        n = capture.comm_noise_samples(jcfg, jspec)
        noise.append(np_of(jchannel.awgn(k_comm, cx.zeros((n,)), 2.0)).astype(np.complex64))
        n_active = jcfg.n_data_carriers + jcfg.n_pilot_carriers
        values.append(np.asarray(jax.random.randint(
            k_tx, (jcfg.n_tx - 1, jspec.n_ofdm_sym, n_active), 0, 4))
            if kw.get("use_radar_streams") else None)
        rec = {f: np.asarray(getattr(r.radar_est, f)) for f in EST_FIELDS}
        ra = np_of(r.ra_map)
        rec["map_row"], rec["map_col"] = ra[int(rec["range_idx"])], ra[:, int(rec["angle_idx"])]
        dec, eq = r.comm.decoded, r.comm.eq
        rec.update(payload=np.asarray(dec.payload), crc_ok=np.asarray(dec.crc_ok),
                   start=np.asarray(r.comm.detection.start))
        for f in ("snr_legacy", "snr_data", "sig_rate_bitmap", "sig_length", "sig_ptype",
                  "sig_ok"):
            rec[f] = np.asarray(getattr(eq, f))
        rec["chan_mean"], rec["chan_est_full"] = np_of(eq.chan_mean), np_of(eq.chan_est_full)
        leaves = jax.tree_util.tree_leaves(state)
        rec.update({f"state_{name}": np.asarray(leaf)
                    for name, leaf in zip(capture.JRC_STATE_LEAVES, leaves)})
        records.append(capture.jrc_record(rec))
    return noise, values, records


def radar_samples(cfg, spec) -> int:
    """Samples of a radar_frame echo: the frame with 3 symbols of tail."""
    return (cfg.n_sync_words + 1 + cfg.n_ltf + spec.n_ofdm_sym + 3) * cfg.sym_len


def reference_radar(c) -> list[tuple]:
    """jrc_tpu's radar_frame at ``c``, keys 0-2, with radar streams where
    n_tx > 1 and radar noise → [(radar values or None, radar noise pairs,
    {estimate fields, "ra_map", "chan"})]."""
    _, jcfg = configs(c)
    _, jspec = entry_spec()
    targets = jchannel.Targets(*((v,) for v in capture.ENTRY_TARGET))
    streams = jcfg.n_tx > 1
    frame = jax.jit(lambda p, k: jradar_chain.radar_frame(
        jcfg, jspec, p, targets, key=k, noise_var=RADAR_NOISE_VAR, use_radar_streams=streams))
    shape = (jcfg.n_rx, radar_samples(jcfg, jspec))
    draw = jax.jit(lambda k: jchannel.awgn(jax.random.split(k, 3)[2], cx.zeros(shape), 2.0))
    payload = jnp.asarray(capture.jrc_payload(capture.ENTRY_FRAME))
    n_active = jcfg.n_data_carriers + jcfg.n_pilot_carriers
    out = []
    for i in range(N_RADAR_DWELLS):
        key = jax.random.PRNGKey(i)
        r = frame(payload, key)
        values = (np.asarray(jax.random.randint(jax.random.split(key, 3)[0], (
            jcfg.n_tx - 1, jspec.n_ofdm_sym, n_active), 0, 4)) if streams else None)
        want = {f: np.asarray(getattr(r.estimate, f)) for f in EST_FIELDS}
        want.update(ra_map=np_of(r.ra_map), chan=np_of(r.chan))
        out.append((values, np_of(draw(key)).astype(np.complex64), want))
    return out


def port_frame(c, traffic):
    """[(frame, payload)] encoded by the port at ``c``."""
    cfg, _ = configs(c)
    return [capture.config_frame(cfg, FrameSpec(mcs, n, ptype), b"cfg")
            for mcs, n, ptype in traffic]


def static_capture(c):
    cfg, _ = configs(c)
    spec, _ = specs(MCS.QPSK_3_4, 64)
    (frame, payload), = port_frame(c, [(MCS.QPSK_3_4, 64, PacketType.DATA)])
    halo = tst.frame_window_samples(cfg, spec) + cfg.fft_len
    cap, n_frames = capture.build_capture(frame, BLOCK_LEN * N_BLOCKS, halo=halo)
    return cap, n_frames, payload


def dynamic_capture(c):
    cfg, _ = configs(c)
    frames = port_frame(c, DYN_TRAFFIC)
    halo = tst.frame_window_samples_dynamic(cfg, MAXP) + cfg.fft_len
    cap, placed = capture.build_mixed_capture([f for f, _ in frames], BLOCK_LEN * N_BLOCKS,
                                              halo=halo)
    return cap, placed, frames


def reference_scan(c, cap):
    _, jcfg = configs(c)
    _, jspec = specs(MCS.QPSK_3_4, 64)
    return jax.jit(lambda x: jst.scan_rx(jcfg, jspec, x, BLOCK_LEN, N_BLOCKS,
                                         max_frames_per_block=MAX_FRAMES))(jnp.asarray(cap))


def reference_scan_dynamic(c, cap):
    _, jcfg = configs(c)
    return jax.jit(lambda x: jst.scan_rx_dynamic(jcfg, x, BLOCK_LEN, N_BLOCKS,
                                                 max_frames_per_block=MAX_FRAMES,
                                                 max_payload=MAXP))(jnp.asarray(cap))


@pytest.fixture(scope="module")
def captures():
    return {c: (static_capture(c), dynamic_capture(c)) for c in SCAN_CONFIGS}


@pytest.fixture(scope="module")
def references(captures):
    """Every reference result of this module, computed four programs at a
    time in threads → {case: future}."""
    with ThreadPoolExecutor(4) as pool:
        futures = {(name, c): pool.submit(reference_jrc, c, dwells)
                   for name, dwells in SEQUENCES.items() for c in CONFIGS}
        futures.update({("radar", c): pool.submit(reference_radar, c) for c in CONFIGS})
        for c, (static, dynamic) in captures.items():
            futures["scan", c] = pool.submit(reference_scan, c, static[0])
            futures["scan_dynamic", c] = pool.submit(reference_scan_dynamic, c, dynamic[0])
        yield futures


@pytest.mark.parametrize("sequence", SEQUENCES)
@pytest.mark.parametrize("c", CONFIGS, ids=IDS)
def test_jrc_step_at_antenna_config(c, sequence, references):
    """A dwell sequence at ``c`` equals jrc_tpu's in every integer field,
    floats within ``capture.jrc_mismatches``' tolerances. "entry": the
    ``__graft_entry__.py`` dwell three times, the background recorded (with
    one TX the beam does not move, and from the second dwell on the
    background takes up the static echo); "sounding": an NDP frame whose
    estimate steers the next DATA frame per subcarrier, radar streams on the
    other antennas. The target is seen in the first dwell; every sounding
    DATA frame decodes."""
    cfg, _ = configs(c)
    noise, values, want = references[sequence, c].result()
    got = capture.config_dwells(jrc_trx.JRCTrx(cfg, device="cpu"), SEQUENCES[sequence], noise,
                                values)
    for i, (g, w) in enumerate(zip(got, want)):
        assert capture.jrc_mismatches(g, w) == [], (c, sequence, i)
    assert bool(want[0]["detected"]) and abs(float(want[0]["range_m"]) - 12.0) < 0.6
    if sequence == "sounding":
        assert bool(want[0]["chan_valid"]) and bool(want[1]["crc_ok"])


@pytest.mark.parametrize("c", CONFIGS, ids=IDS)
def test_radar_frame_at_antenna_config(c, references):
    """Three radar dwells equal jrc_tpu's: estimate fields exactly (SNR
    within 1e-3 dB), map and channel estimate within 1e-5 · max; the target
    found at 12 m in each."""
    cfg, _ = configs(c)
    spec, _ = entry_spec()
    tab, rtab = tables.from_numpy(cfg, spec, "cpu"), tables.radar_from_numpy(cfg, "cpu")
    payload = torch.from_numpy(capture.jrc_payload(capture.ENTRY_FRAME))
    targets = channel.Targets(*((v,) for v in capture.ENTRY_TARGET))
    for values, noise, want in references["radar", c].result():
        draws = comm_link.Draws(radar_values=None if values is None
                                else torch.tensor(values, dtype=torch.int64),
                                radar_noise=torch.from_numpy(noise))
        got = radar_chain.radar_frame(cfg, spec, tab, rtab, payload, targets, draws=draws,
                                      noise_var=RADAR_NOISE_VAR,
                                      use_radar_streams=values is not None)
        est = got.estimate
        for f in ("range_idx", "angle_idx", "detected", "range_m", "angle_deg"):
            assert getattr(est, f).item() == want[f].item(), (c, f)
        assert abs(est.snr_db.item() - float(want["snr_db"])) <= 1e-3
        for name, g, w in (("power", est.power.numpy(), want["power"]),
                           ("ra_map", got.ra_map.numpy(), want["ra_map"]),
                           ("chan", got.chan.numpy(), want["chan"])):
            err = np.abs(g - w).max()
            assert err <= 1e-5 * np.abs(w).max(), (c, name, err / np.abs(w).max())
        assert est.detected.item() and abs(est.range_m.item() - 12.0) < 0.6


@pytest.mark.parametrize("c", SCAN_CONFIGS, ids=["x".join(map(str, c)) for c in SCAN_CONFIGS])
def test_scan_rx_at_n_ltf(c, captures, references):
    """scan_rx on a capture of QPSK-3/4 64-B frames encoded at ``c``: every
    slot's valid, start, crc_ok, sig_ok and payload equal, SNRs within 1e-3
    dB; every placed frame decoded with its payload."""
    cfg, _ = configs(c)
    spec, _ = specs(MCS.QPSK_3_4, 64)
    (cap, n_frames, payload), _ = captures[c]
    got = tst.scan_rx(cfg, spec, tables.from_numpy(cfg, spec, "cpu"), torch.from_numpy(cap),
                      BLOCK_LEN, N_BLOCKS, max_frames_per_block=MAX_FRAMES)
    ref = references["scan", c].result()
    for f in ("valid", "start", "crc_ok", "sig_ok", "payload"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    valid = np.asarray(ref.valid)
    np.testing.assert_allclose(got.snr_db.numpy()[valid], np.asarray(ref.snr_db)[valid],
                               atol=1e-3)
    assert int(got.valid.sum()) == int(got.crc_ok.sum()) == n_frames
    assert (got.payload.numpy()[valid] == payload).all()


@pytest.mark.parametrize("c", SCAN_CONFIGS, ids=["x".join(map(str, c)) for c in SCAN_CONFIGS])
def test_scan_rx_dynamic_at_n_ltf(c, captures, references):
    """scan_rx_dynamic at max_payload 64 on a capture cycling two MCS and an
    NDP frame encoded at ``c``: every integer field equal, SNRs within 1e-3
    dB, the NDP estimate within 1e-5 · max|h|; every placed frame decoded."""
    cfg, _ = configs(c)
    _, (cap, placed, _) = captures[c]
    got = tst.scan_rx_dynamic(cfg, tables.from_numpy_dynamic(cfg, MAXP, "cpu"),
                              torch.from_numpy(cap), BLOCK_LEN, N_BLOCKS,
                              max_frames_per_block=MAX_FRAMES, max_payload=MAXP)
    ref = references["scan_dynamic", c].result()
    for f in ("valid", "start", "crc_ok", "sig_ok", "mcs", "packet_type_bit", "payload_len",
              "payload", "chan_est_ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    valid = np.asarray(ref.valid)
    for f in ("snr_db", "snr_data_db"):
        np.testing.assert_allclose(getattr(got, f).numpy()[valid],
                                   np.asarray(getattr(ref, f))[valid], atol=1e-3, err_msg=f)
    h = np_of(ref.chan_est)
    assert np.abs(got.chan_est.numpy() - h).max() <= 1e-5 * np.abs(h).max()
    assert int(got.valid.sum()) == int(got.crc_ok.sum()) == len(placed)
