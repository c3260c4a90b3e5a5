"""The port's receive app and host glue against jrc_tpu on the CPU.

``comm_rx``: ``main(argv)`` of ``jrc_tpu_torch.apps.comm_rx`` and of
``apps/comm_rx.py`` on the same fc32 and sc16 capture files print the same
lines (frame positions, CRC flags, SNR to 0.1 dB, MCS, NDP marks, the summary)
and write the same ``chan_est.csv``: the same rows, each value within
1e-5 · max|h| (the file prints nine digits of an estimate that torch.fft and
the reference's DFT matmul round differently; the writer itself is byte-equal
on equal input). ``--udp-out`` delivers the decoded payloads. ``FileTrx`` /
``TrxSession``, the UDP PDU classes and the CSV logs are the reference's,
byte for byte on the same input."""
import importlib.util
import socket
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jrc_tpu.config import MCS, PacketType  # noqa: E402
from jrc_tpu.io import backend as jbackend, udp as judp  # noqa: E402
from jrc_tpu.utils import logging as jlogging  # noqa: E402
from jrc_tpu_torch.apps import comm_rx  # noqa: E402
from jrc_tpu_torch.io import backend, udp  # noqa: E402
from jrc_tpu_torch.utils import logging  # noqa: E402
from tests.torch_parity import CFG, JCFG, specs, tx_frame  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BLOCK_LEN = 1 << 13


@pytest.fixture(scope="module")
def ref_comm_rx():
    """apps/comm_rx.py as a module (it is a script: loaded by path, with the
    sys.path entry it inserts taken out again)."""
    before = list(sys.path)
    spec = importlib.util.spec_from_file_location("ref_comm_rx", ROOT / "apps" / "comm_rx.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = before
    return mod


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """A mixed capture (QPSK-3/4 40-byte DATA frames, every third an NDP
    frame, noise 40 dB down) as a complex64 file and as an sc16 file."""
    frames = [tx_frame(specs(m, nb, pt)[1], text)[0] for m, nb, pt, text in (
        (MCS.QPSK_3_4, 40, PacketType.DATA, b"app parity"),
        (MCS.QPSK_3_4, 40, PacketType.DATA, b"app parity"),
        (MCS.QPSK_1_2, 12, PacketType.NDP, b"ndp"))]
    rng = np.random.default_rng(21)
    n = 3 * BLOCK_LEN + 1234
    cap = (rng.normal(0, 3e-3, (n, 2)) @ [1, 1j]).astype(np.complex64)
    pos, k = 700, 0
    while pos + len(frames[k % 3]) < n - 100:
        f = frames[k % 3]
        cap[pos : pos + len(f)] += f
        pos += len(f) + 1500
        k += 1
    d = tmp_path_factory.mktemp("captures")
    cap.tofile(d / "cap.c64")
    q = np.clip(np.rint(cap.view(np.float32) * 32767.0), -32767, 32767).astype(np.int16)
    q.tofile(d / "cap.sc16")
    return d, k


def _lines(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("fmt,dynamic", [("fc32", False), ("sc16", False), ("fc32", True),
                                         ("sc16", True)])
def test_comm_rx_prints_what_the_reference_prints(ref_comm_rx, captures, capsys, tmp_path, fmt,
                                                  dynamic):
    d, n_frames = captures
    argv = ["--cpu", "--iq", str(d / ("cap.c64" if fmt == "fc32" else "cap.sc16")),
            "--iq-format", fmt, "--block-len", str(BLOCK_LEN), "--payload-bytes", "40"]
    csvs = (tmp_path / "ours.csv", tmp_path / "ref.csv")
    if dynamic:
        argv += ["--dynamic", "--max-payload", "64"]
    outs = []
    for main, csv in zip((comm_rx.main, ref_comm_rx.main), csvs):
        extra = ["--chan-est-csv", str(csv)] if dynamic else []
        outs.append([ln.replace(str(csv), "CSV") for ln in _lines(main, argv + extra, capsys)])
    assert outs[0] == outs[1]
    n_ndp = n_frames // 3
    if dynamic:
        assert outs[0][-2] == (f"blocks=4 frames={n_frames} crc_ok={n_frames} dropped_samples=0")
        assert outs[0][-1] == f"chan_est: {n_ndp} NDP sounding update(s) -> CSV"
        assert sum("type=NDP" in ln for ln in outs[0]) == n_ndp
        ours, ref = (p.read_text().splitlines() for p in csvs)
        assert [ln.split(":")[0] for ln in ours] == [ln.split(":")[0] for ln in ref]
        h_ours = logging.read_chan_est_csv(csvs[0], CFG.fft_len, CFG.n_tx)
        h_ref = jlogging.read_chan_est_csv(csvs[1], JCFG.fft_len, JCFG.n_tx)
        assert np.abs(h_ref).max() > 0.1
        np.testing.assert_allclose(h_ours, h_ref, rtol=0, atol=1e-5 * np.abs(h_ref).max())
    else:
        # the static path decodes the DATA frames; an NDP frame fails its CRC there
        assert outs[0][-1].startswith(f"blocks=4 frames={n_frames} crc_ok={n_frames - n_ndp} ")


def test_comm_rx_udp_out_delivers_payloads(captures):
    d, n_frames = captures
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(5.0)
        port = rx.getsockname()[1]
        assert comm_rx.main(["--cpu", "--iq", str(d / "cap.c64"), "--block-len", str(BLOCK_LEN),
                             "--dynamic", "--max-payload", "64", "--udp-out", str(port)]) == 0
        got = [rx.recv(4096) for _ in range(n_frames)]
    data = [g for g in got if len(g) == 40]
    assert len(data) == n_frames - n_frames // 3 and len({len(g) for g in got}) == 2
    assert all(g[:11] == b"\x02app parity" for g in data)


def test_comm_rx_mesh_steps_decode_what_one_step_decodes(captures, capsys):
    """``--mesh 1`` in steps shorter than the capture (six steps of one shape,
    overlapping by the halo and the history) prints the lines of one step
    over the whole capture: every frame once, at the same sample, with the
    same fields. Steps without the overlap would lose the frame across
    sample 14336, and steps that kept every frame they find would print
    frames twice."""
    d, n_frames = captures
    argv = ["--cpu", "--iq", str(d / "cap.c64"), "--block-len", str(BLOCK_LEN), "--dynamic",
            "--max-payload", "64", "--mesh", "1"]
    whole = _lines(comm_rx.main, argv, capsys)
    stepped = _lines(comm_rx.main, argv + ["--step-samples", "7168"], capsys)
    assert stepped == whole, (stepped, whole)
    assert whole[-1] == f"mesh=1 frames={n_frames} crc_ok={n_frames}"


def test_comm_rx_arguments(capsys):
    # --mesh 1 decodes the demo in one sharded step of a world of one
    assert comm_rx.main(["--cpu", "--demo", "--block-len", str(BLOCK_LEN), "--mesh", "1"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    frames, ok = (int(w.split("=")[1]) for w in last.split()[1:])
    assert last.startswith("mesh=1 ") and frames == ok > 0, last
    for argv, msg in (
            (["--cpu", "--demo", "--mesh", "2"], "run under torchrun with 2 processes"),
            (["--cpu"], "--iq or --demo required"),
            (["--cpu", "--demo", "--mcs", "BPSK_1_2"], "--demo decodes the pinned"),
            (["--cpu", "--demo", "--chan-est-csv", "x.csv"], "requires --dynamic"),
            (["--cpu", "--demo", "--dynamic", "--payload-bytes", "300"], "exceeds")):
        with pytest.raises(SystemExit):
            comm_rx.main(argv)
        assert msg in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            comm_rx.main(["--demo", "--block-len", str(BLOCK_LEN)])


def test_comm_rx_refuses_the_float_wire_for_an_sc16_file(captures, capsys):
    with pytest.raises(SystemExit):
        comm_rx.main(["--cpu", "--iq", str(captures[0] / "cap.sc16"), "--iq-format", "sc16",
                      "--wire", "fc32"])
    assert "--wire fc32 with an sc16 capture" in capsys.readouterr().err


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_comm_rx_demo_decodes_the_pinned_frames(capsys, dynamic):
    argv = ["--cpu", "--demo", "--block-len", str(1 << 14)] + (
        ["--dynamic", "--max-payload", "96"] if dynamic else [])
    lines = _lines(comm_rx.main, argv, capsys)
    n = sum(ln.startswith("  frame @") for ln in lines)
    assert n >= 8 and lines[-1] == f"blocks=4 frames={n} crc_ok={n} dropped_samples=0"
    if dynamic:
        assert len({ln.split("mcs=")[1][0] for ln in lines[:-1]}) >= 3
        assert any("type=NDP" in ln for ln in lines)


# ------------------------------------------------------------------ host glue


@pytest.mark.parametrize("fmt", ["fc32", "sc16"])
def test_file_trx_and_trx_session_match(tmp_path, fmt):
    rng = np.random.default_rng(3)
    rx = (rng.normal(0, 0.2, (2, 900)) + 1j * rng.normal(0, 0.2, (2, 900))).astype(np.complex64)
    tx = (rng.normal(0, 0.2, (4, 300)) + 1j * rng.normal(0, 0.2, (4, 300))).astype(np.complex64)
    results = []
    for mod, cfg, tag in ((backend, CFG, "ours"), (jbackend, JCFG, "ref")):
        rec = mod.FileTrx(cfg, tx_path=str(tmp_path / f"rx_{tag}.iq"), fmt=fmt)
        rec.transmit(rx)  # write the replay file with the backend's own writer
        trx = mod.FileTrx(cfg, rx_path=str(tmp_path / f"rx_{tag}.iq"),
                          tx_path=str(tmp_path / f"tx_{tag}.iq"), fmt=fmt)
        sess = mod.TrxSession(trx, update_period=0.04, num_delay_samps=7)
        outs = [sess.frame(tx, now) for now in (0.0, 0.01, 0.05, 0.06, 0.1, 0.2)]
        outs.append(trx.burst(tx, 0))
        results.append((outs, (sess.n_bursts, sess.n_tx_only, sess.n_missed),
                        (tmp_path / f"tx_{tag}.iq").read_bytes(),
                        (tmp_path / f"rx_{tag}.iq").read_bytes()))
    (o_a, c_a, tx_a, rx_a), (o_b, c_b, tx_b, rx_b) = results
    assert c_a == c_b == (4, 2, 0) and tx_a == tx_b and rx_a == rx_b
    for a, b in zip(o_a, o_b):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.rx_time == b.rx_time and a.rx.tobytes() == b.rx.tobytes()
            assert a.rx.shape == b.rx.shape
    with pytest.raises(ValueError, match="fmt"):
        backend.FileTrx(CFG, fmt="sc8")


def test_sim_trx_and_trx_session_match():
    """SimTrx through TrxSession, port against reference, noise-free: the
    same bursts, TX-only frames and deadline misses, and each burst's echo
    of a moving target (delayed by hw_delay_samps, re-aligned by
    num_delay_samps, the Doppler ramp carried across bursts) within 1e-5 ·
    max|echo|; without targets a burst is zeros. SimTrx runs on the card
    unless told otherwise and refuses a TX frame on another device."""
    from jrc_tpu.ops import channel as jchannel
    from jrc_tpu_torch.ops import channel

    rng = np.random.default_rng(4)
    tx = (rng.normal(0, 0.2, (4, 500)) + 1j * rng.normal(0, 0.2, (4, 500))).astype(np.complex64)
    target = ((12.0,), (8.0,), (25.0,), (10.0,))
    results = []
    for mod, cfg, ch in ((backend, CFG, channel), (jbackend, JCFG, jchannel)):
        kw = {"device": "cpu"} if mod is backend else {}
        trx = mod.SimTrx(cfg, ch.Targets(*target), hw_delay_samps=24, miss_bursts={1}, **kw)
        sess = mod.TrxSession(trx, update_period=0.04, num_delay_samps=24)
        outs = [sess.frame(tx, now) for now in (0.0, 0.01, 0.05, 0.06, 0.1, 0.2)]
        results.append((outs, (sess.n_bursts, sess.n_tx_only, sess.n_missed)))
    (o_a, c_a), (o_b, c_b) = results
    assert c_a == c_b == (3, 2, 1)
    for a, b in zip(o_a, o_b):
        assert (a is None) == (b is None)
        if a is not None:
            got, want = a.rx.numpy(), np.asarray(b.rx)
            assert a.rx_time == b.rx_time and got.shape == want.shape == (CFG.n_rx, 500)
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    empty = backend.SimTrx(CFG, device="cpu").burst(tx, 600)
    assert empty.rx.shape == (CFG.n_rx, 600) and not empty.rx.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            backend.SimTrx(CFG)
    with pytest.raises(RuntimeError, match="device"):
        backend.SimTrx(CFG, device="cpu").burst(torch.zeros((4, 500), dtype=torch.complex64,
                                                             device="meta"))


def test_udp_pdu_round_trip():
    src = udp.UdpPduSource(port=0)
    try:
        port = src._sock.getsockname()[1]
        sink = udp.UdpPduSink(port)
        try:
            sink.send(np.arange(5, dtype=np.uint8))
            sink.send(b"\x02hello")
        finally:
            sink.close()
        got = [src.get(timeout=5.0) for _ in range(2)]
    finally:
        src.close()
    assert got[0].tolist() == [0, 1, 2, 3, 4] and got[1].tobytes() == b"\x02hello"
    assert src.get(timeout=0.05) is None
    assert udp.DEFAULT_PORT == judp.DEFAULT_PORT


def test_csv_formats_match(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    h = (rng.normal(size=(64, 4)) + 1j * rng.normal(size=(64, 4))).astype(np.complex64)
    chan = (rng.normal(size=(8, 64)) + 1j * rng.normal(size=(8, 64))).astype(np.complex64)
    for mod in (logging, jlogging):  # the same clock for both
        monkeypatch.setattr(mod, "_now_hms_ms", lambda: "12:34:56.789")
        monkeypatch.setattr(mod, "_now_date", lambda: "01-02-2026 12:34:56")
    files = []
    for mod, tag in ((logging, "ours"), (jlogging, "ref")):
        ce, comm, radar, rc = (tmp_path / f"{n}_{tag}.csv" for n in ("ce", "comm", "radar", "rc"))
        mod.write_chan_est_csv(str(ce), h)
        np.testing.assert_array_equal(mod.read_chan_est_csv(str(ce), 64, 4), h)
        log = mod.CommLog(str(comm))
        log.log_frame(True, 2, 25.1234, 24.9876, 0.5)
        log.log_frame(False, 1, 3.0, 2.5, 12.0)
        rlog = mod.RadarLog(str(radar))
        rlog.log_detection(1.234e-3, 17.5, 41.25, -12.75)
        assert mod.RadarLog.last_angle(str(radar)) == -12.75
        mod.append_radar_capture_csv(str(rc), chan, 4, 2)
        (rec,) = mod.read_radar_capture_csv(str(rc))
        np.testing.assert_array_equal(rec[3], chan)
        files.append([p.read_bytes() for p in (ce, comm, radar, rc)])
    assert files[0] == files[1]
    assert logging.RadarLog.last_angle(str(tmp_path / "missing.csv")) is None
