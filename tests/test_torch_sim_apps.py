"""The port's simulation and evaluation apps against their twins in apps/ on
the CPU, each loaded from its file as tests/test_torch_jrc_app.py loads
apps/jrc_trx.py, and the port's live sinks as tests/test_live_viz.py holds
the reference's.

* ``alignment`` at its defaults;
* ``radar_sim``: two dwells of two targets with ``--max-targets 2 --cfar
  --window-range hann`` and the channel-capture CSV;
* ``comm_sim``: four frames with ``--steering svd --ndp-every 2``, the port
  given the reference's channel noise (``jax.random.split(PRNGKey(i))[1]``,
  drawn as ``channel.awgn`` draws it);
* ``ber_sweep``: BPSK-1/2 at 0 dB, six frames with the reference's noise
  draws (the frames and payload of tests/test_torch_evaluation.py's
  BPSK-1/2 case, so that the reference's one compile serves both), the CSV
  byte for byte;
* ``jrc_trx --doppler-frames 8``: one burst of a target at 150 m/s, the
  velocity line, the frame line and the summary; the port's run with
  ``--live`` writes both PNGs.

Printed lines are equal, but for the SNR fields and radar_sim's CFAR
count. The SNRs are held within 1e-3 dB in the logs (1e-4 relative for the
radar log's power), and printed to 0.1 dB within one unit of that digit:
torch.fft against the reference's DFT matmuls. The CFAR count differs by
exactly the cells whose detection differs between the reference's CFAR on
its map and the port's on its own, and each such flip is explained by the
two maps' float difference: the cell's margin |power − threshold| in the
reference is at most the difference of its power plus that of its threshold
between the two; the flips are counted and printed. The reference apps run
their slow pieces under ``jax.jit`` (fixture ``jitted``,
``torch_parity.jit_reference``: the same functions, compiled once each
instead of primitive by primitive); the echo (``apply_targets``) is jitted
with fusion and the algebraic simplifier off, which gives its eager result
bit for bit, the form tests/test_torch_radar.py holds the port against."""
import importlib.util
import os
import re
import sys
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from jrc_tpu.models import radar_chain as jradar_chain
from jrc_tpu.ops import channel as jchannel, cplx as cx, radar as jradar
from jrc_tpu_torch.apps import alignment, ber_sweep, comm_sim, jrc_trx, radar_sim
from jrc_tpu_torch.viz.live import LiveHeatmap, LiveTimePlot
from tests.torch_parity import awgn_draws, jit_reference, np_of

ROOT = Path(__file__).resolve().parents[1]
DB_TOL = 1e-3
#: printed fields compared apart from the rest of their line
SNR_FIELD = re.compile(r"(snr(?:_data)?=)(-?[0-9.]+)")
CFAR_FIELD = re.compile(r"(cfar: )([0-9]+)")


def _reference_app(name: str):
    before = list(sys.path)
    spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "apps" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = before
    return mod


def _run(main, argv, **kw) -> list[str]:
    buf = StringIO()
    with redirect_stdout(buf):
        assert main(argv, **kw) == 0
    return buf.getvalue().splitlines()


def _same_lines(got: list[str], want: list[str], cfar_diff: int = 0) -> None:
    """Equal line for line once the SNR fields and the CFAR count are taken
    out; a printed SNR within one unit of its last digit (0.1 dB: two values
    within DB_TOL can straddle a rounding edge), the CFAR count the
    reference's plus ``cfar_diff``."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        strip = lambda line: CFAR_FIELD.sub(r"\1", SNR_FIELD.sub(r"\1", line))  # noqa: E731
        assert strip(g) == strip(w), (g, w)
        for (_, a), (_, b) in zip(SNR_FIELD.findall(g), SNR_FIELD.findall(w)):
            assert abs(float(a) - float(b)) <= 0.1 + 1e-9, (g, w)
        for (_, a), (_, b) in zip(CFAR_FIELD.findall(g), CFAR_FIELD.findall(w)):
            assert int(a) - int(b) == cfar_diff, (g, w)


@pytest.fixture
def jitted(monkeypatch):
    jit_reference(monkeypatch)


def _noise(key, n: int) -> torch.Tensor:
    return torch.from_numpy(np_of(jchannel.awgn(key, cx.zeros((n,)), 2.0)).astype(np.complex64))


def test_alignment_prints_what_the_reference_prints(jitted):
    want = _run(_reference_app("alignment").main, ["--cpu"])
    got = _run(alignment.main, ["--cpu"])
    assert got == want
    steps = [float(s) for s in got[-2].split("[")[1].rstrip("]").split()]
    expected = float(got[-1].split(":")[1].split()[0])
    assert len(steps) == 7 and max(abs(s - expected) for s in steps) < 1.0


def _radar_log(path):
    return [line.split(",")[1:] for line in Path(path).read_text().splitlines() if "," in line]


def _cfar_difference(targets) -> int:
    """(the port's CFAR count − the reference's) on each package's own map of
    radar_sim's dwell; each cell whose detection differs must have a margin
    |power − threshold| within the two maps' difference there."""
    from jrc_tpu_torch import tables
    from jrc_tpu_torch.config import MCS, PacketType
    from jrc_tpu_torch.models import radar_chain
    from jrc_tpu_torch.ops import channel, radar
    from jrc_tpu_torch.ops.encoder import make_payload
    from tests.torch_parity import CFG, JCFG, specs

    spec, jspec = specs(MCS.QPSK_1_2, 50, PacketType.NDP)
    payload = make_payload(spec, bytes([1]))
    ref = jradar_chain.radar_frame(JCFG, jspec, jax.numpy.asarray(payload),
                                   jchannel.Targets(*targets), key=jax.random.PRNGKey(0),
                                   window_range="hann")
    port = radar_chain.radar_frame(CFG, spec, tables.from_numpy(CFG, spec, "cpu"),
                                   tables.radar_from_numpy(CFG, "cpu", window_range="hann"),
                                   torch.from_numpy(payload), channel.Targets(*targets))
    kw = dict(guard=(8, 0), train=(24, 0), pfa=1e-4)
    p_ref = np.asarray(cx.abs2(ref.ra_map))
    p_port = (port.ra_map.real ** 2 + port.ra_map.imag ** 2).numpy()
    cr, cp = jradar.cfar_detect(jax.numpy.asarray(p_ref), **kw), radar.cfar_detect(
        torch.from_numpy(p_port), **kw)
    thr_ref, thr_port = np.asarray(cr.threshold), cp.threshold.numpy()
    differ = cp.detections.numpy() != np.asarray(cr.detections)
    explained = (np.abs(p_ref - thr_ref)
                 <= np.abs(p_port - p_ref) + np.abs(thr_port - thr_ref) + 1e-30)
    print(f"radar_sim CFAR: {int(differ.sum())} cells flipped between the two maps")
    assert not (differ & ~explained).any()
    return int(cp.n_detections) - int(cr.n_detections)


def test_radar_sim_prints_what_the_reference_prints(tmp_path, monkeypatch, jitted):
    monkeypatch.chdir(tmp_path)
    argv = ["--cpu", "--dwells", "2", "--targets", "12:0:25:10", "5:0:-20:10", "--max-targets",
            "2", "--cfar", "--window-range", "hann", "--heatmap", ""]
    want = _run(_reference_app("radar_sim").main,
                argv + ["--radar-log", "ref.csv", "--capture-csv", "ref_cap.csv"])
    got = _run(radar_sim.main, argv + ["--radar-log", "port.csv", "--capture-csv", "port_cap.csv"])
    _same_lines(got, want, _cfar_difference(((12.0, 5.0), (0.0, 0.0), (25.0, -20.0),
                                             (10.0, 10.0))))
    assert sum("target" in line for line in got) == 4
    assert all("peak bin detected=True" in line for line in got if "cfar" in line)
    for g, w in zip(_radar_log("port.csv"), _radar_log("ref.csv")):  # power, snr, range, angle
        assert g[2:] == w[2:]
        assert abs(float(g[0]) - float(w[0])) <= 1e-4 * abs(float(w[0]))
        assert abs(float(g[1]) - float(w[1])) <= DB_TOL
    ref_cap, port_cap = (Path(p).read_text().splitlines() for p in ("ref_cap.csv", "port_cap.csv"))
    assert len(ref_cap) == len(port_cap) == 2


def _comm_log(path):
    return [line.split(",")[1:] for line in Path(path).read_text().splitlines() if "," in line]


def test_comm_sim_prints_what_the_reference_prints(tmp_path, monkeypatch, jitted):
    argv = ["--cpu", "--frames", "4", "--steering", "svd", "--ndp-every", "2"]
    out = {}
    for name, main, kw in (("ref", _reference_app("comm_sim").main, {}),
                           ("port", comm_sim.main, {"comm_noise": lambda i, n: _noise(
                               jax.random.split(jax.random.PRNGKey(i))[1], n)})):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        out[name] = _run(main, argv, **kw)
    _same_lines(out["port"], out["ref"])
    for g, w in zip(_comm_log(tmp_path / "port" / "comm_log.csv"),
                    _comm_log(tmp_path / "ref" / "comm_log.csv")):  # crc, type, snr, snr_data, per
        assert g[:2] == w[:2] and g[4] == w[4]
        assert abs(float(g[2]) - float(w[2])) <= DB_TOL and abs(float(g[3]) - float(w[3])) <= DB_TOL
    got = out["port"]
    assert sum("steering refreshed (svd)" in line for line in got) == 2
    assert all("crc=True" in line for line in got if line.startswith("frame") and "crc" in line)


def test_ber_sweep_prints_and_writes_what_the_reference_does(tmp_path, jitted):
    argv = ["--cpu", "--mcs", "BPSK_1_2", "--snrs", "0", "--frames", "6"]

    def noise(mcs, n_frames, n):  # drawn as the reference's jitted, vmapped loop draws it
        return [torch.from_numpy(awgn_draws(jax.random.split(jax.random.PRNGKey(0), n_frames),
                                            n))]

    want = _run(_reference_app("ber_sweep").main, argv + ["--csv", str(tmp_path / "ref.csv")])
    got = _run(ber_sweep.main, argv + ["--csv", str(tmp_path / "port.csv")], noise=noise)
    assert [line.replace("port.csv", "ref.csv") for line in got] == want
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()


def test_jrc_trx_doppler_train_and_live_sinks_match(tmp_path, monkeypatch, jitted):
    """One burst of a target at 150 m/s with a train of 8 frames: the
    velocity line, the frame line and the summary as the reference prints
    them; the port's --live writes the heatmap and the metric plot."""
    argv = ["--cpu", "--frames", "1", "--doppler-frames", "8", "--target", "12:150:25:10",
            "--comm-log", "comm.csv", "--radar-log", "radar.csv"]
    out = {}
    for name, main, kw in (("ref", _reference_app("jrc_trx").main, {}),
                           ("port", jrc_trx.main, {"comm_noise": lambda d, n: _noise(
                               jax.random.split(jax.random.PRNGKey(d))[1], n)})):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        out[name] = _run(main, argv + (["--live", "--heatmap", "hm.png"] if name == "port"
                                       else ["--heatmap", ""]), **kw)
    d = tmp_path / "port"
    assert (d / "hm.png").is_file() and (d / "jrc_metrics.png").is_file()
    assert not [f for f in os.listdir(d) if ".tmp" in f]
    _same_lines(out["port"], out["ref"])
    assert out["port"][0].startswith("  doppler train (8 frames): v=+")
    from jrc_tpu_torch.ops import radar

    v = float(out["port"][0].split("v=")[1].split()[0])
    n = 27 * 80  # the app's DATA frame, QPSK-3/4 of 80 B, padded by 5 + 3 symbols
    v_axis = radar.velocity_axis(8, n / 125e6, 24e9)
    assert abs(v - 150.0) <= float(v_axis[1] - v_axis[0]) + 0.05  # a bin, and the print's 0.05


def test_live_heatmap_coalesces_pushes(tmp_path):
    """tests/test_live_viz.py's first case, on the port's copy."""
    path = str(tmp_path / "hm.png")
    hm = LiveHeatmap(np.linspace(0, 40, 64), np.linspace(-60, 60, 32), path=path,
                     refresh_interval_s=1.0)
    rng = np.random.default_rng(0)
    for k in range(3):  # three pushes inside one refresh interval: one draw
        hm.push(rng.random((64, 32)))
        hm.tick(now=0.1 * k)
    assert (hm.n_pushed, hm.n_drawn) == (3, 1) and os.path.exists(path)
    assert hm.tick(now=2.0) is True  # the coalesced newest frame at the next interval
    assert hm.tick(now=4.0) is False  # nothing new
    hm.push(lambda: rng.random((64, 32)))  # a lazy push, drawn at the next interval
    assert hm.tick(now=5.5) is True and hm.n_drawn == 3


def test_live_timeplot_sliding_window(tmp_path):
    path = str(tmp_path / "tp.png")
    tp = LiveTimePlot(window_s=10.0, path=path, refresh_interval_s=0.5)
    for t in range(15):
        tp.push("snr_db", float(t), 20.0 + t)
    assert tp.tick(now=100.0) is True
    assert min(t for t, _ in tp.series._data["snr_db"]) >= 4.0 and os.path.exists(path)
    with pytest.raises(ValueError, match="path"):
        LiveTimePlot(path="")
