"""The port's JRC transceiver app against apps/jrc_trx.py on the CPU.

Five frames at the defaults but for ``--ndp-every 4`` (a burst at frames
0 and 4, TX-only frames between, frame 3 an NDP sounding frame whose
estimate is in the state when frame 4 goes out): ``jrc_tpu_torch.apps.jrc_trx.main`` is given the
reference app's comm-noise draws (``jax.random.split(PRNGKey(d))[1]``, as
``channel.awgn`` draws them), so both apps see the same noise. Equal: every
printed line (CRC, radar detection, range, angle, steering angle), the
``bursts=`` / ``tx_only=`` / ``missed=`` and PER summary, and the CSV logs'
integer and flag columns (CRC, packet type) and their range and angle
columns; the SNR and power columns within 1e-3 dB (relative 1e-4 for the
power) of the reference's (torch.fft against the reference's DFT matmuls).
The reference app runs with its two heaviest calls, ``jrc_tx`` and
``rx_chain``, under ``jax.jit``: the same functions, compiled once each
instead of primitive by primitive (about 50 s of its 65 s on one CPU).
``--live`` and ``--doppler-frames`` are taken (held against the reference
in tests/test_torch_sim_apps.py; comm_rx's refusal of --mesh is checked in
tests/test_torch_apps.py)."""
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from jrc_tpu.models import comm_link as jcomm_link, jrc_trx as jjrc
from jrc_tpu.ops import channel as jchannel, cplx as cx
from jrc_tpu_torch.apps import jrc_trx as app
from tests.torch_parity import np_of

ROOT = Path(__file__).resolve().parents[1]


def _reference_app():
    before = list(sys.path)
    spec = importlib.util.spec_from_file_location("ref_jrc_trx", ROOT / "apps" / "jrc_trx.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = before
    return mod


def _reference_noise(d: int, n: int) -> torch.Tensor:
    _, k_comm = jax.random.split(jax.random.PRNGKey(d))
    return torch.from_numpy(np_of(jchannel.awgn(k_comm, cx.zeros((n,)), 2.0)).astype(np.complex64))


def _rows(path):
    """The data rows of a CSV log, without the time stamp column."""
    return [[f.strip() for f in line.split(",")[1:]] for line in Path(path).read_text().splitlines()
            if "," in line]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(lines, comm log rows, radar log rows) of the reference app and the port's."""
    from contextlib import redirect_stdout
    from io import StringIO

    out = {}
    for name, main, kw in (("ref", _reference_app().main, {}),
                           ("port", app.main, {"comm_noise": _reference_noise})):
        d = tmp_path_factory.mktemp(name)
        argv = ["--cpu", "--frames", "5", "--ndp-every", "4", "--heatmap", "",
                "--radar-log", str(d / "radar.csv"), "--comm-log", str(d / "comm.csv")]
        buf = StringIO()
        with pytest.MonkeyPatch.context() as mp, redirect_stdout(buf):
            if name == "ref":
                mp.setattr(jjrc, "jrc_tx", jax.jit(jjrc.jrc_tx, static_argnums=(0, 2), static_argnames=(
                    "radar_aided", "phased_steering", "use_radar_streams", "pad_front")))
                mp.setattr(jcomm_link, "rx_chain", jax.jit(jcomm_link.rx_chain,
                                                           static_argnums=(0, 1)))
            assert main(argv, **kw) == 0
        out[name] = (buf.getvalue().splitlines(), _rows(d / "comm.csv"), _rows(d / "radar.csv"))
    return out


def test_app_prints_what_the_reference_prints(runs):
    lines, ref_lines = runs["port"][0], runs["ref"][0]
    assert lines == ref_lines
    assert lines[-1] == "bursts=2 tx_only=3 missed=0; PER: 25.0% over 4 DATA frames"
    assert sum("radar det=True" in line for line in lines) == 2
    assert "[NDP ] tx-only" in lines[3] and "crc=True" in lines[3]
    assert "BURST" in lines[4] and "crc=True" in lines[4]


def test_app_logs_match_the_reference(runs):
    (_, comm, radar), (_, ref_comm, ref_radar) = runs["port"], runs["ref"]
    assert len(comm) == len(ref_comm) == 5 and len(radar) == len(ref_radar) == 2
    for got, want in zip(comm, ref_comm):  # crc, type, snr, snr_data, per
        assert got[:2] == want[:2] and got[4] == want[4]
        assert abs(float(got[2]) - float(want[2])) <= 1e-3
        assert abs(float(got[3]) - float(want[3])) <= 1e-3
    for got, want in zip(radar, ref_radar):  # power, snr, range, angle
        assert got[2:] == want[2:]
        assert abs(float(got[0]) - float(want[0])) <= 1e-4 * float(want[0])
        assert abs(float(got[1]) - float(want[1])) <= 1e-3


@pytest.mark.parametrize("argv", [["--live"], ["--doppler-frames", "64"]],
                         ids=["live", "doppler-frames"])
def test_app_takes_live_and_doppler_frames(argv):
    """The range-Doppler functions and viz/live are ported, so the JRC app
    parses both options and says nothing is left unported."""
    args = app.parser().parse_args(["--cpu", *argv])
    assert args.live or args.doppler_frames == 64
    assert "not ported" not in app.parser().format_help()
