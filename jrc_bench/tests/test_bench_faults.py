"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; so does the control, the reference in
bfloat16 in the program's place, and each fault the truth checks are there
for, planted in the reference put in the program's place. The runs go
through each driver on the CPU (the port's plain versions) at a size a test
can hold: the harness's look for a card is the only part left out."""
import json
from pathlib import Path

import pytest
import torch

from jrc_bench.drivers import jrc_loop, rx_stream
from jrc_bench.harness import Cell, now

ROOT = Path(__file__).resolve().parents[2]


def rx_cell(seconds=1.5):
    conf = json.loads((ROOT / "jrc_bench/configs/comm-rx-n320.json").read_text())
    mix = json.loads((ROOT / "jrc_bench/traffic/mixed_dense.json").read_text())
    mix.update(capture_samples=4 * 65536, warm_calls=1, check_blocks=2)
    return Cell("rx_mixed_dense", conf, mix, 2**31 + 11, seconds, False, torch.device("cpu"),
                now())


def jrc_cell(seconds=0.5):
    conf = json.loads((ROOT / "jrc_bench/configs/jrc-trx-4x2.json").read_text())
    mix = json.loads((ROOT / "jrc_bench/traffic/dwell_80B.json").read_text())
    mix.update(start_dwells=8, check_dwells=1, final_dwells=16)
    return Cell("jrc_dwell_80B", conf, mix, 2**31 + 13, seconds, False, torch.device("cpu"),
                now())


def correct(outcome) -> bool:
    return all(v <= lim for _, v, lim in outcome.checks)


def failed(outcome) -> set:
    return {name for name, v, lim in outcome.checks if v > lim}


@pytest.fixture
def rx_fault(monkeypatch):
    """Break the SIG-driven RX call the streamer captures."""
    from jrc_tpu_torch.models import streaming

    def install(fault):
        real = streaming.flat_rx_dynamic

        def broken(*a, **k):
            return fault(real(*a, **k))
        monkeypatch.setattr(streaming, "flat_rx_dynamic", broken)
    return install


def half_left_out(res):
    """Half of the batch's slots left out."""
    keep = torch.arange(res.valid.shape[0]) < res.valid.shape[0] // 2
    return res._replace(valid=res.valid & keep, crc_ok=res.crc_ok & keep)


def answer_altered(res):
    """A payload byte of every frame altered where it is produced."""
    return res._replace(payload=res.payload ^ torch.tensor(1, dtype=torch.uint8))


def test_rx_sound_run_is_correct():
    assert correct(rx_stream.run(rx_cell()))


@pytest.mark.parametrize("fault, expect", [(half_left_out, "frames_missed"),
                                           (answer_altered, "frames_wrong")])
def test_rx_fault_is_not_correct(rx_fault, fault, expect):
    rx_fault(fault)
    out = rx_stream.run(rx_cell())
    assert not correct(out) and expect in failed(out)


@pytest.mark.parametrize("fault, expect", [(None, "snr_gap_db"),
                                           ("late_sync", "chan_truth_err"),
                                           ("snr_unhalved", "snr_truth_bias_db")])
def test_rx_control_fails(fault, expect):
    cell = rx_cell()
    numbers = rx_stream.control(cell, fault)
    lim = cell.config["limits"]
    assert numbers[expect] > lim[expect]


@pytest.fixture
def jrc_fault(monkeypatch):
    """Break the JRC dwell the step captures."""
    from jrc_tpu_torch.models import jrc_trx

    def install(fault):
        real = jrc_trx.jrc_step

        def broken(cfg, tab, rtab, state, *a, **k):
            return fault(state, real(cfg, tab, rtab, state, *a, **k))
        monkeypatch.setattr(jrc_trx, "jrc_step", broken)
    return install


def state_unchanged(state, res):
    """A step that returns its state unchanged."""
    return res._replace(state=state)


def payload_altered(state, res):
    """The decoded payload altered where it is produced."""
    dec = res.comm.decoded
    return res._replace(comm=res.comm._replace(
        decoded=dec._replace(payload=dec.payload ^ torch.tensor(1, dtype=torch.uint8))))


def test_jrc_sound_run_is_correct():
    assert correct(jrc_loop.run(jrc_cell()))


@pytest.mark.parametrize("fault, expect", [(state_unchanged, "flags_differ"),
                                           (payload_altered, "payload_wrong")])
def test_jrc_fault_is_not_correct(jrc_fault, fault, expect):
    jrc_fault(fault)
    out = jrc_loop.run(jrc_cell())
    assert not correct(out) and expect in failed(out)


@pytest.mark.parametrize("fault, expect", [(None, "snr_gap_db"), ("range_flip", "target_off_bins")])
def test_jrc_control_fails(fault, expect):
    cell = jrc_cell()
    numbers = jrc_loop.control(cell, fault)
    lim = cell.config["limits"]
    assert numbers[expect] > lim[expect]
