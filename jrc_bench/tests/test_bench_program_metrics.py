"""The per-layer metrics read from the program's own counters, spans and
stage clocks (``drivers/program_counters.py`` and the ``metrics/`` files
that use it): each returns None when the program recorded nothing, and the
value the planted counters give. Spans and stages are planted through the
program's own recorders on a clock that advances by known steps; device
times and a streamer's counters directly."""
import json
from pathlib import Path

import pytest
import torch

from jrc_bench import run
from jrc_bench.harness import Observed
from jrc_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = {m["name"]: m for m in BENCH["per_layer"]
           if m["source"] in ("program_span", "program_counter")}


def reader(name: str):
    return run.load_module(ROOT / "jrc_bench" / "metrics" / f"{name}.py",
                           "jrc_bench_metric_" + name.replace(".", "_"))


class Clock:
    """``time`` for the profiling module: perf_counter_ns advances by the
    steps given, one a read."""

    def __init__(self, steps):
        self.t, self.steps = 0, iter(steps)

    def perf_counter_ns(self):
        self.t += next(self.steps)
        return self.t

    def time_ns(self):
        return 0


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def test_the_program_metrics_are_listed():
    assert sorted(PROGRAM) == sorted([
        "ring_ms.rx", "host_blocked_ms.rx", "dispatch_ms.rx", "device_idle_pct.rx",
        "slots_used_pct.rx", "detect_ms.rx", "extract_ms.rx", "equalize_ms.rx",
        "demap_ms.rx", "finish_ms.rx", "dispatch_ms.dwell", "device_idle_pct.dwell",
        "tx_ms.dwell", "channel_ms.dwell", "radar_ms.dwell", "comm_rx_ms.dwell"])
    for name, m in PROGRAM.items():
        kind = name.rsplit(".", 1)[1]
        assert m["moves"] == {"rx": "rx_msps", "dwell": "dwells_per_s"}[kind]
        assert m["workloads"] == (["rx_mixed_dense", "rx_mixed_sparse"] if kind == "rx"
                                  else ["jrc_dwell_80B", "jrc_dwell_1500B"])


@pytest.mark.parametrize("name", sorted(PROGRAM))
def test_nothing_recorded_reads_none(name):
    assert reader(name).read(Observed(calls=100, seconds=1.0)) is None


def _plant_spans(monkeypatch):
    """Three calls: push 2 ms and 1 ms, pop 3 ms, slot wait 1 ms (the first
    call has none), readback 4 ms, replay 5 ms a call."""
    steps = []
    for k in range(3):
        steps += [10**6, 2 * 10**6, 10**6, 10**6]  # two pushes: 2 ms, then 1 ms
        steps += [10**6, 3 * 10**6]  # pop
        steps += [10**6, 10**6] if k else []  # slot wait
        steps += [10**6, 4 * 10**6, 10**6, 5 * 10**6]  # readback, replay
    monkeypatch.setattr(profiling, "time", Clock(steps))
    for k in range(3):
        for name in ("stream.push", "stream.push", "stream.pop") + (
                ("stream.slot_wait",) if k else ()) + ("stream.readback", "graph.replay"):
            with profiling.span(name, k):
                pass


def test_host_spans_read_their_medians(monkeypatch):
    _plant_spans(monkeypatch)
    obs = Observed(calls=3, seconds=1.0)
    assert reader("ring_ms.rx").read(obs) == pytest.approx(6.0)
    assert reader("host_blocked_ms.rx").read(obs) == pytest.approx(5.0)  # calls 4, 5, 5 ms
    assert reader("dispatch_ms.rx").read(obs) == pytest.approx(5.0)
    assert reader("dispatch_ms.dwell").read(obs) == pytest.approx(5.0)


def test_device_idle_reads_the_event_timed_calls(monkeypatch):
    times = {"rx": [4.0, 5.0, 6.0], "dwell": [2.0, 2.0, 1.0]}
    monkeypatch.setattr(profiling, "device_ms", lambda name: times.get(name, []))
    obs = Observed(calls=150, seconds=1.0)
    assert reader("device_idle_pct.rx").read(obs) == pytest.approx(25.0)
    assert reader("device_idle_pct.dwell").read(obs) == pytest.approx(70.0)
    assert reader("device_idle_pct.rx").read(Observed(calls=0, seconds=1.0)) is None


def test_slots_used_reads_the_counters():
    from jrc_tpu_torch.io.stream import StreamStats

    stats = StreamStats(slots_decoded=640)
    profiling.track("rx", stats)
    assert reader("slots_used_pct.rx").read(Observed(calls=20, seconds=1.0)) == 0.0
    stats.frames = 16
    assert reader("slots_used_pct.rx").read(Observed(calls=20, seconds=1.0)) == pytest.approx(2.5)


@pytest.mark.parametrize("entry", ["rx", "dwell"])
def test_stages_read_their_stage_clock(monkeypatch, entry):
    stages = profiling.STAGES[entry]
    # each call: stage s stamped (s + 1) ms after the one before it; the clock of
    # the plain version reads perf_counter_ns once a stamp
    steps = [(s + 1) * 10**6 for _ in range(3) for s in range(len(stages))]
    monkeypatch.setattr(profiling, "time", Clock(steps))
    x = torch.zeros(1)
    for _ in range(3):
        for s in stages:
            profiling.stamp(entry, s, x)
    obs = Observed(calls=3, seconds=1.0)
    read = [name for name in stages[1:] if f"{name}_ms.{entry}" in PROGRAM]
    assert len(read) == len(stages) - 1 - (entry == "rx")  # the rx viterbi stage: no metric
    for name in read:
        assert reader(f"{name}_ms.{entry}").read(obs) == pytest.approx(stages.index(name) + 1)


def test_a_program_without_the_counters_reads_none(monkeypatch):
    """An earlier commit's profiling module has none of the functions."""
    import types

    from jrc_bench.drivers import program_counters

    monkeypatch.setattr(program_counters, "_profiling", lambda: types.ModuleType("old"))
    for name in PROGRAM:
        assert reader(name).read(Observed(calls=10, seconds=1.0)) is None, name
