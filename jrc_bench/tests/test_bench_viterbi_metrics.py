"""The Viterbi layer's per-layer metrics of the receive cells, read from the
program's stage clock and its ``viterbi_steps`` count: None where the
program recorded nothing or has no such count (an earlier commit of the
port), else the values the planted stamps and counts give."""
import json
import types
from pathlib import Path

import pytest
import torch

from jrc_bench import run
from jrc_bench.harness import Observed
from jrc_tpu_torch.ops import viterbi, viterbi_cuda
from jrc_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = ("viterbi_ms.rx", "viterbi_steps_pct.rx")


def reader(name: str):
    return run.load_module(ROOT / "jrc_bench" / "metrics" / f"{name}.py",
                           "jrc_bench_metric_" + name.replace(".", "_"))


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def test_the_metrics_are_listed_for_the_rx_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NAMES:
        m = entries[name]
        assert m["moves"] == "rx_msps" and m["better"] == "lower"
        assert m["layer"] == "Viterbi: ops/viterbi_cuda, K1"
        assert m["workloads"] == ["rx_mixed_dense", "rx_mixed_sparse"]


@pytest.mark.parametrize("name", NAMES)
def test_nothing_recorded_reads_none(name, monkeypatch):
    assert reader(name).read(Observed(calls=10, seconds=1.0)) is None
    from jrc_bench.drivers import program_counters

    monkeypatch.setattr(program_counters, "_profiling", lambda: types.ModuleType("old"))
    assert reader(name).read(Observed(calls=10, seconds=1.0)) is None


def test_the_viterbi_stage_and_its_steps_read_the_program():
    """Three calls, each stage stamped 1 ms after the one before it on a
    clock that steps by 1 ms; the calls' longest rows 26, 6 and 40 steps of
    T = 40."""
    class Clock:
        t = 0

        def perf_counter_ns(self):
            self.t += 10**6
            return self.t

    trellis = tuple(torch.from_numpy(a) for a in viterbi._trellis())
    trellis = (trellis[0].long(), *trellis[1:])
    v = torch.zeros(3, 80)
    real = profiling.time
    profiling.time = Clock()
    try:
        for extents in ([3, 20, 5], [0, 0, 0], [38, 1, 2]):
            for stage in profiling.STAGES["rx"]:
                profiling.stamp("rx", stage, v)
                if stage == "demap":
                    viterbi_cuda.viterbi_decode(v, trellis, n_steps=torch.tensor(extents),
                                                entry="rx")
    finally:
        profiling.time = real
    obs = Observed(calls=3, seconds=1.0)
    assert reader("viterbi_ms.rx").read(obs) == pytest.approx(1.0)
    assert reader("viterbi_steps_pct.rx").read(obs) == pytest.approx(100.0 * 72 / 120)
