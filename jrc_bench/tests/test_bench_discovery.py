"""The harness finds a cell, a configuration, a mix, an entry driver and a
per-layer metric that are added as files plus entries, and edits nothing."""
import json
import shutil
from pathlib import Path

import torch

from jrc_bench import run

ROOT = Path(__file__).resolve().parents[2]

DRIVER = '''
from jrc_bench.harness import Observed, Outcome, checked


def run(cell):
    obs = Observed(calls=1, seconds=1.0, spans={"x": [cell.mix["span"]]})
    return Outcome(setup_s=0.5, end_to_end={"toy_rate": cell.mix["rate"] * cell.seed},
                   attempted=3, failed=0, checks=checked(cell, {"toy_number": 0.0}),
                   memory_peak_bytes=0, observed=obs)
'''
METRIC = '''
def read(obs):
    return 1e3 * obs.spans["x"][0]
'''


def add_toy_cell(root: Path) -> None:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-config", "source": "https://example.org/toy",
                             "file": "jrc_bench/configs/toy-config.json", "reduced": [],
                             "why": "a configuration added as a file"})
    bench["workloads"].append({"name": "toy_cell", "config": "toy-config", "traffic": "toy_mix",
                               "chips": 1, "why": "a cell added as files"})
    bench["end_to_end"].append({"name": "toy_rate", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["toy_cell"]})
    bench["per_layer"].append({"name": "toy_metric.x", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "toy", "moves": "toy_rate",
                               "workloads": ["toy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b = root / "jrc_bench"
    (b / "configs" / "toy-config.json").write_text(json.dumps(
        {"entry": "toy_entry", "limits": {"toy_number": 0}}))
    (b / "traffic" / "toy_mix.json").write_text(json.dumps({"rate": 2.0, "span": 0.004}))
    (b / "drivers" / "toy_entry.py").write_text(DRIVER)
    (b / "metrics" / "toy_metric.x.py").write_text(METRIC)


def test_added_files_are_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "jrc_bench", tmp_path / "jrc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "jrc_bench").rglob("*") if p.is_file()}
    add_toy_cell(tmp_path)
    after = {p: p.read_bytes() for p in (tmp_path / "jrc_bench").rglob("*") if p.is_file()}
    assert all(after[p] == before[p] for p in before)  # nothing existing was edited
    found = run.find(tmp_path, "toy_cell")
    assert found.config["entry"] == "toy_entry" and found.mix["rate"] == 2.0
    line, checks = run.run_cell(tmp_path, found, 3, 0.1, False, torch.device("cpu"))
    assert line["correct"] and checks == [("toy_number", 0.0, 0.0)]
    assert line["metrics"] == {"toy_rate": {"value": 6.0, "unit": "1/s"},
                               "setup_s": {"value": 0.5, "unit": "s"}}
    assert list(line)[-1] == "checks"
    line, _ = run.run_cell(tmp_path, found, 3, 0.1, True, torch.device("cpu"))
    assert line["metrics"] == {"toy_metric.x": {"value": 4.0, "unit": "ms"}}


def test_every_named_file_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        found = run.find(ROOT, w["name"])
        assert found.config["chips"] == w["chips"]
    for m in bench["per_layer"]:
        assert (ROOT / "jrc_bench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_no_card_no_result():
    import subprocess
    import sys

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a CUDA device is present: the run would measure")
    out = subprocess.run([sys.executable, "-m", "jrc_bench.run", "--workload", "rx_mixed_dense",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
