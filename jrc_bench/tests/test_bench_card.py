"""On the card (marker ``cuda``; skipped without one): each cell runs end
to end with ``correct`` true in a short window, and the control fails each
cell's comparison on every seed it reads.

    python3 -m pytest -m cuda jrc_bench/tests/test_bench_card.py
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(card, workload):
    out = subprocess.run([sys.executable, "-m", "jrc_bench.run", "--workload", workload,
                          "--seed", str(2**33 + 5), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["rx_mixed_dense", "jrc_dwell_80B"])
def test_control_fails(card, workload):
    out = subprocess.run([sys.executable, "-m", "jrc_bench.control", "--workload", workload,
                          "--seeds", "21", "22", "23"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
