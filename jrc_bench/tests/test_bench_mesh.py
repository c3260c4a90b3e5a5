"""The sharded cell's pieces on the CPU: the layout of ``mesh_dense`` at the
cell's geometry, the driver over two gloo ranks against the reference of
the sharding (``reference/mesh.py``) with the readers of the decode's
stages and K1's count on every rank, each planted fault tripping its
number, and the watchdog that ends a run whose rank failed; and, on four
cards (marker ``cuda``), the cell itself for a few seconds.

    python3 -m pytest jrc_bench/tests/test_bench_mesh.py
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from jrc_bench import recordings
from jrc_bench.drivers import rx_mesh
from jrc_bench.harness import Cell, limits, now
from jrc_bench.reference import mesh as ref_mesh

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "jrc_bench" / "configs" / "comm-rx-mesh4.json").read_text())
MIX = json.loads((ROOT / "jrc_bench" / "traffic" / "mesh_dense.json").read_text())
SEED = 2**33 + 5
#: two ranks of 2^15 samples at max_payload 256, 32 slots a rank; ``first`` puts a
#: 2560-sample frame's trigger ~20 samples before the boundary
SMALL = {**CONFIG, "ranks": 2, "step_samples": 1 << 16, "block_len": 1 << 16, "max_payload": 256}
SMALL_MIX = {**MIX, "first": 1183, "check_frames": 4, "warm_steps": 3}


def small_cell(seconds: float = 0.0) -> Cell:
    return Cell(name="small", config=SMALL, mix=SMALL_MIX, seed=SEED, seconds=seconds,
                trace=False, device=torch.device("cpu"), t_start=now())


def test_layout_crosses_every_inner_boundary():
    """At the cell's geometry a frame crosses each of the three inner rank
    boundaries of every file, at the same places in both files (the layout
    does not depend on the seed), and one trigger lies within
    ``ref_mesh.WIDEN`` samples before a boundary, where ``owner_shift``
    bites."""
    caps = recordings.recordings(MIX, int(CONFIG["step_samples"]), SEED, "cpu")
    ranks = int(CONFIG["ranks"])
    assert len(caps) == 2 and not np.array_equal(caps[0].samples, caps[1].samples)
    np.testing.assert_array_equal(caps[0].placed.pos, caps[1].placed.pos)
    across = recordings.crossing(caps[0], ranks)
    assert sorted(across) == [1 << 21, 2 << 21, 3 << 21]
    assert all(len(a) for a in across.values())
    starts = ref_mesh.starts(torch.from_numpy(caps[0].samples), ranks,
                             rx_mesh._halo(CONFIG))
    assert any(((b - ref_mesh.WIDEN <= starts) & (starts < b)).any() for b in across)


def test_a_file_is_one_step_of_the_app():
    """The cell's geometry is the app's (``apps/comm_rx --mesh``): a file of
    ``step_samples`` is one step of ``parallel.streaming.file_steps``, with the
    port's halo, and a rank's slots are ``slots_for`` its block, 1024."""
    from jrc_tpu_torch.config import OFDMConfig
    from jrc_tpu_torch.parallel import streaming as pstream

    ranks, n, block, slots, max_payload = rx_mesh._geometry(CONFIG)
    assert (ranks, block, slots) == (4, 1 << 21, 1024)
    assert slots == pstream.slots_for(block, int(CONFIG["block_len"]))
    halo, history = pstream.edges(OFDMConfig(), None, max_payload)
    assert rx_mesh._halo(CONFIG) == halo
    assert pstream.file_steps(n, n, halo, history) == [pstream.FileStep(0, 0, n)]
    assert len(pstream.file_steps(3 * n, n, halo, history)) == 4


def test_driver_on_two_gloo_ranks_matches_the_reference():
    """A whole run of ``drivers/rx_mesh.py`` over two gloo ranks on the CPU (the sharded step
    op by op): every check passes, so the frame across the boundary is found
    once at the reference's global start, the ranks and the steps agree, and
    every stage of ``mesh`` and ``rx`` is stamped on both ranks."""
    code = textwrap.dedent(f"""
        import json, torch
        from jrc_bench.drivers import rx_mesh
        from jrc_bench.run import load_module
        from jrc_bench.tests.test_bench_mesh import small_cell
        torch.set_num_threads(2)
        out = rx_mesh.run(small_cell(seconds=2.0))
        metrics = rx_mesh.ROOT / "jrc_bench" / "metrics"
        read = {{m: load_module(metrics / f"{{m}}.py", m.replace(".", "_")).read(out.observed)
                for m in ("demap_ms.mesh", "viterbi_ms.mesh", "viterbi_steps_pct.mesh")}}
        print(json.dumps({{"checks": out.checks, "steps": out.observed.calls,
                          "rows": [{{e: len(r) for e, r in rank.items()}}
                                   for rank in out.observed.stage_rows],
                          "counts": [len(c.get("viterbi_steps", ()))
                                     for c in out.observed.count_rows],
                          "read": read}}))
    """)
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert got.returncode == 0, got.stderr[-3000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert all(v <= lim for _, v, lim in line["checks"]), line["checks"]
    assert {name for name, _, _ in line["checks"]} == set(SMALL["limits"])
    assert line["steps"] >= 1
    assert len(line["rows"]) == 2 and all(r["mesh"] == r["rx"] >= 4 for r in line["rows"])
    assert line["counts"] == [r["rx"] for r in line["rows"]]
    assert all(v is not None and v > 0 for v in line["read"].values()), line["read"]
    assert line["read"]["viterbi_steps_pct.mesh"] <= 100


@pytest.mark.parametrize("fault, trips", [(None, ("snr_gap_db", "chan_est_err")),
                                          ("halo_dropped", ("boundary_frames_missed",)),
                                          ("owner_shift", ("frames_extra", "starts_wrong"))])
def test_each_fault_trips_its_number(fault, trips):
    """The reference put in the program's place: in bfloat16 (the control)
    past a float limit, with the right halo zeroed past
    ``boundary_frames_missed``, with the owned span widened past
    ``frames_extra`` and ``starts_wrong``; the faults leave the floats of
    the frames they do not touch in float64."""
    cell = small_cell()
    numbers = rx_mesh.control(cell, fault)
    lim = limits(cell)
    assert all(numbers[k] > lim[k] for k in trips), numbers
    if fault is not None:
        assert numbers["chan_est_err"] <= lim["chan_est_err"], numbers


@pytest.mark.parametrize("why", ["a rank failed", "the limit passed"])
def test_the_watchdog_ends_a_run_whose_rank_failed(why):
    """A rank that exits with an error, or a run past its limit, ends rank 0
    with ``RANK_FAILED`` within seconds, its peers killed."""
    code = textwrap.dedent(f"""
        import subprocess, sys, tempfile, time
        from jrc_bench.drivers import rx_mesh
        from jrc_bench.harness import now
        fails = {why == "a rank failed"!r}
        peer = subprocess.Popen([sys.executable, "-c",
                                 "import sys, time; time.sleep(1); sys.exit(3)" if fails
                                 else "import time; time.sleep(60)"])
        rx_mesh._Watch([peer], [tempfile.TemporaryFile("w+")], now() + (60 if fails else 1)).start()
        time.sleep(60)
    """)
    t0 = now()
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert got.returncode == rx_mesh.RANK_FAILED, got.stderr[-2000:]
    assert now() - t0 < 30
    assert ("exited with [(1, 3)]" if why == "a rank failed" else "passed its limit") in got.stderr


@pytest.mark.cuda
def test_sharded_cell_runs_correct():
    """On four cards: the cell for a few seconds, ``correct``."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(CONFIG["chips"]):
        pytest.skip(f"needs {CONFIG['chips']} CUDA devices")
    out = subprocess.run([sys.executable, "-m", "jrc_bench.run", "--workload", "rx_sharded4",
                          "--seed", str(SEED), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 4 and line["metrics"]["rx_msps"]["value"] > 0
