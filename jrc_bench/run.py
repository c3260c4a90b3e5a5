"""The benchmark of ``jrc_tpu_torch``, the PyTorch and CUDA port, on NVIDIA GPUs.

    python3 -m jrc_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. One process runs one cell once: it makes the
cell's inputs from ``--seed``, builds the port's entry point (whose kernels
load from, or build into, ``build/`` in the checkout), warms up the cell's
own shapes, which captures its CUDA graphs, measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
from a traced segment of a few more calls), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which also close standard error. Without a CUDA device, or with fewer than
the cell asks for, it exits with 2 and prints no result; with a JAX module
loaded when the window has closed, with 3.

Everything is found by name from ``BENCHMARK.json``:

* ``workloads[i]`` names a ``config`` and a ``traffic``;
* ``configs/<config>.json`` is the deployment: its source, its settings,
  ``reduced``, ``assumed``, the ``entry`` driver it runs and the
  ``limits`` of the compared numbers;
* ``traffic/<traffic>.json`` is the mix: the parameters the one generator
  (``generate.py``) and the entry's driver read;
* ``drivers/<entry>.py`` is one window loop of the port's entry points,
  ``rx_stream`` (``io.stream.BlockStreamer``, as ``apps/comm_rx`` runs it)
  and ``jrc_loop`` (``models.jrc_trx.JRCTrx`` under ``utils.graph.jit``, as
  the JRC dwell loop runs it), with its checks and its control;
* ``metrics/<metric>.py`` is one per-layer metric: ``read(observed)``
  returns its value from the run's spans or trace, or None where it finds
  nothing to read (the metric is then left out of the line);
* ``reference/`` is the plain reference in numpy, written from the link's
  and the radar's semantics and importing nothing of the port: ``phy.py``
  the frame's TX chain, the bench channel and a receiver, ``dwell.py`` the
  JRC dwell; ``counts.py`` the peaks and the work of each kernel,
  ``trace.py`` the reduction of a device-only profiler trace.

To add a cell, add its entry to ``workloads`` and, where new, its traffic
file; a configuration, its entry in ``configs`` and its file; a mix, its
file under ``traffic/``; a per-layer metric, its entry in ``per_layer`` and
its file under ``metrics/``; an entry point, its driver under ``drivers/``.
No existing file changes.

The control of the comparison (the reference in bfloat16 put in the
program's place) and the faults the truth checks are there for are
``python3 -m jrc_bench.control --workload <name> --seeds <n> ...
[--fault <name>]``; the CPU tests are ``python3 -m pytest jrc_bench/tests`` and the
card's ``python3 -m pytest -m cuda jrc_bench/tests``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "jrc_tpu")


def load_module(path: Path, name: str):
    """A module from its file (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Found(NamedTuple):
    bench: dict  # BENCHMARK.json
    cell: dict  # its workload entry
    config: dict  # the configuration's file
    mix: dict  # the traffic mix's file
    driver: object  # the configuration's entry driver module


def find(root: Path, workload: str) -> Found:
    """Everything a cell names, found by name under ``root``, a checkout."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    (entry,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    here = root / "jrc_bench"
    mix = json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = load_module(here / "drivers" / f"{config['entry']}.py",
                         "jrc_bench_driver_" + config["entry"])
    return Found(bench, cell, config, mix, driver)


def applies(metric: dict, cell: dict, reported: set | None = None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` list,
    else every cell (an end-to-end metric) or every cell that reports the
    end-to-end metric it ``moves`` (a per-layer one; ``reported``)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    return reported is None or metric["moves"] in reported


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")


def result_line(root: Path, found: Found, outcome, trace: bool, device_info: dict) -> dict:
    """The JSON object the run prints last."""
    bench, cell = found.bench, found.cell
    e2e = [m for m in bench["end_to_end"] if applies(m, cell)]
    if trace:
        e2e_names = {m["name"] for m in e2e}
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, cell, e2e_names):
                continue
            reader = load_module(root / "jrc_bench" / "metrics" / f"{m['name']}.py",
                                 "jrc_bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(outcome.observed)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(outcome.end_to_end, setup_s=outcome.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    correct = all(v <= lim for _, v, lim in outcome.checks)
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device_info}
    if trace and outcome.observed.traced is not None:
        line["breakdown"] = outcome.observed.traced.breakdown
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    found = find(ROOT, args.workload)
    cell = found.cell
    cache_env(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"jrc_bench: the cell needs {cell['chips']} CUDA device(s), this machine has {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    line, checks = run_cell(ROOT, found, args.seed, args.seconds, bool(args.trace), device)
    loaded = forbidden_modules()
    if loaded:
        print(f"jrc_bench: the process loaded {loaded}; the port may load no JAX module",
              file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def run_cell(root: Path, found: Found, seed: int, seconds: float, trace: bool,
             device) -> tuple[dict, list]:
    """Run the cell once on ``device`` → (the result line, its checks)."""
    import torch

    from jrc_bench.harness import Cell

    cell = found.cell
    outcome = found.driver.run(Cell(name=cell["name"], config=found.config, mix=found.mix,
                                    seed=seed, seconds=seconds, trace=trace, device=device,
                                    t_start=T_START))
    on_card = device.type == "cuda"
    info = {"platform": "gpu" if on_card else device.type,
            "kind": torch.cuda.get_device_name(device) if on_card else device.type,
            "count": int(cell["chips"]), "memory_peak_bytes": outcome.memory_peak_bytes}
    if trace and outcome.observed.traced is not None:
        info["busy_s"] = outcome.observed.traced.busy_s
        info["window_s"] = outcome.observed.traced.window_s
    return result_line(root, found, outcome, trace, info), outcome.checks


if __name__ == "__main__":
    sys.exit(main())
