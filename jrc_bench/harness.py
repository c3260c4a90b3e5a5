"""What the drivers share: a cell as the harness found it, what a run
returns, the compared numbers with their limits, and a few statistics.

A driver (``drivers/<entry>.py``) exposes ``run(cell) -> Outcome``. It makes
the cell's inputs from the seed, builds the program's entry point and warms
up every shape it will use, measures for ``cell.seconds``, traces a few more
calls where ``cell.trace`` is set, reads the device's peak memory, frees the
program's state and then holds what the timed path produced against the
plain reference. It counts ``setup_s`` from ``cell.t_start``, the moment
the run's process started.
"""
from __future__ import annotations

import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass
class Cell:
    name: str  # the workload's name in BENCHMARK.json
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<traffic>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # time.perf_counter() when the process started


@dataclass
class Observed:
    """What the per-layer metric readers (``metrics/<name>.py``) read."""

    calls: int  # calls of the measured window
    seconds: float  # the measured window's length
    spans: dict = field(default_factory=dict)  # span name → host seconds of each, in the window
    traced: Any = None  # trace.Traced of the traced segment, or None
    work: dict | None = None  # counts' work of the traced calls together (by kernel)


@dataclass
class Outcome:
    setup_s: float
    end_to_end: dict  # metric name → value (the cell's end-to-end metrics but setup_s)
    attempted: int
    failed: int
    checks: list  # [(name, value, limit)]: correct where every value <= its limit
    memory_peak_bytes: int
    observed: Observed


def quantile_95(values) -> float:
    """The 95th percentile of ``values`` (Python's exclusive method)."""
    vals = sorted(values)
    if len(vals) < 2:
        return vals[0] if vals else math.nan
    return statistics.quantiles(vals, n=20)[-1]


def now() -> float:
    return time.perf_counter()


def per_second_log(what: str, done_at: list, t0: float, seconds: float) -> None:
    """One line on standard error: how many ``what`` ended in each second of
    the window (where a run's pace changes inside it)."""
    counts = [0] * max(1, math.ceil(seconds))
    for t in done_at:
        if 0 <= t - t0 < seconds:
            counts[int(t - t0)] += 1
    print(f"{what} a second: {' '.join(map(str, counts))}", file=sys.stderr)


def limits(cell: Cell) -> dict:
    """The limits of the compared numbers: the configuration's, overridden by
    the mix's where it names one."""
    return {**cell.config.get("limits", {}), **cell.mix.get("limits", {})}


def checked(cell: Cell, numbers: dict) -> list:
    """[(name, value, limit)] of ``numbers`` in the order of the limits; a
    number without a limit is an error of the benchmark's files."""
    lim = limits(cell)
    missing = [k for k in numbers if k not in lim]
    if missing:
        raise KeyError(f"no limit for the compared numbers {missing}")
    return [(k, float(numbers[k]), float(lim[k])) for k in lim if k in numbers]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float64 (0 where both are 0; inf where only b is)."""
    a, b = a.to(torch.complex128 if a.is_complex() else torch.float64), \
        b.to(torch.complex128 if b.is_complex() else torch.float64)
    num, den = float(torch.linalg.vector_norm(a - b)), float(torch.linalg.vector_norm(b))
    if den == 0:
        return 0.0 if num == 0 else math.inf
    return num / den


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


