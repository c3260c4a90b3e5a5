"""The program's own counters, spans and stage clocks, as the per-layer
metric readers read them after a run (``metrics/*.rx.py``, ``*.dwell.py``).

They live in ``jrc_tpu_torch.utils.profiling``, whose module state outlives
the run's streamer or captured step, so a reader finds them in the process
once the run has ended. Every number is a median over the program's
per-call rings (the last few thousand calls), so the warm-up and the few
profiled calls of a traced run do not weigh. A program without them (an
earlier commit of the port) gives None for each. This module sits beside
the drivers, the benchmark's other modules that reach into the port.
"""
from __future__ import annotations

import statistics


def _profiling():
    from jrc_tpu_torch.utils import profiling

    return profiling


def _fn(name: str):
    return getattr(_profiling(), name, None)


def _median(values) -> float | None:
    values = list(values or ())
    return statistics.median(values) if values else None


def host_ms(*spans: str) -> float | None:
    """Median host ms a call of the named program spans together."""
    fn = _fn("per_call_ms")
    return None if fn is None else _median(fn(*spans))


def device_ms(entry: str) -> float | None:
    """Median device ms a call of ``entry``'s captured call, from its event pair."""
    fn = _fn("device_ms")
    return None if fn is None else _median(fn(entry))


def device_idle_pct(obs, entry: str) -> float | None:
    """The device's idle share of the window in percent: 1 − the window's calls
    times the median device ms a call over the window's length."""
    ms = device_ms(entry)
    if ms is None or not obs.calls or not obs.seconds:
        return None
    return 100.0 * (1.0 - obs.calls * ms / 1e3 / obs.seconds)


def stage_ms(entry: str, stage: str) -> float | None:
    """Median device ms of one stage of ``entry``'s call (its stage clock)."""
    fn = _fn("stage_ms")
    return None if fn is None else fn(entry).get(stage)


def slots_used_pct(entry: str) -> float | None:
    """100 · the frames found over the slots decoded, from the counters of
    ``entry``'s latest streamer; None where it decoded no slot."""
    fn = _fn("tracked")
    stats = None if fn is None else fn(entry)
    slots = getattr(stats, "slots_decoded", 0)
    return 100.0 * stats.frames / slots if slots else None
