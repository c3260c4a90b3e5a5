"""The traced segment of a ``--trace 1`` run: a ``torch.profiler`` trace of
a few calls of the cell's own loop, reduced to device events, busy and idle
time, and the longest device operations and idle gaps.

Only the device is traced (``ProfilerActivity.CUDA``): no host activity and
no ``record_function`` range, so the calls run as they run untraced and the
traced window's own idle share is the device's. The calls are fenced on the
device by two spin kernels (``torch.cuda._sleep``): the first launched just
before them, the second just after the last call's readback. The window is
the time between the first fence's end and the second's start, and the
calls' device operations are those inside it. The tracer can drop the
first device events of a trace late in a process's life, so each trace
opens with launches of its own; a trace that holds both fences is kept, else
it is taken again with four times the openers, four takes in all. An idle
gap of the device is put down to the operation that ended it.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import Callable, NamedTuple

import torch

OPENERS = 256
FENCE = "spin_kernel"
FENCE_CYCLES = 100_000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Traced(NamedTuple):
    calls: int  # calls of the cell's loop in the traced segment
    events: list  # their device events: dicts with name, ts and dur (µs)
    window_s: float  # the device time between the fences
    busy_s: float  # the union of the device events' intervals
    breakdown: dict  # {"device_ops": [[name, s], ...], "idle_gaps": [[label, s], ...]}


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _gaps(events, start: float, stop: float) -> list[tuple[float, float, str]]:
    """Idle intervals of the device in [start, stop], each with the name of
    the operation that ended it."""
    out, end = [], start
    for e in sorted(events, key=lambda e: e["ts"]):
        if e["ts"] > end:
            out.append((end, e["ts"], e["name"]))
        end = max(end, e["ts"] + e["dur"])
    if stop > end:
        out.append((end, stop, "the closing fence"))
    return out


def trace_calls(call: Callable[[], None], n_calls: int) -> Traced:
    """Run ``call`` ``n_calls`` times under the profiler, between the two
    fences, and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile

    tiny = torch.zeros(1, device="cuda")
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(OPENERS * 4**attempt):
                tiny.add_(1)
            torch.cuda.synchronize()
            torch.cuda._sleep(FENCE_CYCLES)
            for _ in range(n_calls):
                call()
            torch.cuda._sleep(FENCE_CYCLES)
            torch.cuda.synchronize()
        fd, name = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(name)
            events = json.loads(Path(name).read_text())["traceEvents"]
        finally:
            os.unlink(name)
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        fences = sorted((e for e in dev if FENCE in e.get("name", "")), key=lambda e: e["ts"])
        if len(fences) != 2:
            continue
        start = fences[0]["ts"] + fences[0]["dur"]
        stop = fences[1]["ts"]
        inside = [e for e in dev if start <= e["ts"] and e["ts"] + e["dur"] <= stop]
        busy_us = _union_us((e["ts"], e["ts"] + e["dur"]) for e in inside)
        by_name: dict = defaultdict(float)
        for e in inside:
            by_name[short(e["name"])] += e["dur"] / 1e6
        by_gap: dict = defaultdict(float)
        for a, b, before in _gaps(inside, start, stop):
            by_gap["before " + short(before, 100)] += (b - a) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
        return Traced(calls=n_calls,
                      events=[{"name": e["name"], "ts": e["ts"], "dur": e["dur"]} for e in inside],
                      window_s=(stop - start) / 1e6, busy_s=busy_us / 1e6,
                      breakdown={"device_ops": [[k, v] for k, v in top],
                                 "idle_gaps": [[k, v] for k, v in gaps]})
    raise RuntimeError("the profiler trace lost a fence of the traced calls in each of four takes")


def short(name: str, keep: int = 120) -> str:
    """A device operation's name without ``void`` and cut to ``keep`` letters
    (kernel names spell out every template argument)."""
    name = name.removeprefix("void ")
    return name if len(name) <= keep else name[: keep - 3] + "..."


def kernel_ms(traced: Traced, names) -> float | None:
    """Device ms a call of the kernels whose name holds one of ``names``, or
    None where the trace holds none of them."""
    hits = [e["dur"] for e in traced.events if any(n in e["name"] for n in names)]
    return sum(hits) / 1e3 / traced.calls if hits else None
