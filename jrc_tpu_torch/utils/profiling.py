"""The port's tracing: host spans and counters, the device time of each
captured call, and stage clocks inside the captured graphs.

Everything here is always on and costs no synchronize on the path it
measures; only the spans' timeline is off by default. Its state lives in
this module (a streamer's counters are tracked here), so it outlives the
objects that fed it (a streamer, a captured function) and a run is read
once it has ended.

**Host spans.** ``with span(name, call):`` times a host step with
``time.perf_counter_ns`` and adds its duration to the span's totals
(``spans()``: count, total and self ns, self being the duration less the
spans opened inside it on the same thread) and to a bounded ring of
per-call samples (the last ``KEEP`` samples of each span, with the call
index each belongs to; a span opened inside another takes its parent's call
where it names none). ``per_call_ms(*names)`` sums the named spans call by
call over the calls every ring still holds. The entry points' spans:

==================  =====================================================  ==================
span                what it times                                          parent
==================  =====================================================  ==================
``stream.push``     ``BlockStreamer.push`` / ``push_sc16``: the ring copy  none
``stream.dispatch`` ``BlockStreamer``'s pop, upload enqueue and call       none
``stream.slot_wait`` the host blocked on a staging buffer's last upload   ``stream.dispatch``
``stream.pop``      ``pop_block`` into the pinned staging buffer           ``stream.dispatch``
``graph.replay``    a ``CapturedFunction`` call: input copies, replay,     ``stream.dispatch``
                    output clones (on CPU tensors: the call as it is)      or none
``graph.capture``   a capture: warm-up, capture, instantiation             none
``stream.readback`` ``BlockStreamer``'s small readback of a call's counts  none
==================  =====================================================  ==================

**Counters.** Each count has one home, on the object that counts it:
``io.stream.StreamStats`` (calls, slots decoded, frames, the ring's fill)
and ``utils.graph.CapturedFunction`` (replays, captures). ``track(entry,
stats)`` keeps the latest counters of an entry point here, so they are read
(``tracked(entry)``) once the object that fed them is gone.

**Timeline.** Inside ``with recording():`` each span is also kept as (name,
start, end, id, parent id, call index, thread) until the next recording
starts. ``export(path, profiler_trace)`` writes the recorded spans as a
chrome trace, merged into a ``torch.profiler`` chrome trace where one is
given: spans are placed on CLOCK_REALTIME (``perf_counter_ns`` plus the
offset read when the recording started), the clock a profiler trace's
``ts`` · 1000 + ``baseTimeNanoseconds`` stands on. ``idle_gaps(...)`` names
each idle gap of the device in such a trace by the innermost program span
open on the host when it began.

**Device time of a call.** ``DeviceClock`` records a timing event pair on
the current stream around one call in ``DeviceClock.EVERY``, from a small
pool, and harvests a pair once its end event has completed: no
synchronize. ``device_ms(name)`` is the list of the last ``KEEP`` timed
calls' device ms. A captured function puts
the pair around its graph's replay alone (its input copies and output
clones stay outside, as their launches wait on the host), keeps one clock a
signature and names it after the entry point whose stages its capture
stamped (``"rx"``, ``"dwell"``), else after the function.

**Stage clocks.** ``stamp(entry, stage, like)`` writes the time of
``stage`` of ``entry``'s current call into a ring of ``ROWS`` calls ×
stages on ``like``'s device (kernels/csrc/stamp.cu: one thread reads the
device's ``%globaltimer``; on the CPU the host's ``perf_counter_ns`` goes
into the same layout). It is a launch like any other, so a captured graph
holds it and every replay stamps its own row; stage ``start`` begins a
call. The sharded step (``parallel/streaming``) stamps entry ``"mesh"``
before its halo exchange (``start``), after it (``halo``), after the decode
and the global starts (``decode``) and after the all-reduce and the
all-gathers (``collect``); the decode's own ``"rx"`` stamps fire inside it.
``stage_ms(entry)`` reads the rings once, when asked, and gives each
stage's median ms (from the stamp before it) over the complete rows.

**Device counts.** A kernel of a captured call can count what it did into
a ring beside its entry's stage clock (``COUNTS``): ``count_ring(entry,
name, like)`` hands it a (``ROWS``, 2) int64 ring and the stage clock's call
counter, and it raises, in the row of the call begun last, the count and
the envelope it is a share of, each as call << 32 | value (atomicMax, so a
launch's warps need no order and a stale row never wins). The payload's K1
writes ``viterbi_steps`` of ``rx``: the longest row's trellis steps and the
envelope's T (``ops.viterbi_cuda``). ``count`` is the host's version of the
same write (``viterbi_cuda`` on the CPU), ``counts(entry, name)`` reads the rings
once, when asked: (value, envelope) a call.
"""
from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import statistics
import threading
import time
from collections import deque
from pathlib import Path

import torch

#: samples each per-call ring keeps (spans, device times)
KEEP = 4096
#: calls each stage ring keeps
ROWS = 4096
#: the stages of each entry point, in order; ``start`` begins a call
STAGES = {
    "rx": ("start", "detect", "extract", "equalize", "demap", "viterbi", "finish"),
    "dwell": ("start", "tx", "channel", "radar", "comm_rx"),
    "mesh": ("start", "halo", "decode", "collect"),
}
_STAGE_INDEX = {e: {s: i for i, s in enumerate(st)} for e, st in STAGES.items()}
#: the counts that each entry point's kernels write beside its stages
COUNTS = {"rx": ("viterbi_steps",)}
#: device operations in a profiler chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside the program"

# No lock: under the GIL each update below is one step, and a span name is
# fed from one thread at a time.
_local = threading.local()
_ids = itertools.count(1)
_spans: dict = {}  # name → _SpanStats
_tracked: dict = {}  # entry → the counters of its latest instance
_device: dict = {}  # clock name → deque of (call, ms)
_rings: dict = {}  # (entry, device) → _StageRing
_timeline: list | None = None  # the spans of the recording under way
_recorded: list = []  # the spans of the last recording
_anchor_ns = 0  # CLOCK_REALTIME − perf_counter_ns when the last recording started
_stamped: list | None = None  # the entries stamped while ``entries_stamped`` is open


class _SpanStats:
    __slots__ = ("n", "total_ns", "self_ns", "samples")

    def __init__(self):
        self.n = self.total_ns = self.self_ns = 0
        self.samples = deque(maxlen=KEEP)  # (call, ns)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """``with span(name, call):`` times the block on the host clock (see the
    module). ``call`` is the call index the block belongs to; None takes the
    enclosing span's, or -1 where there is none."""

    __slots__ = ("name", "call", "sid", "parent", "child_ns", "t0")

    def __init__(self, name: str, call: int | None = None):
        self.name, self.call = name, call

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent
        if self.call is None:
            self.call = parent.call if parent is not None else -1
        self.sid = next(_ids)
        self.child_ns = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        _stack().pop()
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        st = _spans.get(self.name)
        if st is None:
            st = _spans.setdefault(self.name, _SpanStats())
        st.n += 1
        st.total_ns += dur
        st.self_ns += dur - self.child_ns
        st.samples.append((self.call, dur))
        if _timeline is not None:
            _timeline.append((self.name, self.t0, t1, self.sid,
                              parent.sid if parent is not None else 0, self.call,
                              threading.get_ident()))
        return False


def spans() -> dict:
    """name → {"n", "total_ns", "self_ns"} of every span recorded so far."""
    return {k: {"n": v.n, "total_ns": v.total_ns, "self_ns": v.self_ns}
            for k, v in list(_spans.items())}


def per_call_ms(*names: str) -> list[float]:
    """Host ms a call of the named spans together: for each call index that
    every named span's ring still covers (the calls from the latest first
    call to the earliest last call of the rings), the sum of its samples. A
    span with no sample at all adds nothing; empty where none has one."""
    rings = [list(_spans[n].samples) if n in _spans else [] for n in names]
    rings = [r for r in ([(c, ns) for c, ns in r if c >= 0] for r in rings) if r]
    if not rings:
        return []
    lo = max(min(c for c, _ in r) for r in rings)
    hi = min(max(c for c, _ in r) for r in rings)
    sums: dict = {}
    for r in rings:
        for c, ns in r:
            if lo <= c <= hi:
                sums[c] = sums.get(c, 0) + ns
    return [sums[c] / 1e6 for c in sorted(sums)]


def median(values) -> float | None:
    values = list(values)
    return statistics.median(values) if values else None


def reset() -> None:
    """Forget every span, tracked counter and device time and clear the
    stage rings (between independent runs in one process). A ring is
    cleared in place: the graphs captured with it write to it by address."""
    for d in (_spans, _tracked, _device):
        d.clear()
    _recorded.clear()
    for r in _rings.values():
        r.ring.zero_()
        r.counter.zero_()
        for c in r.counts.values():
            c.zero_()
        r.calls = 0


def track(entry: str, stats) -> None:
    """Keep ``stats``, the counters of ``entry``'s latest instance (a
    streamer's ``StreamStats``), for ``tracked``."""
    _tracked[entry] = stats


def tracked(entry: str):
    """The counters ``track`` kept for ``entry``, else None."""
    return _tracked.get(entry)


# ---------------------------------------------------------------------------
# device time of a call
# ---------------------------------------------------------------------------


class DeviceClock:
    """The device time of calls on a CUDA stream: ``start()`` records the
    first event of a pair on the current stream, ``stop(pair, call)`` the
    second; pairs whose end has completed are harvested into
    ``device_ms(name)`` at each timed ``stop``, with no synchronize. One
    call in ``EVERY`` is timed: a pair's records, query and elapsed time
    cost the host ~32 µs, 3.6% of a closed-loop JRC dwell on the H100 when
    every call was timed, and a median needs no more."""

    EVERY = 8

    def __init__(self, name: str):
        self.name = name
        self._calls = 0
        self._free: list = []
        self._pending: deque = deque()

    def start(self):
        """The pair of this call, its first event recorded; None for a call
        not timed."""
        self._calls += 1
        if (self._calls - 1) % self.EVERY:
            return None
        pair = self._free.pop() if self._free else (torch.cuda.Event(enable_timing=True),
                                                    torch.cuda.Event(enable_timing=True))
        pair[0].record()
        return pair

    def stop(self, pair, call: int) -> None:
        if pair is None:
            return
        pair[1].record()
        self._pending.append((call, pair))
        self.harvest()

    def harvest(self) -> None:
        """File the device ms of every pair that has completed, in order."""
        while self._pending and self._pending[0][1][1].query():
            call, pair = self._pending.popleft()
            _device.setdefault(self.name, deque(maxlen=KEEP)).append(
                (call, pair[0].elapsed_time(pair[1])))
            self._free.append(pair)


def device_ms(name: str) -> list[float]:
    """Device ms of the last ``KEEP`` timed calls of clock ``name``."""
    return [ms for _, ms in _device.get(name, ())]


# ---------------------------------------------------------------------------
# stage clocks
# ---------------------------------------------------------------------------


class _StageRing:
    def __init__(self, entry: str, device: torch.device):
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the stage ring of {entry!r} is made at its first stamp, which "
                               "must run before a capture (a captured function's warm-up does)")
        self.stages = len(STAGES[entry])
        self.ring = torch.zeros((ROWS, 1 + self.stages), dtype=torch.int64, device=device)
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.counts = {name: torch.zeros((ROWS, 2), dtype=torch.int64, device=device)
                       for name in COUNTS.get(entry, ())}
        self.calls = 0  # the counter on the host, for the plain version (no read back)
        self.device = device


def _ring(entry: str, device: torch.device) -> _StageRing:
    r = _rings.get((entry, device))
    if r is None:
        r = _rings[(entry, device)] = _StageRing(entry, device)
    return r


def _stamp_kernel():
    from jrc_tpu_torch import kernels

    fn = kernels.lib().jrc_stamp
    if fn.argtypes is None:
        fn.argtypes = [kernels.P, kernels.P, kernels.I, kernels.I, kernels.I, kernels.P]
        fn.restype = kernels.I
    return kernels


def stamp(entry: str, stage: str, like: torch.Tensor) -> None:
    """Write the time of ``stage`` of ``entry``'s current call on ``like``'s
    device (see the module); stage ``start`` begins a call."""
    s = _STAGE_INDEX[entry][stage]
    if _stamped is not None and entry not in _stamped:
        _stamped.append(entry)
    r = _ring(entry, like.device)
    if like.device.type == "cuda":
        kernels = _stamp_kernel()
        kernels.call("jrc_stamp", kernels.ptr(r.ring), kernels.ptr(r.counter), ROWS, r.stages, s)
        return
    t = time.perf_counter_ns()
    if s == 0:
        r.calls += 1
        r.counter.fill_(r.calls)
    n = r.calls
    if n == 0:
        return
    row = r.ring[(n - 1) % ROWS]
    if s == 0:
        row.zero_()
        row[0] = n
    row[1 + s] = t


def count_ring(entry: str, name: str, like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the (``ROWS``, 2) int64 ring of count ``name`` of ``entry``, its stage
    clock's call counter) on ``like``'s device, for a kernel that writes the
    count of the current call (see the module)."""
    r = _ring(entry, like.device)
    return r.counts[name], r.counter


def count(entry: str, name: str, value: int, envelope: int, like: torch.Tensor) -> None:
    """The host's write of a count into ``entry``'s current call on a CPU
    tensor's ring (the plain version's call counter), as a kernel makes it."""
    r = _ring(entry, like.device)
    call = r.calls
    if call == 0:
        return
    row = r.counts[name][(call - 1) % ROWS]
    for col, v in enumerate((value, envelope)):
        row[col] = max(int(row[col]), call << 32 | int(v))


def counts(entry: str, name: str) -> list[tuple[int, int]]:
    """(value, envelope) of count ``name`` of each of ``entry``'s calls that
    its rings hold, oldest call first. Reading a ring on a card waits for its
    device."""
    rows = []
    for (e, device), r in list(_rings.items()):
        if e != entry or name not in r.counts:
            continue
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for value, envelope in r.counts[name].cpu().tolist():
            call = value >> 32
            if call > 0 and envelope >> 32 == call:
                rows.append((call, value & 0xFFFFFFFF, envelope & 0xFFFFFFFF))
    return [(v, e) for _, v, e in sorted(rows)]


@contextlib.contextmanager
def entries_stamped():
    """Yield the list of the entry points stamped while the block runs."""
    global _stamped
    outer, _stamped = _stamped, []
    try:
        yield _stamped
    finally:
        seen, _stamped = _stamped, outer
        if outer is not None:
            outer.extend(e for e in seen if e not in outer)


def stage_rows(entry: str) -> list[list[int]]:
    """The complete rows of ``entry``'s stage rings, oldest call first: [call,
    t_start, t_stage1, ...] with every stage stamped, in order. Reading a
    ring on a card waits for its device."""
    rows = []
    for (e, device), r in list(_rings.items()):
        if e != entry:
            continue
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for row in r.ring.cpu().tolist():
            ts = row[1:]
            if row[0] > 0 and all(ts) and all(a <= b for a, b in zip(ts, ts[1:])):
                rows.append(row)
    return sorted(rows)


def stage_ms(entry: str, last: int | None = None) -> dict:
    """Median device ms of each stage of ``entry`` but ``start`` (from the
    stamp before it) over the complete rows of its rings, or over the
    ``last`` newest of them; {} without one."""
    rows = stage_rows(entry)
    if last is not None:
        rows = rows[max(0, len(rows) - last):] if last > 0 else []
    names = STAGES[entry]
    if not rows:
        return {}
    return {names[s]: statistics.median((r[1 + s] - r[s]) / 1e6 for r in rows)
            for s in range(1, len(names))}


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recording():
    """Keep every span closed inside the block (``recorded()``), on the
    clock ``export`` places them on."""
    global _timeline, _recorded, _anchor_ns
    _anchor_ns = time.time_ns() - time.perf_counter_ns()
    _timeline = []
    try:
        yield
    finally:
        _recorded, _timeline = _timeline, None


def recorded() -> list[dict]:
    """The spans of the last recording, start and end in CLOCK_REALTIME ns."""
    return [{"name": n, "start": t0 + _anchor_ns, "end": t1 + _anchor_ns, "id": sid,
             "parent": pid, "call": call, "thread": tid}
            for n, t0, t1, sid, pid, call, tid in _recorded]


def _load(trace) -> dict:
    if trace is None or isinstance(trace, dict):
        return trace
    return json.loads(Path(trace).read_text())


def export(path, profiler_trace=None) -> Path:
    """Write the recorded spans as a chrome trace to ``path``, merged into
    ``profiler_trace`` (a ``torch.profiler`` chrome trace: its path or its
    loaded JSON) where one is given; spans and device events then share its
    clock. Returns ``path``."""
    trace = _load(profiler_trace)
    spans_ = recorded()
    if trace is None:
        base = min((s["start"] for s in spans_), default=0)
        trace = {"traceEvents": [], "baseTimeNanoseconds": base}
    base = int(trace.get("baseTimeNanoseconds", 0))
    trace["traceEvents"] = list(trace.get("traceEvents", [])) + [
        {"ph": "X", "cat": "program", "name": s["name"], "pid": "program", "tid": s["thread"],
         "ts": (s["start"] - base) / 1e3, "dur": (s["end"] - s["start"]) / 1e3,
         "args": {"call": s["call"], "id": s["id"], "parent": s["parent"]}}
        for s in spans_]
    path = Path(path)
    path.write_text(json.dumps(trace))
    return path


def idle_gaps(profiler_trace, spans_: list[dict] | None = None) -> list[tuple]:
    """The device's idle gaps in ``profiler_trace`` (between its first and
    last device operation), longest first, as (start ns on CLOCK_REALTIME,
    length ns, label): the innermost of ``spans_`` (default: the recorded
    spans) open when the gap began, or ``OUTSIDE``."""
    trace = _load(profiler_trace)
    base = int(trace.get("baseTimeNanoseconds", 0))
    # integer ns: a float64 holds CLOCK_REALTIME's ns only to a few hundred
    dev = sorted((base + round(e["ts"] * 1e3), base + round((e["ts"] + e["dur"]) * 1e3))
                 for e in trace.get("traceEvents", [])
                 if e.get("cat") in DEVICE_CATS and "dur" in e)
    spans_ = sorted(recorded() if spans_ is None else spans_, key=lambda s: s["start"])
    starts = [s["start"] for s in spans_]
    out, end = [], None
    for a, b in dev:
        if end is not None and a > end:
            out.append((end, a - end, _innermost(spans_, starts, end)))
        end = b if end is None else max(end, b)
    return sorted(out, key=lambda g: -g[1])


def _innermost(spans_: list[dict], starts: list, t: float) -> str:
    """The name of the span open at ``t`` that started last."""
    i = bisect.bisect_right(starts, t)
    while i > 0:
        i -= 1
        if spans_[i]["end"] > t:
            return spans_[i]["name"]
    return OUTSIDE


# ---------------------------------------------------------------------------
# the operator's line
# ---------------------------------------------------------------------------


def summary(entry: str, calls: int, seconds: float, busy: tuple, blocked: tuple, *,
            stats=None, captured=None) -> str:
    """One line of an entry point's counters for an app's exit: its calls,
    the slots used where ``stats`` (a ``StreamStats``) counts slots, the
    replays and captures of ``captured`` (a ``CapturedFunction``; a capture
    beyond its signatures is a recompile), the host ms a call of the
    ``busy`` and ``blocked`` spans (medians), the device's idle share over
    ``seconds`` from ``entry``'s device ms, the median ms of each stage and
    of each of ``entry``'s ``COUNTS``: the median count a call over the
    envelope, and the counts' sum over the envelopes' in percent."""
    parts = [f"counters {entry}: calls={calls}"]
    if stats is not None and stats.slots_decoded:
        parts.append(f"slots_used={stats.frames}/{stats.slots_decoded} "
                     f"({100.0 * stats.frames / stats.slots_decoded:.2f}%)")
    if captured is not None:
        parts.append(f"replays={captured.replays} captures={captured.captures}")
    for label, names in (("host_busy_ms", busy), ("host_blocked_ms", blocked)):
        m = median(per_call_ms(*names))
        parts.append(f"{label}={'n/a' if m is None else f'{m:.4f}'}")
    dev = median(device_ms(entry))
    if dev is None or not seconds:
        parts.append("device_idle=n/a")
    else:
        idle = 100.0 * (1 - calls * dev / 1e3 / seconds)
        parts.append(f"device_ms={dev:.4f} device_idle={idle:.1f}%")
    stages = stage_ms(entry)
    parts.append("stage_ms " + (" ".join(f"{k}={v:.4f}" for k, v in stages.items())
                                if stages else "n/a"))
    for name in COUNTS.get(entry, ()):
        rows = counts(entry, name)
        if rows:
            value = statistics.median(v for v, _ in rows)
            share = 100.0 * sum(v for v, _ in rows) / sum(e for _, e in rows)
            parts.append(f"{name}={value:g}/{rows[-1][1]} ({share:.1f}%)")
    return " ".join(parts)


#: the calls a ``CallTrace`` profiles after the first (as many as the benchmark traces)
TRACE_CALLS = 24


class CallTrace:
    """``with CallTrace(out_dir) as t:`` records the spans' timeline while
    the block runs and a device-only ``torch.profiler`` trace of the
    ``TRACE_CALLS`` calls after the first (``t.called()`` after each call;
    no profiler without a card). On exit it writes ``out_dir``/trace.json,
    the spans merged into the device trace, and ``gaps`` holds the five
    longest idle gaps of the device by host span (``idle_gaps``). With
    ``out_dir`` None it records nothing."""

    def __init__(self, out_dir):
        self.out_dir = None if out_dir is None else Path(out_dir)
        self.calls, self.gaps, self._prof = 0, [], None
        self._recording = recording()

    def __enter__(self):
        if self.out_dir is not None:
            self._recording.__enter__()
        return self

    def called(self) -> None:
        if self.out_dir is None:
            return
        self.calls += 1
        if self.calls == 1 and torch.cuda.is_available():
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
        elif self.calls == 1 + TRACE_CALLS:
            self._stop()

    def _stop(self) -> None:
        if self._prof is not None and self.calls <= 1 + TRACE_CALLS:
            torch.cuda.synchronize()
            self._prof.stop()
            self.calls = 2 + TRACE_CALLS  # stopped once

    def __exit__(self, *exc) -> bool:
        if self.out_dir is None:
            return False
        self._stop()
        self._recording.__exit__(*exc)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        device = None
        if self._prof is not None:
            raw = self.out_dir / "device_trace.json"
            self._prof.export_chrome_trace(str(raw))
            device = _load(raw)
            raw.unlink()
        export(self.out_dir / "trace.json", device)
        self.gaps = idle_gaps(device)[:5] if device is not None else []
        return False
