"""Profiling kernels P1-P3 on the card: the counterpart of the three TPU
scripts scripts/profile_shuffle.py, scripts/profile_gather_variants.py
and scripts/profile_viterbi_variants.py.

    python -m jrc_tpu_torch.profiling

runs every variant at the scripts' own shapes through its CUDA kernel
(``ops/shuffle_pieces``, ``ops/gather_pieces``, ``ops/viterbi_pieces``),
timed with CUDA events (median of 10 after a warm-up), and prints one line
per variant as the scripts do. It needs a CUDA device; there is no CPU
path. ``chip_smoke.py`` runs the same ``cases`` and holds each kernel
against its plain version; ``scripts/bench_pieces_cuda.py`` times each
kernel alone and back to back.
"""
from __future__ import annotations

import json
import statistics
import sys
import tempfile
import time
from functools import partial
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from jrc_tpu_torch.ops import gather_pieces, shuffle_pieces, viterbi_pieces

# the scripts' own shapes: the dynamic executor's at max_payload=96
# (864 trellis steps, a 3328-sample window, 256 blocks × 12 frame slots)
SHUFFLE_B, SHUFFLE_STEPS = 3072, 864  # scripts/profile_shuffle.py:21-22
GATHER_B, GATHER_N, GATHER_WIDTH = 3072, (1 << 23) + 8192, 3328  # profile_gather_variants.py:23-25
VITERBI_B, VITERBI_T, VITERBI_CHUNK_T = 3072, 864, 32  # profile_viterbi_variants.py:29-32


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time in ms the card could take to move ``n_bytes`` once
    and do ``n_ops`` float32 operations, and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


class Case(NamedTuple):
    piece: str  # wrapper name: shuffle_pieces, gather_pieces or viterbi_pieces
    label: str  # the script's line label
    run: Callable  # the wrapper on the case's inputs (the kernel on a CUDA device)
    plain: Callable  # the plain version on the same inputs
    n_bytes: int  # what the case must move: each input read once, each output written once
    n_ops: int  # its float32 operations (adds, multiplies, compares)


def cases(dev) -> list[Case]:
    """Every variant of P1-P3 at the scripts' shapes, inputs on ``dev``
    drawn as the scripts draw them (numpy, seed 0)."""
    out = []
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (64, SHUFFLE_B)).astype(np.float32)).to(dev)
    # per element and step: the halving, plus an add (baseline, repeat2) or
    # two adds and a min (halves)
    step_ops = {"baseline": 2, "repeat2": 2, "interleave": 1, "concat": 1, "halves": 4, "roll8": 1}
    for v in shuffle_pieces.VARIANTS:
        args = (x, v, SHUFFLE_STEPS)
        out.append(Case("shuffle_pieces", f"{v:12s}", partial(shuffle_pieces.shuffle_pieces, *args),
                        partial(shuffle_pieces.shuffle_pieces_plain, *args),
                        2 * x.numel() * 4, x.numel() * SHUFFLE_STEPS * step_ops[v]))

    rng = np.random.default_rng(0)
    xs = rng.normal(0, 1, (2, GATHER_N)).astype(np.float32)
    xc = torch.complex(torch.from_numpy(xs[0]), torch.from_numpy(xs[1])).to(dev)
    starts = torch.from_numpy(rng.integers(0, GATHER_N - 4000, GATHER_B).astype(np.int32)).to(dev)
    for v in gather_pieces.VARIANTS:
        args = (xc, starts, GATHER_WIDTH, v)
        row_bytes = GATHER_B * -(-GATHER_WIDTH // gather_pieces.LANE) * gather_pieces.LANE * 8
        moved = row_bytes if v == "noroll_nodma" else 2 * row_bytes + 4 * GATHER_B
        out.append(Case("gather_pieces", f"{v:14s}", partial(gather_pieces.gather_pieces, *args),
                        partial(gather_pieces.gather_pieces_plain, *args), moved, 0))

    rng = np.random.default_rng(0)
    for variant, chunk_t in [(v, VITERBI_CHUNK_T) for v in ("noacs", "norepeat", "nopack", "full")] \
            + [("full", 16), ("full", 64)]:
        t_pad = -(-VITERBI_T // chunk_t) * chunk_t
        va, vb = (torch.from_numpy(rng.normal(0, 1, (t_pad, VITERBI_B)).astype(np.float32)).to(dev)
                  for _ in range(2))
        label = (f"fwd[{variant}] T={t_pad} B={VITERBI_B}" if chunk_t == VITERBI_CHUNK_T
                 else f"fwd[{variant}] chunk_t={chunk_t}")
        args = (va, vb, variant, chunk_t)
        # va, vb in; w0, w1 and the 64 metrics out; per state and step two
        # adds and a compare-select, per chunk a renormalizing subtract
        moved = 4 * t_pad * VITERBI_B * 4 + 64 * VITERBI_B * 4
        ops = 0 if variant == "noacs" else 64 * VITERBI_B * (3 * t_pad + t_pad // chunk_t)
        out.append(Case("viterbi_pieces", f"{label:34s}",
                        partial(viterbi_pieces.viterbi_pieces, *args),
                        partial(viterbi_pieces.viterbi_pieces_plain, *args), moved, ops))
    return out


def library_call(case: Case):
    """The one PyTorch call that computes ``case``'s function, its index
    built here, outside any timing: for P2 ``xp[idx]`` on the zero-padded
    stream, as the plain version's last line (``torch.zeros`` for
    noroll_nodma, which reads nothing); None for P1 and P3, which no single
    call computes."""
    if case.piece != "gather_pieces":
        return None
    x, starts, width, variant = case.run.args
    w_out = -(-width // gather_pieces.LANE) * gather_pieces.LANE
    if variant == "noroll_nodma":
        return partial(torch.zeros, (starts.shape[0], w_out), dtype=torch.complex64,
                       device=x.device)
    s = starts.to(torch.int64).clamp(0, x.shape[-1] - width)
    if variant == "noroll":
        s = s // gather_pieces.LANE * gather_pieces.LANE
    xp = torch.cat([x, torch.zeros(w_out, dtype=x.dtype, device=x.device)])
    idx = s[:, None] + torch.arange(w_out, device=x.device)
    return lambda: xp[idx]


L2_FLUSH_BYTES = 1 << 27  # 128 MiB, more than twice the H100's 50 MB L2


def l2_flusher(dev):
    """A function that overwrites a buffer larger than the L2, so the next
    launch finds the cache cold as a caller's would."""
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    return buf.zero_


def warm_up(fn, seconds: float = 0.2) -> None:
    """Run ``fn`` for ``seconds`` so the card's clocks are up before a timing."""
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()


def time_ms(fn, reps: int, flush=None) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA events,
    after one warm-up run). ``flush`` (see ``l2_flusher``) runs before each
    timed run, outside the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: launches that open every trace before ``fn``'s own: late in a process's
#: life the tracer drops the first device events of each trace, a number that
#: grows with the process's age (on an H100, one more about every 11 s of a
#: run with idle spells); each retake opens with four times as many
OPENERS = 256


def device_events(fn, runs: int) -> list[dict]:
    """The kernel, memcpy and memset events of ``runs`` calls of ``fn`` in a
    ``torch.profiler`` trace (read from the exported trace, so no kernel is
    counted under its operator too): dicts with ``name`` and ``dur`` in
    microseconds. ``fn``'s launches are the host's launch, memcpy and memset
    calls inside a ``record_function`` range around the calls, matched to
    their device events by correlation id; the range follows ``OPENERS``
    launches of the trace's own, which the tracer may drop. A trace that
    lacks a device event of one of ``fn``'s launches is taken again, up to
    four times in all; then that raises."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tiny = torch.zeros(1, device="cuda")
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(OPENERS * 4**attempt):
                tiny.add_(1)
            torch.cuda.synchronize()
            with record_function("device_events_calls"):
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
        (span,) = [e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == "device_events_calls"]
        calls = {e["args"].get("correlation") for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and any(w in e.get("name", "") for w in ("Launch", "Memcpy", "Memset"))
                 and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]}
        dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and e.get("args", {}).get("correlation") in calls]
        lost = len(calls - {e["args"]["correlation"] for e in dev})
        if not lost:
            return dev
    raise RuntimeError(f"the profiler trace lost {lost} of the {len(calls)} device events of "
                       f"{runs} calls in each of four takes")


def device_ms(fn, runs: int = 20, name: str | None = None,
              flush=None) -> tuple[float, float]:
    """(device ms, launches) of one call of ``fn``: the kernels' own time,
    free of the host's share of a wrapped call. With ``name``, only the
    device events whose kernel name holds it (P1's kernel without the
    wrapper's float64 sum). With ``flush`` (see ``l2_flusher``; give
    ``name`` too), the L2 is overwritten before each call, so ``fn`` finds
    it cold; otherwise the calls run back to back and the inputs of one may
    still lie in the L2 for the next."""
    fn()
    torch.cuda.synchronize()
    traced = fn if flush is None else lambda: (flush(), fn())
    events = [e for e in device_events(traced, runs) if name is None or name in e["name"]]
    return sum(e["dur"] for e in events) / 1e3 / runs, len(events) / runs


def back_to_back_ms(fn, n: int = 50, repeats: int = 3) -> float:
    """Device ms of one call of ``fn`` when ``n`` calls run back to back:
    CUDA events around the ``n`` calls, divided by ``n``, median of
    ``repeats`` after a warm-up. The host's launch cost hides behind the
    device's work where it is shorter; the wrapper's other launches (P1's
    float64 sum) are in it."""
    warm_up(fn)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


#: a substring of the name of every P1-P3 kernel, and of no kernel of PyTorch's
PIECES_KERNEL = "_pieces_kernel"


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("jrc_tpu_torch.profiling needs a CUDA device")
    dev = torch.device("cuda:0")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    for case in cases(dev):
        t0 = time.perf_counter()
        case.run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        ms = time_ms(case.run, 10)
        steps = f" ({SHUFFLE_STEPS} steps)" if case.piece == "shuffle_pieces" else ""
        print(f"{case.label} {ms:8.3f} ms{steps}  first call {first:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
