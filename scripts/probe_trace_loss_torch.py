"""How many device events a short ``torch.profiler`` trace loses as a
process ages, with one opening launch and through
``jrc_tpu_torch.profiling.device_events`` (card only).

    python scripts/probe_trace_loss_torch.py [--seconds 200] [--idle 10]

Each round runs 50 products of 4096 x 4096 float32 matrices, then takes a
trace of one tiny launch followed by 20 short kernels and reports how many
of those 21 device events the trace holds and which were lost (by launch
order), then takes ``device_events`` of the same 20 kernels and its
``device_ms``, then stays idle for ``--idle`` seconds. One line a round.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def raw_trace(x: torch.Tensor, runs: int) -> tuple[int, list[int]]:
    """(launches, indices of the launches without a device event) of a
    trace of one opening launch and ``runs`` short kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device=x.device)
        torch.cuda.synchronize()
        for _ in range(runs):
            torch.mul(x, 2)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    launches = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and any(w in e.get("name", "") for w in ("Launch", "Memset"))),
                      key=lambda e: e["ts"])
    got = {e.get("args", {}).get("correlation") for e in events
           if e.get("cat") in ("kernel", "gpu_memset")}
    return len(launches), [i for i, e in enumerate(launches)
                           if e["args"].get("correlation") not in got]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seconds", type=float, default=200.0)
    p.add_argument("--idle", type=float, default=10.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_trace_loss_torch.py needs a CUDA device")
    from jrc_tpu_torch import profiling

    x = torch.randn(1 << 16, device="cuda")
    t0 = time.time()
    while time.time() - t0 < args.seconds:
        y = torch.randn(4096, 4096, device="cuda")
        for _ in range(50):
            y = y @ y.T / 4096
        torch.cuda.synchronize()
        n, lost = raw_trace(x, 20)
        events = profiling.device_events(lambda: torch.mul(x, 2), 20)
        ms, launches = profiling.device_ms(lambda: torch.mul(x, 2))
        print(f"{time.time() - t0:7.1f} s: one opener: {n - len(lost)} of {n} device events "
              f"(lost launches {lost}); device_events: {len(events)} of 20; device_ms "
              f"{ms:.4f} ms in {launches:g} launches", flush=True)
        time.sleep(args.idle)
    return 0


if __name__ == "__main__":
    sys.exit(main())
