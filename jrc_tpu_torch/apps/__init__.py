"""Command-line applications of the port (``python -m jrc_tpu_torch.apps.<name>``)."""
from __future__ import annotations

import argparse
import sys


def add_trace_argument(p: argparse.ArgumentParser) -> None:
    """``--trace-out`` (``utils.profiling.CallTrace``)."""
    p.add_argument("--trace-out", metavar="DIR", default=None,
                   help="write DIR/trace.json: the program's host spans merged into a "
                        "device-only profiler trace of the 24 calls after the first; print "
                        "the longest idle gaps of the device by host span")


def report_trace(tracer) -> None:
    """Where a ``CallTrace`` went and its longest idle gaps of the device,
    each with the host span open when it began, on standard error."""
    if tracer.out_dir is None:
        return
    print(f"trace: {tracer.out_dir / 'trace.json'}", file=sys.stderr)
    for _start, length, label in tracer.gaps:
        print(f"  device idle {length / 1e6:.4f} ms, the host in: {label}", file=sys.stderr)
