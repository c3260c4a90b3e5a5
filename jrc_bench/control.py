"""The control of a cell's comparison, and the faults of its truth checks:

    python3 -m jrc_bench.control --workload <name> --seeds <n> [<n> ...] [--fault <name>]

For each seed, the plain reference is put in the program's place and
compared with the float64 reference exactly as a run compares the program:
on the seed's check blocks (``rx_stream``), or over its start dwells and
its state after ``final_dwells`` dwells (``jrc_loop``). Without ``--fault``
it is computed in bfloat16 (``phy.Prec``), the control; with one it is
float64 with that fault planted (``late_sync``, ``snr_unhalved``: rx;
``range_flip``: jrc). It prints one JSON line a seed with each number, its
limit and whether it failed it, then a line with the smallest reading of
each number over the seeds, the upper readings the limits were set below.
The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from jrc_bench.run import ROOT, cache_env, find


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    cache_env(ROOT)
    import torch

    from jrc_bench.harness import Cell, limits

    found = find(ROOT, args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("jrc_bench.control: no CUDA device", file=sys.stderr)
        return 2
    lowest: dict = {}
    any_unfailed = False
    for seed in args.seeds:
        cell = Cell(name=found.cell["name"], config=found.config, mix=found.mix, seed=seed,
                    seconds=0.0, trace=False, device=device, t_start=time.perf_counter())
        lim = limits(cell)
        numbers = found.driver.control(cell, args.fault)
        failed = sorted(k for k, v in numbers.items() if v > lim[k])
        any_unfailed |= not failed
        for k, v in numbers.items():
            lowest[k] = min(lowest.get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "failed": failed,
                          "numbers": {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}}),
              flush=True)
    print(json.dumps({"workload": args.workload, "fault": args.fault, "lowest": lowest,
                      "control_failed_every_seed": not any_unfailed}), flush=True)
    return 0 if not any_unfailed else 1


if __name__ == "__main__":
    sys.exit(main())
