#!/usr/bin/env python3
"""Scaling of the port's sharded step over NCCL ranks, one card a rank (the
twin of scripts/measure_multihost.py, which measured jax.distributed
processes over gloo on one host).

Runs scripts/multihost_rx_torch.py --bench at 1, 2 and 4 ranks (``--worlds``)
for three scalings:

- ``weak_16384``: the reference's 16384 samples a rank (the straddle
  capture: one QPSK-1/2 frame a block, every block's but the last's across
  its end);
- ``weak_2097152``: 2^21 samples a rank, the same capture;
- ``strong_8388608``: the 2^23-sample bench capture (2417 QPSK-3/4 frames)
  split over the ranks.

Every rank of every run must print its correctness line, its timing and
``MULTIHOST_EXIT`` and exit 0 within ``--timeout`` seconds; past it every
rank is killed and the measurement fails. Prints the card line of
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``, then one
JSON line: per scaling and world, each rank's median ms a step (16 steps a
batch, ``--batches`` batches) with its least and most batch, the slowest
rank's median, and samples/s over it. It writes no file.

    python scripts/measure_multihost_torch.py
    python scripts/measure_multihost_torch.py --cpu --worlds 1 2 --scalings weak_16384
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "multihost_rx_torch.py")
sys.path.insert(0, REPO)
#: scaling → (capture, samples a rank at a world of w)
SCALINGS = {
    "weak_16384": ("straddle", lambda w: 16384),
    "weak_2097152": ("straddle", lambda w: 2**21),
    "strong_8388608": ("bench", lambda w: 2**23 // w),
}
BENCH = re.compile(r"MULTIHOST_BENCH rank=(\d+) t_ms=([\d.]+) t_min_ms=([\d.]+) "
                   r"t_max_ms=([\d.]+) cpu_ms=([\d.]+) samples_per_s=(\d+)")


def run_world(world: int, capture: str, block_len: int, *, cpu: bool, batches: int,
              timeout: float) -> dict:
    """``world`` processes of the sharded step's script, one a rank → the
    ranks' timings; raises where a rank failed or outlived ``timeout``."""
    from jrc_tpu_torch.parallel.launch import run_ranks

    with tempfile.TemporaryDirectory() as d:
        outs = run_ranks(
            lambda r: [sys.executable, SCRIPT, "--coordinator", f"file://{d}/store",
                       "--num-processes", str(world), "--process-id", str(r), "--capture",
                       capture, "--block-len", str(block_len), "--bench", str(batches),
                       "--device", "cpu" if cpu else "cuda", "--backend",
                       "gloo" if cpu else "nccl"],
            world, timeout=timeout, cwd=REPO)
    ranks = []
    for r, (code, out) in enumerate(outs):
        if code is None:
            raise RuntimeError(f"{capture} {block_len} x {world}: rank {r} still ran after "
                               f"{timeout:.0f} s and was killed:\n{out[-3000:]}")
        m = BENCH.search(out)
        if code != 0 or m is None or f"MULTIHOST_EXIT rank={r}" not in out:
            raise RuntimeError(f"{capture} {block_len} x {world}: rank {r} exited "
                               f"{code}:\n{out[-3000:]}")
        ranks.append({"rank": int(m.group(1)), "t_ms": float(m.group(2)),
                      "t_min_ms": float(m.group(3)), "t_max_ms": float(m.group(4)),
                      "cpu_ms": float(m.group(5))})
    slowest = max(r["t_ms"] for r in ranks)
    return {"samples_a_rank": block_len, "ranks": ranks, "median_ms": slowest,
            "min_ms": min(r["t_min_ms"] for r in ranks),
            "max_ms": max(r["t_max_ms"] for r in ranks),
            "samples_per_s": world * block_len / (slowest / 1e3)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--scalings", nargs="+", choices=sorted(SCALINGS), default=list(SCALINGS))
    p.add_argument("--batches", type=int, default=7, help="batches of 16 timed steps a rank")
    p.add_argument("--timeout", type=float, default=300.0, help="seconds a run may take")
    p.add_argument("--cpu", action="store_true",
                   help="gloo ranks decoding on the CPU (a rehearsal: no device figure)")
    args = p.parse_args(argv)

    import torch

    if args.cpu:
        device = {"platform": "cpu", "kind": "cpu", "count": 0}
    else:
        if not torch.cuda.is_available():
            p.error("no CUDA device: the measurement runs one NCCL rank a card (--cpu rehearses "
                    "it on gloo)")
        if max(args.worlds) > torch.cuda.device_count():
            p.error(f"--worlds {args.worlds}: NCCL takes one card a rank and the host has "
                    f"{torch.cuda.device_count()}")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()
        print(card[0], flush=True)
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count(), "cards": card}
    result = {}
    for name in args.scalings:
        capture, per_rank = SCALINGS[name]
        result[name] = {}
        for world in args.worlds:
            row = run_world(world, capture, per_rank(world), cpu=args.cpu,
                            batches=args.batches, timeout=args.timeout)
            result[name][str(world)] = row
            print(f"{name} x {world}: {row['median_ms']:.4f} ms a step (min {row['min_ms']:.4f}, "
                  f"max {row['max_ms']:.4f}), {row['samples_per_s']:.6g} samples/s", flush=True)
    print(json.dumps({"multihost": result, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
