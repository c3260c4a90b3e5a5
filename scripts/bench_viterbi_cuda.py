"""Time the fused Viterbi kernel of jrc_tpu_torch on a CUDA device.

    python scripts/bench_viterbi_cuda.py [--parent DIR] [--reps N] [--scaling]

For each (B, T) of the RX paths the kernel is first held against the plain
version (bits exactly equal) on both decision routes, then timed with CUDA
events, median of N launches after 0.2 s of warm-up, with a 128 MiB buffer
overwritten before each (so the L2 is cold), on the route ``decision_route`` chooses and on the
other one where it fits. ``--parent DIR`` names a checkout of an earlier
commit whose decoder was two kernels (``viterbi_acs`` + ``viterbi_traceback``):
its time is taken in a subprocess in the order parent, this, this, parent,
so both come from one card. ``--scaling`` also times T = 576 at batch sizes
from one frame per SM to twice the bench's, which shows where the serial
chain of a frame stops and the schedulers' rate starts to bound the kernel.
Prints one JSON object per line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = ((3072, 24), (3072, 576), (3072, 864), (3072, 2160))

PARENT_CODE = """
import json, sys, statistics, time
import numpy as np, torch
from jrc_tpu_torch import tables
from jrc_tpu_torch.ops import viterbi, viterbi_cuda
dev = torch.device("cuda")
trellis = tuple(torch.as_tensor(a).to(torch.int64 if a.dtype == np.int32 else torch.float32).to(dev)
                for a in viterbi._trellis())
flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
def time_ms(fn, reps):
    t_end = time.perf_counter() + 0.2
    while time.perf_counter() < t_end:
        fn(); torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize(); out.append(a.elapsed_time(b))
    return statistics.median(out)
reps = int(sys.argv[1])
for b, t in json.loads(sys.argv[2]):
    rng = np.random.default_rng(0)
    vals = rng.normal(0, 1, (b, 2 * t)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.2] = 0.0
    v = torch.from_numpy(vals).to(dev)
    words, end = viterbi_cuda.viterbi_acs(v, trellis)
    print(json.dumps({"what": "parent", "B": b, "T": t,
        "acs_ms": time_ms(lambda: viterbi_cuda.viterbi_acs(v, trellis), reps),
        "traceback_ms": time_ms(lambda: viterbi_cuda.viterbi_traceback(words, end), reps),
        "decode_ms": time_ms(lambda: viterbi_cuda.viterbi_decode(v, trellis), reps)}), flush=True)
"""


def soft_values(b: int, t: int, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    vals = rng.normal(0, 1, (b, 2 * t)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.2] = 0.0  # erasures
    return torch.from_numpy(vals).to(dev)


def run_parent(parent: str, reps: int) -> None:
    out = subprocess.run([sys.executable, "-c", PARENT_CODE, str(reps), json.dumps(SHAPES)],
                         cwd=parent, capture_output=True, text=True, timeout=900)
    sys.stdout.write(out.stdout)
    if out.returncode:
        raise RuntimeError(f"parent run failed:\n{out.stderr}")


def run_this(reps: int, check: bool) -> None:
    import numpy as np
    import torch

    from jrc_tpu_torch import profiling
    from jrc_tpu_torch.ops import viterbi, viterbi_cuda

    dev = torch.device("cuda")
    trellis = tuple(torch.as_tensor(a).to(torch.int64 if a.dtype == np.int32 else torch.float32)
                    .to(dev) for a in viterbi._trellis())
    flush = profiling.l2_flusher(dev)
    for b, t in SHAPES:
        v = soft_values(b, t, dev)
        chosen = viterbi_cuda.decision_route(b, t)
        routes = [chosen] + [r for r in ("shared", "global") if r != chosen
                             and (r == "global" or viterbi_cuda.shared_block_bytes(t)
                                  <= viterbi_cuda.MAX_BLOCK_SMEM)]
        row = {"what": "fused", "B": b, "T": t, "route": chosen}
        if check:
            want = viterbi.viterbi_decode_plain(v, trellis)
        for r in routes:
            if check:
                got = viterbi_cuda.viterbi_decode(v, trellis, route=r)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"fused kernel != plain at ({b}, {t}) on the {r} route: "
                                       f"{int((got != want).sum())} bits differ")
            profiling.warm_up(lambda: viterbi_cuda.viterbi_decode(v, trellis, route=r))
            row[f"{r}_ms"] = profiling.time_ms(
                lambda: viterbi_cuda.viterbi_decode(v, trellis, route=r), reps, flush)
        row["exact"] = check
        print(json.dumps(row), flush=True)


def run_scaling(reps: int) -> None:
    import numpy as np
    import torch

    from jrc_tpu_torch import profiling
    from jrc_tpu_torch.ops import viterbi, viterbi_cuda

    dev = torch.device("cuda")
    trellis = tuple(torch.as_tensor(a).to(torch.int64 if a.dtype == np.int32 else torch.float32)
                    .to(dev) for a in viterbi._trellis())
    flush = profiling.l2_flusher(dev)
    for b in (132, 528, 1056, 2112, 3072, 6144):
        v = soft_values(b, 576, dev)
        profiling.warm_up(lambda: viterbi_cuda.viterbi_decode(v, trellis))
        print(json.dumps({"what": "scaling", "B": b, "T": 576,
                          "route": viterbi_cuda.decision_route(b, 576),
                          "ms": profiling.time_ms(lambda: viterbi_cuda.viterbi_decode(v, trellis),
                                                  reps, flush)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="checkout of a commit with the two-kernel decoder")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--scaling", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_viterbi_cuda.py needs a CUDA device")
    from jrc_tpu_torch import kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    kernels.lib()
    if args.parent:
        run_parent(args.parent, args.reps)
    run_this(args.reps, check=True)
    run_this(args.reps, check=False)
    if args.parent:
        run_parent(args.parent, args.reps)
    if args.scaling:
        run_scaling(args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
