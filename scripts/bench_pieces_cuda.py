"""Time the profiling kernels P1-P3 of jrc_tpu_torch on a CUDA device.

    python scripts/bench_pieces_cuda.py [--parent DIR] [--reps N]

For every variant of P1, P2 and P3 at the TPU scripts' shapes
(``jrc_tpu_torch.profiling.cases``) it prints one JSON object a line:

- ``wrapped_ms``: CUDA events around one call, median of N after a warm-up
  (``profiling.time_ms``, the figure every earlier row of PERF.md was taken
  with: it holds the ctypes call and, for P1, the wrapper's float64 sum);
- ``alone_ms``: the kernel's own device events in a profiler trace of 20
  calls in a row (``profiling.device_ms`` with the kernels' name), with its
  launches; a case's inputs may stay in the L2 from one call to the next;
- ``alone_cold_ms``: the same with the L2 overwritten before each call
  (``profiling.l2_flusher``), as a caller's first touch of the inputs;
- ``back_to_back_ms``: events around N calls in a row, over N
  (``profiling.back_to_back_ms``; P1's sum is in it);
- ``bound_ms`` and ``bound_by``: the larger of the bytes the case must move
  over 3.35 TB/s and its float32 operations over 67 TFLOP/s
  (``profiling.bound``);
- ``library_ms`` for P2: one ``xp[idx]`` call on the same inputs, the index
  built outside the timing (``profiling.library_call``).

``--parent DIR`` names a checkout of an earlier commit (a ``git archive``
unpacked under ``build/``). Each tree runs in a process of its own with its
own kernel build, in the order parent, this, this, parent, so both come
from one card; the timing helpers are this checkout's in every process, the
cases and kernels the tree's. The first run of each tree also holds every
kernel against its plain version (exact).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def timing_helpers():
    """This checkout's profiling module, loaded from its file: its helpers
    time whichever tree's package is first on sys.path."""
    spec = importlib.util.spec_from_file_location("_pieces_timing",
                                                  ROOT / "jrc_tpu_torch" / "profiling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def equal(got, want) -> bool:
    import torch

    got, want = (o if isinstance(o, tuple) else (o,) for o in (got, want))
    return all(torch.equal(g, w) for g, w in zip(got, want))


def worker(tree: str, label: str, reps: int, check: bool) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from jrc_tpu_torch import kernels, profiling

    timing = timing_helpers()
    dev = torch.device("cuda")
    kernels.lib()
    flush = timing.l2_flusher(dev)
    for case in profiling.cases(dev):
        if check and not equal(case.run(), case.plain()):
            raise RuntimeError(f"{label}: {case.piece} [{case.label.strip()}] kernel != plain")
        alone, launches = timing.device_ms(case.run, name=timing.PIECES_KERNEL)
        bound_ms, bound_by = timing.bound(case.n_bytes, case.n_ops)
        row = {"tree": label, "piece": case.piece, "variant": case.label.strip(),
               "wrapped_ms": timing.time_ms(case.run, reps), "alone_ms": alone,
               "alone_cold_ms": timing.device_ms(case.run, 10, timing.PIECES_KERNEL, flush)[0],
               "launches": launches, "back_to_back_ms": timing.back_to_back_ms(case.run, reps),
               "bound_ms": bound_ms, "bound_by": bound_by, "exact": check}
        library = timing.library_call(case)
        if library is not None:
            if check and not torch.equal(library(), case.run()):
                raise RuntimeError(f"{label}: the library call differs from {case.label.strip()}")
            row["library_ms"] = timing.time_ms(library, reps)
        print(json.dumps(row), flush=True)


def run_tree(tree: Path, label: str, reps: int, check: bool) -> None:
    cmd = [sys.executable, __file__, "--worker", str(tree), "--label", label, "--reps", str(reps)]
    out = subprocess.run(cmd + (["--check"] if check else []), capture_output=True, text=True,
                         timeout=900)
    sys.stdout.write(out.stdout)
    sys.stdout.flush()
    if out.returncode:
        raise RuntimeError(f"the {label} run failed:\n{out.stderr}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="checkout of an earlier commit, timed in the same call")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.label, args.reps, args.check)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_pieces_cuda.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    order = [(ROOT, "this", True), (ROOT, "this", False)]
    if args.parent:
        parent = Path(args.parent).resolve()
        order = [(parent, "parent", True), *order, (parent, "parent", False)]
    for tree, label, check in order:
        run_tree(tree, label, args.reps, check)
    return 0


if __name__ == "__main__":
    sys.exit(main())
