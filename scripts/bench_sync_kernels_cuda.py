"""Time the row gather K3 and the detection front end K2 of jrc_tpu_torch
on a CUDA device, this tree against an earlier one in the same call.

    python scripts/bench_sync_kernels_cuda.py [--parent DIR] [--reps N]

Each tree is timed in a process of its own (it builds its own kernels), in
the order parent, this, this, parent, so that both come from one card.
``--parent DIR`` names a checkout of an earlier commit (a ``git archive``
unpacked under ``build/``). One JSON object per line, per tree and pass:

* K3 at 3072 rows of the bench capture and widths 383, 1168 (static path),
  3328 (dynamic) and 7568 (mixed), starts int64 with some out of range:
  ``wrapped_ms`` and ``wrapped_cold_ms`` are the median over N calls of CUDA
  events around one ``gather_rows`` call, warm and with 128 MiB overwritten
  before each call; ``device_ms`` and ``kernels`` are the device time and the
  number of kernels of one call, from a ``torch.profiler`` trace of 20 calls
  (the kernel-only time, free of the host's share of a wrapped call);
  ``host_us`` is the host's time for one call (200 calls, no synchronize).
  ``rot_*`` are the same for the gather followed by the derotation
  exp(j·omega·(n0 + k)): one call with ``rot=`` where the tree has it, else
  the gather followed by the expression ``extract_frames_batch`` used.
  ``library_*``: one advanced-indexing call ``x[idx]``, index built outside.
* K2 over the 2^23-sample bench capture with its left history: the same
  four figures for one ``detect_front_end`` call.
* Where the tree's kernels take the int16 stream of the sc16 wire (``dq=``):
  ``sc16_*`` and ``sc16_rot_*`` are the same figures for K3, and ``sc16_*``
  for K2, on the capture quantized at full scale 1.0 (``sc16_bound_ms``
  reckons 4 B a sample read); ``two_pass_*`` is the route those loads avoid,
  one dequantization pass ``q.to(float32) * dq`` and then the fc32 kernel.

Every figure is first checked: K3 exactly equal to the tree's plain version,
the rotated rows within 4e-7 · max|x|, K2's triggers exactly equal; on the
int16 stream K3's rows and K2's three outputs exactly equal to the same
kernel's on the dequantized stream.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_ROWS = 3072
WIDTHS = (383, 1168, 3328, 7568)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def worker(tree: str, reps: int, label: str) -> None:
    """Time the kernels of the package found in ``tree``."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jrc_tpu_torch import capture, kernels
    from jrc_tpu_torch.config import OFDMConfig
    from jrc_tpu_torch.models.streaming import left_history_samples
    from jrc_tpu_torch.ops import detect_cuda, gather_cuda

    dev = torch.device("cuda")
    kernels.lib()
    flush_buf = torch.empty(1 << 27, dtype=torch.uint8, device=dev)

    def events_ms(fn, cold: bool) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            if cold:
                flush_buf.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def device_ms(fn, calls: int = 20):
        """(device ms, kernels) of one call, from the trace's device events
        (kept here: an earlier tree's package has no such helper)."""
        fn()
        torch.cuda.synchronize()
        for attempt in range(3):  # a trace now and then comes back short of device events
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.zeros(1, device=dev)  # late in a process the tracer misses a trace's first launch
                torch.cuda.synchronize()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                trace = Path(tmp) / "trace.json"
                prof.export_chrome_trace(str(trace))
                events = json.loads(trace.read_text())["traceEvents"]
            launched = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and any(w in e.get("name", "") for w in ("Launch", "Memcpy", "Memset"))]
            opener = min(launched, key=lambda e: e["ts"])["args"].get("correlation") if launched else None
            ev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and e.get("args", {}).get("correlation") != opener]
            if ev and (len(ev) % calls == 0 or attempt == 2):
                return sum(e["dur"] for e in ev) / 1e3 / calls, len(ev) / calls
        raise RuntimeError("the profiler trace holds no device event")

    def host_us(fn, calls: int = 200) -> float:
        """The host's time for one call, the device left to catch up after."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        spent = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * spent / calls

    def figures(prefix: str, fn) -> dict:
        dms, n_kernels = device_ms(fn)
        return {f"{prefix}wrapped_ms": events_ms(fn, False), f"{prefix}host_us": host_us(fn),
                f"{prefix}wrapped_cold_ms": events_ms(fn, True),
                f"{prefix}device_ms": dms, f"{prefix}kernels": n_kernels}

    cfg = OFDMConfig()
    frame, _, halo = capture.load_bench_frame()
    cap, _ = capture.build_capture(frame, 2**15 * 256, halo=halo)
    x = torch.from_numpy(cap).to(dev)
    xp = torch.cat([torch.zeros(left_history_samples(cfg), dtype=x.dtype, device=dev), x])
    n = xp.shape[0]
    x_max = float(xp.abs().max())
    rng = np.random.default_rng(0)
    starts = torch.from_numpy(rng.integers(-1000, n + 1000, N_ROWS)).to(dev)
    omega = torch.from_numpy(rng.uniform(-0.02, 0.02, N_ROWS).astype(np.float32)).to(dev)
    n0 = torch.from_numpy(rng.integers(0, 2 * cfg.sym_len, N_ROWS)).to(dev)
    has_rot = "rot" in inspect.signature(gather_cuda.gather_rows).parameters
    has_sc16 = "dq" in inspect.signature(gather_cuda.gather_rows).parameters
    if has_sc16:
        from jrc_tpu_torch.ops import wire
        from jrc_tpu_torch.runtime import quantize_sc16

        dq = wire.dq_scale(1.0)
        q = torch.from_numpy(quantize_sc16(xp.cpu().numpy())).to(dev)
        xd = wire.dequantize(q, dq)

        def dequantized():  # the pass the fused loads avoid
            return torch.view_as_complex(q.to(torch.float32) * dq)

    def derotated(rows, width):  # the expression extract_frames_batch used after the gather
        phase = omega[:, None] * (n0.to(torch.float32)[:, None]
                                  + torch.arange(width, dtype=torch.float32, device=dev)[None, :])
        return rows * torch.complex(torch.cos(phase), torch.sin(phase))

    for width in WIDTHS:
        idx = starts.clamp(0, n - width)[:, None] + torch.arange(width, device=dev)
        want = xp[idx]
        if not torch.equal(gather_cuda.gather_rows(xp, starts, width), want):
            raise RuntimeError(f"gather_rows != x[idx] at width {width}")
        if has_rot:
            rotated = lambda: gather_cuda.gather_rows(xp, starts, width, rot=(omega, n0))  # noqa: E731
        else:
            rotated = lambda: derotated(gather_cuda.gather_rows(xp, starts, width), width)  # noqa: E731
        rot_err = float((rotated() - derotated(want, width)).abs().max())
        if rot_err > 4e-7 * x_max:
            raise RuntimeError(f"rotated rows differ by {rot_err} at width {width}")
        row = {"tree": label, "kernel": "gather_rows", "width": width, "rows": N_ROWS,
               "bound_ms": 1e3 * (2 * 8 * N_ROWS * width + 8 * N_ROWS) / 3.35e12,
               "rot_in_kernel": has_rot, "rot_max_abs_err": rot_err}
        row.update(figures("", lambda: gather_cuda.gather_rows(xp, starts, width)))
        row.update(figures("rot_", rotated))
        row.update(figures("library_", lambda: xp[idx]))
        row.update(figures("library_rot_", lambda: derotated(xp[idx], width)))
        if has_sc16:
            for rot in (None, (omega, n0)):
                if not torch.equal(gather_cuda.gather_rows(q, starts, width, rot=rot, dq=dq),
                                   gather_cuda.gather_rows(xd, starts, width, rot=rot)):
                    raise RuntimeError(f"gather_rows on int16 != on the dequantized stream at "
                                       f"width {width}")
            row["sc16_bound_ms"] = 1e3 * (12 * N_ROWS * width + 8 * N_ROWS) / 3.35e12
            row.update(figures("sc16_", lambda: gather_cuda.gather_rows(q, starts, width, dq=dq)))
            row.update(figures("sc16_rot_", lambda: gather_cuda.gather_rows(
                q, starts, width, rot=(omega, n0), dq=dq)))
            row.update(figures("two_pass_rot_", lambda: gather_cuda.gather_rows(
                dequantized(), starts, width, rot=(omega, n0))))
        print(json.dumps(row), flush=True)

    kw = dict(threshold=0.6, min_n_peaks=10, max_peak_distance=2 * cfg.sym_len,
              lag=cfg.fft_len // 4, win=cfg.fft_len // 2, pwin=int(1.5 * (cfg.fft_len // 2)))
    a_k, first_k, count_k = detect_cuda.detect_front_end(xp, **kw)
    a_p, first_p, count_p = detect_cuda.detect_front_end_plain(xp, **kw)
    if not (torch.equal(first_k, first_p) and torch.equal(count_k, count_p)):
        raise RuntimeError("detect_front_end: triggers differ from the plain version")
    row = {"tree": label, "kernel": "detect_front_end", "samples": n,
           "triggers": int(count_k.sum()),
           "bound_ms": 1e3 * (16 * n + 8 * first_k.numel()) / 3.35e12,
           "a_max_abs_err": float((torch.view_as_real(a_k) - torch.view_as_real(a_p)).abs().max())}
    row.update(figures("", lambda: detect_cuda.detect_front_end(xp, **kw)))
    if has_sc16:
        for got, want in zip(detect_cuda.detect_front_end(q, dq=dq, **kw),
                             detect_cuda.detect_front_end(xd, **kw)):
            if not torch.equal(got, want):
                raise RuntimeError("detect_front_end on int16 != on the dequantized stream")
        row["sc16_bound_ms"] = 1e3 * (12 * n + 8 * first_k.numel()) / 3.35e12
        row.update(figures("sc16_", lambda: detect_cuda.detect_front_end(q, dq=dq, **kw)))
        row.update(figures("two_pass_", lambda: detect_cuda.detect_front_end(dequantized(), **kw)))
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="checkout of an earlier commit to time in the same call")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker[0], args.reps, args.worker[1])
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_sync_kernels_cuda.py needs a CUDA device")
    print(json.dumps({"card": card(), "torch": torch.__version__}), flush=True)
    trees = [(str(ROOT), "this")]
    if args.parent:
        parent = (str(Path(args.parent).resolve()), "parent")
        trees = [parent, *trees, *trees, parent]
    for tree, label in trees:
        out = subprocess.run([sys.executable, __file__, "--reps", str(args.reps),
                              "--worker", tree, label], cwd=tree, timeout=900)
        if out.returncode:
            raise RuntimeError(f"the run of {tree} failed with code {out.returncode}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
