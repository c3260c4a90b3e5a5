"""Where the time of the port's three RX paths goes on a CUDA device.

    python scripts/profile_torch_paths.py [--runs N]

Drives the paths of chip_smoke.py (StreamingRx on the bench capture,
StreamingRxDynamic at max_payload 96 on the same capture and at max_payload
256 on the mixed capture; 2^15-sample blocks x 256, 12 frame slots a block)
and prints one JSON object per path:

* ``wall_ms``: median host time of N runs, each ended by a synchronize;
* ``device_ms``, ``launches``: kernel, memcpy and memset events of a
  ``torch.profiler`` trace over 3 runs, per run (read from the exported
  trace's device events, so no kernel is counted under its operator too);
* ``idle_share``: 1 - device_ms / wall_ms;
* ``viterbi_ms``: the share of ``device_ms`` spent in the fused decoder;
* ``host_syncs``: warnings of ``torch.cuda.set_sync_debug_mode("warn")``
  over one run;
* ``peak_gib``: ``torch.cuda.max_memory_allocated`` over one run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BLOCK_LEN, N_BLOCKS, MAX_FRAMES = 2**15, 256, 12


def paths(dev):
    """{name: (model, capture on dev)} of the three configurations."""
    import torch

    from jrc_tpu_torch import capture
    from jrc_tpu_torch.config import MCS, OFDMConfig, PacketType
    from jrc_tpu_torch.models.streaming import (
        StreamingRx, StreamingRxDynamic, frame_window_samples_dynamic,
    )
    from jrc_tpu_torch.ops.encoder import FrameSpec

    cfg = OFDMConfig()
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    frame, _, halo = capture.load_bench_frame()
    cap, _ = capture.build_capture(frame, BLOCK_LEN * N_BLOCKS, halo=halo)
    x = torch.from_numpy(cap).to(dev)
    mixed, _ = capture.build_mixed_capture(
        [f.samples for f in capture.load_mixed_frames()], BLOCK_LEN * N_BLOCKS,
        halo=frame_window_samples_dynamic(cfg, 256) + cfg.fft_len)
    kw = dict(max_frames_per_block=MAX_FRAMES, device=dev)
    return {
        "static": (StreamingRx(cfg, spec, BLOCK_LEN, N_BLOCKS, **kw), x),
        "dynamic": (StreamingRxDynamic(cfg, BLOCK_LEN, N_BLOCKS, max_payload=96, **kw), x),
        "mixed": (StreamingRxDynamic(cfg, BLOCK_LEN, N_BLOCKS, max_payload=256, **kw),
                  torch.from_numpy(mixed).to(dev)),
    }


def device_events(model, x, runs: int):
    """(device ms, launches, decoder ms) per run from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            model(x)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise RuntimeError("the profiler trace holds no device event")
    total = sum(e["dur"] for e in dev) / 1e3
    decoder = sum(e["dur"] for e in dev if "viterbi_decode_kernel" in e["name"]) / 1e3
    return total / runs, len(dev) / runs, decoder / runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_paths.py needs a CUDA device")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    for name, (model, x) in paths(dev).items():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        wall = statistics.median(times)
        device_ms, launches, viterbi_ms = device_events(model, x, 3)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model(x)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = sum("synchroniz" in str(w.message).lower() for w in caught)
        print(json.dumps({
            "path": name, "samples": BLOCK_LEN * N_BLOCKS, "wall_ms": wall,
            "wall_ms_min": min(times), "wall_ms_max": max(times),
            "samples_per_s": BLOCK_LEN * N_BLOCKS / (wall / 1e3), "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall, "launches": launches, "viterbi_ms": viterbi_ms,
            "host_syncs": syncs, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
