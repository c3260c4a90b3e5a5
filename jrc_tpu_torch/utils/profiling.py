"""Throughput counters and the profiler hook (port of
jrc_tpu/utils/profiling.py): samples and frames per second around the RX
calls, and a ``torch.profiler`` trace. The timings of the profiling
kernels P1-P3 are ``jrc_tpu_torch.profiling``.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch


@dataclass
class Throughput:
    """Rolling throughput counter (samples and frames per second). With a
    CUDA ``device`` each clock read waits for the device's queued work
    first, so an interval holds the work launched inside it."""

    samples: int = 0
    frames: int = 0
    seconds: float = 0.0
    device: torch.device | str | None = None
    _t0: float | None = None

    def _now(self) -> float:
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self):
        self._t0 = self._now()
        return self

    def stop(self, n_samples: int = 0, n_frames: int = 0):
        if self._t0 is None:
            raise RuntimeError("Throughput.stop without start")
        self.seconds += self._now() - self._t0
        self.samples += n_samples
        self.frames += n_frames
        self._t0 = None

    @contextlib.contextmanager
    def measure(self, n_samples: int = 0, n_frames: int = 0):
        self.start()
        try:
            yield
        finally:
            self.stop(n_samples, n_frames)

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.seconds if self.seconds else 0.0

    @property
    def frames_per_sec(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    def report(self) -> str:
        return (f"{self.samples_per_sec/1e6:.2f} Msamp/s, "
                f"{self.frames_per_sec:.1f} frames/s over {self.seconds:.2f}s")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the CUDA device, written to ``log_dir`` for TensorBoard."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
